"""Gather of chunk tiles from a paged arena by an index vector (K8).

The last hop of the server-side aggregation on the device: once the matched
chunks' layer slices sit in a paged arena ``pool`` [P, G, W], attention
wants them contiguous and in prefix order, ``out[n] = pool[indices[n]]``
[N, G, W].  ``kv_gather`` runs the CUDA kernel of ``csrc/kv_gather.cu``;
``kv_gather_ref`` is its plain PyTorch version (the CPU path and the oracle
the kernel is held to, bit for bit).

The gather moves bytes and does no arithmetic, so the pool may hold any
dtype.  Indices are int32 (as the reference passes them) or int64 (torch's
default).  The contract is ``0 <= idx < P``; both versions clamp each index
into [0, P), so an index outside it reads the nearest end tile and never
memory outside the pool.  Repeated indices copy the same tile again.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, launches

INDEX_KINDS = {torch.int32: 0, torch.int64: 1}


def check_gather_args(pool: torch.Tensor, indices: torch.Tensor) -> int:
    """Validate the inputs both versions take; returns P."""
    if pool.ndim != 3:
        raise ValueError(f"want pool [P, G, W], got {tuple(pool.shape)}")
    if pool.shape[0] < 1:
        raise ValueError("the pool holds no tile")
    if indices.dtype not in INDEX_KINDS or indices.ndim != 1:
        raise TypeError(f"indices must be a vector of int32 or int64, got "
                        f"{indices.dtype} {tuple(indices.shape)}")
    if indices.device != pool.device:
        raise ValueError(f"indices on {indices.device}, the pool on "
                         f"{pool.device}")
    return pool.shape[0]


def kv_gather_ref(pool: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Plain version of `kv_gather`: pool [P, G, W]; indices [N] -> [N, G, W]
    in pool's dtype."""
    P = check_gather_args(pool, indices)
    return pool.index_select(0, indices.long().clamp(0, P - 1))


def _lib() -> ctypes.CDLL:
    lib = build.load("kv_gather")
    fn = lib.kv_gather
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def kv_gather(pool: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """CUDA kernel: the same function as `kv_gather_ref` on CUDA tensors.
    An empty gather (no index, or empty tiles) returns its empty result
    without a launch."""
    P = check_gather_args(pool, indices)
    for name, t in (("pool", pool), ("indices", indices)):
        if t.device.type != "cuda":
            raise ValueError(f"kv_gather runs on CUDA tensors, got {name} on "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"kv_gather needs contiguous inputs; {name} is "
                             f"not")
    N = indices.shape[0]
    out = torch.empty((N, *pool.shape[1:]), dtype=pool.dtype,
                      device=pool.device)
    tile_bytes = pool[0].numel() * pool.element_size()
    if out.numel() == 0:
        return out
    with torch.cuda.device(pool.device):
        stream = torch.cuda.current_stream(pool.device).cuda_stream
        err = _lib().kv_gather(pool.data_ptr(), indices.data_ptr(),
                               INDEX_KINDS[indices.dtype], out.data_ptr(), P,
                               N, tile_bytes, stream)
    if err != 0:
        raise RuntimeError(f"kv_gather launch failed: CUDA error {err}")
    launches.count("kv_gather")
    return out
