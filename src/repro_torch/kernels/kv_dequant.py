"""KV dequantization: the client-side decode hop of the quantized wire codecs.

An aggregated layer payload lands as N per-chunk quantized tiles plus one
fp16 scale row per matrix per chunk.  ``kv_dequant`` (int8) and
``kv_dequant_packed4`` (two biased nibbles per byte) expand them to
``out_dtype`` on the card with the CUDA kernels of ``csrc/kv_dequant.cu``;
``kv_dequant_ref`` and ``kv_dequant_packed4_ref`` are their plain PyTorch
versions (the CPU path and the oracle the kernels are held to).

Both compute ``f32(q) * f32(scale[n, c // group])`` with one rounding to
``out_dtype``, so kernel and plain version are bit-equal.

Each kernel wrapper counts its launches in ``LAUNCHES`` so a run can show
that the serving path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1}

# launches of each CUDA kernel since the last `reset_launch_counts`
LAUNCHES = {"kv_dequant": 0, "kv_dequant_packed4": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_dequant_args(q: torch.Tensor, scales: torch.Tensor, group: int,
                       out_dtype: torch.dtype, *, packed: bool
                       ) -> tuple[int, int, int]:
    """Validate the inputs both versions take; returns (N, R, W) with W the
    unpacked width.  Raises on anything the kernel does not take."""
    want = torch.uint8 if packed else torch.int8
    if q.dtype != want:
        raise TypeError(f"q must be {want}, got {q.dtype}")
    if scales.dtype != torch.float16:
        raise TypeError(f"scales must be float16, got {scales.dtype}")
    if out_dtype not in OUT_KINDS:
        raise TypeError(f"out_dtype must be float32 or bfloat16, "
                        f"got {out_dtype}")
    if q.ndim != 3 or scales.ndim != 2:
        raise ValueError(f"want q [N, R, W'] and scales [N, W/group], got "
                         f"{tuple(q.shape)} and {tuple(scales.shape)}")
    N, R, Wq = q.shape
    W = 2 * Wq if packed else Wq
    if not isinstance(group, int) or group < 1 or W % group:
        raise ValueError(f"group {group!r} must be a positive divisor of "
                         f"the width {W}")
    if tuple(scales.shape) != (N, W // group):
        raise ValueError(f"scales shape {tuple(scales.shape)} != "
                         f"{(N, W // group)} for q {tuple(q.shape)}, "
                         f"group {group}")
    if q.device != scales.device:
        raise ValueError(f"q on {q.device}, scales on {scales.device}")
    return N, R, W


def _expand_scales(scales: torch.Tensor, group: int) -> torch.Tensor:
    """[N, W/group] fp16 -> [N, W] fp32."""
    s = scales.float()
    return s if group == 1 else s.repeat_interleave(group, dim=-1)


def unpack_int4(q_packed: torch.Tensor) -> torch.Tensor:
    """[..., W/2] uint8 biased nibbles -> [..., W] int32 values in [-8, 7]
    (low nibble = even channel)."""
    lo = (q_packed & 0xF).to(torch.int32) - 8
    hi = (q_packed >> 4).to(torch.int32) - 8
    return torch.stack([lo, hi], dim=-1).reshape(
        *q_packed.shape[:-1], 2 * q_packed.shape[-1])


def kv_dequant_ref(q: torch.Tensor, scales: torch.Tensor, *, group: int = 1,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of `kv_dequant`: q [N, R, W] int8, scales [N, W/group]
    fp16 -> [N, R, W] ``out_dtype``."""
    check_dequant_args(q, scales, group, out_dtype, packed=False)
    return (q.float() * _expand_scales(scales, group)[:, None, :]).to(out_dtype)


def kv_dequant_packed4_ref(q_packed: torch.Tensor, scales: torch.Tensor, *,
                           group: int = 1,
                           out_dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """Plain version of `kv_dequant_packed4`: q_packed [N, R, W/2] uint8,
    scales [N, W/group] fp16 -> [N, R, W] ``out_dtype``."""
    check_dequant_args(q_packed, scales, group, out_dtype, packed=True)
    q = unpack_int4(q_packed).float()
    return (q * _expand_scales(scales, group)[:, None, :]).to(out_dtype)


def _lib() -> ctypes.CDLL:
    lib = build.load("kv_dequant")
    if lib.kv_dequant_i8.argtypes is None:
        args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
        for fn in (lib.kv_dequant_i8, lib.kv_dequant_p4):
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def _launch(fn_name: str, count_name: str, q: torch.Tensor,
            scales: torch.Tensor, N: int, R: int, W: int, group: int,
            out_dtype: torch.dtype) -> torch.Tensor:
    if q.device.type != "cuda":
        raise ValueError(f"{count_name} runs on a CUDA tensor, got one on "
                         f"{q.device}")
    if not (q.is_contiguous() and scales.is_contiguous()):
        raise ValueError(f"{count_name} needs contiguous q and scales")
    if N * R * W == 0:
        raise ValueError(f"{count_name} got an empty tensor {tuple(q.shape)}")
    out = torch.empty((N, R, W), dtype=out_dtype, device=q.device)
    # the vector path makes 8 outputs of one row per thread: one 8-byte
    # (int8) or 4-byte (int4) load and 16-byte stores
    vec = int(W % 8 == 0 and q.data_ptr() % 8 == 0
              and out.data_ptr() % 16 == 0)
    fn = getattr(_lib(), fn_name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), scales.data_ptr(), out.data_ptr(), N, R, W,
                 group, OUT_KINDS[out_dtype], vec, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")
    LAUNCHES[count_name] += 1
    return out


def kv_dequant(q: torch.Tensor, scales: torch.Tensor, *, group: int = 1,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """CUDA kernel: q [N, R, W] int8, scales [N, W/group] fp16 ->
    [N, R, W] ``out_dtype`` (fp32 or bf16)."""
    N, R, W = check_dequant_args(q, scales, group, out_dtype, packed=False)
    return _launch("kv_dequant_i8", "kv_dequant", q, scales, N, R, W, group,
                   out_dtype)


def kv_dequant_packed4(q_packed: torch.Tensor, scales: torch.Tensor, *,
                       group: int = 1,
                       out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """CUDA kernel: q_packed [N, R, W/2] uint8 (pairwise biased int4),
    scales [N, W/group] fp16 -> [N, R, W] ``out_dtype``."""
    N, R, W = check_dequant_args(q_packed, scales, group, out_dtype,
                                 packed=True)
    return _launch("kv_dequant_p4", "kv_dequant_packed4", q_packed, scales,
                   N, R, W, group, out_dtype)
