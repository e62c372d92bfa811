"""KV_L2TD chunk layout (paper §3.3).

Physical layout of one immutable chunk object::

    [ layer 0 | layer 1 | ... | layer L-1 ]          (Layer-major)
      each layer slice = [ K(G,n_kv*d) ; V(G,n_kv*d) ]   (2 matrices concatenated,
                                                          Token-major, then Dim)

Server-side aggregation never reshapes stored bytes — it only changes the
*readout order*: one layerwise payload concatenates the layer-l slices of all
matched chunks in prefix order.

This module is the *identity* (raw) wire format.  Quantized wire codecs
(DESIGN.md §Codec) reuse the same layer-major envelope with smaller
per-layer strides ``spec.wire_layer_bytes(l)`` (constant for the uniform
codecs, a per-layer size table for mixed-bit); their transforms live in
``src/repro/codec/``.
"""
from __future__ import annotations

import numpy as np

from .types import KVSpec

# bf16 is not a numpy dtype; we carry KV bytes as uint16 words on the wire and
# let JAX reinterpret on device. float16/float32 work natively.
_WIRE_DTYPES = {2: np.uint16, 4: np.uint32, 1: np.uint8}


def wire_dtype(dtype_bytes: int) -> np.dtype:
    return np.dtype(_WIRE_DTYPES[dtype_bytes])


def pack_chunk(k: np.ndarray, v: np.ndarray, spec: KVSpec) -> bytes:
    """Serialize per-chunk K/V into KV_L2TD bytes.

    ``k``, ``v``: [L, G, n_kv * d] arrays whose itemsize == spec.dtype_bytes
    (bf16 arrives as uint16 words).
    """
    L, G = spec.num_layers, spec.chunk_tokens
    width = spec.num_kv_heads * spec.head_dim
    if k.shape != (L, G, width) or v.shape != (L, G, width):
        raise ValueError(f"bad chunk shape {k.shape} / {v.shape}, want {(L, G, width)}")
    if k.dtype.itemsize != spec.dtype_bytes:
        raise ValueError(f"dtype width {k.dtype.itemsize} != spec {spec.dtype_bytes}")
    # Layer-major, K then V inside each layer.
    interleaved = np.concatenate([k, v], axis=1)  # [L, 2G, width]
    buf = np.ascontiguousarray(interleaved).tobytes()
    assert len(buf) == spec.chunk_bytes
    return buf


def unpack_chunk(buf: bytes, spec: KVSpec) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of :func:`pack_chunk` → (k, v) each [L, G, n_kv*d]."""
    L, G = spec.num_layers, spec.chunk_tokens
    width = spec.num_kv_heads * spec.head_dim
    arr = np.frombuffer(buf, dtype=wire_dtype(spec.dtype_bytes)).reshape(L, 2 * G, width)
    return arr[:, :G, :].copy(), arr[:, G:, :].copy()


def layer_range(layer: int, spec: KVSpec) -> tuple[int, int]:
    """Byte range of layer ``l`` inside any *stored* chunk (§3.2).  Under a
    constant-rate codec this is the arithmetic [l*S_wire, (l+1)*S_wire); a
    variable-rate codec replaces the stride with the prefix sums of its
    per-layer size table (Descriptor v3) — same lookup, general sizes."""
    off = spec.wire_layer_offsets
    return off[layer], off[layer + 1]


def unpack_layer_payload(payload: bytes, num_chunks: int, spec: KVSpec
                         ) -> tuple[np.ndarray, ...]:
    """Decode one aggregated layer payload into (k, v) [N*G, n_kv*d] arrays,
    or the one latent array of a `LatentKVSpec`.

    The payload is the concatenation, in prefix order, of the layer-l slices of
    N chunks; each slice is [K(G,width); V(G,width)] (or the one [G, width]).
    """
    G, n = spec.chunk_tokens, spec.kv_tensors
    width = spec.num_kv_heads * spec.head_dim
    arr = np.frombuffer(payload, dtype=wire_dtype(spec.dtype_bytes))
    arr = arr.reshape(num_chunks, n * G, width)
    return tuple(np.ascontiguousarray(
        arr[:, i * G:(i + 1) * G, :].reshape(num_chunks * G, width))
        for i in range(n))
