"""Numpy reference primitives for the quantized KV wire codecs.

These are the ground truth the Pallas fused-dequant kernels are validated
against (`kernels/kv_dequant.py`) and the host fallback the serving client
uses when the kernel API is unavailable on the current jax build.

Quantization scheme (DESIGN.md §Codec): symmetric per-channel over the token
axis of one [tokens, width] matrix — one fp16 scale per channel (width =
n_kv * head_dim payload columns), values in [-qmax, qmax] with
qmax = 2^(bits-1) - 1.  The scale is rounded to fp16 *before* quantizing so
encode and decode agree on the exact multiplier that will be used at
dequantization time.
"""
from __future__ import annotations

import numpy as np


def qmax_for_bits(bits: int) -> int:
    """Symmetric integer range: 127 for int8, 7 for int4."""
    return (1 << (bits - 1)) - 1


def quantize_per_channel(x: np.ndarray, bits: int
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Quantize ``x`` [..., tokens, width] → (q int8 [..., tokens, width],
    scales fp16 [..., width]); channels run along the last axis."""
    qmax = qmax_for_bits(bits)
    x = np.asarray(x, dtype=np.float32)
    absmax = np.max(np.abs(x), axis=-2)
    # fp16 scale storage: clamp before the cast, or a channel whose absmax
    # exceeds qmax * 65504 stores scale=inf and dequantizes to 0*inf = NaN;
    # clamped channels clip to +-qmax*65504 instead (bounded, finite).
    fp16_max = float(np.finfo(np.float16).max)
    scales = np.minimum(absmax / qmax, fp16_max).astype(np.float16)
    s = scales.astype(np.float32)
    s_safe = np.where(s > 0.0, s, 1.0)  # all-zero channel: q = 0 exactly
    q = np.clip(np.rint(x / s_safe[..., None, :]), -qmax, qmax)
    return q.astype(np.int8), scales


def dequantize_per_channel(q: np.ndarray, scales: np.ndarray,
                           dtype=np.float32) -> np.ndarray:
    """Inverse of :func:`quantize_per_channel` (up to rounding):
    q [..., tokens, width] * scales [..., width] → ``dtype``."""
    out = q.astype(np.float32) * scales.astype(np.float32)[..., None, :]
    return out.astype(dtype)


def quantize_grouped(x: np.ndarray, bits: int, group: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Group-wise generalisation: one fp16 scale per ``group`` consecutive
    channels (absmax over the token axis *and* the channels of the group) —
    ``group=1`` is exactly :func:`quantize_per_channel`.

    ``x`` [..., tokens, width] → (q int8 [..., tokens, width],
    scales fp16 [..., width/group])."""
    if group == 1:
        return quantize_per_channel(x, bits)
    qmax = qmax_for_bits(bits)
    x = np.asarray(x, dtype=np.float32)
    *lead, T, W = x.shape
    if W % group:
        raise ValueError(f"group {group} does not divide width {W}")
    xg = x.reshape(*lead, T, W // group, group)
    absmax = np.max(np.abs(xg), axis=(-3, -1))  # [..., W/group]
    fp16_max = float(np.finfo(np.float16).max)
    scales = np.minimum(absmax / qmax, fp16_max).astype(np.float16)
    s = scales.astype(np.float32)
    s_safe = np.where(s > 0.0, s, 1.0)
    q = np.clip(np.rint(xg / s_safe[..., None, :, None]), -qmax, qmax)
    return q.reshape(*lead, T, W).astype(np.int8), scales


def dequantize_grouped(q: np.ndarray, scales: np.ndarray, group: int,
                       dtype=np.float32) -> np.ndarray:
    """Inverse of :func:`quantize_grouped` (up to rounding):
    q [..., tokens, width] * scales [..., width/group] → ``dtype``."""
    if group == 1:
        return dequantize_per_channel(q, scales, dtype)
    *lead, T, W = q.shape
    qg = q.astype(np.float32).reshape(*lead, T, W // group, group)
    out = qg * scales.astype(np.float32)[..., None, :, None]
    return out.reshape(*lead, T, W).astype(dtype)


def pack_int4(q: np.ndarray) -> np.ndarray:
    """Pack int4 values in [-8, 7] pairwise along the last axis (biased to
    unsigned nibbles: n = q + 8; even column → low nibble)."""
    if q.shape[-1] % 2:
        raise ValueError(f"int4 packing needs an even width, got {q.shape}")
    b = (q.astype(np.int16) + 8).astype(np.uint8)
    return b[..., 0::2] | (b[..., 1::2] << 4)


def unpack_int4(packed: np.ndarray) -> np.ndarray:
    """Inverse of :func:`pack_int4`: uint8 [..., w/2] → int8 [..., w]."""
    lo = (packed & 0xF).astype(np.int8) - 8
    hi = (packed >> 4).astype(np.int8) - 8
    out = np.empty(packed.shape[:-1] + (packed.shape[-1] * 2,), np.int8)
    out[..., 0::2] = lo
    out[..., 1::2] = hi
    return out
