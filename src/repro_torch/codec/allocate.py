"""Per-layer bit allocation for the mixed-bit codec (DESIGN.md §Codec).

Calibration pass: given sample KV for every layer, measure each layer's
quantization error at every candidate width, then greedily spend a wire-byte
budget where it reduces (sensitivity-weighted) error fastest.  The output is
a ``mixed/<digits>[/gN]`` codec spec string (`mixedbit.mixed_codec_name`).

Sensitivity weights are the load-bearing input: raw KV reconstruction error
is nearly flat across layers, but the *logit* impact of layer l's error
decays steeply with depth (early layers feed every later block — measured in
bench_codec's calibration probe, and the premise of the ROADMAP's
"early layers are more error-sensitive" item).  Callers that can run the
model pass per-layer logit sensitivities (`bench_codec.probe_sensitivity`);
without weights the allocator falls back to unweighted KV error, which still
produces a valid map, just not the frontier-optimal one.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core.types import KVSpec

from .mixedbit import mixed_codec_name
from .ref import dequantize_grouped, quantize_grouped


def layer_quant_error(k: np.ndarray, v: np.ndarray, bits: int,
                      group: int = 1) -> np.ndarray:
    """Relative quantization MSE per layer of one calibration chunk.

    ``k``/``v``: [L, T, W] float arrays → [L] array of
    ||dequant(x) - x||² / ||x||² summed over both matrices."""
    k = np.asarray(k, np.float32)
    v = np.asarray(v, np.float32)
    kv = np.stack([k, v], axis=1)  # [L, 2, T, W]
    q, scales = quantize_grouped(kv, bits, group)
    y = dequantize_grouped(q, scales, group)
    num = ((y - kv) ** 2).sum(axis=(1, 2, 3))
    den = np.maximum((kv ** 2).sum(axis=(1, 2, 3)), 1e-30)
    return num / den


def greedy_bit_map(errors_by_bits: dict[int, np.ndarray],
                   bytes_by_bits: dict[int, int],
                   budget_bytes: float,
                   weights: Optional[Sequence[float]] = None
                   ) -> tuple[int, ...]:
    """Greedy per-layer allocation under a per-chunk wire-byte budget.

    Every layer starts at the cheapest width; the layer with the largest
    weighted error reduction per extra wire byte upgrades first, until no
    upgrade fits the budget.  With two widths and constant upgrade cost the
    greedy is exactly optimal (it is the fractional-knapsack order); with
    more widths it is the usual marginal-gain heuristic.
    """
    bits_sorted = sorted(errors_by_bits)  # ascending widths
    L = len(next(iter(errors_by_bits.values())))
    w = np.ones(L) if weights is None else np.asarray(weights, np.float64)
    if w.shape != (L,) or (w < 0).any():
        raise ValueError(f"weights must be {L} non-negative values")
    level = [0] * L  # index into bits_sorted per layer
    spent = L * bytes_by_bits[bits_sorted[0]]
    if spent > budget_bytes:
        raise ValueError(
            f"budget {budget_bytes} cannot fit {L} layers even at "
            f"{bits_sorted[0]} bits ({spent} bytes)")
    while True:
        best, best_rate = None, 0.0
        for l in range(L):
            if level[l] + 1 >= len(bits_sorted):
                continue
            lo, hi = bits_sorted[level[l]], bits_sorted[level[l] + 1]
            cost = bytes_by_bits[hi] - bytes_by_bits[lo]
            if spent + cost > budget_bytes:
                continue
            gain = w[l] * (errors_by_bits[lo][l] - errors_by_bits[hi][l])
            rate = gain / cost
            if rate > best_rate:
                best, best_rate = (l, cost), rate
        if best is None:
            return tuple(bits_sorted[i] for i in level)
        l, cost = best
        level[l] += 1
        spent += cost


def calibrate_mixed_codec(k: np.ndarray, v: np.ndarray, *,
                          chunk_tokens: int, num_kv_heads: int, head_dim: int,
                          budget_bytes_per_chunk: float,
                          bits_choices: Sequence[int] = (4, 8),
                          group: int = 1,
                          weights: Optional[Sequence[float]] = None,
                          dtype_bytes: int = 2) -> str:
    """End-to-end calibration: sample KV → mixed codec spec string.

    ``k``/``v``: [L, T, W] calibration arrays (T need not equal
    ``chunk_tokens``; errors are scale statistics, not exact chunk bytes).
    ``budget_bytes_per_chunk`` bounds the encoded size of one whole chunk
    (`KVSpec.wire_chunk_bytes` of the result).
    """
    L = k.shape[0]
    errors = {b: layer_quant_error(k, v, b, group) for b in bits_choices}
    per_bytes = {}
    for b in bits_choices:
        spec = KVSpec(num_layers=L, chunk_tokens=chunk_tokens,
                      num_kv_heads=num_kv_heads, head_dim=head_dim,
                      dtype_bytes=dtype_bytes,
                      codec=mixed_codec_name([b] * L, group))
        per_bytes[b] = spec.wire_layer_bytes(0)
    bit_map = greedy_bit_map(errors, per_bytes, budget_bytes_per_chunk,
                             weights)
    return mixed_codec_name(bit_map, group)
