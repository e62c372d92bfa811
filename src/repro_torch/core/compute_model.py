"""Prefill compute-time models.

Two sources of per-layer compute windows C_l:

1. ``A100_LLAMA31_8B`` — the paper's measured Table A8 (A100, Llama 3.1 8B):
   total suffix-prefill compute time and per-layer window for the canonical
   (context, hit-rate) grid.  Used by the paper-scale simulator and the
   scheduler workloads so our reproduction is anchored to the paper's own
   numbers.
2. ``RooflineCompute`` — an analytic model (FLOPs / (MFU * peak)) for arbitrary
   model configs and hardware (TPU v5e target), used when extrapolating beyond
   the paper's grid.
3. ``MeasuredCompute`` — wall-clock per-layer times measured from the real JAX
   models in this process (CPU here, TPU in deployment); used by the live
   serving engine.
"""
from __future__ import annotations

import dataclasses
from bisect import bisect_left
from typing import Mapping, Sequence

# (context_tokens, hit_rate) -> (cached_tokens, total_compute_ms, per_layer_ms,
#                                required_bw_GBps)   [paper Table A8]
A100_LLAMA31_8B: dict[tuple[int, float], tuple[int, float, float, float]] = {
    (4096, 0.500): (2048, 185.31, 5.79, 1.45),
    (4096, 0.875): (3584, 63.47, 1.98, 7.41),
    (16384, 0.500): (8192, 955.89, 29.87, 1.12),
    (16384, 0.875): (14336, 281.76, 8.80, 6.67),
    (32768, 0.500): (16384, 2589.25, 80.91, 0.83),
    (32768, 0.875): (28672, 763.19, 23.85, 4.92),
    (65536, 0.500): (32768, 8672.79, 271.02, 0.50),
    (65536, 0.875): (57344, 2423.90, 75.75, 3.10),
}

LLAMA31_8B_LAYERS = 32
LLAMA31_8B_BYTES_PER_TOKEN_PER_LAYER = 4096  # b = 2 * n_kv(8) * d(128) * p(2)

# Full-prefill (hit 0) totals interpolated from Appendix Table A1 trend —
# T(P) for the quadratic-ish prefill cost on A100.
_A100_FULL_PREFILL_MS = {
    4096: 322.6 / (1 - 0.125),  # A1 gives suffix costs; extrapolate r->0
    65536: 11643.8 / (1 - 0.125),
}


class ComputeModelBase:
    """Shared derived quantities of a layer-compute model.

    Subclasses provide ``num_layers``, ``bytes_per_token_per_layer`` and
    ``layer_compute_s(context, hit_rate)``; everything the scheduler and the
    compute-or-load planner consume follows from those.
    """

    def bytes_per_layer(self, context: int, hit_rate: float) -> float:
        return context * hit_rate * self.bytes_per_token_per_layer

    def required_bw(self, context: int, hit_rate: float) -> float:
        """B/s for perfect overlap (matches Table A8 'Req. BW' column)."""
        return self.bytes_per_layer(context, hit_rate) / self.layer_compute_s(
            context, hit_rate)


@dataclasses.dataclass(frozen=True)
class PaperComputeModel(ComputeModelBase):
    """Table A8-backed compute windows for Llama 3.1 8B on A100."""

    num_layers: int = LLAMA31_8B_LAYERS
    bytes_per_token_per_layer: int = LLAMA31_8B_BYTES_PER_TOKEN_PER_LAYER

    def suffix_compute_s(self, context: int, hit_rate: float) -> float:
        key = (context, round(hit_rate, 3))
        if key in A100_LLAMA31_8B:
            return A100_LLAMA31_8B[key][1] / 1e3
        return self._interp(context, hit_rate)

    def layer_compute_s(self, context: int, hit_rate: float) -> float:
        return self.suffix_compute_s(context, hit_rate) / self.num_layers

    # -- quadratic-in-suffix interpolation for off-grid points ---------------
    def _interp(self, context: int, hit_rate: float) -> float:
        # Prefill cost of computing the (1-r)·C suffix attending into C
        # context ≈ a·C·suffix + b·suffix².  Fit a,b from the two hit rates
        # at the nearest measured context.
        ctxs = sorted({c for c, _ in A100_LLAMA31_8B})
        c_near = min(ctxs, key=lambda c: abs(c - context))
        (s1, t1, _, _) = A100_LLAMA31_8B[(c_near, 0.500)]
        (s2, t2, _, _) = A100_LLAMA31_8B[(c_near, 0.875)]
        # suffix lengths at the measured points
        x1, x2 = c_near - s1, c_near - s2
        # t = k1·x + k2·x² (attention into full context folded into k1 via C)
        import numpy as np
        A = np.array([[x1, x1 * x1], [x2, x2 * x2]], dtype=float)
        k = np.linalg.solve(A, np.array([t1, t2], dtype=float))
        x = context * (1.0 - hit_rate) * (c_near / context)
        t = float(k[0] * x + k[1] * x * x)
        # scale by context ratio for the attention term
        return max(t, 1e-3) / 1e3


@dataclasses.dataclass(frozen=True)
class MeasuredCompute(ComputeModelBase):
    """Per-layer prefill-time model fit from *measured* wall-clock times.

    The live serving engine observes real per-layer compute windows (CPU here,
    TPU in deployment); a linear fit  t(suffix) = base_s + per_token_s·suffix
    per layer is all the compute-or-load planner needs.  The same interface as
    :class:`PaperComputeModel` (``layer_compute_s`` / ``suffix_compute_s`` /
    ``bytes_per_layer``), so the two are interchangeable planner inputs.
    """

    num_layers: int
    base_s: float  # fixed per-layer cost (dispatch, norm, MLP ramp)
    per_token_s: float  # marginal per-suffix-token per-layer cost
    bytes_per_token_per_layer: int = LLAMA31_8B_BYTES_PER_TOKEN_PER_LAYER

    @classmethod
    def fit(cls, samples: Sequence[tuple[int, float]], num_layers: int,
            bytes_per_token_per_layer: int = LLAMA31_8B_BYTES_PER_TOKEN_PER_LAYER
            ) -> "MeasuredCompute":
        """Least-squares fit of per-layer seconds vs suffix-token count.

        ``samples`` are (suffix_tokens, per_layer_seconds) measurements, e.g.
        one per warm request from ``ServingEngine`` compute timings.
        """
        import numpy as np
        if not samples:
            raise ValueError("MeasuredCompute.fit needs >= 1 measurement")
        xs = np.array([s for s, _ in samples], dtype=float)
        ys = np.array([t for _, t in samples], dtype=float)
        if len(samples) == 1:  # no intercept identifiable from one point
            per_token = float(ys[0] / max(xs[0], 1.0))
            return cls(num_layers, 0.0, per_token, bytes_per_token_per_layer)
        A = np.stack([np.ones_like(xs), xs], axis=1)
        base, per_token = np.linalg.lstsq(A, ys, rcond=None)[0]
        return cls(num_layers, max(float(base), 0.0),
                   max(float(per_token), 0.0), bytes_per_token_per_layer)

    def layer_compute_s(self, context: int, hit_rate: float) -> float:
        # Floored like PaperComputeModel (1 us): a zero window would blow up
        # required_bw and FlowRequest.zero_stall_rate, and fit() can clamp
        # both coefficients to 0 (full hit + zero intercept).
        suffix = context * (1.0 - hit_rate)
        return max(self.base_s + self.per_token_s * suffix, 1e-6)

    def suffix_compute_s(self, context: int, hit_rate: float) -> float:
        return self.num_layers * self.layer_compute_s(context, hit_rate)
