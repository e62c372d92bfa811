"""Compute-or-load split planner (DESIGN.md §Compute-or-load).

ObjectCache always *fetches* a matched prefix; Cake (arXiv:2410.03065) showed
that under constrained bandwidth the otherwise-idle GPU should recompute part
of it instead.  This planner picks the chunk split point ``m``: chunks
``[0, m)`` are fetched layerwise through the Eq. 3 pipeline while chunks
``[m, n)`` join the suffix and are recomputed during prefill.

TTFT of a split ``m`` over ``L`` layers (steady pipeline, constant per-layer
transfer ``stage(m)`` and compute ``c(m)``):

    T(m) = startup(m) + first(m) + (L-1)·max(stage(m), c(m)) + c(m)

with the degenerate endpoints T(0) = L·c(0) (pure recompute, no transfer) and
T(n) = the pure layerwise fetch of `core.simulator.ttft_layerwise`.

Structure of T on [1, n]: every transfer-side term is *proportional* to m
(per-object metadata, seek, stream, assemble, wire all scale with the bytes
or count of fetched chunks), so ``startup + first`` is affine and ``stage``
is a single line ``a·m``; the compute window ``c(m)`` is quadratic in m for
`PaperComputeModel` (the suffix-cost fit ``k1·x + k2·x²``, and the measured
anchors lie on that curve) and linear for `MeasuredCompute`.  Hence on each
interval where the max-branch is fixed, T *is* one quadratic — note T is not
convex in general (the fitted ``k2`` can be negative, making c concave and T
bimodal), and there is a fixed jump at m=0 -> m=1 (startup is paid the moment
anything is fetched).  The *closed-form* mode therefore evaluates the exact
O(1) candidate set: both endpoints, the ``a·m = c(m)`` crossover roots, and
each branch-quadratic's vertex.  The *exhaustive* mode scans all ``n+1``
splits and exists to validate the closed form (`validate_split`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.core.overlap import gated_layerwise_ttft, steady_pipeline_ttft
from repro_torch.core.transport import (LOCAL_DRAM, RDMA_SESSION_SETUP_S,
                                  TransportProfile)
from repro_torch.core.types import KVSpec


@dataclasses.dataclass(frozen=True)
class HybridSplit:
    """The planner's decision for one matched prefix."""

    fetch_chunks: int  # m: chunks [0, m) are fetched layerwise
    total_chunks: int  # n: chunks [m, n) are recomputed with the suffix
    chunk_tokens: int  # G
    ttft_s: float  # modelled TTFT at the chosen m
    fetch_ttft_s: float  # endpoint T(n): pure layerwise fetch
    recompute_ttft_s: float  # endpoint T(0): full recompute prefill
    layer_compute_s: float  # per-layer compute window at the chosen m
    bytes_per_layer: float  # demanded transfer bytes per layer at the chosen m

    @property
    def recompute_chunks(self) -> int:
        return self.total_chunks - self.fetch_chunks

    @property
    def fetch_fraction(self) -> float:
        return self.fetch_chunks / self.total_chunks if self.total_chunks else 0.0

    @property
    def is_pure_fetch(self) -> bool:
        return self.fetch_chunks == self.total_chunks

    @property
    def is_pure_recompute(self) -> bool:
        return self.fetch_chunks == 0


def split_ttft(m: int, context: int, spec: KVSpec, compute,
               profile: TransportProfile, rate: Optional[float] = None,
               session_setup: bool = True) -> float:
    """Modelled TTFT when the first ``m`` chunks are fetched layerwise and the
    remaining prefix is recomputed with the suffix.

    ``compute`` is any layer-compute model exposing
    ``layer_compute_s(context, hit_rate)`` (`PaperComputeModel` /
    `MeasuredCompute`).  Matches `ServingSimulator.ttft_layerwise` exactly at
    the pure-fetch endpoint.
    """
    L = spec.num_layers
    hit_eff = m * spec.chunk_tokens / context
    c = compute.layer_compute_s(context, hit_eff)
    if m == 0:
        return L * c
    if rate is not None and rate <= 0.0:
        # allocate() hands out a zero rate when the budget is exhausted:
        # fetching anything would never complete, so any m > 0 is infeasible
        # and the planner degenerates to pure recompute.
        return math.inf
    extra = RDMA_SESSION_SETUP_S \
        if session_setup and profile is not LOCAL_DRAM else 0.0
    if spec.is_variable_rate:
        # per-layer wire sizes (mixed-bit codec): the steady closed form's
        # single stage no longer exists — evaluate the gated per-layer
        # schedule exactly (prefix sums replace L*S_wire), the same
        # recurrence `ServingSimulator.ttft_layerwise` and the cluster
        # simulator use
        per_layer = [m * spec.wire_layer_bytes(l) for l in range(L)]
        _, avail, wire = profile.layer_pipeline(m, per_layer, rate,
                                                startup_extra_s=extra)
        return gated_layerwise_ttft(avail, wire, [c] * L)
    # transfer terms see the *wire* (codec-encoded) bytes: compression
    # shifts the compute-or-load crossover toward fetching
    layer_bytes = m * spec.wire_per_layer_chunk_bytes
    startup, first, stage = profile.stage_times(m, layer_bytes, rate)
    return startup + extra + steady_pipeline_ttft(L, first, stage, c)


def _closed_form_argmin(T, n: int, context: int, spec: KVSpec, compute,
                        profile: TransportProfile, rate: Optional[float]
                        ) -> int:
    """Exact integer minimiser of T on [0, n] via candidate enumeration.

    On [1, n], T(m) = K + B·m + c(m) + (L-1)·max(a·m, c(m)) with c quadratic
    (see module docstring): on each max-branch interval T is one quadratic,
    so its minimum over the interval sits at an interval boundary (an
    ``a·m = c(m)`` root or an endpoint) or at that quadratic's vertex.  All
    of those are enumerated below; c's coefficients are recovered from three
    exact samples.  ±1 integer neighbours absorb rounding.
    """
    if n <= 4:
        return min(range(n + 1), key=T)
    if rate is not None and rate <= 0.0:
        return 0  # no bandwidth: every m > 0 is infeasible (split_ttft = inf)
    if spec.is_variable_rate:
        # Per-layer wire sizes break the single-stage affine structure the
        # candidate enumeration is exact for (each layer contributes its own
        # max-branch boundary).  T is still O(L) to evaluate, so the exact
        # answer is a plain scan — "closed form" here means deterministic
        # arithmetic, not O(1).
        return min(range(n + 1), key=T)
    L = spec.num_layers
    S = spec.wire_per_layer_chunk_bytes
    # Probe the shared stage-timing model at m=1 and m=2 rather than
    # re-deriving slopes from profile internals: every transfer term is
    # proportional to chunk count except the fixed control-plane cost, so
    # two probes recover the affine model exactly — and the probes call the
    # same `stage_times` as `split_ttft`, so the two cannot drift apart.
    su1, fi1, st1 = profile.stage_times(1, S, rate)
    su2, fi2, st2 = profile.stage_times(2, 2 * S, rate)
    a = st2 - st1  # stage(m) = a·m
    b = (su2 - su1) + (fi2 - fi1)  # slope of (startup + first)(m)

    def c(m: float) -> float:
        return compute.layer_compute_s(context, m * spec.chunk_tokens / context)

    # Recover c(m) = q2·m² + q1·m + q0 from three exact samples.  The mid
    # sample sits at 0.4·n, not n/2: n/2 of a full match has hit 0.5, which
    # PaperComputeModel snaps onto its measured anchor (round(hit, 3) table
    # lookup) and would pollute the fit; 0.4·hit_rate never hits an anchor.
    m0, m1, m2 = 0.0, 0.4 * n, float(n)
    A = np.array([[1, m0, m0 * m0], [1, m1, m1 * m1], [1, m2, m2 * m2]])
    q0, q1, q2 = np.linalg.solve(A, np.array([c(m0), c(m1), c(m2)]))

    cand: set[int] = {0, 1, n}
    # Branch boundaries: roots of q2·m² + (q1 - a)·m + q0 = 0, via the
    # cancellation-free form (q/q2, q0/q): the fit of a *linear* c leaves
    # q2 ~ fp-noise, and the textbook formula then destroys the finite root.
    B2, C2 = q1 - a, q0
    disc = B2 * B2 - 4 * q2 * C2
    if disc >= 0 and (abs(q2) > 0 or abs(B2) > 0):
        r = math.sqrt(disc)
        qq = -(B2 + math.copysign(r, B2)) / 2 if B2 != 0 else r / 2
        if abs(q2) > 0 and abs(qq) > 0:
            cand.update((int(qq / q2), int(C2 / qq)))
        elif abs(qq) > 0:  # exactly linear: single root
            cand.add(int(C2 / qq))
    # vertices of the two branch quadratics (evaluation discards maxima)
    for lin, quad in ((b + q1 + (L - 1) * a, q2),  # transfer-bound branch
                      (b + L * q1, L * q2)):  # compute-bound branch
        if abs(quad) > 0:
            cand.add(int(-lin / (2 * quad)))
    # Coarse safety grid: if a future transport/compute model breaks the
    # affine/quadratic structure the analytic candidates assume, these keep
    # the answer near-optimal instead of arbitrarily wrong (the validation
    # tests against the exhaustive scan enforce exactness for today's models).
    cand.update(round(i * n / 8) for i in range(1, 8))
    ms: set[int] = set()
    for v in cand:
        if -3 <= v <= n + 3:  # clamp before widening: fp-noise roots can be huge
            ms.update(range(v - 3, v + 4))
    return min((m for m in ms if 0 <= m <= n), key=T)


def plan_split(context: int, matched_chunks: int, spec: KVSpec, compute,
               profile: TransportProfile, rate: Optional[float] = None, *,
               session_setup: bool = True,
               method: str = "closed_form") -> HybridSplit:
    """Find the TTFT-minimising split ``m`` in [0, matched_chunks].

    ``method``: "closed_form" (exact O(1) candidate enumeration over branch
    boundaries, vertices and endpoints — see `_closed_form_argmin`; T is NOT
    convex in general) or "exhaustive" (scan every split; the validation
    reference).
    """
    n = matched_chunks
    cache: dict[int, float] = {}

    def T(m: int) -> float:
        if m not in cache:
            cache[m] = split_ttft(m, context, spec, compute, profile, rate,
                                  session_setup)
        return cache[m]

    if method == "closed_form":
        best = _closed_form_argmin(T, n, context, spec, compute, profile, rate)
    elif method == "exhaustive":
        best = min(range(n + 1), key=T)
    else:
        raise ValueError(f"unknown method {method!r}")
    hit_eff = best * spec.chunk_tokens / context
    return HybridSplit(
        fetch_chunks=best, total_chunks=n, chunk_tokens=spec.chunk_tokens,
        ttft_s=T(best), fetch_ttft_s=T(n), recompute_ttft_s=T(0),
        layer_compute_s=compute.layer_compute_s(context, hit_eff),
        bytes_per_layer=best * spec.mean_wire_layer_bytes)


def validate_split(context: int, matched_chunks: int, spec: KVSpec, compute,
                   profile: TransportProfile, rate: Optional[float] = None, *,
                   session_setup: bool = True
                   ) -> tuple[HybridSplit, HybridSplit]:
    """Run both planner modes; returns (closed_form, exhaustive).  The two
    must agree on TTFT (the candidate enumeration is exact whenever the
    compute model's window is quadratic or linear in the split — true for
    both shipped models)."""
    cf = plan_split(context, matched_chunks, spec, compute, profile, rate,
                    session_setup=session_setup, method="closed_form")
    ex = plan_split(context, matched_chunks, spec, compute, profile, rate,
                    session_setup=session_setup, method="exhaustive")
    return cf, ex


@dataclasses.dataclass
class HybridPlanner:
    """Orchestrator-facing planner configuration.

    Bound to one compute model + transport profile; `Orchestrator.plan` calls
    :meth:`plan` with the request's context, match size and allocated rate.
    """

    compute: object  # PaperComputeModel / MeasuredCompute
    profile: TransportProfile
    session_setup: bool = True
    method: str = "closed_form"

    def plan(self, context: int, matched_chunks: int, spec: KVSpec,
             rate: Optional[float] = None) -> HybridSplit:
        return plan_split(context, matched_chunks, spec, self.compute,
                          self.profile, rate, session_setup=self.session_setup,
                          method=self.method)
