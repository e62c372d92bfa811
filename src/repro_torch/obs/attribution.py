"""Per-request added-TTFT attribution (DESIGN.md §Observability).

The paper's claims are *differences* against an opt-local baseline: +5.6 %
TTFT at 64K, +56-75 ms at 4K.  This module decomposes each request's
measured added TTFT into the four causes a hierarchical KV cache can
exhibit, via two counterfactual schedules that telescope exactly:

    actual   — what the simulator/engine measured after admission
    nowire   — the same request with an INFINITE wire (storage read /
               assemble gating and the one-layer-prefetch discipline kept)
    baseline — the same request served layerwise out of local DRAM
               (`LOCAL_DRAM` profile, no RDMA session setup) — the paper's
               "opt-local-LW" zero line

    queue           = admit - arrival          (admission-slot wait)
    bandwidth_stall = actual - nowire - dequant (finite allocated rate)
    gate_stall      = nowire - baseline        (storage io/assembly +
                                                control-plane + session
                                                costs beyond local DRAM)
    dequant         = measured codec decode time (0 in the fluid sims)

Because the components are differences of the SAME quantity evaluated
under nested counterfactuals, their sum is *identically* the measured
added TTFT:

    queue + bandwidth_stall + gate_stall + dequant
        = (ttft - queueless-baseline-ttft)  =  added TTFT

up to float cancellation — the golden-trace tests pin the residual below
1e-6.  No component is fitted as a residual; each is independently
meaningful (and `residual_s` reports the identity gap explicitly).

Inputs come from the ``"request"`` summary instants the instrumented
`ClusterSim` emits at PREFILL_DONE (`attribute_trace`), or directly via
`attribute_flow` for engine-side use.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from repro_torch.core.overlap import gated_layerwise_ttft
from repro_torch.core.transport import LOCAL_DRAM, TransportProfile

from .trace import Tracer

#: name of the per-request summary instant the instrumented sims emit
REQUEST_SUMMARY = "request"


@dataclasses.dataclass(frozen=True)
class TTFTAttribution:
    """One request's added-TTFT decomposition (all seconds)."""

    req_id: str
    mode: str  # "layerwise" | "chunkwise" | "recompute"
    ttft_s: float  # measured first-token latency (arrival -> prefill done)
    baseline_ttft_s: float  # local-DRAM layerwise serve of the same work
    queue_s: float
    bandwidth_stall_s: float
    gate_stall_s: float
    dequant_s: float

    @property
    def added_ttft_s(self) -> float:
        return self.ttft_s - self.baseline_ttft_s

    @property
    def components_sum_s(self) -> float:
        return (self.queue_s + self.bandwidth_stall_s + self.gate_stall_s
                + self.dequant_s)

    @property
    def residual_s(self) -> float:
        """Identity gap — float cancellation only; pinned < 1e-6 in tests."""
        return self.added_ttft_s - self.components_sum_s


def attribute_flow(req_id: str, mode: str, *,
                   arrival_s: float, admit_s: float, prefill_done_s: float,
                   num_layers: int, layer_compute_s: float,
                   per_layer_bytes: Sequence[float], n_objects: int,
                   avail_rel: Optional[Sequence[float]] = None,
                   pre_s: float = 0.0, c_total: Optional[float] = None,
                   dequant_s: float = 0.0,
                   baseline_profile: TransportProfile = LOCAL_DRAM
                   ) -> TTFTAttribution:
    """Decompose one served request.

    ``avail_rel`` (layerwise) are assembled-availability times relative to
    admission — exactly what the flow's wire clock was gated on, session
    setup included.  ``pre_s``/``c_total`` describe the chunkwise path
    (startup+io latency, total suffix compute).  A zero-byte flow (hybrid
    re-planned to pure recompute) attributes everything to ``queue``.
    """
    L = num_layers
    c = layer_compute_s
    served = prefill_done_s - admit_s
    total_bytes = float(sum(per_layer_bytes))
    if total_bytes <= 0.0 or mode == "recompute":
        nowire = baseline = served  # pure recompute: L*c, by construction
    elif mode == "layerwise":
        if avail_rel is None:
            raise ValueError("layerwise attribution needs avail_rel")
        zeros = [0.0] * L
        nowire = gated_layerwise_ttft(list(avail_rel), zeros, [c] * L)
        _, avail_d, wire_d = baseline_profile.layer_pipeline(
            n_objects, list(per_layer_bytes), None)
        baseline = gated_layerwise_ttft(avail_d, wire_d, [c] * L)
    elif mode == "chunkwise":
        ct = c_total if c_total is not None else L * c
        nowire = pre_s + ct
        startup_d, io_d, _ = baseline_profile.pipeline_components(
            n_objects, int(total_bytes))
        baseline = (startup_d + io_d
                    + baseline_profile.wire_time(int(total_bytes)) + ct)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    queue = admit_s - arrival_s
    return TTFTAttribution(
        req_id=req_id, mode=mode,
        ttft_s=prefill_done_s - arrival_s,
        baseline_ttft_s=baseline,
        queue_s=queue,
        bandwidth_stall_s=served - nowire - dequant_s,
        gate_stall_s=nowire - baseline,
        dequant_s=dequant_s)


def attribute_trace(tracer: Tracer) -> dict[str, TTFTAttribution]:
    """Attribute every ``"request"`` summary instant in a trace.

    Works on single-sim traces and fleet traces alike (fleet tracks are
    ``"n<i>/<req_id>"``; the summary args carry the bare ``req_id``).
    """
    out: dict[str, TTFTAttribution] = {}
    for inst in tracer.instants(name=REQUEST_SUMMARY):
        a = inst.args
        out[a["req_id"]] = attribute_flow(
            a["req_id"], a["mode"],
            arrival_s=a["arrival_s"], admit_s=a["admit_s"],
            prefill_done_s=a["prefill_done_s"],
            num_layers=a["num_layers"], layer_compute_s=a["layer_compute_s"],
            per_layer_bytes=a["per_layer_bytes"], n_objects=a["n_objects"],
            avail_rel=a.get("avail_rel"), pre_s=a.get("pre_s", 0.0),
            c_total=a.get("c_total"), dequant_s=a.get("dequant_s", 0.0))
    return out


def format_attribution(attrs: dict[str, TTFTAttribution]) -> str:
    """Fixed-width table of per-request components (ms)."""
    hdr = (f"{'req':<12}{'mode':<11}{'ttft':>9}{'base':>9}{'added':>9}"
           f"{'queue':>9}{'bw':>9}{'gate':>9}{'deq':>9}")
    rows = [hdr, "-" * len(hdr)]
    for rid in sorted(attrs):
        a = attrs[rid]
        ms = 1e3
        rows.append(
            f"{rid:<12}{a.mode:<11}{a.ttft_s*ms:>9.2f}"
            f"{a.baseline_ttft_s*ms:>9.2f}{a.added_ttft_s*ms:>9.2f}"
            f"{a.queue_s*ms:>9.2f}{a.bandwidth_stall_s*ms:>9.2f}"
            f"{a.gate_stall_s*ms:>9.2f}{a.dequant_s*ms:>9.2f}")
    return "\n".join(rows)


def check_identity(attrs: dict[str, TTFTAttribution],
                   tol: float = 1e-6) -> float:
    """Max |residual| over the set; raises if any exceeds ``tol``."""
    worst = 0.0
    for a in attrs.values():
        r = abs(a.residual_s)
        if math.isnan(r) or r > tol:
            raise AssertionError(
                f"attribution identity broken for {a.req_id}: "
                f"residual {a.residual_s:.3e} > {tol:g}")
        worst = max(worst, r)
    return worst
