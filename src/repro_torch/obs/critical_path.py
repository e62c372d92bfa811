"""Critical-path extraction and what-if projection over PR-7 span trees.

`attribution.py` explains a request's added TTFT as a sum of *budgets*
(queue + bandwidth stall + gate stall + dequant).  This module answers the
complementary operator questions directly from the spans:

* **Which edge was binding, when?**  `extract_critical_path` walks one
  request's track backward from first token to arrival, at every instant
  choosing the span whose completion *enabled* the next segment — the
  standard backward-chaining critical path over the
  arrive→queue→(gate)→wire→compute→first-token DAG the simulators emit.
  Intervals covered by no span are the pipeline's implicit gates (the
  assembly/startup window before the first wire byte, the one-layer-
  prefetch gate) and surface as synthetic ``gate`` segments, so the path
  is gap-free by construction: segments tile [arrival, prefill_done]
  exactly.
* **Where does the fleet spend its tail?**  `aggregate_profile` folds the
  per-request paths into seconds-per-category (and shares), the profile a
  flamegraph would show for the p95 cohort.
* **What if the wire were faster?**  `project_wire_scale` re-runs the
  gated-pipeline recurrence (Eq. 3 / `core.overlap`) per request with
  every measured wire duration scaled by ``1/scale``, holding admission
  times, bandwidth allocations and assembly gates fixed — a counterfactual
  "2× wire rate would cut p95 added-TTFT by X" that is *exact* at
  ``scale=1`` (the replay reproduces every measured first-token time to
  1e-9; the conformance tests pin this).  The held-fixed caveat is
  deliberate: a really-faster wire would also drain the pool queue sooner,
  so the projection is a lower bound on the improvement from the wire
  edge alone.

All inputs are the tracer's own spans and ``"request"`` summary instants —
nothing here touches a simulator, so what-if analysis runs offline on any
recorded trace (cluster, fleet, or async engine; fleet node prefixes ride
along in the track names).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from .trace import Span, Tracer

#: span names that can carry the critical path, highest priority first —
#: on a tie (two spans ending at the same instant) the *enabling* resource
#: wins: compute finishing beats the wire crossing that fed it, the wire
#: beats the storage pipeline, real work beats bookkeeping (queue), and
#: ``stall`` never wins (a stall interval is the *absence* of progress; the
#: wire span ending at the same instant is what was binding).
_LEAF_PRIORITY = ("compute", "dequant", "wire", "fetch.pre", "queue",
                  "stall")
_EPS = 1e-12

REQUEST_SUMMARY = "request"


@dataclasses.dataclass(frozen=True)
class PathSegment:
    """One edge of a request's critical path."""

    t0: float
    t1: float
    name: str            # leaf span name, or "gate" for un-spanned gaps
    layer: Optional[int] = None

    @property
    def dur_s(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass(frozen=True)
class CriticalPath:
    req_id: str
    track: str
    arrival_s: float
    prefill_done_s: float
    segments: tuple[PathSegment, ...]

    @property
    def ttft_s(self) -> float:
        return self.prefill_done_s - self.arrival_s

    def by_category(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for seg in self.segments:
            out[seg.name] = out.get(seg.name, 0.0) + seg.dur_s
        return out


def _request_instants(tracer: Tracer) -> list:
    out = []
    for track in tracer.tracks():
        out.extend(tracer.instants(track, REQUEST_SUMMARY))
    return out


def extract_critical_path(tracer: Tracer, track: str) -> CriticalPath:
    """Backward-chain the critical path of the request on ``track``.

    Starting from the first-token time, repeatedly pick the
    highest-priority leaf span ending at the current frontier (its body
    becomes the binding segment) and jump to its start; an interval no
    span ends in is a synthetic ``gate`` segment reaching back to the
    nearest earlier span end.  Terminates at the request's arrival.
    """
    summaries = tracer.instants(track, REQUEST_SUMMARY)
    if not summaries:
        raise ValueError(f"track {track!r} has no {REQUEST_SUMMARY!r} "
                         f"summary instant")
    info = summaries[-1].args
    arrival = info["arrival_s"]
    done = info["prefill_done_s"]

    leaves = [s for s in tracer.spans(track) if s.name in _LEAF_PRIORITY]
    prio = {name: i for i, name in enumerate(_LEAF_PRIORITY)}

    segments: list[PathSegment] = []
    t = done
    while t > arrival + _EPS:
        ending = [s for s in leaves
                  if s.t1 >= t - _EPS and s.t0 < t - _EPS]
        if ending:
            s = min(ending, key=lambda s: (prio[s.name], -s.t1, s.seq))
            t0 = max(s.t0, arrival)
            segments.append(PathSegment(t0, t, s.name,
                                        s.args.get("layer")))
            t = t0
        else:
            # no span ends here: an implicit gate (assembly/startup window,
            # prefetch gate).  Reach back to the nearest earlier span end.
            ends = [s.t1 for s in leaves if s.t1 < t - _EPS]
            t0 = max(max(ends, default=arrival), arrival)
            segments.append(PathSegment(t0, t, "gate"))
            t = t0
    segments.reverse()
    return CriticalPath(req_id=info["req_id"], track=track,
                        arrival_s=arrival, prefill_done_s=done,
                        segments=tuple(segments))


def extract_all(tracer: Tracer) -> list[CriticalPath]:
    """Critical paths for every request summarized on the trace."""
    return [extract_critical_path(tracer, inst.track)
            for inst in _request_instants(tracer)]


def aggregate_profile(paths) -> dict:
    """Fold per-request paths into a seconds-per-category profile.

    Returns ``{"requests": n, "total_s": T, "by_category": {name:
    {"seconds": s, "share": s/T, "segments": k}}}`` sorted by descending
    seconds — the flamegraph cut of where the cohort's TTFT actually went.
    """
    seconds: dict[str, float] = {}
    counts: dict[str, int] = {}
    n = 0
    for p in paths:
        n += 1
        for seg in p.segments:
            seconds[seg.name] = seconds.get(seg.name, 0.0) + seg.dur_s
            counts[seg.name] = counts.get(seg.name, 0) + 1
    total = sum(seconds.values())
    by_cat = {
        name: {"seconds": s, "share": (s / total if total else 0.0),
               "segments": counts[name]}
        for name, s in sorted(seconds.items(), key=lambda kv: -kv[1])}
    return {"requests": n, "total_s": total, "by_category": by_cat}


# -- what-if projection -------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Projection:
    """Measured vs counterfactual first-token times for one request."""

    req_id: str
    track: str
    measured_ttft_s: float
    projected_ttft_s: float
    measured_added_s: float
    projected_added_s: float

    @property
    def delta_s(self) -> float:
        return self.measured_ttft_s - self.projected_ttft_s


def _wire_spans_by_layer(tracer: Tracer, track: str) -> dict:
    out: dict = {}
    for s in tracer.spans(track):
        if s.name == "wire":
            out[s.args.get("layer")] = s
    return out


def project_request(tracer: Tracer, track: str,
                    wire_scale: float) -> Projection:
    """Replay one request's gated-pipeline recurrence with every measured
    wire duration divided by ``wire_scale`` (admission, allocation history
    and assembly gates held fixed).  ``wire_scale=1`` reproduces the
    measured first-token time exactly."""
    if wire_scale <= 0:
        raise ValueError("wire_scale must be positive")
    info = tracer.instants(track, REQUEST_SUMMARY)[-1].args
    arrival = info["arrival_s"]
    admit = info["admit_s"]
    done = info["prefill_done_s"]
    mode = info["mode"]
    c = info["layer_compute_s"]
    num_layers = info["num_layers"]
    measured_ttft = done - arrival

    if mode == "recompute":
        projected_done = done  # no wire edge at all
    elif mode == "chunkwise":
        wire = _wire_spans_by_layer(tracer, track).get(None)
        dur = wire.dur_s if wire is not None else 0.0
        t0 = wire.t0 if wire is not None else admit
        projected_done = (t0 + dur / wire_scale + info["pre_s"]
                          + info["c_total"])
    else:  # layerwise: the Eq. 3 recurrence with gates intact
        wires = _wire_spans_by_layer(tracer, track)
        avail = [admit + a for a in info["avail_rel"]]
        cross_prev = -math.inf
        compute_start_prev = -math.inf
        finish_prev = -math.inf
        for l in range(num_layers):
            # wire start: previous crossing, the one-layer-prefetch gate
            # (compute of l-1 must have started), and the assembly gate
            start = max(cross_prev, compute_start_prev, avail[l])
            w = wires.get(l)
            dur = (w.dur_s if w is not None else 0.0) / wire_scale
            cross = start + dur
            compute_start = max(cross, finish_prev)
            cross_prev = cross
            compute_start_prev = compute_start
            finish_prev = compute_start + c
        projected_done = finish_prev
    projected_ttft = projected_done - arrival
    wire_compute = (info["c_total"] if mode == "chunkwise"
                    else num_layers * c)
    base = wire_compute + (info["pre_s"] if mode == "chunkwise" else 0.0)
    return Projection(
        req_id=info["req_id"], track=track,
        measured_ttft_s=measured_ttft, projected_ttft_s=projected_ttft,
        measured_added_s=measured_ttft - base,
        projected_added_s=projected_ttft - base)


def project_wire_scale(tracer: Tracer, wire_scale: float) -> dict:
    """Fleet-level what-if: replay every summarized request at
    ``wire_scale``× wire rate and report the measured vs projected TTFT
    distribution shift ("2× wire rate would cut p95 added-TTFT by X").
    """
    projections = [project_request(tracer, inst.track, wire_scale)
                   for inst in _request_instants(tracer)]
    if not projections:
        return {"wire_scale": wire_scale, "requests": 0,
                "projections": []}

    def pct(vals, q):
        vals = sorted(vals)
        return vals[max(1, math.ceil(q * len(vals))) - 1]

    meas = [p.measured_ttft_s for p in projections]
    proj = [p.projected_ttft_s for p in projections]
    meas_add = [p.measured_added_s for p in projections]
    proj_add = [p.projected_added_s for p in projections]
    return {
        "wire_scale": wire_scale,
        "requests": len(projections),
        "measured_ttft_p95_s": pct(meas, 0.95),
        "projected_ttft_p95_s": pct(proj, 0.95),
        "measured_added_ttft_p95_s": pct(meas_add, 0.95),
        "projected_added_ttft_p95_s": pct(proj_add, 0.95),
        "p95_added_ttft_cut_s": pct(meas_add, 0.95) - pct(proj_add, 0.95),
        "projections": projections,
    }


def format_profile(profile: dict) -> str:
    """Render an `aggregate_profile` as an aligned text table."""
    lines = [f"critical-path profile over {profile['requests']} requests "
             f"({profile['total_s'] * 1e3:.3f} ms on-path total)"]
    for name, row in profile["by_category"].items():
        lines.append(f"  {name:<10s} {row['seconds'] * 1e3:>10.3f} ms  "
                     f"{row['share'] * 100:>5.1f} %  "
                     f"({row['segments']} segments)")
    return "\n".join(lines)
