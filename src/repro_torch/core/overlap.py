"""Layerwise compute/transfer overlap model (paper §3.5, Eq. 3; §5.3).

With one-layer prefetch, TTFT is

    T_TTFT ≈ X_0 + sum_{l=0}^{L-2} max(X_{l+1}, C_l) + C_{L-1}        (Eq. 3)

X_0 is the latency before the GPU can start (layer 0 must fully arrive); the
middle stages overlap transfer of layer l+1 with compute of layer l; the last
layer's compute runs after all transfers finished.  A chunkwise baseline
instead serializes the full prefix transfer before any compute (Fig. 7a).

§5.3 connects the byte layout (Eq. 1) to Eq. 3: for context P and hit rate r,
matched KV bytes per layer are D^(l) = 2 n_kv d p (P r); perfect overlap needs
throughput B_req = D^(l) / t^(l).
"""
from __future__ import annotations

from typing import Sequence


def layerwise_ttft(transfer_s: Sequence[float], compute_s: Sequence[float]) -> float:
    """Eq. 3 — ``transfer_s`` = X_0..X_{L-1}, ``compute_s`` = C_0..C_{L-1}."""
    L = len(compute_s)
    assert len(transfer_s) == L
    if L == 0:
        return 0.0
    t = transfer_s[0]
    for l in range(L - 1):
        t += max(transfer_s[l + 1], compute_s[l])
    return t + compute_s[L - 1]


def chunkwise_ttft(total_transfer_s: float, compute_s: Sequence[float]) -> float:
    """Fig. 7a — compute cannot start before the whole prefix arrives."""
    return total_transfer_s + sum(compute_s)


def pipeline_ttft(ready_s: Sequence[float], compute_s: Sequence[float]) -> float:
    """Event-stepped generalisation of Eq. 3 for *arbitrary* layer-ready times
    (what the engine actually observes from the storage server):

        start_l = max(ready_l, finish_{l-1});  finish_l = start_l + C_l.
    """
    finish = 0.0
    for ready, c in zip(ready_s, compute_s):
        finish = max(ready, finish) + c
    return finish


def per_layer_stalls(ready_s: Sequence[float], compute_s: Sequence[float]) -> list[float]:
    """Per-layer GPU wait exposed by late layer arrivals."""
    stalls = []
    finish = 0.0
    for ready, c in zip(ready_s, compute_s):
        stalls.append(max(0.0, ready - finish))
        finish = max(ready, finish) + c
    return stalls


def required_bandwidth(bytes_per_layer: float, layer_compute_s: float) -> float:
    """B_req = D^(l) / t^(l) (§5.3) — throughput for perfect overlap."""
    return bytes_per_layer / layer_compute_s


def gated_layerwise_schedule(avail_s: Sequence[float], wire_s: Sequence[float],
                             compute_s: Sequence[float]
                             ) -> tuple[list[float], list[float]]:
    """Layer-ready and compute-finish times of the §3.5 one-layer-prefetch
    pipeline with *per-layer-varying* stage times (variable-rate codecs).

    ``avail_s[l]`` is when layer l's payload is assembled and could start
    crossing the wire (storage read + assemble recurrences, rate-independent);
    ``wire_s[l]`` its wire transmit time at the allocated rate.  The wire is
    serial and gated: it serves layer l no earlier than

        max(ready_{l-1}, compute-start of layer l-1, avail_l)

    — a flow cannot absorb bandwidth faster than its pipeline consumes
    (`cluster.sim`'s premise).  Then

        ready_l  = wire-start_l + wire_s[l]
        finish_l = max(ready_l, finish_{l-1}) + compute_s[l]      (Eq. 3)

    At constant per-layer times this reduces exactly to
    `steady_pipeline_ttft` (the gate is TTFT-neutral for constant cadence);
    with variable sizes the gate can genuinely reshape readiness, so the
    closed forms and the event-driven cluster simulator both use THIS
    schedule and cannot drift apart.
    """
    ready: list[float] = []
    finish: list[float] = []
    wire_free = 0.0
    for l, (a, x, c) in enumerate(zip(avail_s, wire_s, compute_s)):
        r = max(wire_free, a) + x
        compute_start = max(r, finish[-1]) if l else r
        ready.append(r)
        finish.append(compute_start + c)
        # next layer's wire start waits for this layer's compute to start
        wire_free = compute_start
    return ready, finish


def gated_layerwise_ttft(avail_s: Sequence[float], wire_s: Sequence[float],
                         compute_s: Sequence[float]) -> float:
    """TTFT of :func:`gated_layerwise_schedule` (finish of the last layer)."""
    if not compute_s:
        return 0.0
    return gated_layerwise_schedule(avail_s, wire_s, compute_s)[1][-1]


def steady_pipeline_ttft(num_layers: int, first_s: float, stage_s: float,
                         layer_compute_s: float) -> float:
    """Closed form of Eq. 3 for a *steady* pipeline: layer l is ready at
    ``first_s + l·stage_s`` and every layer computes for ``layer_compute_s``:

        T = first + (L-1)·max(stage, C) + C.

    Equals ``pipeline_ttft([first + l*stage], [C]*L)``; the compute-or-load
    planner (DESIGN.md §Compute-or-load) uses this form because both its
    transfer cadence and its compute window are constant across layers for a
    fixed split point.
    """
    if num_layers == 0:
        return 0.0
    return (first_s + (num_layers - 1) * max(stage_s, layer_compute_s)
            + layer_compute_s)
