"""Bandwidth-aware re-planning policy (DESIGN.md §Compute-or-load).

`core.scheduler.BandwidthPool` water-fills a shared cap across layerwise
flows; a flow whose allocated rate lands below its zero-stall rate r* = s/c
would stall the GPU every layer (Eq. 4).  The hybrid answer: shrink the
request instead — re-plan the compute-or-load split at the offered rate, so
the flow demands fewer bytes per layer (smaller s) over a longer compute
window (larger c, the recompute-span joined the suffix).  Its zero-stall rate
drops on both counts and the pool's pressure falls for everyone.

`HybridReplanner` is the ``replanner`` callable `BandwidthPool` accepts.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Optional

from repro_torch.core.transport import TransportProfile
from repro_torch.core.types import FlowRequest, KVSpec

from .planner import plan_split


@dataclasses.dataclass(frozen=True)
class ReplanRecord:
    """One event-time-stamped re-planning decision.

    Replaces the historical bare ``(now, req_id, fetch_chunks, rate)``
    tuples — iteration order is preserved, so legacy tuple-unpacking still
    works — and carries the demand shift the decision produced so a trace
    consumer can see *why* the pool's pressure fell."""

    t_s: float  # event time the decision was made at
    req_id: str
    fetch_chunks: int  # chunks kept on the fetch-span (0 = pure recompute)
    offered_rate: float  # the allocation that triggered re-planning (B/s)

    def __iter__(self):  # legacy order: (now, req_id, fetch_chunks, rate)
        return iter((self.t_s, self.req_id, self.fetch_chunks,
                     self.offered_rate))


@dataclasses.dataclass
class HybridReplanner:
    """Maps a stalling `FlowRequest` to a reduced hybrid demand.

    A `FlowRequest` carries only (s_i, c_i, L); the planner also needs the
    request's context length, so callers :meth:`register` it per ``req_id``
    (the orchestrator knows it at plan time).  The registry is an LRU bounded
    at ``max_contexts`` — a long-lived pool never accumulates entries even if
    nobody calls :meth:`unregister`; re-registering a reused ``req_id``
    overwrites the stale prompt length.  Tidy callers may still
    :meth:`unregister` on flow completion (the ids `BandwidthPool.advance`
    returns).
    """

    compute: object  # PaperComputeModel / MeasuredCompute
    profile: TransportProfile
    spec: KVSpec
    contexts: Dict[str, int] = dataclasses.field(
        default_factory=collections.OrderedDict)
    max_contexts: int = 4096
    session_setup: bool = True
    method: str = "closed_form"
    # Event-time integration (DESIGN.md §Cluster-sim): when a clock is
    # attached (`cluster.sim.ClusterSim` assigns its event clock; any object
    # with ``now()`` works), every re-planning decision is stamped with the
    # *event* time it was made at — not an epoch index — and logged to
    # ``history`` as a `ReplanRecord`.  Bounded like ``contexts``: a
    # long-lived pool keeps only the most recent ``max_history`` decisions.
    # With a tracer attached each record is also emitted as a ``"replan"``
    # trace instant on ``trace_track`` (purely observational).
    clock: Optional[object] = None
    history: list = dataclasses.field(default_factory=list)
    max_history: int = 4096
    tracer: Optional[object] = None
    trace_track: str = "pool"

    def register(self, req_id: str, context_tokens: int) -> None:
        self.contexts.pop(req_id, None)
        self.contexts[req_id] = context_tokens
        while len(self.contexts) > self.max_contexts:
            self.contexts.pop(next(iter(self.contexts)))

    def unregister(self, req_id: str) -> None:
        self.contexts.pop(req_id, None)

    def __call__(self, req: FlowRequest, rate: float) -> Optional[FlowRequest]:
        context = self.contexts.get(req.req_id)
        if context is None or rate <= 0.0:
            return None
        # demand carries the *mean* per-layer stride (variable-rate codecs
        # included): total demand over the chunk total recovers the exact
        # matched chunk count
        n = int(round(req.bytes_per_layer * req.num_layers
                      / self.spec.wire_chunk_bytes))
        if n <= 0:
            return None
        split = plan_split(context, n, self.spec, self.compute, self.profile,
                           rate, session_setup=self.session_setup,
                           method=self.method)
        if split.is_pure_fetch:
            return None  # fetching everything is still optimal at this rate
        if self.clock is not None:
            record = ReplanRecord(self.clock.now(), req.req_id,
                                  split.fetch_chunks, rate)
            self.history.append(record)
            if len(self.history) > self.max_history:
                del self.history[:len(self.history) - self.max_history]
            if self.tracer is not None:
                self.tracer.instant(
                    self.trace_track, "replan", t=record.t_s, cat="pool",
                    req_id=record.req_id, fetch_chunks=record.fetch_chunks,
                    offered_rate=record.offered_rate,
                    bytes_per_layer=split.bytes_per_layer)
        return FlowRequest(req.req_id, split.bytes_per_layer,
                           split.layer_compute_s, req.num_layers)
