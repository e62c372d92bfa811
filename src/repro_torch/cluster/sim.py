"""Trace-driven discrete-event cluster serving simulator (DESIGN.md
§Cluster-sim).

`core.simulator.ServingSimulator.run_workload` evaluates a *fixed* batch with
static `BandwidthPool` membership — the paper's §5.7 scheduler claim is a
concurrency claim, so this module adds the missing time axis: requests
ARRIVE from a trace, queue for admission, join the shared bandwidth pool,
stream layers, recompute (hybrid re-planning at the offered rate), and leave
— with rates re-shaped at event granularity.

Fluid transfer model (exact vs the Eq. 3 closed forms at constant rate):

    avail_l  = assembled-availability of layer l's payload — the storage
               read/assemble recurrence of `TransportProfile.layer_pipeline`
               rooted at admit (+session setup); rate-independent, so it is
               precomputed per flow at admission.  Per-layer payload bytes
               come from the codec's size table (`spec.wire_layer_bytes` —
               constant-stride codecs are the degenerate table), so
               variable-rate codecs integrate exactly.
    the wire byte-clock integrates `profile.effective_wire_rate(alloc)`;
    layer l's crossing is when its prefix-sum byte threshold lands, and the
    clock may not serve layer l before ``avail_l`` (a payload cannot cross
    the wire before it is assembled);
    ready_l  = crossing time of layer l
    finish_l = max(ready_l, finish_{l-1}) + c            (Eq. 3 recurrence)

One-layer prefetch gate (§3.5): the wire may serve layer l+1 no earlier
than compute of layer l *starts* (S_l = max(ready_l, finish_{l-1})) — a
flow cannot absorb bandwidth faster than its pipeline consumes, so
allocating beyond the zero-stall rate r* is physically useless, exactly the
premise of `allocate`'s caps.  The gate never changes TTFT at a constant
rate with constant per-layer sizes; with *variable* per-layer sizes it can
genuinely reshape readiness, which is why the closed-form reference
(`overlap.gated_layerwise_schedule`, used by `ServingSimulator` and the
hybrid planner for variable-rate codecs) models the identical gated
recurrence — the single-request conformance tests pin the event loop to
`ttft_layerwise` / `ttft_chunkwise` / `split_ttft` at 1e-9 for every
registered codec.

Reallocation modes: ``epoch_s=None`` (default) re-allocates at every ARRIVE
admission and FLOW_DONE departure (event mode); ``epoch_s=x`` restores the
paper's conservative epoch rule — joins/leaves wait for the next REALLOC
boundary, which makes the epoch API a degenerate trace of this simulator.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Optional, Sequence, Union

from repro_torch.core.compute_model import PaperComputeModel
from repro_torch.core.scheduler import BandwidthPool, Policy
from repro_torch.core.transport import (LOCAL_DRAM, RDMA_SESSION_SETUP_S,
                                  S3_RDMA_AGG, TransportProfile, VirtualClock)
from repro_torch.core.types import FlowRequest, KVSpec

from .events import Event, EventKind, EventQueue
from .metrics import ClusterMetrics, RequestRecord, summarize
from .trace import ClosedLoopTrace, TraceRequest

_NEG_INF = float("-inf")


@dataclasses.dataclass
class _ActiveFlow:
    tr: TraceRequest
    record: RequestRecord
    fr: FlowRequest  # admitted (possibly re-planned) demand
    chunkwise: bool
    layer_bytes: float  # mean per-layer wire bytes (the pool's s_i)
    total_bytes: float
    num_layers: int
    c: float  # per-layer compute window
    c_total: float  # chunkwise total suffix compute
    pre_s: float  # startup(+session) + io_0 + asm_0 (= avail[0] - admit)
    # per-layer wire state (layerwise flows): cumulative byte thresholds and
    # absolute assembled-availability times, from the codec's size table
    thresholds: list[float] = dataclasses.field(default_factory=list)
    avail: list[float] = dataclasses.field(default_factory=list)
    # fluid wire state
    t_update: float = 0.0
    delivered: float = 0.0
    alloc_rate: Optional[float] = None
    phys_rate: float = 0.0
    next_layer: int = 0
    version: int = 0
    wire_done: bool = False
    # Eq. 3 recurrences
    ready_prev: float = _NEG_INF
    finish_prev: float = _NEG_INF
    # observability helpers (also consumed by the TTFT-attribution summary)
    n_chunks: int = 0
    per_layer: Optional[list[float]] = None  # exact per-layer wire bytes
    wire_from: float = 0.0  # when the wire started serving the next layer
    flow_in_pending: Optional[str] = None  # pool flow id for the next wire span

    def next_threshold(self) -> float:
        if self.chunkwise:
            return self.total_bytes
        return self.thresholds[self.next_layer]


@dataclasses.dataclass
class ClusterResult:
    records: list[RequestRecord]
    reallocs: int
    replans: int
    events: dict[str, int]

    def metrics(self, baseline_ttft_s=None) -> ClusterMetrics:
        return summarize(self.records, baseline_ttft_s)

    def by_id(self) -> dict[str, RequestRecord]:
        return {r.req_id: r for r in self.records}


class ClusterSim:
    """Deterministic discrete-event simulator of one serving cluster sharing
    a bandwidth cap.

    ``cap_bps=None`` runs unthrottled (no pool); otherwise a `BandwidthPool`
    allocates under ``policy``/``margin`` and ``replanner`` (a
    `HybridReplanner`) lets stalling admissions shrink to a compute-or-load
    split at their offered rate.  ``max_flows`` bounds concurrent transfers;
    excess arrivals wait in FIFO admission order.
    """

    def __init__(self, cap_bps: Optional[float] = None,
                 policy: Policy = Policy.CAL_STALL_OPT,
                 margin_bps: float = 0.0,
                 compute: Optional[PaperComputeModel] = None,
                 profile: TransportProfile = S3_RDMA_AGG,
                 spec: Optional[KVSpec] = None,
                 mode: str = "layerwise",
                 session_setup: bool = True,
                 replanner=None,
                 max_flows: Optional[int] = None,
                 epoch_s: Optional[float] = None,
                 codec: str = "identity",
                 tracer=None,
                 track_prefix: str = "",
                 monitor=None,
                 slo=None) -> None:
        if mode not in ("layerwise", "chunkwise"):
            raise ValueError(f"unknown mode {mode!r}")
        self.compute = compute or PaperComputeModel()
        self.profile = profile
        self.mode = mode
        self.codec = codec
        self.session_setup = session_setup
        self.replanner = replanner
        self.max_flows = max_flows
        self.epoch_s = epoch_s
        self.clock = VirtualClock()
        self._spec_arg = spec
        # Observability (DESIGN.md §Observability): a nullable `obs.Tracer`.
        # Every emission is guarded by `if tracer is not None` and stamped
        # with event times the loop already computed — attaching a tracer can
        # never perturb a simulated timestamp (the golden tests assert
        # bit-identity).  `track_prefix` namespaces tracks per node so a
        # fleet exports one process group per node ("n0/req-3").
        self.tracer = tracer
        self.track_prefix = track_prefix
        # Live observability (same contract): `monitor` is a nullable
        # stream-metrics sink (`obs.window.StreamMonitor` shape) fed each
        # completed request at its prefill-done event time; `slo` is a
        # nullable `obs.slo.SLOMonitor` evaluated on the same stream.  Both
        # only *read* event times already computed — zero perturbation.
        self.monitor = monitor
        self.slo = slo
        if slo is not None and getattr(slo, "tracer", None) is None:
            slo.tracer = tracer
        self.pool: Optional[BandwidthPool] = None
        if cap_bps is not None:
            self.pool = BandwidthPool(cap_bps, policy, margin_bps,
                                      replanner=replanner)
            self.pool.tracer = tracer
            self.pool.trace_track = track_prefix + "pool"
            self.pool.monitor = monitor
        if replanner is not None and hasattr(replanner, "clock"):
            replanner.clock = self.clock
        if replanner is not None and hasattr(replanner, "tracer") \
                and tracer is not None:
            replanner.tracer = tracer
            replanner.trace_track = track_prefix + "pool"

    def kv_spec(self, chunk_tokens: int) -> KVSpec:
        if self._spec_arg is not None:
            return self._spec_arg
        return KVSpec(num_layers=self.compute.num_layers,
                      chunk_tokens=chunk_tokens, num_kv_heads=8, head_dim=128,
                      dtype_bytes=2, codec=self.codec)

    # -- one run --------------------------------------------------------------
    # run() decomposes into begin/seed/dispatch/finish so a fleet driver
    # (repro.fleet.sim.FleetSim) can give N node sims one *shared* queue and
    # route each popped event to its owning node — a single node driven that
    # way replays bit-for-bit what run() does.
    def begin(self, queue: Optional[EventQueue] = None) -> None:
        """Reset per-run state; ``queue`` injects a shared event queue."""
        self._queue = queue if queue is not None else EventQueue()
        self._active: dict[str, _ActiveFlow] = {}
        self._backlog: collections.deque[TraceRequest] = collections.deque()
        self._records: list[RequestRecord] = []
        self._transfers = 0  # flows occupying admission slots
        self._realloc_scheduled_t: Optional[float] = None
        self._counts = {k.value: 0 for k in EventKind}
        self._sim_reallocs = 0
        self._closed = None

    def seed(self, trace: Union[Sequence[TraceRequest], ClosedLoopTrace]
             ) -> None:
        if isinstance(trace, ClosedLoopTrace) or hasattr(trace, "initial"):
            self._closed = trace
            initial = list(trace.initial())
        else:
            initial = sorted(trace, key=lambda r: (r.arrival_s, r.req_id))
        for tr in initial:
            self._queue.push(Event(tr.arrival_s, EventKind.ARRIVE, payload=tr))

    def dispatch(self, ev: Event) -> None:
        self.clock.advance_to(ev.time)
        self._counts[ev.kind.value] += 1
        handler = {
            EventKind.ARRIVE: self._on_arrive,
            EventKind.WIRE: self._on_wire,
            EventKind.LAYER_READY: self._on_layer_ready,
            EventKind.FLOW_DONE: self._on_flow_done,
            EventKind.PREFILL_DONE: self._on_prefill_done,
            EventKind.REALLOC: self._on_realloc,
        }[ev.kind]
        handler(ev)

    def finish(self) -> ClusterResult:
        pool = self.pool
        return ClusterResult(
            records=self._records,
            reallocs=pool.reallocs if pool else self._sim_reallocs,
            replans=pool.replans if pool else 0,
            events=dict(self._counts))

    def run(self, trace: Union[Sequence[TraceRequest], ClosedLoopTrace]
            ) -> ClusterResult:
        self.begin()
        self.seed(trace)
        while self._queue:
            self.dispatch(self._queue.pop())
        return self.finish()

    # -- event handlers -------------------------------------------------------
    def _trk(self, req_id: str) -> str:
        return self.track_prefix + req_id

    def _on_arrive(self, ev: Event) -> None:
        tr: TraceRequest = ev.payload
        rec = RequestRecord(tr.req_id, tr.context, tr.hit_rate, tr.arrival_s,
                            tenant=tr.tenant, hot_tokens=tr.hot_tokens)
        self._records.append(rec)
        self._backlog.append(tr)
        if self.tracer is not None:
            self.tracer.instant(self._trk(tr.req_id), "arrive", t=ev.time,
                                cat="cluster", context=tr.context,
                                hit_rate=tr.hit_rate)
        if self.epoch_s is None:
            self._reallocate(ev.time)
        else:
            self._schedule_epoch_realloc(ev.time)

    def _on_wire(self, ev: Event) -> None:
        fl = self._active.get(ev.req_id)
        if fl is None or fl.wire_done or ev.version != fl.version:
            return  # stale prediction (rate changed since it was pushed)
        self._advance_wire(fl, ev.time)

    def _on_layer_ready(self, ev: Event) -> None:
        pass  # observational: readiness was folded into the recurrences

    def _on_flow_done(self, ev: Event) -> None:
        fl = self._active.get(ev.req_id)
        if fl is None:
            return
        fl.record.flow_done_s = ev.time
        self._transfers -= 1
        if self.pool is not None:
            self.pool.complete(ev.req_id)
        if self.epoch_s is None:
            self._reallocate(ev.time)

    def _on_prefill_done(self, ev: Event) -> None:
        fl = self._active.pop(ev.req_id, None)
        if fl is None:
            return
        fl.record.prefill_done_s = ev.time
        if self.tracer is not None:
            self._emit_request_summary(fl, ev.time)
        if self.monitor is not None:
            self.monitor.record_request(ev.time, fl.record)
        if self.slo is not None:
            self.slo.record_request(ev.time, fl.record)
        if self.replanner is not None and hasattr(self.replanner, "unregister"):
            self.replanner.unregister(ev.req_id)
        if self._closed is not None:
            nxt = self._closed.on_complete(fl.tr, ev.time)
            if nxt is not None:
                self._queue.push(Event(nxt.arrival_s, EventKind.ARRIVE,
                                       payload=nxt))

    def _emit_request_summary(self, fl: _ActiveFlow, done: float) -> None:
        """Close the request's track: a ``serve`` span plus the ``"request"``
        summary instant that `obs.attribution.attribute_trace` consumes.
        All values are event times the loop already computed — emission is
        purely observational."""
        rec = fl.record
        trk = self._trk(rec.req_id)
        self.tracer.span_at(trk, "serve", rec.admit_s, done, cat="cluster")
        if fl.total_bytes <= 0.0:
            mode = "recompute"
        elif fl.chunkwise:
            mode = "chunkwise"
        else:
            mode = "layerwise"
        per_layer = (list(fl.per_layer) if fl.per_layer is not None
                     else [fl.layer_bytes] * fl.num_layers)
        self.tracer.instant(
            trk, "request", t=done, cat="cluster",
            req_id=rec.req_id, mode=mode,
            arrival_s=rec.arrival_s, admit_s=rec.admit_s,
            prefill_done_s=done, flow_done_s=rec.flow_done_s,
            num_layers=fl.num_layers, layer_compute_s=fl.c,
            per_layer_bytes=per_layer, n_objects=fl.n_chunks,
            avail_rel=([a - rec.admit_s for a in fl.avail]
                       if fl.avail else None),
            pre_s=fl.pre_s, c_total=fl.c_total,
            replanned=rec.replanned)

    def _on_realloc(self, ev: Event) -> None:
        self._realloc_scheduled_t = None
        self._reallocate(ev.time)
        if self._transfers > 0 or self._backlog:
            self._realloc_scheduled_t = ev.time + self.epoch_s
            self._queue.push(Event(ev.time + self.epoch_s, EventKind.REALLOC))

    def _schedule_epoch_realloc(self, after: float) -> None:
        """Next epoch boundary at or after ``after`` (epoch mode only)."""
        if self.epoch_s is None or self._realloc_scheduled_t is not None:
            return
        k = math.ceil(after / self.epoch_s - 1e-12)
        t = max(k, 0) * self.epoch_s
        self._realloc_scheduled_t = t
        self._queue.push(Event(t, EventKind.REALLOC))

    # -- admission + rate shaping ---------------------------------------------
    def _reallocate(self, now: float) -> None:
        self._sim_reallocs += 1
        # 1. bring every in-flight wire up to `now` under the old rates
        for fl in self._active.values():
            if not fl.wire_done:
                self._advance_wire(fl, now)
        # 2. FIFO admission under the transfer-slot cap
        admitted: list[TraceRequest] = []
        while self._backlog and (self.max_flows is None
                                 or self._transfers < self.max_flows):
            tr = self._backlog.popleft()
            if self.replanner is not None and hasattr(self.replanner, "register"):
                self.replanner.register(tr.req_id, tr.context)
            if self.pool is not None:
                self.pool.submit(self._flow_request(tr))
            admitted.append(tr)
            self._transfers += 1
        # 3. one allocation round (replanner folds stalling fresh flows here)
        alloc = self.pool.reallocate(now) if self.pool is not None else {}
        # 4. start newly admitted flows from their *admitted* demand
        for tr in admitted:
            self._start_flow(tr, now, alloc)
        # 5. re-shape surviving flows' rates
        flow_ids = self.pool.last_flow_ids if self.pool is not None else {}
        for fid, fl in self._active.items():
            if fl.wire_done:
                continue
            if fid in flow_ids:
                # the pool started/reshaped this flow: its next wire span
                # consumes the flow id (Perfetto causality arrow)
                fl.flow_in_pending = flow_ids[fid]
            rate = alloc.get(fid) if self.pool is not None else None
            if rate != fl.alloc_rate:
                fl.alloc_rate = rate
                fl.phys_rate = self.profile.effective_wire_rate(rate)
                fl.version += 1
                self._schedule_next_wire(fl)

    def _flow_request(self, tr: TraceRequest) -> FlowRequest:
        spec = self.kv_spec(tr.chunk_tokens)
        # only non-hot cached chunks cross the wire — chunks resident in the
        # node's hot tier (tr.hot_tokens, set by the fleet cache layer) are
        # consumed from local DRAM; compute still follows the full hit rate
        n_chunks = tr.fetch_tokens // tr.chunk_tokens
        # per-flow bandwidth demand is the codec-encoded (wire) byte count;
        # the mean per-layer stride keeps variable-rate codecs a scalar s_i
        layer_bytes = n_chunks * spec.mean_wire_layer_bytes
        if self.mode == "chunkwise":
            # the pool waterfills on (s_i, c_i); spread the bulk transfer
            # evenly so zero_stall_rate stays meaningful
            c = self.compute.suffix_compute_s(tr.context, tr.hit_rate) \
                / spec.num_layers
        else:
            c = self.compute.layer_compute_s(tr.context, tr.hit_rate)
        return FlowRequest(tr.req_id, layer_bytes, c, spec.num_layers)

    def _start_flow(self, tr: TraceRequest, now: float,
                    alloc: dict[str, float]) -> None:
        spec = self.kv_spec(tr.chunk_tokens)
        nominal = self._flow_request(tr)
        fr = nominal
        rate: Optional[float] = None
        if self.pool is not None:
            fr = self.pool.flow_request(tr.req_id)  # post-replan demand
            rate = alloc[tr.req_id]
        L = spec.num_layers
        layer_bytes = fr.bytes_per_layer
        # the scalar demand is the mean stride; recover the chunk count to
        # rebuild the exact per-layer byte thresholds from the size table
        n_chunks = int(round(layer_bytes * L / spec.wire_chunk_bytes))
        rec = next(r for r in reversed(self._records) if r.req_id == tr.req_id)
        rec.admit_s = now
        rec.num_layers = L
        rec.layer_compute_s = fr.layer_compute_s
        rec.bytes_total = layer_bytes * L
        rec.replanned = fr.bytes_per_layer != nominal.bytes_per_layer
        if self.tracer is not None and now > tr.arrival_s:
            self.tracer.span_at(self._trk(tr.req_id), "queue",
                                tr.arrival_s, now, cat="cluster")

        fl = _ActiveFlow(
            tr=tr, record=rec, fr=fr, chunkwise=(self.mode == "chunkwise"),
            layer_bytes=layer_bytes, total_bytes=layer_bytes * L,
            num_layers=L, c=fr.layer_compute_s,
            c_total=fr.layer_compute_s * L, pre_s=0.0,
            t_update=now, alloc_rate=rate,
            phys_rate=self.profile.effective_wire_rate(rate))
        fl.n_chunks = n_chunks
        self._active[tr.req_id] = fl

        if layer_bytes <= 0.0:
            # pure recompute (re-planned to m=0): no transfer, no startup —
            # the T(0) endpoint of the planner, L*c after admission.
            fl.wire_done = True
            fl.pre_s = 0.0
            if self.tracer is not None:
                self.tracer.span_at(self._trk(tr.req_id), "compute",
                                    now, now + L * fl.c, cat="compute")
            self._queue.push(Event(now, EventKind.FLOW_DONE, tr.req_id))
            self._queue.push(Event(now + L * fl.c, EventKind.PREFILL_DONE,
                                   tr.req_id))
            return
        if fl.chunkwise:
            startup, io, _asm = self.profile.pipeline_components(
                n_chunks, int(fl.total_bytes))
            # batch_get semantics: control + storage io, no assemble stage
            fl.pre_s = startup + io
            fl.c_total = self.compute.suffix_compute_s(tr.context, tr.hit_rate)
        else:
            per_layer = [n_chunks * spec.wire_layer_bytes(l) for l in range(L)]
            extra = RDMA_SESSION_SETUP_S \
                if self.session_setup and self.profile is not LOCAL_DRAM else 0.0
            _, avail_rel, _ = self.profile.layer_pipeline(
                n_chunks, per_layer, None, startup_extra_s=extra)
            fl.avail = [now + a for a in avail_rel]
            thr, cum = [], 0.0
            for b in per_layer:
                cum += b
                thr.append(cum)
            fl.thresholds = thr
            fl.pre_s = avail_rel[0]
            fl.per_layer = per_layer
            # the wire stage starts once layer 0 is assembled
            fl.t_update = fl.avail[0]
        fl.wire_from = fl.t_update
        self._schedule_next_wire(fl)

    # -- fluid wire integration ----------------------------------------------
    def _schedule_next_wire(self, fl: _ActiveFlow) -> None:
        if fl.wire_done or fl.phys_rate <= 0.0:
            return  # starved: woken by the next reallocation
        t = fl.t_update + (fl.next_threshold() - fl.delivered) / fl.phys_rate
        self._queue.push(Event(t, EventKind.WIRE, fl.tr.req_id,
                               version=fl.version))

    def _advance_wire(self, fl: _ActiveFlow, now: float) -> None:
        """Process every wire-threshold crossing in (t_update, now] at the
        current constant rate, then sync the byte clock to ``now``.

        ``t_update`` may sit in the future while the wire idles at the
        one-layer-prefetch gate (or during the initial ``pre`` latency);
        integration simply has nothing to do until then."""
        while not fl.wire_done and fl.phys_rate > 0.0:
            thr = fl.next_threshold()
            t_cross = fl.t_update + (thr - fl.delivered) / fl.phys_rate
            if t_cross > now:
                break
            fl.delivered = thr
            fl.t_update = t_cross
            self._on_wire_cross(fl, t_cross)
        if not fl.wire_done and now > fl.t_update:
            fl.delivered += fl.phys_rate * (now - fl.t_update)
            fl.t_update = now

    def _on_wire_cross(self, fl: _ActiveFlow, t: float) -> None:
        fid = fl.tr.req_id
        if fl.chunkwise:
            fl.wire_done = True
            if self.tracer is not None:
                trk = self._trk(fid)
                wire_args = {"bytes": fl.total_bytes}
                if fl.flow_in_pending is not None:
                    wire_args["flow_in"] = fl.flow_in_pending
                    fl.flow_in_pending = None
                self.tracer.span_at(trk, "wire", fl.wire_from, t, cat="wire",
                                    **wire_args)
                self.tracer.span_at(trk, "fetch.pre", t, t + fl.pre_s,
                                    cat="fetch")
                self.tracer.span_at(trk, "compute", t + fl.pre_s,
                                    t + fl.pre_s + fl.c_total, cat="compute")
            self._queue.push(Event(t, EventKind.FLOW_DONE, fid))
            self._queue.push(Event(t + fl.pre_s + fl.c_total,
                                   EventKind.PREFILL_DONE, fid))
            return
        l = fl.next_layer
        ready = t  # the clock was assembly-gated, so the crossing IS ready
        compute_start = max(ready, fl.finish_prev) if l > 0 else ready
        if self.tracer is not None:
            trk = self._trk(fid)
            wire_args = {"layer": l, "bytes": fl.per_layer[l]}
            if fl.flow_in_pending is not None:
                wire_args["flow_in"] = fl.flow_in_pending
                fl.flow_in_pending = None
            self.tracer.span_at(trk, "wire", fl.wire_from, t, cat="wire",
                                **wire_args)
            if l > 0 and ready > fl.finish_prev:
                # compute pipeline idles between finishing layer l-1 and
                # layer l's payload crossing — the per-layer stall interval
                self.tracer.span_at(trk, "stall", fl.finish_prev, ready,
                                    cat="stall", layer=l)
            self.tracer.span_at(trk, "compute", compute_start,
                                compute_start + fl.c, cat="compute", layer=l)
        fl.ready_prev = ready
        fl.finish_prev = compute_start + fl.c
        self._queue.push(Event(ready, EventKind.LAYER_READY, fid, layer=l))
        if l == fl.num_layers - 1:
            fl.wire_done = True
            self._queue.push(Event(t, EventKind.FLOW_DONE, fid))
            self._queue.push(Event(fl.finish_prev, EventKind.PREFILL_DONE,
                                   fid))
        else:
            # one-layer prefetch (the wire serves layer l+1 no earlier than
            # compute of layer l starts: absorption is consumption-gated)
            # composed with the assembly gate (a payload cannot cross the
            # wire before the storage pipeline assembled it)
            fl.t_update = max(t, compute_start, fl.avail[l + 1])
            fl.next_layer = l + 1
            fl.wire_from = fl.t_update
            self._schedule_next_wire(fl)
