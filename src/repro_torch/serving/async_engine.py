"""Continuous-batching async serving engine (DESIGN.md §Async-engine), in
PyTorch: port of the reference's ``serving/async_engine.py``.

`ServingEngine.submit` is strictly sequential: one request owns the whole
engine from plan to commit, so the §3.6 bandwidth-sharing story — multiple
in-flight layerwise fetches water-filled by one `BandwidthPool` — and the
§5.7 scheduler claims could only be *simulated* (`cluster.sim.ClusterSim`).
This engine serves them: an event loop drives chunked prefill of many
requests interleaved with `ContinuousBatcher` decode steps, with the
orchestrator issuing real plans (pool submit + event-time reallocation) at
every arrival and real `release` calls at every flow completion — the
submit/reallocate/complete lifecycle the pool-flow-leak fix establishes.

Two timelines compose, the same contract as `ServingEngine`:

* transfer (virtual) — the calibrated transport model's fluid wire clock,
  advanced event-by-event exactly as `ClusterSim` advances it (same
  per-layer byte thresholds from the codec size table, same assembly gating,
  same one-layer-prefetch discipline, same FIFO admission under
  ``max_flows``).  ClusterSim is the conformance oracle: on the matching
  replay trace the engine's per-request admit / flow-done / prefill-done
  times agree to float precision.
* compute (real) — the per-layer steps actually run, in event-dispatch
  order, on the model's device (``"cuda"`` unless the model was built on
  another).  Bytes are real end-to-end: payloads round-trip the object
  store, dequantize on the device (the dequant kernel K1/K2 on a CUDA
  device), and the logits are bit-identical to the sequential engine
  serving the same prompts.  Every wall time read after device work is
  read after ``runner.sync()``, or it would time kernel launches only.

The *virtual* per-layer compute window ``c`` comes from the injected compute
model (the same model the oracle uses); real wall times are recorded per
request (and exported as ``"<req>/wall"`` spans) but never steer the virtual
clock — that determinism is what makes the oracle comparison exact.

Known divergences from the oracle, by design:

* pool-level ``replanner`` is unsupported here (the orchestrator's hybrid
  planner owns compute-or-load); attach one to the sim only.
* the orchestrator re-allocates once per `plan` call, the sim once per
  admission round — rates agree after the round's final ``reallocate``
  (demands are identical), only the pool's realloc *count* differs.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import Delivery
from repro_torch.core.transport import (LOCAL_DRAM, RDMA_SESSION_SETUP_S,
                                  S3_RDMA_AGG, TransportProfile, VirtualClock)
from repro_torch.cluster.events import Event, EventKind, EventQueue
from repro_torch.cluster.metrics import RequestRecord
from repro_torch.hybrid.executor import HybridPlan
from repro_torch.models import layers as nn
from repro_torch.obs.metrics import MetricsRegistry

from .batching import ContinuousBatcher, SlotRequest
from .engine import (EngineStats, ModelRunner, check_residency,
                     encode_new_chunks, layer_upload, layerwise_ok,
                     stack_layers)
from .kv_chunks import packed_layer_to_fp, wire_images_to_objects
from .orchestrator import Orchestrator

_NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class AsyncRequest:
    """One arrival on the engine's virtual timeline."""

    req_id: str
    tokens: tuple  # prompt token ids (any int sequence; stored frozen)
    arrival_s: float = 0.0
    max_new_tokens: int = 0
    tenant: str = ""  # per-tenant metric/SLO label ("" = unlabelled)


@dataclasses.dataclass
class AsyncResult:
    req_id: str
    logits: np.ndarray  # last-token logits [V]
    new_tokens: list[int]
    matched_tokens: int  # prefix tokens served from fetched payloads
    delivery: Optional[Delivery]
    record: RequestRecord  # virtual-timeline life (admit/flow_done/ttft)
    wall_compute_s: float  # real device wall time spent on this request
    wall_dequant_s: float

    @property
    def hit(self) -> bool:
        return self.matched_tokens > 0

    @property
    def ttft_s(self) -> float:
        return self.record.ttft_s


@dataclasses.dataclass
class _Flight:
    """One in-flight request: `ClusterSim._ActiveFlow`'s fluid wire state
    plus the real compute state the simulator doesn't have."""

    req: AsyncRequest
    record: RequestRecord
    mode: str  # "recompute" | "chunkwise" | "layerwise"
    delivery: Optional[Delivery]  # reported mode (HYBRID for split plans)
    tokens: np.ndarray
    n_fetch: int  # chunks crossing the wire
    P: int  # prefix tokens consumed from payloads (n_fetch * G)
    num_layers: int
    c: float  # virtual per-layer compute window
    c_total: float
    pre_s: float
    layer_bytes: float  # mean per-layer wire bytes (the pool's s_i)
    total_bytes: float
    payloads: Optional[list] = None  # real payload bytes (fetched at admit)
    # fluid wire state (mirrors cluster.sim._ActiveFlow)
    thresholds: list = dataclasses.field(default_factory=list)
    avail: list = dataclasses.field(default_factory=list)
    per_layer: Optional[list] = None
    t_update: float = 0.0
    delivered: float = 0.0
    alloc_rate: Optional[float] = None
    phys_rate: float = 0.0
    next_layer: int = 0
    version: int = 0
    wire_done: bool = False
    ready_prev: float = _NEG_INF
    finish_prev: float = _NEG_INF
    wire_from: float = 0.0
    flow_in_pending: Optional[str] = None  # pool flow id for the next wire span
    # real compute state (layerwise streaming): per layer, the fetched
    # prefix as `layer_upload` made it and this request's suffix (k, v)
    x: object = None
    positions: object = None
    prefix: list = dataclasses.field(default_factory=list)
    segs: list = dataclasses.field(default_factory=list)
    wall_compute_s: float = 0.0
    wall_dequant_s: float = 0.0

    def next_threshold(self) -> float:
        if self.mode == "chunkwise":
            return self.total_bytes
        return self.thresholds[self.next_layer]


class AsyncEngine:
    """Continuous-batching engine over one `Orchestrator`.

    ``compute`` supplies the *virtual* per-layer windows (any
    `core.compute_model.ComputeModelBase`); ``profile``/``session_setup``
    must match the oracle sim's when conformance matters.  ``num_slots`` /
    ``max_seq`` / ``eos_id`` size the decode batcher (built lazily on the
    first request with ``max_new_tokens > 0``).  The orchestrator's clock
    must be a `VirtualClock` (installed if absent) — `plan` stamps pool
    reallocation with it.
    """

    def __init__(self, model, params, orch: Orchestrator, *,
                 compute, profile: TransportProfile = S3_RDMA_AGG,
                 session_setup: bool = True,
                 max_flows: Optional[int] = None,
                 num_slots: int = 2, max_seq: int = 512,
                 eos_id: Optional[int] = None,
                 runner: Optional[ModelRunner] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer=None,
                 monitor=None,
                 slo=None,
                 kv_resident: str = "fp") -> None:
        self.model = model
        self.params = params
        self.orch = orch
        self.cfg = model.cfg
        self.spec = orch.spec
        if self.spec.kv_tensors != 2:
            raise ValueError("AsyncEngine serves K and V caches; a one-tensor "
                             "(latent) KV layout is served by ServingEngine")
        self.compute = compute
        self.profile = profile
        self.session_setup = session_setup
        self.max_flows = max_flows
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.runner = runner if runner is not None else ModelRunner(model,
                                                                    params)
        self.device = model.device
        if orch.clock is None:
            orch.clock = VirtualClock()
        self.clock = orch.clock
        self.metrics = metrics if metrics is not None else orch.metrics
        self.stats = EngineStats(self.metrics)
        self.tracer = tracer if tracer is not None else orch.tracer
        # Live observability (DESIGN.md §Observability): nullable streaming
        # monitor + SLO evaluator, fed at completion event times only —
        # attaching them cannot perturb the virtual timeline.
        self.monitor = monitor
        self.slo = slo
        if slo is not None and getattr(slo, "tracer", None) is None:
            slo.tracer = self.tracer
        if orch.pool is not None and monitor is not None:
            orch.pool.monitor = monitor
        self._layerwise_ok = layerwise_ok(self.cfg)
        # same residency contract as ServingEngine: "packed" keeps layerwise
        # prefixes quantized-resident through prefill (the fused
        # dequant-attention kernel K7); the ContinuousBatcher pools sequences
        # into one fp cache, so a packed prefix entering decode is expanded
        # exactly once at the `packed_layer_to_fp` boundary.
        check_residency(kv_resident, self.spec, self.cfg)
        self.kv_resident = kv_resident
        self._upload = layer_upload(kv_resident, self.spec, nn.dt(self.cfg),
                                    self.device)
        self.batcher: Optional[ContinuousBatcher] = None
        self.peak_transfers = 0  # max concurrently in-flight fetches observed

    # -- public entry ---------------------------------------------------------
    def serve(self, requests: Sequence[AsyncRequest]
              ) -> dict[str, AsyncResult]:
        """Serve a whole arrival trace; returns results keyed by req_id.

        One event loop per call: ARRIVE events seed the queue, admission /
        wire / completion events drain it, and one `ContinuousBatcher.step`
        runs per dispatched event while any decode slot is occupied (the
        continuous-batching interleave), with a final drain at the end.
        """
        self._queue = EventQueue()
        self._active: dict[str, _Flight] = {}
        self._backlog: deque = deque()
        self._results: dict[str, AsyncResult] = {}
        self._slot_reqs: dict[str, SlotRequest] = {}
        self._transfers = 0
        for r in sorted(requests, key=lambda r: (r.arrival_s, r.req_id)):
            self._queue.push(Event(r.arrival_s, EventKind.ARRIVE, payload=r))
        while self._queue:
            ev = self._queue.pop()
            self.clock.advance_to(ev.time)
            self._dispatch(ev)
            if self.batcher is not None and any(self.batcher.active):
                self.batcher.step()
        if self.batcher is not None:
            self.batcher.drain()
        for rid, sreq in self._slot_reqs.items():
            self._results[rid].new_tokens = list(sreq.tokens_out)
        return self._results

    # -- event dispatch -------------------------------------------------------
    def _dispatch(self, ev: Event) -> None:
        if ev.kind is EventKind.ARRIVE:
            self._on_arrive(ev)
        elif ev.kind is EventKind.WIRE:
            fl = self._active.get(ev.req_id)
            if fl is None or fl.wire_done or ev.version != fl.version:
                return  # stale prediction (rate changed since push)
            self._advance_wire(fl, ev.time)
        elif ev.kind is EventKind.FLOW_DONE:
            self._on_flow_done(ev)
        elif ev.kind is EventKind.PREFILL_DONE:
            self._on_prefill_done(ev)
        # LAYER_READY is observational (readiness folded into recurrences)

    def _on_arrive(self, ev: Event) -> None:
        ar: AsyncRequest = ev.payload
        rec = RequestRecord(ar.req_id, len(ar.tokens), 0.0, ar.arrival_s,
                            tenant=ar.tenant)
        self._backlog.append((ar, rec))
        if self.tracer is not None:
            self.tracer.instant(ar.req_id, "arrive", t=ev.time, cat="cluster",
                                context=len(ar.tokens))
        self._reallocate(ev.time)

    def _on_flow_done(self, ev: Event) -> None:
        fl = self._active.get(ev.req_id)
        if fl is None:
            return
        fl.record.flow_done_s = ev.time
        self._transfers -= 1
        # the lifecycle fix in action: the flow leaves the pool the moment
        # its last byte lands, and every survivor's rate re-shapes now
        self.orch.release(ev.req_id)
        self._reallocate(ev.time)

    # -- admission + rate shaping (mirrors ClusterSim._reallocate) ------------
    def _compute_hint(self, tokens) -> float:
        """The per-layer window the pool water-fills against — derived from
        the *post-trim* match so demand registration sees the same chunk
        count `Orchestrator._plan` will serve."""
        match = self.orch.index.match(tokens)
        n, G = match.num_chunks, self.spec.chunk_tokens
        while n > 0 and n * G >= len(tokens):
            n -= 1
        return self.compute.layer_compute_s(len(tokens),
                                            n * G / len(tokens))

    def _reallocate(self, now: float) -> None:
        # 1. bring every in-flight wire up to `now` under the old rates
        for fl in self._active.values():
            if not fl.wire_done:
                self._advance_wire(fl, now)
        # 2. FIFO admission under the transfer-slot cap; each admission is a
        #    REAL orchestrator plan: index match, mode selection, pool submit
        #    and an event-time reallocation inside `plan`
        admitted = []
        while self._backlog and (self.max_flows is None
                                 or self._transfers < self.max_flows):
            ar, rec = self._backlog.popleft()
            self.stats.add(requests=1)
            plan = self.orch.plan(np.asarray(ar.tokens, np.int32),
                                  self._compute_hint(ar.tokens),
                                  req_id=ar.req_id)
            admitted.append((ar, rec, plan))
            self._transfers += 1
        self.peak_transfers = max(self.peak_transfers, self._transfers)
        # 3. one final allocation round so all rates are mutually consistent
        pool = self.orch.pool
        alloc = pool.reallocate(now) if pool is not None else {}
        # 4. start newly admitted flights from their admitted demand
        for ar, rec, plan in admitted:
            self._start_flight(ar, rec, plan, now, alloc)
        # 5. re-shape surviving flights' rates
        flow_ids = getattr(pool, "last_flow_ids", None) or {}
        for fid, fl in self._active.items():
            if fl.wire_done:
                continue
            if fid in flow_ids:
                # pool started/reshaped this flight: its next wire span
                # consumes the flow id (Perfetto causality arrow)
                fl.flow_in_pending = flow_ids[fid]
            rate = alloc.get(fid) if pool is not None else fl.alloc_rate
            if rate != fl.alloc_rate:
                fl.alloc_rate = rate
                fl.phys_rate = self.profile.effective_wire_rate(rate)
                fl.version += 1
                self._schedule_next_wire(fl)

    def _start_flight(self, ar: AsyncRequest, rec: RequestRecord, plan,
                      now: float, alloc: dict) -> None:
        spec = self.spec
        L = spec.num_layers
        G = spec.chunk_tokens
        tokens = np.asarray(ar.tokens, np.int32)
        ctx = len(tokens)
        hybrid = isinstance(plan, HybridPlan)
        if plan.delivery is None:
            m = 0
        elif hybrid:
            m = min(plan.fetch_chunks, plan.match.num_chunks)
        else:
            m = plan.match.num_chunks
        P = m * G
        hit = P / ctx
        rec.hit_rate = hit
        rec.admit_s = now
        rec.num_layers = L
        rec.replanned = hybrid
        if self.tracer is not None and now > ar.arrival_s:
            self.tracer.span_at(ar.req_id, "queue", ar.arrival_s, now,
                                cat="cluster")

        if m <= 0:  # recompute fallback: T(0), L*c after admission
            c = self.compute.layer_compute_s(ctx, 0.0)
            fl = _Flight(ar, rec, "recompute", None, tokens, 0, 0, L, c,
                         L * c, 0.0, 0.0, 0.0, wire_done=True, t_update=now)
            rec.layer_compute_s = c
            self._active[ar.req_id] = fl
            if self.tracer is not None:
                self.tracer.span_at(ar.req_id, "compute", now, now + L * c,
                                    cat="compute")
            self._queue.push(Event(now, EventKind.FLOW_DONE, ar.req_id))
            self._queue.push(Event(now + L * c, EventKind.PREFILL_DONE,
                                   ar.req_id))
            return

        # the real bytes move now (write-ahead of the virtual wire): the
        # descriptor round-trips the object store so dequant at each layer
        # crossing consumes genuine payloads
        res = self.orch.fetch(plan)
        layer_bytes = m * spec.mean_wire_layer_bytes
        layerwise = (plan.delivery is Delivery.LAYERWISE
                     and self._layerwise_ok)
        delivery = (Delivery.HYBRID if hybrid
                    else (Delivery.LAYERWISE if layerwise
                          else Delivery.CHUNKWISE))
        rec.bytes_total = layer_bytes * L
        rate = alloc.get(ar.req_id) if self.orch.pool is not None \
            else plan.rate
        if layerwise:
            c = (plan.split.layer_compute_s if hybrid and plan.split is not None
                 else self.compute.layer_compute_s(ctx, hit))
            fl = _Flight(ar, rec, "layerwise", delivery, tokens, m, P, L, c,
                         L * c, 0.0, layer_bytes, layer_bytes * L,
                         payloads=res.payloads, alloc_rate=rate,
                         phys_rate=self.profile.effective_wire_rate(rate),
                         t_update=now)
            per_layer = [m * spec.wire_layer_bytes(l) for l in range(L)]
            extra = RDMA_SESSION_SETUP_S if self.session_setup \
                and self.profile is not LOCAL_DRAM else 0.0
            _, avail_rel, _ = self.profile.layer_pipeline(
                m, per_layer, None, startup_extra_s=extra)
            fl.avail = [now + a for a in avail_rel]
            thr, cum = [], 0.0
            for b in per_layer:
                cum += b
                thr.append(cum)
            fl.thresholds = thr
            fl.pre_s = avail_rel[0]
            fl.per_layer = per_layer
            fl.t_update = fl.avail[0]  # wire starts once layer 0 assembles
            # real compute state: the suffix rides the per-layer stream
            suffix = self._tokens(tokens[P:])
            fl.positions = P + torch.arange(suffix.shape[1],
                                            device=self.device)[None, :]
            fl.x = self.runner.embed(suffix)
        else:
            # chunkwise (or a fused family served bulk): one wire threshold,
            # then startup+io and the whole suffix compute follow
            startup, io, _ = self.profile.pipeline_components(
                m, int(layer_bytes * L))
            fl = _Flight(ar, rec, "chunkwise", delivery, tokens, m, P, L,
                         self.compute.layer_compute_s(ctx, hit),
                         self.compute.suffix_compute_s(ctx, hit),
                         startup + io, layer_bytes, layer_bytes * L,
                         payloads=res.payloads, alloc_rate=rate,
                         phys_rate=self.profile.effective_wire_rate(rate),
                         t_update=now)
        rec.layer_compute_s = fl.c
        self._active[ar.req_id] = fl
        fl.wire_from = fl.t_update
        self._schedule_next_wire(fl)

    # -- fluid wire integration (mirrors ClusterSim) --------------------------
    def _schedule_next_wire(self, fl: _Flight) -> None:
        if fl.wire_done or fl.phys_rate <= 0.0:
            return  # starved: woken by the next reallocation
        t = fl.t_update + (fl.next_threshold() - fl.delivered) / fl.phys_rate
        self._queue.push(Event(t, EventKind.WIRE, fl.req.req_id,
                               version=fl.version))

    def _advance_wire(self, fl: _Flight, now: float) -> None:
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

    def _on_wire_cross(self, fl: _Flight, t: float) -> None:
        fid = fl.req.req_id
        if fl.mode == "chunkwise":
            fl.wire_done = True
            if self.tracer is not None:
                wire_args = {"bytes": fl.total_bytes}
                if fl.flow_in_pending is not None:
                    wire_args["flow_in"] = fl.flow_in_pending
                    fl.flow_in_pending = None
                self.tracer.span_at(fid, "wire", fl.wire_from, t, cat="wire",
                                    **wire_args)
                self.tracer.span_at(fid, "fetch.pre", t, t + fl.pre_s,
                                    cat="fetch")
                self.tracer.span_at(fid, "compute", t + fl.pre_s,
                                    t + fl.pre_s + fl.c_total, cat="compute")
            self._queue.push(Event(t, EventKind.FLOW_DONE, fid))
            self._queue.push(Event(t + fl.pre_s + fl.c_total,
                                   EventKind.PREFILL_DONE, fid))
            return
        l = fl.next_layer
        ready = t  # the clock was assembly-gated: the crossing IS ready
        compute_start = max(ready, fl.finish_prev) if l > 0 else ready
        self._run_layer(fl, l)
        if self.tracer is not None:
            wire_args = {"layer": l, "bytes": fl.per_layer[l]}
            if fl.flow_in_pending is not None:
                wire_args["flow_in"] = fl.flow_in_pending
                fl.flow_in_pending = None
            self.tracer.span_at(fid, "wire", fl.wire_from, t, cat="wire",
                                **wire_args)
            if l > 0 and ready > fl.finish_prev:
                self.tracer.span_at(fid, "stall", fl.finish_prev, ready,
                                    cat="stall", layer=l)
            self.tracer.span_at(fid, "compute", compute_start,
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
            # one-layer prefetch composed with the assembly gate
            fl.t_update = max(t, compute_start, fl.avail[l + 1])
            fl.next_layer = l + 1
            fl.wire_from = fl.t_update
            self._schedule_next_wire(fl)

    def _run_layer(self, fl: _Flight, l: int) -> None:
        """The real §4.2 step: layer l's payload just became consumable, so
        upload it (`layer_upload`) and run the layer — wall-timed on the
        ``"<req>/wall"`` track, invisible to the virtual clock.  Each span
        ends after the device has finished its work."""
        runner = self.runner
        wall = fl.req.req_id + "/wall"
        t0 = time.perf_counter()
        prefix = self._upload(fl.payloads[l], fl.n_fetch, l)
        runner.sync()
        t1 = time.perf_counter()
        fl.x, seg = runner.step(l, fl.x, prefix, fl.positions)
        runner.sync()
        t2 = time.perf_counter()
        fl.wall_dequant_s += t1 - t0
        fl.wall_compute_s += t2 - t1
        fl.prefix.append(prefix)
        fl.segs.append(seg)
        if self.tracer is not None:
            self.tracer.span_at(wall, "dequant", t0, t1, cat="engine",
                                layer=l)
            self.tracer.span_at(wall, "compute", t1, t2, cat="engine",
                                layer=l)

    # -- completion -----------------------------------------------------------
    def _on_prefill_done(self, ev: Event) -> None:
        fl = self._active.pop(ev.req_id, None)
        if fl is None:
            return
        rec = fl.record
        rec.prefill_done_s = ev.time
        tokens = fl.tokens
        runner = self.runner
        t0 = time.perf_counter()
        if fl.mode == "recompute":
            lg, cache = runner.prefill({"tokens": self._tokens(tokens)})
        elif fl.mode == "chunkwise":
            prefix = runner.payloads_to_prefix(fl.payloads, fl.n_fetch,
                                               self.spec)
            batch = {"tokens": self._tokens(tokens[fl.P:])}
            lg, cache = runner.prefill(batch, prefix, fl.P)
        else:
            lg = runner.final(fl.x)
            cache = stack_layers(fl.segs)  # the suffix's, from token P
        runner.sync()
        dt = time.perf_counter() - t0
        lg = lg[0].float().cpu().numpy()
        fl.wall_compute_s += dt
        if self.tracer is not None and fl.mode != "layerwise":
            self.tracer.span_at(ev.req_id + "/wall", "compute", t0, t0 + dt,
                                cat="engine")
        start = fl.P if fl.mode == "layerwise" else 0
        if start and self.kv_resident == "fp":
            # the ContinuousBatcher decodes from one fp cache: the fetched
            # prefix joins the suffix here
            cache, start = torch.cat([stack_layers(fl.prefix), cache],
                                     dim=3), 0
        # write-behind commit in virtual event order: later arrivals sharing
        # the prefix hit what this request just produced
        images, keys = encode_new_chunks(self.orch, tokens, cache, start)
        new = self.orch.commit(tokens, wire_images_to_objects(images, keys))
        self.stats.add(commits=len(new),
                       prefix_tokens_reused=fl.P,
                       tokens_computed=len(tokens) - fl.P)
        self.metrics.histogram("engine.ttft_model_s").observe(rec.ttft_s)
        if fl.req.tenant:
            self.metrics.histogram("engine.ttft_model_s",
                                   tenant=fl.req.tenant).observe(rec.ttft_s)
        if self.monitor is not None:
            self.monitor.record_request(ev.time, rec)
        if self.slo is not None:
            self.slo.record_request(ev.time, rec)
        if self.tracer is not None:
            self._emit_request_summary(fl, ev.time)
        self._results[ev.req_id] = AsyncResult(
            ev.req_id, lg, [], fl.P, fl.delivery, rec,
            fl.wall_compute_s, fl.wall_dequant_s)
        if fl.req.max_new_tokens > 0:
            if start:
                # the packed->batcher boundary: decode slots pool sequences
                # into one fp cache, so the packed prefix is expanded exactly
                # once here, only for requests that actually decode
                cache = self._materialize_packed(fl, cache)
            self._enqueue_decode(fl, lg, cache)

    def _materialize_packed(self, fl: _Flight, seg_cache) -> torch.Tensor:
        act = nn.dt(self.cfg)
        prefix = torch.stack([torch.stack(packed_layer_to_fp(pkv, act))
                              for pkv in fl.prefix])  # [L,2,1,P,KV,dh]
        return torch.cat([prefix, seg_cache.to(act)], dim=3)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens, np.int64),
                               device=self.device)[None, :]

    def _emit_request_summary(self, fl: _Flight, done: float) -> None:
        """Same ``"request"`` summary vocabulary as `ClusterSim` — one
        `attribution.attribute_trace` pass works on either trace."""
        rec = fl.record
        trk = rec.req_id
        self.tracer.span_at(trk, "serve", rec.admit_s, done, cat="cluster")
        per_layer = (list(fl.per_layer) if fl.per_layer is not None
                     else [fl.layer_bytes] * fl.num_layers)
        self.tracer.instant(
            trk, "request", t=done, cat="cluster",
            req_id=rec.req_id, mode=fl.mode,
            arrival_s=rec.arrival_s, admit_s=rec.admit_s,
            prefill_done_s=done, flow_done_s=rec.flow_done_s,
            num_layers=fl.num_layers, layer_compute_s=fl.c,
            per_layer_bytes=per_layer, n_objects=fl.n_fetch,
            avail_rel=([a - rec.admit_s for a in fl.avail]
                       if fl.avail else None),
            pre_s=fl.pre_s, c_total=fl.c_total,
            replanned=rec.replanned)

    def _enqueue_decode(self, fl: _Flight, logits: np.ndarray, cache) -> None:
        if self.batcher is None:
            self.batcher = ContinuousBatcher(self.model, self.params,
                                             self.num_slots, self.max_seq,
                                             eos_id=self.eos_id)
        first = int(np.argmax(logits[:self.cfg.vocab_size]))
        sreq = SlotRequest(fl.req.req_id, len(fl.tokens),
                           fl.req.max_new_tokens)
        self.batcher.enqueue(sreq, cache, first)
        self._slot_reqs[fl.req.req_id] = sreq
