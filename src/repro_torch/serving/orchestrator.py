"""Central orchestrator (paper Fig. 5).

Receives a request, performs prefix matching against the radix index, decides
the delivery mode (Eq. 2), obtains a bandwidth allocation from the shared
pool (§3.6), and issues the ObjectCache descriptor to the gateway.  Also owns
the straggler story for the storage tier: hedged reads (duplicate the request
to a second replica after the hedge quantile) and the recompute fallback of
paper §6.2 when the hit is too small to amortise S3 overheads.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

import numpy as np

if TYPE_CHECKING:
    from repro_torch.core.scheduler import BandwidthPool
    from repro_torch.hybrid.planner import HybridPlanner

from repro_torch.core import (Delivery, FlowRequest, Gateway, KVSpec, Policy,
                        RadixIndex, make_descriptor, select_mode)
from repro_torch.core.aggregation import DEFAULT_THETA_BYTES, AggResult
from repro_torch.core.scheduler import allocate
from repro_torch.core.types import MatchResult, Timing
from repro_torch.hybrid.executor import HybridPlan, fetch_span_plan
from repro_torch.obs.metrics import MetricsRegistry

_ORCH_FIELDS = ("hits", "misses", "fallbacks", "hedged", "hybrid_splits",
                "reallocs", "evicted_objects")


@dataclasses.dataclass
class TransferPlan:
    match: MatchResult
    delivery: Optional[Delivery]  # None => recompute fallback (no fetch)
    rate: Optional[float]  # allocated bandwidth (None = unthrottled)
    hedged: bool = False
    req_id: str = "req"  # pool flow id (release() retires it after serving)


@dataclasses.dataclass
class StragglerModel:
    """Lognormal service-time inflation of the storage tier; hedging takes the
    min of two independent samples (classic tail-cutting)."""

    sigma: float = 0.0  # 0 => deterministic
    hedge_quantile: float = 0.95
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def sample(self, hedged: bool) -> float:
        if self.sigma == 0.0:
            return 1.0
        a = float(self._rng.lognormal(0.0, self.sigma))
        if not hedged:
            return a
        b = float(self._rng.lognormal(0.0, self.sigma))
        return min(a, b)


class Orchestrator:
    def __init__(self, index: RadixIndex, gateway: Gateway, spec: KVSpec,
                 *, theta_bytes: int = DEFAULT_THETA_BYTES,
                 min_hit_chunks: int = 1,
                 bandwidth_cap: Optional[float] = None,
                 policy: Policy = Policy.CAL_STALL_OPT,
                 margin: float = 0.0,
                 straggler: Optional[StragglerModel] = None,
                 hedge: bool = False,
                 hybrid: Optional["HybridPlanner"] = None,
                 pool: Optional["BandwidthPool"] = None,
                 clock=None,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer=None) -> None:
        self.index = index
        self.gateway = gateway
        self.spec = spec
        self.theta = theta_bytes
        self.min_hit_chunks = min_hit_chunks
        self.cap = bandwidth_cap
        self.policy = policy
        self.margin = margin
        self.straggler = straggler or StragglerModel()
        self.hedge = hedge
        self.hybrid = hybrid
        # Event-time scheduling (DESIGN.md §Cluster-sim): with a shared
        # `BandwidthPool` + clock attached, `plan` obtains its rate by
        # submitting to the pool and re-allocating at the *event* time of the
        # request's arrival — not by a one-shot static `allocate` against a
        # snapshot of `active` flows, and not by waiting for an epoch
        # boundary.  `clock` is any object with ``now()`` (VirtualClock in
        # simulation, WallClock when serving live).
        self.pool = pool
        self.clock = clock
        # registry-backed counters (obs.metrics): dict-style access is
        # unchanged (`stats["hits"] += 1`), but every mutation is locked and
        # `stats.snapshot()` is a consistent cut (mirrors StoreStats)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.stats = self.metrics.group("orch", _ORCH_FIELDS)
        # nullable obs tracer; `plan` emits one decision instant per request
        self.tracer = tracer
        # index eviction must delete the backing objects, or the store leaks
        # every evicted chunk forever; respect a callback the caller installed
        if self.index.on_evict is None:
            self.index.on_evict = self._on_index_evict

    def _on_index_evict(self, key: bytes) -> None:
        self.gateway.delete(key)
        self.stats.add(evicted_objects=1)

    # -- planning ------------------------------------------------------------
    def plan(self, tokens, layer_compute_s: float,
             active: Optional[list[FlowRequest]] = None,
             req_id: str = "req") -> TransferPlan:
        plan = self._plan(tokens, layer_compute_s, active, req_id)
        if self.tracer is not None:
            self.tracer.instant(
                req_id, "plan_decision", cat="orch",
                matched_chunks=plan.match.num_chunks,
                delivery=(plan.delivery.name if plan.delivery is not None
                          else "recompute"),
                rate=plan.rate, hedged=plan.hedged,
                fetch_chunks=getattr(plan, "fetch_chunks", None))
        return plan

    def _plan(self, tokens, layer_compute_s: float,
              active: Optional[list[FlowRequest]] = None,
              req_id: str = "req") -> TransferPlan:
        match = self.index.match(tokens)
        # Always keep >= 1 suffix token (the engine must compute next-token
        # logits), so a full-prompt match is trimmed *here*, before bandwidth
        # demand is registered — otherwise the pool water-fills against
        # chunks that will never cross the wire (stale-demand bug).
        n = match.num_chunks
        while n > 0 and n * self.spec.chunk_tokens >= len(tokens):
            n -= 1
        if n != match.num_chunks:
            match = dataclasses.replace(
                match, chunk_keys=match.chunk_keys[:n],
                matched_tokens=n * self.spec.chunk_tokens)
        if match.num_chunks < self.min_hit_chunks:
            self.stats.add(**{"misses" if not match.is_hit else "fallbacks": 1})
            return TransferPlan(match, None, None, req_id=req_id)
        # Mode selection and bandwidth demand follow the bytes that actually
        # cross the wire — the codec-encoded size (DESIGN.md §Codec).
        W = self.spec.matched_wire_bytes(match.num_chunks)
        delivery = select_mode(W, self.theta)
        rate = None
        if delivery is Delivery.LAYERWISE and (self.pool is not None
                                               or self.cap is not None):
            # per-layer demand is the *mean* encoded stride: variable-rate
            # codecs still present one scalar s_i to the water-filler, and
            # s_i * L recovers the exact wire total
            me = FlowRequest(req_id,
                             match.num_chunks * self.spec.mean_wire_layer_bytes,
                             layer_compute_s, self.spec.num_layers)
            if self.pool is not None:
                # event-driven: join the shared pool and re-shape every
                # tenant's rate now, at this arrival's event time
                now = self.clock.now() if self.clock is not None else 0.0
                if hasattr(self.pool.replanner, "register"):
                    self.pool.replanner.register(req_id, len(tokens))
                self.pool.submit(me)
                rate = self.pool.reallocate(now)[req_id]
                self.stats.add(reallocs=1)
            else:
                flows = [me, *(active or [])]
                rate = allocate(flows, self.cap, self.policy, self.margin)[req_id]
        if self.hybrid is not None and delivery is Delivery.LAYERWISE:
            split = self.hybrid.plan(len(tokens), match.num_chunks, self.spec,
                                     rate)
            if split.is_pure_recompute:
                # Fetching nothing is a recompute fallback (§6.2), not a hit.
                # The flow joined the pool above but will never transfer a
                # byte — retire it, or it would hold (and shrink) every
                # future tenant's allocation forever.
                if self.pool is not None:
                    self.pool.complete(req_id)
                self.stats.add(fallbacks=1)
                return TransferPlan(match, None, None, req_id=req_id)
            if not split.is_pure_fetch:
                if self.pool is not None:
                    # Only the fetch-span crosses the wire, so the pool must
                    # water-fill against the split's bytes: the full match's
                    # demand would shrink every other tenant for bytes the
                    # planner decided to recompute (stale-demand, hybrid
                    # edition).  complete+resubmit restarts the flow with the
                    # reduced demand in one reallocation round.
                    now = self.clock.now() if self.clock is not None else 0.0
                    self.pool.complete(req_id)
                    self.pool.submit(FlowRequest(
                        req_id, split.bytes_per_layer, split.layer_compute_s,
                        self.spec.num_layers))
                    rate = self.pool.reallocate(now)[req_id]
                    self.stats.add(reallocs=1)
                self.stats.add(hits=1, hybrid_splits=1)
                return HybridPlan(match, Delivery.LAYERWISE, rate,
                                  hedged=self.hedge,
                                  fetch_chunks=split.fetch_chunks, split=split,
                                  req_id=req_id)
        self.stats.add(hits=1)
        return TransferPlan(match, delivery, rate, hedged=self.hedge,
                            req_id=req_id)

    # -- execution ------------------------------------------------------------
    def fetch(self, plan: TransferPlan) -> AggResult:
        assert plan.delivery is not None
        if isinstance(plan, HybridPlan):
            # Only the fetch-span travels; the recompute-span was planned to
            # stay on the GPU, so fetching the untrimmed match would move
            # exactly the bytes the planner decided not to.
            plan = fetch_span_plan(plan, plan.fetch_chunks, self.spec)
        desc = make_descriptor(list(plan.match.chunk_keys), self.spec,
                               plan.delivery)
        self.index.pin(plan.match.chunk_keys)
        try:
            res = self.gateway.objectcache_get(desc.to_wire(),
                                               rate_limit=plan.rate)
        finally:
            self.index.unpin(plan.match.chunk_keys)
        # Straggler inflation (and hedging) applies to the storage tier as a
        # whole: the layer-ready events AND the reported latency breakdown
        # must scale together, or the chunkwise TTFT (completion_s derives
        # from events) and the Fig. 10 splits (timing) would disagree about
        # how slow the slow replica was.
        infl = self.straggler.sample(plan.hedged)
        if plan.hedged:
            self.stats.add(hedged=1)
        if infl != 1.0:
            for e in res.events:
                e.t_ready_s *= infl
            res.timing = Timing(res.timing.control_plane_s * infl,
                                res.timing.storage_s * infl,
                                res.timing.network_s * infl)
        return res

    # -- completion -----------------------------------------------------------
    def release(self, req_id: str) -> None:
        """Retire a served request's pool flow (and its replanner context).

        `plan` joins the shared pool at arrival time; the flow must leave at
        completion time or it holds — and shrinks — every future tenant's
        water-filled share forever (the pool-flow leak).  The bandwidth
        returns at the next `reallocate`, matching the simulator's FLOW_DONE
        handling.  Safe to call for plans that never joined the pool
        (chunkwise / recompute / no-pool): `BandwidthPool.complete` is a
        no-op for unknown ids.
        """
        if self.pool is not None:
            self.pool.complete(req_id)
            if hasattr(self.pool.replanner, "unregister"):
                self.pool.replanner.unregister(req_id)

    # -- commit (write-behind of freshly produced chunks) ---------------------
    def commit(self, tokens, chunk_objects: dict[bytes, bytes]) -> list[bytes]:
        new_keys = self.index.insert(tokens)
        for key in new_keys:
            # a key the insert itself already evicted must not be uploaded —
            # that would orphan the object (nothing would ever delete it)
            if key in chunk_objects and self.index.contains(key):
                self.gateway.put(key, chunk_objects[key])
        return new_keys
