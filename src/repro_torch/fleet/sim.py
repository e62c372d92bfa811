"""Multi-node fleet simulator: cache-affinity routing over N `ClusterSim`
nodes, each with its own radix hot-tier index, byte-accounted store, and
bandwidth pool (DESIGN.md §Fleet).

The cluster simulator models *one* node's delivery machinery; this module
adds the population-scale decision layer above it: which node serves a
request (`repro.fleet.routing`), what its hot tier actually holds (a
`RadixIndex` + `EvictionPolicy` per node, coherent with a per-node object
ledger via ``on_evict``), and what that does to hit rates, TTFT tails and
object-storage egress under Zipfian traffic (`repro.fleet.workload`).

Event model: all N node sims share ONE event queue (`ClusterSim.begin(queue)`
/ ``dispatch``), so cross-node event ordering is globally deterministic.
ARRIVE events are fleet-level — the router picks a node, the node's hot tier
is matched (hot chunks cost neither wire bytes nor recompute: the
``hot_tokens`` split of `TraceRequest`), and the rewritten arrival is
dispatched to the owning node.  Every other event belongs to the node that
admitted the request.  A 1-node fleet with random routing and no caches
replays `ClusterSim.run` bit-for-bit — the conformance oracle.

Cache semantics: requests are matched against the *global* radix namespace
(what has ever been committed to object storage — the paper's unbounded
capacity tier) to find the fetchable prefix, and against the serving node's
hot tier to find the free part.  Chunks commit write-behind at PREFILL_DONE,
so two concurrent misses on the same prefix both fetch — the thundering-herd
cost is modelled, not hidden.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Callable, Optional, Sequence, Union

from repro_torch.cluster.events import Event, EventKind, EventQueue
from repro_torch.cluster.metrics import (ClusterMetrics, RequestRecord, per_tenant,
                                   summarize)
from repro_torch.cluster.sim import ClusterResult, ClusterSim
from repro_torch.cluster.trace import ClosedLoopTrace, TraceRequest
from repro_torch.core.hashing import GENESIS, KEY_BYTES
from repro_torch.core.object_store import ObjectStore, StoreStats
from repro_torch.core.radix import RadixIndex

from .policy import EvictionPolicy, make_policy
from .routing import Router


# ---------------------------------------------------------------------------
# Chunk-key chains without token materialisation
# ---------------------------------------------------------------------------
def derive_chain(parent: bytes, label: str, n: int) -> list[bytes]:
    """A rolling-hash chain of ``n`` chunk keys seeded by ``label`` — the
    same H_i = Hash(H_{i-1} || content) recurrence as `core.hashing`, with
    the label standing in for the token block.  Same (parent, label) →
    same keys: the dedup property the radix namespace needs, minus the cost
    of materialising tens of thousands of synthetic tokens per request."""
    keys, h = [], parent
    for i in range(n):
        d = hashlib.blake2b(digest_size=KEY_BYTES)
        d.update(h)
        d.update(label.encode())
        d.update(i.to_bytes(4, "little"))
        h = d.digest()
        keys.append(h)
    return keys


def request_chain(tr: TraceRequest,
                  prefix_cache: Optional[dict] = None) -> list[bytes]:
    """Full chunk-key chain of a trace request: the shareable prefix
    (``prefix_id``-derived, identical across requests naming it) followed by
    a unique per-request suffix chained off the prefix tail."""
    G = tr.chunk_tokens
    n_total = tr.context // G
    n_prefix = min(tr.cached_tokens // G, n_total)
    if tr.prefix_id:
        ck = (tr.prefix_id, n_prefix)
        if prefix_cache is not None and ck in prefix_cache:
            prefix = prefix_cache[ck]
        else:
            prefix = derive_chain(GENESIS, "p:" + tr.prefix_id, n_prefix)
            if prefix_cache is not None:
                prefix_cache[ck] = prefix
    else:
        prefix = derive_chain(GENESIS, "p:" + tr.req_id, n_prefix)
    tail = prefix[-1] if prefix else GENESIS
    return prefix + derive_chain(tail, "s:" + tr.req_id, n_total - n_prefix)


# ---------------------------------------------------------------------------
# Byte-accounted store + per-node hot tier
# ---------------------------------------------------------------------------
class ByteLedgerStore(ObjectStore):
    """Control-plane object store: tracks sizes, not payloads.

    The fleet simulator moves no real KV bytes (transfer is the fluid model),
    but occupancy accounting must be exact — puts, deletes and dedup hits
    land in `StoreStats` and `total_bytes` is the capacity-bound invariant
    the coherence tests assert.  Data-plane reads raise: nothing in the
    simulator may depend on payload content.
    """

    def __init__(self) -> None:
        self._sizes: dict[bytes, int] = {}
        self._lock = threading.Lock()
        self.stats = StoreStats()

    def put_size(self, key: bytes, size: int) -> None:
        with self._lock:
            if key in self._sizes:
                self.stats.add(dedup_hits=1)
                return
            self._sizes[key] = size
            self.stats.add(puts=1, bytes_written=size)

    def put(self, key: bytes, data: bytes) -> None:
        self.put_size(key, len(data))

    def get(self, key: bytes) -> bytes:
        raise TypeError("ByteLedgerStore is control-plane only (no payloads)")

    def range_get(self, key: bytes, offset: int, length: int) -> bytes:
        raise TypeError("ByteLedgerStore is control-plane only (no payloads)")

    def contains(self, key: bytes) -> bool:
        with self._lock:
            return key in self._sizes

    def delete(self, key: bytes) -> None:
        with self._lock:
            if self._sizes.pop(key, None) is not None:
                self.stats.add(deletes=1)

    def object_size(self, key: bytes) -> int:
        with self._lock:
            return self._sizes[key]

    def total_bytes(self) -> int:
        with self._lock:
            return sum(self._sizes.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._sizes)


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Per-node hot-tier shape: capacity in bytes of the *wire-encoded*
    chunk objects, an eviction-policy spec (`fleet.policy.make_policy`), and
    the chunk granularity the namespace is keyed on."""

    hot_capacity_bytes: int
    policy: str = "lru"
    chunk_tokens: int = 64
    store_factory: Optional[Callable[[], ObjectStore]] = None


class NodeCache:
    """One node's hot tier: a policy-driven `RadixIndex` over the chunk
    namespace, coherent with a byte-accounted object store — every index
    eviction deletes the backing object exactly once (``on_evict``), which
    is what keeps resident bytes inside the configured capacity."""

    def __init__(self, cfg: CacheConfig, chunk_bytes: int,
                 clock: Callable[[], float],
                 policy: Optional[EvictionPolicy] = None) -> None:
        self.cfg = cfg
        self.chunk_bytes = chunk_bytes
        self.capacity_bytes = cfg.hot_capacity_bytes
        self.store = (cfg.store_factory or ByteLedgerStore)()
        self.index = RadixIndex(
            cfg.chunk_tokens,
            max_chunks=max(1, cfg.hot_capacity_bytes // chunk_bytes),
            clock=clock,
            policy=policy if policy is not None else make_policy(cfg.policy),
            on_evict=self._on_evict,
            chunk_bytes=chunk_bytes)
        self.peak_bytes = 0

    def _on_evict(self, key: bytes) -> None:
        self.store.delete(key)

    def peek_chunks(self, chain: Sequence[bytes]) -> int:
        """Match length without touching recency/frequency — router scoring
        must not distort the policy's view of real accesses."""
        return self.index.match_keys(chain, touch=False).num_chunks

    def match_chunks(self, chain: Sequence[bytes]) -> int:
        return self.index.match_keys(chain).num_chunks

    def commit(self, chain: Sequence[bytes]) -> list[bytes]:
        new = self.index.insert_keys(chain)
        for k in new:
            # a key evicted within the same insert burst must not be put —
            # it would orphan the object (the leak this layer exists to fix)
            if self.index.contains(k):
                if hasattr(self.store, "put_size"):
                    self.store.put_size(k, self.chunk_bytes)
                else:
                    self.store.put(k, bytes(self.chunk_bytes))
        self.peak_bytes = max(self.peak_bytes, self.total_bytes())
        return new

    def total_bytes(self) -> int:
        if hasattr(self.store, "total_bytes"):
            return self.store.total_bytes()
        # injected stores without a ledger: resident keys track the index
        # (commit puts / on_evict deletes keep them coherent)
        return len(self.index) * self.chunk_bytes

    def snapshot(self) -> dict:
        snap = self.store.stats.snapshot()
        snap.update(resident_bytes=self.total_bytes(),
                    peak_bytes=self.peak_bytes,
                    capacity_bytes=self.capacity_bytes,
                    index=self.index.stats())
        return snap


class FleetNode:
    """One serving node: its cluster sim (pool, flows, clock), its hot tier,
    and the in-flight count the load-shedding router reads."""

    def __init__(self, idx: int, sim: ClusterSim,
                 cache: Optional[NodeCache]) -> None:
        self.idx = idx
        self.sim = sim
        self.cache = cache
        self.inflight = 0
        self.inflight_peak = 0

    def arrive(self) -> None:
        self.inflight += 1
        self.inflight_peak = max(self.inflight_peak, self.inflight)


# ---------------------------------------------------------------------------
# The fleet
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class FleetResult:
    records: list[RequestRecord]  # all nodes, (arrival, req_id)-sorted
    node_results: list[ClusterResult]
    node_stats: list[dict]
    shed: int  # affinity load-shed diversions (0 for other routers)
    global_chunks: int  # distinct chunks committed to object storage
    global_bytes: int  # capacity-tier growth over the run

    def metrics(self, baseline_ttft_s=None) -> ClusterMetrics:
        return summarize(self.records, baseline_ttft_s)

    def per_tenant(self, baseline_ttft_s=None) -> dict[str, ClusterMetrics]:
        return per_tenant(self.records, baseline_ttft_s)

    def by_id(self) -> dict[str, RequestRecord]:
        return {r.req_id: r for r in self.records}


class FleetSim:
    """N-node fleet under one router and one deterministic event clock.

    ``cache=None`` disables the cache layer entirely: arrivals pass through
    with their trace-specified hit rates, and a 1-node fleet reproduces
    `ClusterSim` bit-for-bit (the conformance tests' oracle).  With a
    `CacheConfig`, each request's hit rate is *derived* — global radix match
    for the fetchable prefix, node hot-tier match for the free part — and
    commits flow write-behind at PREFILL_DONE.

    Every `ClusterSim` keyword (cap, policy, compute, profile, spec, codec,
    mode, max_flows …) is per-node; ``epoch_s`` is rejected because REALLOC
    events carry no request id to route by (event-mode reallocation is
    strictly more precise anyway).
    """

    def __init__(self, num_nodes: int, router: Router, *,
                 cache: Optional[CacheConfig] = None,
                 tracer=None,
                 monitor=None,
                 slo=None,
                 **node_kwargs) -> None:
        if num_nodes < 1:
            raise ValueError("need at least one node")
        if node_kwargs.get("epoch_s") is not None:
            raise ValueError("fleet simulation is event-mode only "
                             "(epoch REALLOC events cannot be routed)")
        node_kwargs.pop("epoch_s", None)
        self.router = router
        self.cache_cfg = cache
        # Observability: one shared tracer, one track namespace per node
        # ("n0/req-3", "n0/pool", ...) so the Chrome export renders one
        # process group per node.  Purely observational — see ClusterSim.
        # `monitor` (an `obs.window.StreamMonitor` shape) is `spawn()`ed per
        # node so each node sketches its own windows independently;
        # `monitor_rollup()` merges them into the node-order-invariant
        # global view.  `slo` is fleet-global (one burn-rate evaluation over
        # all completions) and is shared across nodes unchanged.
        self.tracer = tracer
        self.monitor = monitor
        self.slo = slo
        self.node_monitors = ([monitor.spawn() for _ in range(num_nodes)]
                              if monitor is not None else None)
        self.nodes: list[FleetNode] = []
        for i in range(num_nodes):
            sim = ClusterSim(tracer=tracer, track_prefix=f"n{i}/",
                             monitor=(self.node_monitors[i]
                                      if self.node_monitors else None),
                             slo=slo,
                             **node_kwargs)
            node_cache = None
            if cache is not None:
                chunk_bytes = sim.kv_spec(cache.chunk_tokens).wire_chunk_bytes
                node_cache = NodeCache(cache, chunk_bytes,
                                       clock=sim.clock.now)
            self.nodes.append(FleetNode(i, sim, node_cache))
        # the global namespace: everything ever committed to object storage
        self._global_index: Optional[RadixIndex] = None
        self._global_store: Optional[ByteLedgerStore] = None
        if cache is not None:
            self._global_store = ByteLedgerStore()
            self._global_index = RadixIndex(
                cache.chunk_tokens, max_chunks=None,
                clock=self.nodes[0].sim.clock.now)
        self._prefix_chains: dict = {}

    # -- run ------------------------------------------------------------------
    def run(self, trace: Union[Sequence[TraceRequest], ClosedLoopTrace]
            ) -> FleetResult:
        queue = EventQueue()
        for node in self.nodes:
            node.sim.begin(queue)
        self._owner: dict[str, int] = {}
        self._pending: dict[str, tuple[TraceRequest, list[bytes]]] = {}
        self._closed = None
        if isinstance(trace, ClosedLoopTrace) or hasattr(trace, "initial"):
            self._closed = trace
            initial = list(trace.initial())
        else:
            initial = sorted(trace, key=lambda r: (r.arrival_s, r.req_id))
        for tr in initial:
            queue.push(Event(tr.arrival_s, EventKind.ARRIVE, payload=tr))

        while queue:
            ev = queue.pop()
            # all node clocks advance together: routing and cache decisions
            # at time t must observe every node at time t
            for node in self.nodes:
                node.sim.clock.advance_to(ev.time)
            if ev.kind is EventKind.ARRIVE:
                self._on_arrive(ev)
                continue
            node = self.nodes[self._owner[ev.req_id]]
            node.sim.dispatch(ev)
            if ev.kind is EventKind.PREFILL_DONE:
                self._on_complete(ev, queue)
        return self._finish()

    # -- event handlers -------------------------------------------------------
    def _on_arrive(self, ev: Event) -> None:
        tr: TraceRequest = ev.payload
        chain: list[bytes] = []
        if self.cache_cfg is not None:
            if tr.chunk_tokens != self.cache_cfg.chunk_tokens:
                raise ValueError(
                    f"request {tr.req_id}: chunk_tokens {tr.chunk_tokens} != "
                    f"cache namespace {self.cache_cfg.chunk_tokens}")
            chain = request_chain(tr, self._prefix_chains)
        i = self.router.route(tr, self.nodes, chain)
        node = self.nodes[i]
        if self.cache_cfg is not None:
            G = tr.chunk_tokens
            m = self._global_index.match_keys(chain).num_chunks
            hot = node.cache.match_chunks(chain[:m]) if m else 0
            tr = dataclasses.replace(
                tr, hit_rate=(m * G) / tr.context, hot_tokens=hot * G)
            ev = dataclasses.replace(ev, payload=tr)
        self._owner[tr.req_id] = i
        self._pending[tr.req_id] = (tr, chain)
        if self.tracer is not None:
            self.tracer.instant(
                "fleet/router", "route", t=ev.time, cat="fleet",
                req_id=tr.req_id, node=i, inflight=node.inflight + 1,
                hit_rate=tr.hit_rate, hot_tokens=tr.hot_tokens)
        node.arrive()
        node.sim.dispatch(ev)
        node.sim._records[-1].node = i

    def _on_complete(self, ev: Event, queue: EventQueue) -> None:
        tr, chain = self._pending.pop(ev.req_id)
        node = self.nodes[self._owner[ev.req_id]]
        node.inflight -= 1
        if self.cache_cfg is not None:
            # write-behind commit: the produced chunks enter object storage
            # (global namespace) and the serving node's hot tier
            spec_bytes = node.cache.chunk_bytes
            for k in self._global_index.insert_keys(chain):
                self._global_store.put_size(k, spec_bytes)
            node.cache.commit(chain)
        if self._closed is not None:
            nxt = self._closed.on_complete(tr, ev.time)
            if nxt is not None:
                queue.push(Event(nxt.arrival_s, EventKind.ARRIVE, payload=nxt))

    # -- rollup ---------------------------------------------------------------
    def monitor_rollup(self):
        """The fleet-global streaming-metrics view: per-node monitors merged
        window-by-window into a fresh monitor (nodes untouched).  Windows
        are aligned to absolute time and sketches merge associatively and
        commutatively, so the rollup is identical for any node order."""
        if self.node_monitors is None:
            raise ValueError("FleetSim was built without a monitor")
        return type(self.node_monitors[0]).merged(self.node_monitors)

    def _finish(self) -> FleetResult:
        node_results = [n.sim.finish() for n in self.nodes]
        records = sorted((r for res in node_results for r in res.records),
                         key=lambda r: (r.arrival_s, r.req_id))
        stats = []
        for n, res in zip(self.nodes, node_results):
            done = [r for r in res.records if r.done]
            st = {
                "requests": len(res.records),
                "egress_bytes": sum(r.bytes_total for r in done),
                "hot_tokens": sum(r.hot_tokens for r in done),
                "inflight_peak": n.inflight_peak,
            }
            if n.cache is not None:
                st["cache"] = n.cache.snapshot()
            stats.append(st)
        return FleetResult(
            records=records,
            node_results=node_results,
            node_stats=stats,
            shed=getattr(self.router, "shed", 0),
            global_chunks=(len(self._global_index)
                           if self._global_index is not None else 0),
            global_bytes=(self._global_store.total_bytes()
                          if self._global_store is not None else 0))
