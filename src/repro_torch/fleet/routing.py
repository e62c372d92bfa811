"""Cache-affinity request routing across fleet nodes (DESIGN.md §Fleet).

A `Router` picks the serving node for each arrival.  It sees the request,
its derived chunk-key chain, and the per-node state the fleet simulator
exposes (`node.cache` — hot-tier index, possibly None — and
`node.inflight` — requests admitted but not yet served).  All routers are
deterministic: seeded RNG or pure functions of the observable state.

The policy ladder the fleet benchmark walks:

* `RandomRouter` — seeded uniform placement, the statistical baseline.
* `RoundRobinRouter` — perfect load spread, zero affinity.
* `ConsistentHashRouter` — hash the *prefix identity* onto a virtual-node
  ring: same prefix, same node, so cache affinity emerges without any state
  inspection (and node churn only remaps 1/N of the keyspace).
* `AffinityRouter` — hottest-prefix affinity: route to the node whose hot
  tier holds the longest prefix of the chain, with load shedding — when the
  favourite is ``max_imbalance`` requests deeper than the least-loaded node,
  spill there instead (affinity concentrates load by design; unchecked it
  melts the popular node).
"""
from __future__ import annotations

import bisect
import hashlib
import random
from abc import ABC, abstractmethod
from typing import Sequence

from repro_torch.cluster.trace import TraceRequest


class Router(ABC):
    @abstractmethod
    def route(self, tr: TraceRequest, nodes: Sequence,
              chain: Sequence[bytes]) -> int:
        """Index of the node that will serve ``tr``."""

    @property
    def name(self) -> str:
        return type(self).__name__.removesuffix("Router").lower()


class RandomRouter(Router):
    def __init__(self, seed: int = 0) -> None:
        self._rng = random.Random(seed)

    def route(self, tr, nodes, chain):
        return self._rng.randrange(len(nodes))


class RoundRobinRouter(Router):
    def __init__(self) -> None:
        self._next = 0

    def route(self, tr, nodes, chain):
        i = self._next % len(nodes)
        self._next += 1
        return i


def _ring_hash(data: bytes) -> int:
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(),
                          "big")


class ConsistentHashRouter(Router):
    """Prefix-id → ring position with ``virtual`` points per node.  The ring
    is rebuilt only when the node count changes (node sets are static within
    a simulation; the virtual points make remapping on change ~1/N)."""

    def __init__(self, virtual: int = 64) -> None:
        self.virtual = virtual
        self._ring: list[tuple[int, int]] = []
        self._for_nodes = 0

    def _build(self, n: int) -> None:
        self._ring = sorted(
            (_ring_hash(f"node{i}/v{v}".encode()), i)
            for i in range(n) for v in range(self.virtual))
        self._points = [p for p, _ in self._ring]
        self._for_nodes = n

    def route(self, tr, nodes, chain):
        if self._for_nodes != len(nodes):
            self._build(len(nodes))
        h = _ring_hash((tr.prefix_id or tr.req_id).encode())
        i = bisect.bisect_right(self._points, h)
        return self._ring[i % len(self._ring)][1]


class AffinityRouter(Router):
    """Hottest-prefix affinity with load shedding.

    Scores every node by its hot-tier match length for the chain (longest
    cached prefix, in chunks); routes to the best, breaking ties toward the
    least-loaded (then lowest-index) node.  If the winner is already
    ``max_imbalance`` in-flight requests deeper than the least-loaded node,
    the request is shed to the least-loaded node instead — the cache there
    will warm up, which is exactly how a popular prefix ends up replicated
    across nodes under load.
    """

    def __init__(self, max_imbalance: int = 8) -> None:
        if max_imbalance < 1:
            raise ValueError("max_imbalance must be >= 1")
        self.max_imbalance = max_imbalance
        self.shed = 0  # observability: requests diverted off their affinity

    def route(self, tr, nodes, chain):
        scores = []
        for i, node in enumerate(nodes):
            cache = getattr(node, "cache", None)
            m = cache.peek_chunks(chain) if cache is not None else 0
            scores.append((-m, node.inflight, i))
        best = min(scores)
        i_best = best[2]
        least = min(nodes, key=lambda nd: nd.inflight).inflight
        if nodes[i_best].inflight - least >= self.max_imbalance:
            self.shed += 1
            return min(range(len(nodes)),
                       key=lambda i: (nodes[i].inflight, i))
        return i_best


_ROUTERS = {
    "random": RandomRouter,
    "round_robin": RoundRobinRouter,
    "hash": ConsistentHashRouter,
    "affinity": AffinityRouter,
}


def make_router(spec: str, seed: int = 0) -> Router:
    """``random`` | ``round_robin`` | ``hash`` | ``affinity``."""
    try:
        cls = _ROUTERS[spec]
    except KeyError:
        raise ValueError(f"unknown router {spec!r}; known: "
                         + ", ".join(_ROUTERS))
    return cls(seed) if cls is RandomRouter else cls()
