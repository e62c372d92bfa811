"""Chunk-granular radix prefix index (paper §2.1, Fig. 3).

Because chunk keys form a rolling-hash chain (H_i depends on H_{i-1}), the set
of committed chunks *is* a radix tree over token prefixes: each node is one
G-token chunk; children diverge where requests diverge.  Fine granularity
preserves branch points (Fig. 3a); coarse granularity merges them and forces
recompute of otherwise reusable tokens (Fig. 3b) — quantified in
benchmarks/bench_granularity.py against Appendix Table A6.

The index is deliberately cheap: Fig. 4 shows lookup cost is small relative to
tokenization even at G = 16, so the serving bottleneck is delivery, not lookup.

Eviction is policy-driven (DESIGN.md §Fleet): the index maintains the
*evictable* set — unpinned leaves; internal nodes cannot go without severing
their descendants' hash chain — incrementally, and an `EvictionPolicy`
(`repro_torch.fleet.policy`; LRU by default) ranks it.  Every membership change is
O(1), so an eviction burst costs O(victims), not O(victims · nodes).  Evicted
keys are surfaced through ``on_evict`` so the caller deletes the backing
objects — index eviction and store deletion stay coherent.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Iterable, Optional, Sequence

import numpy as np

from .hashing import GENESIS, chunk_keys
from .types import MatchResult


@dataclasses.dataclass
class _Node:
    key: bytes
    parent: Optional["_Node"]
    depth: int  # chunks from root (root = 0)
    children: dict[bytes, "_Node"] = dataclasses.field(default_factory=dict)
    last_access: float = 0.0
    hits: int = 0
    pinned: int = 0  # in-flight references; pinned nodes are not evictable


class RadixIndex:
    """Longest-prefix chunk matcher with policy-driven leaf eviction.

    Thread-safe: the serving orchestrator matches on the request path while a
    write-behind thread commits freshly produced chunks.  ``policy`` is any
    `repro_torch.fleet.policy.EvictionPolicy` (default LRU — the historical leaf-LRU
    behaviour); ``on_evict`` is called, under the index lock, once per evicted
    key so the owner can delete the backing object exactly once;
    ``chunk_bytes`` is the per-chunk object size handed to size-aware
    policies (GDSF).
    """

    def __init__(self, chunk_tokens: int, max_chunks: int | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 policy=None,
                 on_evict: Optional[Callable[[bytes], None]] = None,
                 chunk_bytes: int = 1):
        self.chunk_tokens = chunk_tokens
        self.max_chunks = max_chunks
        self.chunk_bytes = chunk_bytes
        self._clock = clock
        if policy is None:
            from repro_torch.fleet.policy import LRUPolicy  # default; lazy to keep
            policy = LRUPolicy()                      # core import-light
        self._policy = policy
        self.on_evict = on_evict
        self._root = _Node(GENESIS, None, 0)
        self._nodes: dict[bytes, _Node] = {}
        self._lock = threading.RLock()
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._nodes)

    # -- lookup ---------------------------------------------------------------
    def match(self, tokens: Sequence[int] | np.ndarray) -> MatchResult:
        """Longest cached prefix of ``tokens``, in whole chunks."""
        return self.match_keys(chunk_keys(tokens, self.chunk_tokens))

    def match_keys(self, keys: Sequence[bytes],
                   touch: bool = True) -> MatchResult:
        """Key-chain variant of :meth:`match` — the fleet simulator derives
        chains directly (no token materialisation) and matches here.
        ``touch=False`` is a pure peek (router *scoring* must not distort the
        eviction policy's view of real accesses)."""
        now = self._clock()
        matched: list[bytes] = []
        with self._lock:
            node = self._root
            for k in keys:
                child = node.children.get(k)
                if child is None:
                    break
                if touch:
                    child.last_access = now
                    child.hits += 1
                    self._policy.touch(k, now)
                matched.append(k)
                node = child
        return MatchResult(tuple(matched), len(matched) * self.chunk_tokens)

    # -- insert ---------------------------------------------------------------
    def insert(self, tokens: Sequence[int] | np.ndarray) -> list[bytes]:
        """Register every complete chunk of ``tokens``; returns the *new* keys
        (the caller uploads exactly those objects — dedup is free because the
        keys are content-derived)."""
        return self.insert_keys(chunk_keys(tokens, self.chunk_tokens))

    def insert_keys(self, keys: Sequence[bytes]) -> list[bytes]:
        now = self._clock()
        new: list[bytes] = []
        with self._lock:
            node = self._root
            for k in keys:
                child = node.children.get(k)
                if child is None:
                    child = _Node(k, node, node.depth + 1, last_access=now)
                    if node is not self._root:
                        self._policy.remove(node.key)  # gained a child
                    node.children[k] = child
                    self._nodes[k] = child
                    self._policy.add(k, self.chunk_bytes, now)
                    new.append(k)
                else:
                    child.last_access = now
                    self._policy.touch(k, now)
                node = child
            for key in self._maybe_evict():
                if self.on_evict is not None:
                    self.on_evict(key)
        return new

    def contains(self, key: bytes) -> bool:
        with self._lock:
            return key in self._nodes

    def pin(self, keys: Iterable[bytes]) -> None:
        with self._lock:
            for k in keys:
                n = self._nodes.get(k)
                if n:
                    if n.pinned == 0:
                        self._policy.remove(k)
                    n.pinned += 1

    def unpin(self, keys: Iterable[bytes]) -> None:
        with self._lock:
            for k in keys:
                n = self._nodes.get(k)
                if n and n.pinned > 0:
                    n.pinned -= 1
                    if n.pinned == 0 and not n.children:
                        self._policy.add(k, self.chunk_bytes, n.last_access,
                                         n.hits)

    # -- eviction ---------------------------------------------------------------
    def _unlink(self, node: _Node) -> None:
        """Remove ``node`` from the tree; its parent may become evictable."""
        parent = node.parent
        parent.children.pop(node.key, None)
        del self._nodes[node.key]
        self.evictions += 1
        if (parent is not self._root and not parent.children
                and parent.pinned == 0):
            self._policy.add(parent.key, self.chunk_bytes,
                             parent.last_access, parent.hits)

    def _maybe_evict(self) -> list[bytes]:
        """Evict until at/under ``max_chunks``.  Leaf-first: internal nodes
        cannot be evicted without severing their descendants' hash chain —
        the policy ranks exactly the unpinned-leaf set, so each victim is
        O(policy-pop), not O(n)."""
        evicted: list[bytes] = []
        if self.max_chunks is None:
            return evicted
        now = self._clock()
        while len(self._nodes) > self.max_chunks:
            key = self._policy.pop_victim(now)
            if key is None:
                break  # everything left is pinned or internal
            self._unlink(self._nodes[key])
            evicted.append(key)
        return evicted

    def sweep_expired(self, now: Optional[float] = None) -> list[bytes]:
        """Drain TTL-expired keys (no-op for lifetime-free policies), firing
        ``on_evict`` per key.  Call periodically when using `TTLPolicy`."""
        with self._lock:
            if now is None:
                now = self._clock()
            out: list[bytes] = []
            for key in self._policy.expired(now):
                self._unlink(self._nodes[key])
                out.append(key)
            for key in out:
                if self.on_evict is not None:
                    self.on_evict(key)
        return out

    # -- introspection ----------------------------------------------------------
    def branch_points(self) -> int:
        """Nodes with >1 child — the reuse-preserving divergences of Fig. 3."""
        with self._lock:
            return sum(1 for n in [self._root, *self._nodes.values()]
                       if len(n.children) > 1)

    def stats(self) -> dict:
        with self._lock:
            return {
                "chunks": len(self._nodes),
                "branch_points": self.branch_points(),
                "evictions": self.evictions,
                "evictable": len(self._policy),
                "policy": type(self._policy).__name__,
            }
