"""Pluggable admission/eviction policies over the chunk namespace
(DESIGN.md §Fleet).

A policy tracks only the *evictable* population: the owner — `RadixIndex`
(unpinned leaves) or `TieredStore` (hot-tier residents) — adds and removes
keys as their evictability changes and asks the policy "who goes next".
Keeping the candidate-set maintenance in the owner and the ordering in the
policy is what lets index eviction and store deletion stay coherent: the
owner unlinks the victim, fires its ``on_evict`` hook, and the backing
object is deleted exactly once.

All operations are O(1) (`LRUPolicy`, `LFUPolicy`, `TTLPolicy`) or
O(log n) (`GDSFPolicy`, heap with lazy invalidation).  Policies are not
thread-safe on their own; owners call them under their own lock.
"""
from __future__ import annotations

import collections
import heapq
from abc import ABC, abstractmethod
from typing import Optional


class EvictionPolicy(ABC):
    """Ranking over the currently-evictable keys.

    ``add``/``remove`` maintain membership, ``touch`` records an access,
    ``pop_victim`` removes and returns the next key to evict (None when
    nothing is evictable), ``expired`` drains keys whose lifetime lapsed
    (TTL policies only — the default is none).
    """

    @abstractmethod
    def add(self, key: bytes, size_bytes: int, now: float,
            hits: int = 0) -> None: ...

    @abstractmethod
    def remove(self, key: bytes) -> bool:
        """Forget ``key`` (no longer evictable); True if it was tracked."""

    @abstractmethod
    def touch(self, key: bytes, now: float) -> None: ...

    @abstractmethod
    def pop_victim(self, now: float) -> Optional[bytes]: ...

    @abstractmethod
    def __contains__(self, key: bytes) -> bool: ...

    @abstractmethod
    def __len__(self) -> int: ...

    def expired(self, now: float) -> list[bytes]:
        """Pop and return every key whose TTL lapsed (empty by default)."""
        return []


class LRUPolicy(EvictionPolicy):
    """Least-recently-used: victim is the key touched longest ago."""

    def __init__(self) -> None:
        self._order: "collections.OrderedDict[bytes, int]" = \
            collections.OrderedDict()

    def add(self, key, size_bytes, now, hits=0):
        self._order[key] = size_bytes
        self._order.move_to_end(key)

    def remove(self, key):
        return self._order.pop(key, None) is not None

    def touch(self, key, now):
        if key in self._order:
            self._order.move_to_end(key)

    def pop_victim(self, now):
        if not self._order:
            return None
        key, _ = self._order.popitem(last=False)
        return key

    def __contains__(self, key):
        return key in self._order

    def __len__(self):
        return len(self._order)


class LFUPolicy(EvictionPolicy):
    """Least-frequently-used with LRU tie-break inside a frequency class
    (the classic O(1) two-level structure: freq -> insertion-ordered keys)."""

    def __init__(self) -> None:
        self._freq: dict[bytes, int] = {}
        self._buckets: dict[int, "collections.OrderedDict[bytes, None]"] = {}
        self._min_freq = 0

    def _bucket(self, f: int) -> "collections.OrderedDict[bytes, None]":
        b = self._buckets.get(f)
        if b is None:
            b = self._buckets[f] = collections.OrderedDict()
        return b

    def _bump(self, key: bytes, to: int) -> None:
        f = self._freq.get(key)
        if f is not None:
            b = self._buckets[f]
            del b[key]
            if not b:
                del self._buckets[f]
                if self._min_freq == f:
                    self._min_freq = to
        self._freq[key] = to
        self._bucket(to)[key] = None
        if to < self._min_freq or len(self._freq) == 1:
            self._min_freq = to

    def add(self, key, size_bytes, now, hits=0):
        # seed frequency from the owner's hit counter so a key that cycles
        # evictable->pinned->evictable keeps its history
        self._bump(key, max(1, 1 + hits))

    def remove(self, key):
        f = self._freq.pop(key, None)
        if f is None:
            return False
        b = self._buckets[f]
        del b[key]
        if not b:
            del self._buckets[f]
        return True

    def touch(self, key, now):
        f = self._freq.get(key)
        if f is not None:
            self._bump(key, f + 1)

    def pop_victim(self, now):
        if not self._freq:
            return None
        while self._min_freq not in self._buckets:
            self._min_freq += 1
        b = self._buckets[self._min_freq]
        key, _ = b.popitem(last=False)
        del self._freq[key]
        if not b:
            del self._buckets[self._min_freq]
        return key

    def __contains__(self, key):
        return key in self._freq

    def __len__(self):
        return len(self._freq)


class TTLPolicy(EvictionPolicy):
    """LRU order plus a hard lifetime: any key untouched for ``ttl_s`` is
    expired and drains ahead of (and independently of) capacity pressure."""

    def __init__(self, ttl_s: float) -> None:
        if ttl_s <= 0:
            raise ValueError("ttl_s must be positive")
        self.ttl_s = ttl_s
        self._deadline: "collections.OrderedDict[bytes, float]" = \
            collections.OrderedDict()

    def add(self, key, size_bytes, now, hits=0):
        self._deadline[key] = now + self.ttl_s
        self._deadline.move_to_end(key)

    def remove(self, key):
        return self._deadline.pop(key, None) is not None

    def touch(self, key, now):
        if key in self._deadline:
            self._deadline[key] = now + self.ttl_s
            self._deadline.move_to_end(key)

    def pop_victim(self, now):
        if not self._deadline:
            return None
        # refresh-on-touch keeps the OrderedDict deadline-sorted, so the
        # head is simultaneously the LRU victim and the earliest deadline
        key, _ = self._deadline.popitem(last=False)
        return key

    def expired(self, now):
        out = []
        while self._deadline:
            key = next(iter(self._deadline))
            if self._deadline[key] > now:
                break
            del self._deadline[key]
            out.append(key)
        return out

    def __contains__(self, key):
        return key in self._deadline

    def __len__(self):
        return len(self._deadline)


class GDSFPolicy(EvictionPolicy):
    """Greedy-Dual-Size-Frequency: priority = clock + hits·cost/size.

    Size-aware — frequently-hit small objects outrank cold large ones; the
    aging clock (set to each victim's priority) lets once-hot keys decay
    instead of starving newcomers.  Heap entries are lazily invalidated by a
    per-key version counter.
    """

    def __init__(self, cost: float = 1.0) -> None:
        self.cost = cost
        self.clock = 0.0
        self._state: dict[bytes, tuple[int, int, int]] = {}  # ver, hits, size
        self._heap: list[tuple[float, int, int, bytes]] = []
        self._seq = 0  # deterministic tie-break: FIFO among equal priorities

    def _priority(self, hits: int, size: int) -> float:
        return self.clock + hits * self.cost / max(size, 1)

    def _push(self, key: bytes, ver: int, hits: int, size: int) -> None:
        heapq.heappush(self._heap,
                       (self._priority(hits, size), self._seq, ver, key))
        self._seq += 1

    def add(self, key, size_bytes, now, hits=0):
        ver = self._state[key][0] + 1 if key in self._state else 0
        h = max(1, 1 + hits)
        self._state[key] = (ver, h, size_bytes)
        self._push(key, ver, h, size_bytes)

    def remove(self, key):
        return self._state.pop(key, None) is not None

    def touch(self, key, now):
        st = self._state.get(key)
        if st is None:
            return
        ver, hits, size = st
        self._state[key] = (ver + 1, hits + 1, size)
        self._push(key, ver + 1, hits + 1, size)

    def pop_victim(self, now):
        while self._heap:
            prio, _, ver, key = heapq.heappop(self._heap)
            st = self._state.get(key)
            if st is None or st[0] != ver:
                continue  # stale entry
            del self._state[key]
            self.clock = prio  # aging: future insertions outrank old ghosts
            return key
        return None

    def __contains__(self, key):
        return key in self._state

    def __len__(self):
        return len(self._state)


_POLICIES = {
    "lru": LRUPolicy,
    "lfu": LFUPolicy,
    "gdsf": GDSFPolicy,
}


def make_policy(spec: str) -> EvictionPolicy:
    """Construct a policy from a spec string: ``lru`` | ``lfu`` | ``gdsf`` |
    ``ttl/<seconds>``."""
    if spec.startswith("ttl/"):
        return TTLPolicy(float(spec.split("/", 1)[1]))
    try:
        return _POLICIES[spec]()
    except KeyError:
        known = ", ".join([*_POLICIES, "ttl/<s>"])
        raise ValueError(f"unknown eviction policy {spec!r}; known: {known}")
