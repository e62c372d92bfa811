"""Object-store backends.

``InMemoryStore`` is the unit-test substrate; ``FileStore`` persists chunk
objects to disk (the laptop stand-in for DAOS/S3); ``TieredStore`` composes a
DRAM hot tier over a cold object tier — the hierarchy of paper §6.1 / Table A5
(GPU VRAM > DRAM > remote DRAM > NVMe > object storage).

All stores speak the same minimal interface: immutable puts keyed by
content-derived hashes, whole-object gets, and *range* gets — the primitive
server-side layer aggregation is built from (paper Table A3: RANGEGET(H_j,
l*S, S)).
"""
from __future__ import annotations

import os
import threading
import time
from abc import ABC, abstractmethod
from typing import Callable


class ObjectStore(ABC):
    @abstractmethod
    def put(self, key: bytes, data: bytes) -> None: ...

    @abstractmethod
    def get(self, key: bytes) -> bytes: ...

    @abstractmethod
    def range_get(self, key: bytes, offset: int, length: int) -> bytes: ...

    @abstractmethod
    def contains(self, key: bytes) -> bool: ...

    @abstractmethod
    def delete(self, key: bytes) -> None: ...

    @abstractmethod
    def object_size(self, key: bytes) -> int: ...


class StoreStats:
    """Thread-safe operation counters.

    Stores mutate through :meth:`add` and readers use :meth:`snapshot`; both
    take the internal lock, so a snapshot is a *consistent* cut (a concurrent
    get can never be observed with its byte count but not its op count).
    """

    _FIELDS = ("puts", "gets", "range_gets", "bytes_read", "bytes_written",
               "dedup_hits", "deletes", "evictions")

    def __init__(self) -> None:
        for f in self._FIELDS:
            setattr(self, f, 0)
        self._lock = threading.Lock()

    def add(self, **deltas: int) -> None:
        with self._lock:
            for field, delta in deltas.items():
                setattr(self, field, getattr(self, field) + delta)

    def snapshot(self) -> dict:
        with self._lock:
            return {f: getattr(self, f) for f in self._FIELDS}


class InMemoryStore(ObjectStore):
    def __init__(self) -> None:
        self._data: dict[bytes, bytes] = {}
        self._lock = threading.RLock()
        self.stats = StoreStats()

    def put(self, key: bytes, data: bytes) -> None:
        with self._lock:
            if key in self._data:
                self.stats.add(dedup_hits=1)  # immutable + content-addressed
                return
            self._data[key] = bytes(data)
            self.stats.add(puts=1, bytes_written=len(data))

    def get(self, key: bytes) -> bytes:
        with self._lock:
            data = self._data[key]
            self.stats.add(gets=1, bytes_read=len(data))
            return data

    def range_get(self, key: bytes, offset: int, length: int) -> bytes:
        with self._lock:
            data = self._data[key]
            self.stats.add(range_gets=1, bytes_read=length)
            return data[offset:offset + length]

    def contains(self, key: bytes) -> bool:
        with self._lock:
            return key in self._data

    def delete(self, key: bytes) -> None:
        with self._lock:
            if self._data.pop(key, None) is not None:
                self.stats.add(deletes=1)

    def object_size(self, key: bytes) -> int:
        with self._lock:
            return len(self._data[key])

    def total_bytes(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._data.values())


class FileStore(ObjectStore):
    """One file per object under ``root`` (two-level fanout on key hex)."""

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock = threading.RLock()
        self.stats = StoreStats()

    def _path(self, key: bytes) -> str:
        h = key.hex()
        return os.path.join(self.root, h[:2], h)

    def put(self, key: bytes, data: bytes) -> None:
        path = self._path(key)
        with self._lock:
            if os.path.exists(path):
                self.stats.add(dedup_hits=1)
                return
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)  # atomic commit — immutability invariant
            self.stats.add(puts=1, bytes_written=len(data))

    def get(self, key: bytes) -> bytes:
        with open(self._path(key), "rb") as f:
            data = f.read()
        self.stats.add(gets=1, bytes_read=len(data))
        return data

    def range_get(self, key: bytes, offset: int, length: int) -> bytes:
        with open(self._path(key), "rb") as f:
            f.seek(offset)
            data = f.read(length)
        self.stats.add(range_gets=1, bytes_read=len(data))
        return data

    def contains(self, key: bytes) -> bool:
        return os.path.exists(self._path(key))

    def delete(self, key: bytes) -> None:
        try:
            os.remove(self._path(key))
            self.stats.add(deletes=1)
        except FileNotFoundError:
            pass

    def object_size(self, key: bytes) -> int:
        return os.path.getsize(self._path(key))


class TieredStore(ObjectStore):
    """DRAM hot cache over a cold object tier (paper §6.1).

    Reads promote into the hot tier (byte-capacity bound); writes go
    through to the cold tier and optionally populate hot.  ObjectCache is the
    *capacity* tier; this class is how a deployment keeps its hottest prefixes
    near the serving node without changing any protocol semantics.

    Hot-tier victim selection is delegated to an `EvictionPolicy`
    (`repro_torch.fleet.policy`; default LRU = the historical behaviour) — the same
    interface `RadixIndex` consumes, so a fleet deployment ranks index
    eviction and hot-tier residency with one policy family (DESIGN.md §Fleet).
    """

    def __init__(self, cold: ObjectStore, hot_capacity_bytes: int,
                 populate_on_write: bool = True, hot_policy=None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.cold = cold
        self.hot_capacity = hot_capacity_bytes
        self.populate_on_write = populate_on_write
        if hot_policy is None:
            from repro_torch.fleet.policy import LRUPolicy
            hot_policy = LRUPolicy()
        self._policy = hot_policy
        self._clock = clock
        self._hot: dict[bytes, bytes] = {}
        self._hot_bytes = 0
        self._lock = threading.RLock()
        self.stats = StoreStats()  # aggregate, whichever tier served
        self.hot_stats = StoreStats()  # reads served by the DRAM tier only
        self.hot_hits = 0
        self.hot_misses = 0
        # nullable obs tracer (DESIGN.md §Observability): get/put/promote/
        # evict instants stamped from the store's own injected clock, so a
        # simulated deployment traces in sim time and a live one in wall time
        self.tracer = None
        self.trace_track = "store"

    def _emit(self, name: str, **args) -> None:
        if self.tracer is not None:
            self.tracer.instant(self.trace_track, name, t=self._clock(),
                                cat="store", **args)

    def tier_snapshot(self) -> dict:
        """Per-tier read/write split (the aggregate ``stats`` can't say
        *where* a byte was served from).  ``hot`` counts reads the DRAM tier
        absorbed; ``cold`` is the backing store's own counters (which include
        promotion-triggered whole-object reads); ``total`` is the aggregate
        view callers have always had."""
        cold_stats = getattr(self.cold, "stats", None)
        with self._lock:
            hot = self.hot_stats.snapshot()
            hot.update(hits=self.hot_hits, misses=self.hot_misses,
                       resident_objects=len(self._hot),
                       resident_bytes=self._hot_bytes,
                       capacity_bytes=self.hot_capacity)
        return {"hot": hot,
                "cold": cold_stats.snapshot() if cold_stats is not None else {},
                "total": self.stats.snapshot()}

    def _admit(self, key: bytes, data: bytes) -> None:
        if len(data) > self.hot_capacity:
            return
        with self._lock:
            now = self._clock()
            if key in self._hot:
                self._policy.touch(key, now)
                return
            self._hot[key] = data
            self._hot_bytes += len(data)
            self._policy.add(key, len(data), now)
            self._emit("promote", bytes=len(data))
            while self._hot_bytes > self.hot_capacity:
                victim = self._policy.pop_victim(now)
                if victim is None:
                    break  # policy tracks nothing else — cannot shrink
                evicted = self._hot.pop(victim)
                self._hot_bytes -= len(evicted)
                self.hot_stats.add(evictions=1)
                self._emit("evict", bytes=len(evicted))

    def put(self, key: bytes, data: bytes) -> None:
        with self._lock:  # atomic contains+put: racing writers of the same
            # new key must classify exactly one put and one dedup hit
            dup = self.cold.contains(key)  # immutable content-addressed store
            self.cold.put(key, data)
        if dup:
            self.stats.add(dedup_hits=1)
        else:
            self.stats.add(puts=1, bytes_written=len(data))
        self._emit("put", bytes=len(data), dedup=dup)
        if self.populate_on_write:
            self._admit(key, bytes(data))

    def get(self, key: bytes) -> bytes:
        self.stats.add(gets=1)
        with self._lock:
            hit = self._hot.get(key)
            if hit is not None:
                self._policy.touch(key, self._clock())
                self.hot_hits += 1
                self.hot_stats.add(gets=1, bytes_read=len(hit))
                self.stats.add(bytes_read=len(hit))
                self._emit("get", tier="hot", bytes=len(hit))
                return hit
            self.hot_misses += 1
        data = self.cold.get(key)
        self._emit("get", tier="cold", bytes=len(data))
        self._admit(key, data)
        self.stats.add(bytes_read=len(data))
        return data

    def range_get(self, key: bytes, offset: int, length: int) -> bytes:
        self.stats.add(range_gets=1)
        with self._lock:
            hit = self._hot.get(key)
            if hit is not None:
                self._policy.touch(key, self._clock())
                self.hot_hits += 1
                self.hot_stats.add(range_gets=1, bytes_read=length)
                self.stats.add(bytes_read=length)
                self._emit("get", tier="hot", bytes=length)
                return hit[offset:offset + length]
            self.hot_misses += 1
        self._emit("get", tier="cold", bytes=length)
        # Promote the *whole* object, not just the requested range: layerwise
        # retrieval issues L range reads against the same chunk, so serving
        # the miss from cold without admitting would defeat the hot tier for
        # exactly the access pattern it exists for.  But an object that can
        # never be admitted must not be amplified into L full-object reads.
        self.stats.add(bytes_read=length)
        if self.cold.object_size(key) > self.hot_capacity:
            return self.cold.range_get(key, offset, length)
        data = self.cold.get(key)
        self._admit(key, data)
        return data[offset:offset + length]

    def contains(self, key: bytes) -> bool:
        with self._lock:
            if key in self._hot:
                return True
        return self.cold.contains(key)

    def delete(self, key: bytes) -> None:
        with self._lock:
            data = self._hot.pop(key, None)
            if data is not None:
                self._hot_bytes -= len(data)
                self._policy.remove(key)
        self.cold.delete(key)
        self.stats.add(deletes=1)

    def object_size(self, key: bytes) -> int:
        with self._lock:
            if key in self._hot:
                return len(self._hot[key])
        return self.cold.object_size(key)
