"""Labeled counters/gauges/histograms behind one lock-safe registry.

Before this module the repo had four ad-hoc stat surfaces — `EngineStats`
(a plain dataclass), the orchestrator's ``stats`` dict, `StoreStats`, and
the replanner's history tuples — none of which could be read consistently
while another thread was writing.  `MetricsRegistry` replaces them with one
API and one invariant, borrowed from `StoreStats`: **every mutation and
every snapshot takes the registry lock, so a snapshot is a consistent
cut**.  Multi-field updates that must be seen together go through one
:meth:`StatGroup.add` call (e.g. the engine's ``reused + computed`` pair)
— a concurrent snapshot can never observe one field of the pair without
the other (the torn-snapshot tests assert exactly this).

`StatGroup` is the migration shim: it answers both the orchestrator's
dict-style ``stats["hits"] += 1`` and the engine's attribute-style
``stats.requests += 1`` against registry-backed counters, so every
existing call site and test keeps working while the storage moves.

Histograms are deterministic and **unbiased over the whole run**: exact
nearest-rank percentiles (same definition as `cluster.metrics.percentile`)
while the observation count fits the bounded sample buffer, and a
mergeable relative-error `sketch.QuantileSketch` beyond it.  The old
keep-first-``max_samples`` reservoir answered long-run percentiles from
the run's *first minutes only* (warm-up bias — late samples could never
move p99); the sketch sees every observation.

Instruments optionally carry a ``tenant`` label (fleet per-tenant TTFT
previously existed only in `cluster.metrics` rollups): the label is
folded into the canonical instrument name (``name{tenant=t}``), so
labeled instruments live in the same namespace, under the same lock, and
appear in the same consistent `snapshot` cut as everything else.
"""
from __future__ import annotations

import math
import threading
from typing import Iterator, Optional, Sequence

from .sketch import QuantileSketch


def labeled(name: str, tenant: str = "") -> str:
    """Canonical instrument name for a (name, tenant) pair."""
    return name if not tenant else f"{name}{{tenant={tenant}}}"


def _nearest_rank(xs: Sequence[float], q: float) -> float:
    if not xs:
        return math.nan
    s = sorted(xs)
    k = max(1, math.ceil(q * len(s)))
    return s[k - 1]


class Counter:
    """Monotone counter.  Mutate via :meth:`inc` (under the registry lock)."""

    def __init__(self, name: str, lock: threading.Lock) -> None:
        self.name = name
        self._lock = lock
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def _peek(self) -> int:  # caller holds the lock
        return self._value


class Gauge:
    """Last-write-wins instantaneous value."""

    def __init__(self, name: str, lock: threading.Lock) -> None:
        self.name = name
        self._lock = lock
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _peek(self) -> float:
        return self._value


class Histogram:
    """Streaming count/sum/min/max with exact small-n percentiles and a
    sketch-backed tail for long runs.

    While the count fits ``max_samples`` the raw samples are kept and
    percentiles are exact nearest-rank; past that, answers come from the
    `QuantileSketch` that has been fed *every* observation, so late
    samples always move the tail (no warm-up bias).  Deterministic by
    construction either way: no random eviction anywhere."""

    def __init__(self, name: str, lock: threading.Lock,
                 max_samples: int = 4096,
                 rel_err: float = 0.01) -> None:
        self.name = name
        self._lock = lock
        self.max_samples = max_samples
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._samples: list[float] = []
        self._sketch = QuantileSketch(rel_err)

    def observe(self, v: float) -> None:
        with self._lock:
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)
            if len(self._samples) < self.max_samples:
                self._samples.append(v)
            self._sketch.add(v)

    def _percentile(self, q: float) -> float:
        if self._count <= self.max_samples:
            return _nearest_rank(self._samples, q)
        return self._sketch.quantile(q)

    def percentile(self, q: float) -> float:
        with self._lock:
            return self._percentile(q)

    def _peek(self) -> dict:
        if self._count == 0:
            return {"count": 0, "sum": 0.0, "mean": math.nan,
                    "min": math.nan, "max": math.nan, "p50": math.nan,
                    "p95": math.nan, "p99": math.nan}
        return {"count": self._count, "sum": self._sum,
                "mean": self._sum / self._count,
                "min": self._min, "max": self._max,
                "p50": self._percentile(0.50),
                "p95": self._percentile(0.95),
                "p99": self._percentile(0.99)}

    def snapshot(self) -> dict:
        with self._lock:
            return self._peek()

    def sketch(self) -> QuantileSketch:
        """A consistent copy of the underlying sketch (mergeable into
        fleet rollups without racing live observes)."""
        with self._lock:
            return QuantileSketch.from_dict(self._sketch.to_dict())


class StatGroup:
    """A named family of counters supporting dict-style *and* attribute-style
    access, with an atomic multi-field :meth:`add` and a consistent
    :meth:`snapshot` — the drop-in replacement for the orchestrator's stats
    dict and `EngineStats`.

    ``group["hits"] += 1`` and ``group.hits += 1`` both resolve to a locked
    counter increment; ``group.add(a=1, b=n)`` applies several deltas under
    ONE lock acquisition so no snapshot can tear the pair apart.
    """

    def __init__(self, registry: "MetricsRegistry", prefix: str,
                 fields: Sequence[str]) -> None:
        object.__setattr__(self, "_registry", registry)
        object.__setattr__(self, "_prefix", prefix)
        object.__setattr__(self, "_counters",
                           {f: registry.counter(f"{prefix}.{f}")
                            for f in fields})

    # dict-style ---------------------------------------------------------------
    def __getitem__(self, field: str) -> int:
        return self._counters[field].value

    def __setitem__(self, field: str, value: int) -> None:
        c = self._counters[field]
        with self._registry._lock:
            c._value = value

    def __contains__(self, field: str) -> bool:
        return field in self._counters

    def __iter__(self) -> Iterator[str]:
        return iter(self._counters)

    def keys(self):
        return self._counters.keys()

    # attribute-style ----------------------------------------------------------
    def __getattr__(self, field: str) -> int:
        try:
            return self._counters[field].value
        except KeyError:
            raise AttributeError(field) from None

    def __setattr__(self, field: str, value: int) -> None:
        self[field] = value

    # atomic multi-field update ------------------------------------------------
    def add(self, **deltas: int) -> None:
        """Apply several field deltas under one lock acquisition — fields
        updated together are always observed together."""
        with self._registry._lock:
            for field, delta in deltas.items():
                self._counters[field]._value += delta

    def snapshot(self) -> dict:
        """Consistent cut of all fields (mirrors `StoreStats.snapshot`)."""
        with self._registry._lock:
            return {f: c._peek() for f, c in self._counters.items()}

    def __repr__(self) -> str:
        return f"StatGroup({self._prefix!r}, {self.snapshot()})"


class MetricsRegistry:
    """One process-wide (or per-subsystem) metric namespace.

    All instruments created by a registry share ITS lock, so
    :meth:`snapshot` is a consistent cut across every counter, gauge and
    histogram at once — not per-instrument.  Creating an instrument that
    already exists returns the existing one (labels live in the name:
    ``"engine.requests"``, ``"store.node0.evictions"``).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str, tenant: str = "") -> Counter:
        name = labeled(name, tenant)
        c = self._counters.get(name)
        if c is None:
            c = self._counters.setdefault(name, Counter(name, self._lock))
        return c

    def gauge(self, name: str, tenant: str = "") -> Gauge:
        name = labeled(name, tenant)
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges.setdefault(name, Gauge(name, self._lock))
        return g

    def histogram(self, name: str, max_samples: int = 4096,
                  tenant: str = "") -> Histogram:
        name = labeled(name, tenant)
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms.setdefault(
                name, Histogram(name, self._lock, max_samples))
        return h

    def group(self, prefix: str, fields: Sequence[str],
              tenant: str = "") -> StatGroup:
        return StatGroup(self, labeled(prefix, tenant), fields)

    def tenants(self, name: str) -> list[str]:
        """Tenant labels under which instrument ``name`` exists."""
        prefix = f"{name}{{tenant="
        out = set()
        with self._lock:
            for store in (self._counters, self._gauges, self._histograms):
                for full in store:
                    if full.startswith(prefix) and full.endswith("}"):
                        out.add(full[len(prefix):-1])
        return sorted(out)

    def snapshot(self) -> dict:
        """One consistent cut of the whole registry:
        ``{"counters": {...}, "gauges": {...}, "histograms": {...}}``."""
        with self._lock:
            return {
                "counters": {n: c._peek()
                             for n, c in sorted(self._counters.items())},
                "gauges": {n: g._peek()
                           for n, g in sorted(self._gauges.items())},
                "histograms": {n: h._peek()
                               for n, h in sorted(self._histograms.items())},
            }
