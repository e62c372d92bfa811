"""Streaming windowed metrics: tumbling/sliding windows, EWMA, live rollups.

PR 7's observability can only explain a run *after the fact* — a complete
trace in, a waterfall out.  This module is the *online* half: per-window
TTFT / stall / hit-rate series that exist **while** `AsyncEngine`,
`ClusterSim` and `FleetSim` run, built from the same two contracts as the
tracer (DESIGN.md §Observability):

* **Clock injection / zero perturbation** — nothing here reads a clock.
  Every ingest call carries an explicit event time the caller already
  computed (``monitor.observe(name, t, v)``), so attaching a monitor to a
  simulator cannot move a single simulated timestamp (the golden-trace
  tests assert bit-identity with monitors attached).
* **Merge algebra** — windows are aligned to *absolute* time
  (window k covers ``[k*width, (k+1)*width)``; an observation exactly on a
  boundary opens the new window), and each window aggregates with a
  mergeable `QuantileSketch`.  Two monitors over the same width therefore
  merge window-by-window, associatively and commutatively — fleet nodes
  sketch locally and `FleetSim.monitor_rollup()` folds them into one
  consistent global series in any node order.

`Ewma` is the constant-memory trend line over irregular samples (half-life
decay on the virtual clock), and `StreamMonitor` is the duck-typed object
the sims accept: ``observe``/``inc`` for named series plus
``record_request`` for the standard per-request vocabulary
(ttft/queue/stall/hit_rate, per-tenant).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from .sketch import QuantileSketch


def window_index(t: float, width_s: float) -> int:
    """Index of the window containing ``t``: boundary samples open the new
    window (``[k*w, (k+1)*w)`` semantics).  The epsilon absorbs float noise
    from event arithmetic so ``t = k*w - 1e-18`` doesn't straddle."""
    return math.floor(t / width_s + 1e-12)


@dataclasses.dataclass
class Window:
    """One closed-or-open tumbling window's aggregate."""

    index: int
    width_s: float
    sketch: QuantileSketch

    @property
    def start_s(self) -> float:
        return self.index * self.width_s

    @property
    def end_s(self) -> float:
        return (self.index + 1) * self.width_s

    @property
    def count(self) -> int:
        return self.sketch.count

    def snapshot(self) -> dict:
        snap = self.sketch.snapshot()
        snap["t0_s"] = self.start_s
        snap["t1_s"] = self.end_s
        return snap


class WindowedSeries:
    """Tumbling-window series of one metric: each observation lands in its
    absolute-time-aligned window's sketch.  ``max_windows`` bounds memory
    (oldest windows are dropped — a live monitor keeps the recent past)."""

    def __init__(self, width_s: float, rel_err: float = 0.01,
                 max_windows: Optional[int] = None) -> None:
        if width_s <= 0:
            raise ValueError("window width must be positive")
        self.width_s = width_s
        self.rel_err = rel_err
        self.max_windows = max_windows
        self._windows: dict[int, Window] = {}

    def observe(self, t: float, v: float, n: int = 1) -> None:
        k = window_index(t, self.width_s)
        w = self._windows.get(k)
        if w is None:
            w = self._windows[k] = Window(k, self.width_s,
                                          QuantileSketch(self.rel_err))
            if self.max_windows is not None \
                    and len(self._windows) > self.max_windows:
                del self._windows[min(self._windows)]
        w.sketch.add(v, n)

    # -- queries --------------------------------------------------------------
    def windows(self) -> list[Window]:
        return [self._windows[k] for k in sorted(self._windows)]

    def window_at(self, t: float) -> Optional[Window]:
        return self._windows.get(window_index(t, self.width_s))

    def last(self, k: int, before: Optional[float] = None
             ) -> QuantileSketch:
        """Sliding view: merged sketch of the last ``k`` windows at or
        before ``before`` (default: the newest populated window).  Built by
        merging tumbling sub-windows — the standard sliding-window-over-
        buckets construction, exact because sketches merge losslessly."""
        if not self._windows:
            return QuantileSketch(self.rel_err)
        hi = (max(self._windows) if before is None
              else window_index(before, self.width_s))
        picked = [w.sketch for i, w in sorted(self._windows.items())
                  if hi - k < i <= hi]
        if not picked:
            return QuantileSketch(self.rel_err)
        return QuantileSketch.merged(picked)

    def total(self) -> QuantileSketch:
        return QuantileSketch.merged(
            [w.sketch for w in self.windows()], rel_err=self.rel_err)

    def series(self, q: float = 0.95) -> list[tuple[float, float, int]]:
        """``(window_start_s, quantile_q, count)`` per populated window —
        the per-window TTFT/stall line a dashboard plots."""
        return [(w.start_s, w.sketch.quantile(q), w.count)
                for w in self.windows()]

    # -- merge algebra --------------------------------------------------------
    def merge(self, other: "WindowedSeries") -> "WindowedSeries":
        if other.width_s != self.width_s or other.rel_err != self.rel_err:
            raise ValueError("cannot merge series with different "
                             "width/rel_err")
        for k, w in other._windows.items():
            mine = self._windows.get(k)
            if mine is None:
                fresh = Window(k, self.width_s, QuantileSketch(self.rel_err))
                fresh.sketch.merge(w.sketch)
                self._windows[k] = fresh
            else:
                mine.sketch.merge(w.sketch)
        return self

    def __len__(self) -> int:
        return len(self._windows)


class Ewma:
    """Half-life EWMA over irregularly spaced samples on an injected
    timeline: ``update(t, v)`` decays the running mean by
    ``2^(-(t - t_prev) / half_life)`` before folding ``v`` in.  Samples at
    identical times average with full weight on the newer value's share."""

    def __init__(self, half_life_s: float) -> None:
        if half_life_s <= 0:
            raise ValueError("half_life_s must be positive")
        self.half_life_s = half_life_s
        self._value = math.nan
        self._t = -math.inf

    def update(self, t: float, v: float) -> float:
        if math.isnan(self._value):
            self._value = float(v)
        else:
            dt = max(0.0, t - self._t)
            w = 0.5 ** (dt / self.half_life_s)
            self._value = w * self._value + (1.0 - w) * float(v)
        self._t = max(self._t, t)
        return self._value

    @property
    def value(self) -> float:
        return self._value


def _label(name: str, tenant: str) -> tuple[str, str]:
    return (name, tenant)


class StreamMonitor:
    """The live-metrics sink the simulators and the async engine accept.

    Duck-typed like the tracer (sims never import `repro.obs`): ingest is
    ``observe(name, t, v, tenant="")`` / ``inc(name, t, n=1, tenant="")``
    for free-form series plus ``record_request(t, rec)`` for anything
    shaped like `cluster.metrics.RequestRecord` — which emits the standard
    per-request vocabulary, each both unlabelled (fleet-wide) and under the
    record's tenant:

        ttft_s, queue_s, stall_s, hit_rate, hot_token_rate, wire_bytes

    All ingest is explicit-time; the monitor never reads a clock.
    ``spawn()`` hands a fresh empty monitor with identical configuration —
    the per-node child `FleetSim` creates so nodes sketch independently and
    `merge` rolls them up node-order-invariantly.
    """

    #: metric names record_request emits (the per-request vocabulary)
    REQUEST_METRICS = ("ttft_s", "queue_s", "stall_s", "hit_rate",
                       "hot_token_rate", "wire_bytes")

    def __init__(self, width_s: float = 1.0, rel_err: float = 0.01,
                 max_windows: Optional[int] = None,
                 ewma_half_life_s: Optional[float] = None) -> None:
        self.width_s = width_s
        self.rel_err = rel_err
        self.max_windows = max_windows
        self.ewma_half_life_s = ewma_half_life_s
        self._series: dict[tuple[str, str], WindowedSeries] = {}
        self._ewma: dict[tuple[str, str], Ewma] = {}

    def spawn(self) -> "StreamMonitor":
        return StreamMonitor(self.width_s, self.rel_err, self.max_windows,
                             self.ewma_half_life_s)

    # -- ingest ---------------------------------------------------------------
    def _get(self, name: str, tenant: str) -> WindowedSeries:
        key = _label(name, tenant)
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = WindowedSeries(
                self.width_s, self.rel_err, self.max_windows)
        return s

    def observe(self, name: str, t: float, v: float, tenant: str = "",
                n: int = 1) -> None:
        self._get(name, tenant).observe(t, v, n)
        if self.ewma_half_life_s is not None:
            key = _label(name, tenant)
            e = self._ewma.get(key)
            if e is None:
                e = self._ewma[key] = Ewma(self.ewma_half_life_s)
            e.update(t, v)

    def inc(self, name: str, t: float, n: int = 1, tenant: str = "") -> None:
        """Counter-style ingest: ``n`` unit events in ``t``'s window (the
        per-window count is the counter delta; values are 1.0)."""
        self.observe(name, t, 1.0, tenant=tenant, n=n)

    def record_request(self, t: float, rec) -> None:
        """Ingest one completed request (anything with the
        `RequestRecord` surface) at its completion event time ``t``."""
        tenant = getattr(rec, "tenant", "") or ""
        ctx = max(1, getattr(rec, "context", 1))
        values = (
            ("ttft_s", rec.ttft_s),
            ("queue_s", rec.queue_s),
            ("stall_s", rec.stall_s),
            ("hit_rate", rec.hit_rate),
            ("hot_token_rate", getattr(rec, "hot_tokens", 0) / ctx),
            ("wire_bytes", getattr(rec, "bytes_total", 0.0)),
        )
        for name, v in values:
            if isinstance(v, float) and math.isnan(v):
                continue
            self.observe(name, t, v)
            if tenant:
                self.observe(name, t, v, tenant=tenant)

    # -- queries --------------------------------------------------------------
    def names(self) -> list[tuple[str, str]]:
        return sorted(self._series)

    def tenants(self, name: str) -> list[str]:
        return sorted(t for (n, t) in self._series if n == name and t)

    def series(self, name: str, tenant: str = "") -> WindowedSeries:
        key = _label(name, tenant)
        if key not in self._series:
            raise KeyError(f"no series {name!r} (tenant={tenant!r})")
        return self._series[key]

    def ewma(self, name: str, tenant: str = "") -> float:
        e = self._ewma.get(_label(name, tenant))
        return e.value if e is not None else math.nan

    def snapshot(self) -> dict:
        """Per-(name, tenant) totals plus the per-window series — the live
        dashboard cut, JSON-able."""
        out: dict = {}
        for (name, tenant), s in sorted(self._series.items()):
            key = name if not tenant else f"{name}{{tenant={tenant}}}"
            out[key] = {"total": s.total().snapshot(),
                        "windows": [w.snapshot() for w in s.windows()]}
        return out

    # -- merge algebra --------------------------------------------------------
    def merge(self, other: "StreamMonitor") -> "StreamMonitor":
        if (other.width_s != self.width_s
                or other.rel_err != self.rel_err):
            raise ValueError("cannot merge monitors with different "
                             "width/rel_err")
        for key, s in other._series.items():
            name, tenant = key
            self._get(name, tenant).merge(s)
        return self

    @staticmethod
    def merged(monitors) -> "StreamMonitor":
        """A fresh monitor equal to the merge of ``monitors`` (inputs
        untouched) — the fleet's global rollup."""
        out: Optional[StreamMonitor] = None
        for m in monitors:
            if out is None:
                out = m.spawn()
            out.merge(m)
        return out if out is not None else StreamMonitor()


class MultiMonitor:
    """Fan one ingest stream out to several monitors (e.g. a
    `StreamMonitor` plus an `slo.SLOMonitor`) behind the sims' single
    ``monitor=`` parameter."""

    def __init__(self, monitors) -> None:
        self.monitors = list(monitors)

    def observe(self, name, t, v, tenant: str = "", n: int = 1) -> None:
        for m in self.monitors:
            m.observe(name, t, v, tenant=tenant, n=n)

    def inc(self, name, t, n: int = 1, tenant: str = "") -> None:
        for m in self.monitors:
            m.inc(name, t, n=n, tenant=tenant)

    def record_request(self, t, rec) -> None:
        for m in self.monitors:
            m.record_request(t, rec)

    def spawn(self) -> "MultiMonitor":
        return MultiMonitor([m.spawn() for m in self.monitors])

    def merge(self, other: "MultiMonitor") -> "MultiMonitor":
        for mine, theirs in zip(self.monitors, other.monitors):
            mine.merge(theirs)
        return self
