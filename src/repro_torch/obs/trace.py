"""Deterministic tracing: nested spans and instant events on named tracks.

The paper's headline numbers are *attribution* claims (5.6 % added TTFT at
64K, 56-75 ms fixed cost at 4K, 1.2-1.8x scheduler wins), which are only
checkable if a request can be decomposed into queue / fetch / stall /
dequant / compute intervals.  This module is the recording substrate every
serving layer shares (DESIGN.md §Observability):

* A `Tracer` is a flat, append-only list of `Span` / `Instant` records.
  Each record lives on a *track* (one per request, pool, node, ...) and is
  stamped from an **injected clock** — the cluster simulator passes its
  event clock, the serving engine a wall clock — so a simulated trace is
  bit-reproducible: same trace in, same timestamps out, byte-identical
  export.  The tracer itself never reads wall time.
* Instrumentation sites hold a *nullable* tracer (`self.tracer` is
  ``None`` by default) and guard every emission with ``if tracer is not
  None`` — the uninstrumented hot path costs one attribute test.
* Span nesting is by interval containment per track (`span_tree`), not by
  emission order: a discrete-event simulator emits spans for interleaved
  requests out of order, and containment is the only nesting that survives
  that.  The clock-scoped :meth:`Tracer.span` context manager is sugar for
  callers whose spans do nest in real time.

Emission order is preserved via a per-record ``seq`` so exports are stable
even among equal timestamps (the same (time, seq) discipline as
`cluster.events.EventQueue`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Iterator, Optional, Union


@dataclasses.dataclass(frozen=True)
class Span:
    """A closed interval ``[t0, t1]`` on ``track`` (absolute seconds)."""

    track: str
    name: str
    t0: float
    t1: float
    cat: str = ""
    args: dict = dataclasses.field(default_factory=dict)
    seq: int = 0

    @property
    def dur_s(self) -> float:
        return self.t1 - self.t0

    def contains(self, other: "Span") -> bool:
        return self.t0 <= other.t0 and other.t1 <= self.t1 \
            and (self.t0, self.t1) != (other.t0, other.t1)


@dataclasses.dataclass(frozen=True)
class Instant:
    """A point event at ``t`` on ``track``."""

    track: str
    name: str
    t: float
    cat: str = ""
    args: dict = dataclasses.field(default_factory=dict)
    seq: int = 0


Record = Union[Span, Instant]


@dataclasses.dataclass
class SpanNode:
    """One node of a containment-nested span tree."""

    span: Span
    children: list["SpanNode"] = dataclasses.field(default_factory=list)

    def walk(self, depth: int = 0) -> Iterator[tuple[int, Span]]:
        yield depth, self.span
        for c in self.children:
            yield from c.walk(depth + 1)


class Tracer:
    """Append-only span/instant recorder stamped from an injected clock.

    ``clock`` is any object with ``now() -> float`` (`VirtualClock`,
    `WallClock`) or a bare callable; it is consulted only by the
    clock-scoped conveniences (:meth:`span`, :meth:`instant` without an
    explicit ``t``).  Explicit-timestamp emission (:meth:`span_at`,
    :meth:`instant` with ``t=``) never touches the clock, which is what
    keeps simulator instrumentation purely observational.
    """

    def __init__(self, clock: Optional[object] = None) -> None:
        if clock is None:
            clock = time.perf_counter
        self._now: Callable[[], float] = (
            clock if callable(clock) else clock.now)
        self.records: list[Record] = []
        self._seq = 0

    # -- emission -------------------------------------------------------------
    def _next_seq(self) -> int:
        s = self._seq
        self._seq += 1
        return s

    def span_at(self, track: str, name: str, t0: float, t1: float,
                cat: str = "", **args: Any) -> Span:
        """Record a completed span with explicit timestamps."""
        rec = Span(track, name, t0, t1, cat, args, self._next_seq())
        self.records.append(rec)
        return rec

    def instant(self, track: str, name: str, t: Optional[float] = None,
                cat: str = "", **args: Any) -> Instant:
        """Record a point event (at the clock's now() when ``t`` is None)."""
        rec = Instant(track, name, self._now() if t is None else t,
                      cat, args, self._next_seq())
        self.records.append(rec)
        return rec

    @contextlib.contextmanager
    def span(self, track: str, name: str, cat: str = "",
             **args: Any) -> Iterator[dict]:
        """Clock-scoped span: ``with tracer.span("req", "plan"): ...``.

        Yields the args dict so the body can attach results
        (``a["chunks"] = n``) that land on the recorded span.
        """
        t0 = self._now()
        try:
            yield args
        finally:
            self.span_at(track, name, t0, self._now(), cat, **args)

    # -- queries --------------------------------------------------------------
    def tracks(self) -> list[str]:
        seen: dict[str, None] = {}
        for r in self.records:
            seen.setdefault(r.track)
        return list(seen)

    def spans(self, track: Optional[str] = None,
              name: Optional[str] = None) -> list[Span]:
        return [r for r in self.records if isinstance(r, Span)
                and (track is None or r.track == track)
                and (name is None or r.name == name)]

    def instants(self, track: Optional[str] = None,
                 name: Optional[str] = None) -> list[Instant]:
        return [r for r in self.records if isinstance(r, Instant)
                and (track is None or r.track == track)
                and (name is None or r.name == name)]

    def span_tree(self, track: str) -> list[SpanNode]:
        """Containment-nested forest of the track's spans.

        Spans are sorted by ``(t0, -dur, seq)``; each span becomes a child
        of the innermost earlier span that strictly contains it.  Identical
        intervals nest by emission order (first recorded = parent).
        """
        spans = sorted(self.spans(track),
                       key=lambda s: (s.t0, -(s.t1 - s.t0), s.seq))
        roots: list[SpanNode] = []
        stack: list[SpanNode] = []
        for s in spans:
            node = SpanNode(s)
            while stack and not (stack[-1].span.contains(s)
                                 or (stack[-1].span.t0 <= s.t0
                                     and s.t1 <= stack[-1].span.t1)):
                stack.pop()
            if stack:
                stack[-1].children.append(node)
            else:
                roots.append(node)
            stack.append(node)
        return roots

    def clear(self) -> None:
        self.records.clear()
        self._seq = 0

    def __len__(self) -> int:
        return len(self.records)
