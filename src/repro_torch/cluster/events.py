"""Deterministic discrete-event queue for the cluster simulator.

Event vocabulary (DESIGN.md §Cluster-sim):

    ARRIVE        a request enters the system (trace-driven)
    WIRE          internal pacing event: a flow's next per-layer wire
                  threshold is predicted to cross (re-predicted on REALLOC)
    LAYER_READY   layer ``l`` of a flow finished the 3-stage pipeline and is
                  consumable by the GPU
    FLOW_DONE     a flow's last wire byte landed; its bandwidth returns to
                  the pool at the next reallocation
    PREFILL_DONE  the request's last layer finished computing (first token)
    REALLOC       rate re-allocation point (epoch cadence in epoch mode)

Determinism contract: the queue orders by ``(time, seq)`` where ``seq`` is
the monotone push counter — same-time events fire in push order, so a given
trace and seed always replays the exact same schedule.  Predicted events that
a rate change invalidates are not removed from the heap; they carry a per-flow
``version`` and are dropped as stale on pop (classic lazy invalidation).
"""
from __future__ import annotations

import dataclasses
import enum
import heapq
from typing import Any, Optional


class EventKind(enum.Enum):
    ARRIVE = "arrive"
    WIRE = "wire"
    LAYER_READY = "layer_ready"
    FLOW_DONE = "flow_done"
    PREFILL_DONE = "prefill_done"
    REALLOC = "realloc"


@dataclasses.dataclass(frozen=True)
class Event:
    time: float
    kind: EventKind
    req_id: Optional[str] = None
    layer: int = -1
    version: int = 0  # flow-state version this prediction was made under
    payload: Any = None


class EventQueue:
    """Min-heap of events keyed (time, seq) — deterministic pop order."""

    def __init__(self) -> None:
        self._heap: list[tuple[float, int, Event]] = []
        self._seq = 0
        self.pushed = 0
        self.popped = 0

    def push(self, event: Event) -> None:
        heapq.heappush(self._heap, (event.time, self._seq, event))
        self._seq += 1
        self.pushed += 1

    def pop(self) -> Event:
        _, _, ev = heapq.heappop(self._heap)
        self.popped += 1
        return ev

    def peek_time(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
