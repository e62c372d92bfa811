"""The traced run's reduction of a torch.profiler record: device activity on
the host's clock, the device's busy time, and the breakdown (the device
operations that took most time; idle time by what the host was doing)."""
from __future__ import annotations

import collections
import time

import numpy as np
import torch

MARK = "ocbench.clock"


class Profile:
    """torch.profiler over a stretch of the window (`start` .. `stop`).

    ``device`` holds (name, t0, t1) of every operation that ran on the
    device (kernels, copies, sets), on the host's ``perf_counter`` clock:
    the profiler's clock is tied to it by a marker recorded at the start."""

    def __init__(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self.t0 = self.t1 = 0.0
        self.running = False
        self.device: list[tuple[str, float, float]] = []

    def start(self) -> None:
        self._prof.start()
        self.running = True
        with torch.profiler.record_function(MARK):
            self._mark = time.perf_counter()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self.t1 = time.perf_counter()
        self._prof.stop()
        self.running = False

    def reduce(self, trace_path=None) -> None:
        """Read the device operations out of the record (after `stop`);
        write the chrome trace to ``trace_path`` if given."""
        events = self._prof.events()
        mark = next(e for e in events if e.name == MARK)
        off = mark.time_range.start / 1e6 - self._mark
        self.device = sorted(
            (e.name, e.time_range.start / 1e6 - off,
             e.time_range.end / 1e6 - off)
            for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA)
        if trace_path is not None:
            trace_path.parent.mkdir(parents=True, exist_ok=True)
            self._prof.export_chrome_trace(str(trace_path))


def busy_intervals(ops, t0: float, t1: float) -> list[tuple[float, float]]:
    """The union of the operations' intervals, clipped to [t0, t1]."""
    out: list[list[float]] = []
    for _, a, b in sorted(ops, key=lambda o: o[1]):
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_s(ops, t0: float, t1: float) -> float:
    return sum(b - a for a, b in busy_intervals(ops, t0, t1))


def idle_gaps(ops, t0: float, t1: float) -> list[tuple[float, float]]:
    gaps, t = [], t0
    for a, b in busy_intervals(ops, t0, t1):
        if a > t:
            gaps.append((t, a))
        t = b
    if t < t1:
        gaps.append((t, t1))
    return gaps


def top_device_ops(ops, n: int = 10) -> list[list]:
    total: dict[str, float] = collections.defaultdict(float)
    for name, a, b in ops:
        total[name] += b - a
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])
            [:n]]


def _union(spans) -> list[tuple[float, float]]:
    return busy_intervals([("", a, b) for a, b in spans], -np.inf, np.inf)


def _subtract(pieces, spans):
    """Sorted disjoint ``pieces`` less sorted disjoint ``spans``."""
    rest, j = [], 0
    for a, b in pieces:
        while j < len(spans) and spans[j][1] <= a:
            j += 1
        t, k = a, j
        while k < len(spans) and spans[k][0] < b:
            x, y = spans[k]
            if x > t:
                rest.append((t, x))
            t = max(t, y)
            k += 1
        if t < b:
            rest.append((t, b))
    return rest


def idle_by_host(gaps, labelled, n: int = 10) -> list[list]:
    """Idle seconds of the device by the host span that covered them.

    ``labelled`` is a list of (label, [(t0, t1), ...]) in priority order:
    an idle moment goes to the first label whose spans cover it, and to
    "other" if none does."""
    pieces = list(gaps)
    out: dict[str, float] = {}
    for label, spans in labelled:
        rest = _subtract(pieces, _union(spans))
        got = sum(b - a for a, b in pieces) - sum(b - a for a, b in rest)
        if got > 0:
            out[label] = out.get(label, 0.0) + got
        pieces = rest
    other = sum(b - a for a, b in pieces)
    if other > 0:
        out["other"] = other
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])
            [:n]]
