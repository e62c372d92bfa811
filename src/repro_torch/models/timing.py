"""Device-timed regions inside one model step, for the serving engine's
tracer.

Model code marks a stretch of its work with ``with region(name,
**counters)``.  That records nothing unless the engine has opened a
`Recorder` around the step, which it does only when it has a tracer.  On a
CUDA device a region is a pair of CUDA events, read after the step's own
synchronisation, so the timing adds no wait; on the CPU, where an operation
has finished when it returns, it is the host's clock.
"""
from __future__ import annotations

import contextlib
import contextvars
import time

import torch

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("regions",
                                                         default=None)


@contextlib.contextmanager
def region(name: str, **counters):
    """Time the enclosed device work as ``name`` in the open `Recorder`,
    if there is one."""
    rec = _ACTIVE.get()
    if rec is None:
        yield
        return
    start = rec.stamp()
    yield
    rec.marks.append((name, start, rec.stamp(), counters))


class Recorder:
    """The regions of the steps run inside ``with Recorder(device):``."""

    def __init__(self, device: torch.device) -> None:
        self.cuda = torch.device(device).type == "cuda"
        self.marks: list = []

    def stamp(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def __enter__(self) -> "Recorder":
        self._token = _ACTIVE.set(self)
        # the host time of an origin on the device: the engine opens a
        # recorder on an idle device (after the previous step's sync), so
        # the origin event runs as it is recorded
        self._origin = self.stamp()
        self._t_origin = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.reset(self._token)

    def regions(self) -> list[tuple[str, float, float, dict]]:
        """(name, start, end, counters) of each region on the host's
        clock; on a card only once the device has finished the step."""
        if not self.cuda:
            return list(self.marks)

        def host(ev):
            return self._t_origin + self._origin.elapsed_time(ev) / 1e3
        return [(name, host(a), host(b), c) for name, a, b, c in self.marks]
