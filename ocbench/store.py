"""The object store the benchmark serves: in memory, read over a paced link.

An in-memory store moves no byte over a wire, so the overlap of a layerwise
fetch with compute would have nothing to hide.  `PacedStore` delivers reads
no faster than a link of ``gbps``: a read completes no earlier than the time
the link is free plus its bytes over the rate, and it waits only when that
time is still ahead once the read's own host work is done.  Host work slower
than the link is not slowed.  Writes are not paced (the commit is
write-behind in a deployment).
"""
from __future__ import annotations

import time

from repro_torch.core.object_store import InMemoryStore


def wait_until(t: float) -> None:
    """Return at ``time.perf_counter() >= t``: a sleep for the bulk, a spin
    for the last half millisecond (a sleep overshoots by tens of us, which
    would be lost link time on every read)."""
    while True:
        rem = t - time.perf_counter()
        if rem <= 0:
            return
        if rem > 1e-3:
            time.sleep(rem - 5e-4)


class PacedStore(InMemoryStore):
    def __init__(self, gbps: float) -> None:
        super().__init__()
        self.bytes_per_s = gbps * 1e9 / 8
        self._link_free = 0.0

    def _pace(self, nbytes: int, t0: float) -> None:
        with self._lock:
            done = max(self._link_free, t0) + nbytes / self.bytes_per_s
            self._link_free = done
        wait_until(done)

    def get(self, key: bytes) -> bytes:
        t0 = time.perf_counter()
        data = super().get(key)
        self._pace(len(data), t0)
        return data

    def range_get(self, key: bytes, offset: int, length: int) -> bytes:
        t0 = time.perf_counter()
        data = super().range_get(key, offset, length)
        self._pace(len(data), t0)
        return data
