"""The paced store: reads no faster than the link, host work slower than
the link not slowed."""
import time

from ocbench import store as store_mod
from ocbench.store import PacedStore
from repro_torch.core.object_store import InMemoryStore


def test_a_read_takes_its_bytes_over_the_link():
    store = PacedStore(gbps=100)
    store.put(b"k", bytes(125_000_000))
    t0 = time.perf_counter()
    data = store.get(b"k")
    assert len(data) == 125_000_000
    assert time.perf_counter() - t0 >= 0.010  # 125 MB at 12.5 GB/s
    t0 = time.perf_counter()
    for i in range(10):
        store.range_get(b"k", i * 1_250_000, 1_250_000)
    assert time.perf_counter() - t0 >= 0.001  # 12.5 MB


def test_host_work_slower_than_the_link_is_not_slowed(monkeypatch):
    store = PacedStore(gbps=100)
    store.put(b"k", bytes(1_000_000))  # 80 us on the link
    real = InMemoryStore.range_get

    def slow(self, key, offset, length):  # 20 ms of host work
        t = time.perf_counter() + 0.02
        while time.perf_counter() < t:
            pass
        return real(self, key, offset, length)
    monkeypatch.setattr(InMemoryStore, "range_get", slow)
    ahead = []  # how far each pace's deadline lay ahead of the clock

    def record(t):
        ahead.append(t - time.perf_counter())
    monkeypatch.setattr(store_mod, "wait_until", record)
    store.range_get(b"k", 0, 1_000_000)
    assert len(ahead) == 1 and ahead[0] <= 0  # the link finished first


def test_idle_link_time_is_not_banked():
    store = PacedStore(gbps=100)
    store.put(b"k", bytes(12_500_000))  # 1 ms on the link
    store.get(b"k")
    time.sleep(0.01)  # the link idles
    t0 = time.perf_counter()
    store.get(b"k")
    assert time.perf_counter() - t0 >= 0.001
