"""Deterministic synthetic LM data pipeline.

Sequences follow a per-sequence affine recurrence t_{i+1} = (a*t_i + c) mod V'
over a reduced vocabulary — learnable in a few hundred steps, fully
reproducible, and sharded per host (each host materialises only its slice of
the global batch, the multi-pod input pattern).  Background prefetch keeps the
host busy while the device steps.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np


class SyntheticLM:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 *, host_id: int = 0, num_hosts: int = 1, seed: int = 0,
                 vocab_cap: int = 997, prefetch: int = 2) -> None:
        assert global_batch % num_hosts == 0
        self.vocab = min(vocab_size, vocab_cap)
        self.seq_len = seq_len
        self.host_batch = global_batch // num_hosts
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.seed = seed
        self.prefetch = prefetch
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- deterministic batch at a given step (restart-safe data order) --------
    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            (self.seed, step, self.host_id, self.num_hosts))
        B, S = self.host_batch, self.seq_len
        a = rng.integers(1, 31, size=(B, 1))
        c = rng.integers(0, self.vocab, size=(B, 1))
        t0 = rng.integers(0, self.vocab, size=(B, 1))
        seq = np.empty((B, S + 1), np.int32)
        seq[:, 0:1] = t0
        for i in range(S):
            seq[:, i + 1:i + 2] = (a * seq[:, i:i + 1] + c) % self.vocab
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}

    # -- prefetching iterator --------------------------------------------------
    def __iter__(self) -> Iterator[dict]:
        return self.iterate(0)

    def iterate(self, start_step: int) -> Iterator[dict]:
        self._q = queue.Queue(maxsize=self.prefetch)
        self._stop.clear()

        def producer():
            s = start_step
            while not self._stop.is_set():
                try:
                    self._q.put(self.batch_at(s), timeout=0.2)
                    s += 1
                except queue.Full:
                    continue

        self._thread = threading.Thread(target=producer, daemon=True)
        self._thread.start()
        try:
            while True:
                yield self._q.get()
        finally:
            self._stop.set()

    def close(self):
        self._stop.set()
