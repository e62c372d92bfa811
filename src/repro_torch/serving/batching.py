"""Slot-based continuous batching for decode (port of the reference's
``serving/batching.py``).

A fixed-slot batch (the production pattern: decode runs at one shape for the
slot count) with per-slot positions: requests enter a free slot after
prefill, emit one token per engine step, and leave on EOS/length, freeing
the slot for the next queued request mid-flight — no global drain between
batches.  The batch's cache is one [L, 2, num_slots, max_seq, KV, dh] tensor
on the model's device; each decode step writes the new K/V into it in place
(`layers.decode_attention`).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.models import Model


@dataclasses.dataclass
class SlotRequest:
    req_id: str
    prompt_len: int
    max_new_tokens: int
    tokens_out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    """Decode across ``num_slots`` concurrent requests with one step."""

    def __init__(self, model: Model, params, num_slots: int, max_seq: int,
                 eos_id: Optional[int] = None) -> None:
        self.model = model
        self.params = params
        self.cfg = model.cfg
        self.device = model.device
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.eos_id = eos_id  # None => no EOS convention (length-only exit)
        self.cache = model.init_cache(num_slots, max_seq)
        self.pos = np.zeros((num_slots,), np.int32)
        self.cur = np.zeros((num_slots,), np.int32)
        self.active: list[Optional[SlotRequest]] = [None] * num_slots
        self.queue: deque = deque()
        self.steps = 0

    # ------------------------------------------------------------------
    def enqueue(self, req: SlotRequest, slot_cache, first_token: int) -> None:
        """``slot_cache``: per-request cache from prefill ([L,2,1,S,KV,dh]
        tensor); copied into a free slot (queued if none free)."""
        self.queue.append((req, slot_cache, first_token))
        self._admit()

    def _admit(self) -> None:
        while self.queue and None in self.active:
            slot = self.active.index(None)
            req, slot_cache, first = self.queue.popleft()
            # dense-family KV caches: [L, 2, B, S, KV, dh]
            S = slot_cache.shape[3]
            self.cache[:, :, slot, :S] = slot_cache[:, :, 0].to(
                self.cache.dtype)
            self.pos[slot] = req.prompt_len
            self.cur[slot] = first
            req.tokens_out.append(first)
            self.active[slot] = req

    # ------------------------------------------------------------------
    def step(self) -> list[SlotRequest]:
        """One decode step across all occupied slots; returns finished reqs."""
        if not any(self.active):
            return []
        # an empty slot decodes a dummy token at position 0 and its output is
        # dropped: its stale position may be max_seq (it left on the length
        # rule), one past the cache, where the in-place K/V write cannot go
        live = np.array([r is not None for r in self.active])
        tok = torch.as_tensor(self.cur[:, None].astype(np.int64),
                              device=self.device)
        pos = torch.as_tensor(np.where(live, self.pos, 0).astype(np.int64),
                              device=self.device)
        lg, self.cache = self.model.decode_step(self.params, self.cache, tok,
                                                pos)
        lg = lg.float().cpu().numpy()[:, :self.cfg.vocab_size]
        nxt = lg.argmax(-1).astype(np.int32)
        finished = []
        for s, req in enumerate(self.active):
            if req is None:
                continue
            self.pos[s] += 1
            self.cur[s] = nxt[s]
            req.tokens_out.append(int(nxt[s]))
            # Exit on EOS or length.  The length bound compares the *next*
            # decode's write position against the cache: position `pos` is
            # writable while pos < max_seq, so the last cache slot
            # (max_seq - 1) stays usable — `pos + 1 >= max_seq` here would
            # retire the slot one token early.
            if (len(req.tokens_out) >= req.max_new_tokens
                    or (self.eos_id is not None and int(nxt[s]) == self.eos_id)
                    or self.pos[s] >= self.max_seq):
                req.done = True
                finished.append(req)
                self.active[s] = None
        self.steps += 1
        self._admit()
        return finished

    def drain(self, max_steps: int = 10_000) -> list[SlotRequest]:
        done = []
        for _ in range(max_steps):
            done += self.step()
            if not any(self.active) and not self.queue:
                break
        return done
