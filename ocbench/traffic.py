"""The one traffic generator: reads a mix file (``traffic/<mix>.json``) and
gives the schedule of requests and their tokens.

A mix is a population of shared prefixes (``prefixes`` of them, lengths
log-uniform in ``prefix_tokens`` and rounded to ``prefix_multiple``,
popularity Zipf(``prefix_alpha``)) and a distinct suffix per request
(log-uniform in ``suffix_tokens``); ``prefixes: 0`` gives prompts that share
nothing.  Arrivals are Poisson at ``rate_rps``.

The schedule (prefix lengths, each request's due time, prefix and suffix
length) comes from the mix's ``schedule_seed`` and is the same for every run:
every seed gets the same work, and only the tokens (and the weights) come
from the run's seed.  A shorter window is a prefix of a longer one, and a
rate only scales the gaps.
"""
from __future__ import annotations

import bisect
import dataclasses
import itertools
import math
import random

import numpy as np


class ZipfSampler:
    """Zipf(alpha) over ranks 0..n-1: P(rank k) proportional to
    1/(k+1)^alpha (a frozen copy of the program's ``fleet.workload``
    sampler)."""

    def __init__(self, n: int, alpha: float) -> None:
        if n <= 0:
            raise ValueError("need a positive population")
        weights = [1.0 / (k + 1) ** alpha for k in range(n)]
        total = sum(weights)
        self._cdf = list(itertools.accumulate(w / total for w in weights))
        self._cdf[-1] = 1.0

    def sample(self, rng: random.Random) -> int:
        return bisect.bisect_left(self._cdf, rng.random())


def _log_uniform(rng: random.Random, lo: float, hi: float) -> float:
    return math.exp(rng.uniform(math.log(lo), math.log(hi)))


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    due_s: float  # from the window's start
    prefix: int  # index into the prefix population, -1 for none
    prefix_len: int
    suffix_len: int

    @property
    def prompt_len(self) -> int:
        return self.prefix_len + self.suffix_len


def prefix_lengths(mix: dict) -> list[int]:
    rng = random.Random(mix["schedule_seed"])
    m = mix.get("prefix_multiple", 1)
    lo, hi = mix.get("prefix_tokens", (0, 0))
    return [max(m, int(round(_log_uniform(rng, lo, hi) / m)) * m)
            for _ in range(mix["prefixes"])]


def schedule(mix: dict, seconds: float, rate_rps: float | None = None
             ) -> list[Request]:
    """The requests due in ``[0, seconds)`` at ``rate_rps`` (the mix's rate
    by default)."""
    rate = mix["rate_rps"] if rate_rps is None else rate_rps
    lens = prefix_lengths(mix)
    # a stream of its own, so the prefix lengths do not shift the requests
    rng = random.Random(mix["schedule_seed"] + 1)
    zipf = ZipfSampler(len(lens), mix["prefix_alpha"]) if lens else None
    lo, hi = mix["suffix_tokens"]
    out, t = [], 0.0
    while True:
        t += rng.expovariate(1.0) / rate
        pid = zipf.sample(rng) if zipf else -1
        s = int(round(_log_uniform(rng, lo, hi)))
        if t >= seconds:
            return out
        out.append(Request(len(out), t, pid, lens[pid] if pid >= 0 else 0,
                           s))


def warmup_requests(mix: dict) -> list[Request]:
    """Three requests of the mix's own shapes: the longest prefix with the
    longest suffix, the shortest with the shortest, and one between."""
    lens = prefix_lengths(mix)
    lo, hi = mix["suffix_tokens"]
    mid = int(round(math.sqrt(lo * hi)))
    if not lens:
        return [Request(i, 0.0, -1, 0, s) for i, s in enumerate((hi, lo, mid))]
    order = sorted(range(len(lens)), key=lens.__getitem__)
    picks = (order[-1], order[0], order[len(order) // 2])
    return [Request(i, 0.0, p, lens[p], s)
            for i, (p, s) in enumerate(zip(picks, (hi, lo, mid)))]


class Tokens:
    """Token ids from the run's seed: each prefix's, then each request's
    suffix in schedule order; warm-up suffixes from a stream of their
    own."""

    def __init__(self, mix: dict, seed: int, vocab: int) -> None:
        rng = np.random.default_rng(seed)
        self.prefixes = [rng.integers(0, vocab, n, dtype=np.int64)
                         for n in prefix_lengths(mix)]
        self._rng = rng
        self._warm_rng = np.random.default_rng([seed, 1])
        self._suffixes: list[np.ndarray] = []
        self.vocab = vocab

    def _prompt(self, req: Request, suffix: np.ndarray) -> np.ndarray:
        if req.prefix < 0:
            return suffix
        return np.concatenate([self.prefixes[req.prefix], suffix])

    def prompt(self, req: Request) -> np.ndarray:
        """The prompt of schedule request ``req`` (after `draw`)."""
        return self._prompt(req, self._suffixes[req.index])

    def draw(self, reqs: list[Request]) -> None:
        """Suffixes of ``reqs`` (a schedule), in order."""
        self._suffixes = [self._rng.integers(0, self.vocab, r.suffix_len,
                                             dtype=np.int64) for r in reqs]

    def warm_prompt(self, req: Request) -> np.ndarray:
        return self._prompt(req, self._warm_rng.integers(
            0, self.vocab, req.suffix_len, dtype=np.int64))
