"""Mergeable quantile sketch with a proven relative rank-error bound.

`metrics.Histogram`'s first-N reservoir is deterministic but *warm-up
biased*: once ``max_samples`` observations land, every later sample is
dropped, so a long run's percentiles describe only its first minutes.  The
fix is the standard streaming answer (DDSketch, arXiv:1908.10693 — the
sketch LMCache-class production caches ship for live latency telemetry):
log-spaced buckets with a guaranteed *relative* error.

Bucket rule: a value ``v > 0`` lands in bucket ``i = ceil(log_gamma(v))``
with ``gamma = (1 + alpha) / (1 - alpha)``, i.e. bucket i covers
``(gamma^(i-1), gamma^i]``.  Reporting the bucket midpoint
``2 * gamma^(i-1) / (1 + 1/gamma)`` keeps every point of the bucket within
``alpha`` relative distance of the estimate, so for any quantile q:

    |q_est - q_true| <= alpha * q_true

where ``q_true`` is the exact nearest-rank order statistic (the same
ceil(q*n)-th definition as `cluster.metrics.percentile`) — the property
tests check exactly this inequality against exact percentiles on >= 10k
sample runs.

The sketch is **deterministic by construction** (no reservoir sampling:
the bucket of a value depends only on the value) and **mergeable**:
`merge` adds bucket counts, which is associative and commutative, so fleet
nodes can sketch locally and roll up in any order to the byte-identical
global sketch — the node-order-invariance the fleet rollup tests pin.

Values <= 0 are clamped into a dedicated zero bucket (latencies are
non-negative; an exact-zero observation stays exactly representable).
"""
from __future__ import annotations

import math
from typing import Iterable, Optional


class QuantileSketch:
    """DDSketch-style relative-error quantile sketch.

    ``rel_err`` is alpha, the guaranteed relative rank-error bound.
    ``min_value`` floors the resolvable magnitude: anything in
    ``[0, min_value)`` counts as zero (default 1 ns — far below any
    latency this repo measures).
    """

    def __init__(self, rel_err: float = 0.01,
                 min_value: float = 1e-9) -> None:
        if not 0.0 < rel_err < 1.0:
            raise ValueError(f"rel_err must be in (0, 1), got {rel_err}")
        self.rel_err = rel_err
        self.min_value = min_value
        self.gamma = (1.0 + rel_err) / (1.0 - rel_err)
        self._log_gamma = math.log(self.gamma)
        self._buckets: dict[int, int] = {}
        self._zero = 0
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    # -- ingest ---------------------------------------------------------------
    def _key(self, v: float) -> int:
        # ceil(log_gamma(v)) with an epsilon so exact powers of gamma land in
        # their own bucket despite float log noise
        return math.ceil(math.log(v) / self._log_gamma - 1e-12)

    def add(self, v: float, n: int = 1) -> None:
        if n <= 0:
            return
        self._count += n
        self._sum += v * n
        self._min = min(self._min, v)
        self._max = max(self._max, v)
        if v < self.min_value:  # zero (and any negative noise) bucket
            self._zero += n
            return
        k = self._key(v)
        self._buckets[k] = self._buckets.get(k, 0) + n

    # -- merge algebra --------------------------------------------------------
    def _check_compatible(self, other: "QuantileSketch") -> None:
        if (other.rel_err != self.rel_err
                or other.min_value != self.min_value):
            raise ValueError(
                f"cannot merge sketches with different parameters: "
                f"({self.rel_err}, {self.min_value}) vs "
                f"({other.rel_err}, {other.min_value})")

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Fold ``other`` into self (bucket-wise add); returns self.

        Merging is associative and commutative — `merge` over any
        permutation / parenthesisation of the same sketch set yields
        identical buckets, hence identical quantiles.
        """
        self._check_compatible(other)
        for k, n in other._buckets.items():
            self._buckets[k] = self._buckets.get(k, 0) + n
        self._zero += other._zero
        self._count += other._count
        self._sum += other._sum
        self._min = min(self._min, other._min)
        self._max = max(self._max, other._max)
        return self

    @staticmethod
    def merged(sketches: Iterable["QuantileSketch"],
               rel_err: Optional[float] = None) -> "QuantileSketch":
        """A fresh sketch equal to the merge of ``sketches`` (inputs
        untouched)."""
        out: Optional[QuantileSketch] = None
        for s in sketches:
            if out is None:
                out = QuantileSketch(s.rel_err, s.min_value)
            out.merge(s)
        if out is None:
            out = QuantileSketch(rel_err if rel_err is not None else 0.01)
        return out

    # -- queries --------------------------------------------------------------
    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def min(self) -> float:
        return self._min if self._count else math.nan

    @property
    def max(self) -> float:
        return self._max if self._count else math.nan

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else math.nan

    def _bucket_value(self, k: int) -> float:
        # midpoint of (gamma^(k-1), gamma^k]: 2*gamma^k / (gamma + 1)
        return 2.0 * self.gamma ** k / (self.gamma + 1.0)

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile estimate: the bucket holding the
        ceil(q*n)-th smallest observation, reported at its midpoint (and
        clamped to the observed [min, max] so the estimate never leaves the
        data's range)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self._count == 0:
            return math.nan
        rank = max(1, math.ceil(q * self._count))
        if rank <= self._zero:
            return 0.0
        seen = self._zero
        for k in sorted(self._buckets):
            seen += self._buckets[k]
            if seen >= rank:
                return min(max(self._bucket_value(k), self._min), self._max)
        return self._max  # unreachable unless counts drifted; be safe

    def snapshot(self) -> dict:
        """The same summary shape `metrics.Histogram._peek` reports."""
        if self._count == 0:
            return {"count": 0, "sum": 0.0, "mean": math.nan,
                    "min": math.nan, "max": math.nan, "p50": math.nan,
                    "p95": math.nan, "p99": math.nan}
        return {"count": self._count, "sum": self._sum, "mean": self.mean,
                "min": self._min, "max": self._max,
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}

    # -- serialisation (BENCH files, fleet rollup over the wire) --------------
    def to_dict(self) -> dict:
        return {"rel_err": self.rel_err, "min_value": self.min_value,
                "zero": self._zero, "count": self._count, "sum": self._sum,
                "min": self._min if self._count else None,
                "max": self._max if self._count else None,
                "buckets": {str(k): n
                            for k, n in sorted(self._buckets.items())}}

    @classmethod
    def from_dict(cls, d: dict) -> "QuantileSketch":
        s = cls(d["rel_err"], d["min_value"])
        s._zero = d["zero"]
        s._count = d["count"]
        s._sum = d["sum"]
        s._min = d["min"] if d["min"] is not None else math.inf
        s._max = d["max"] if d["max"] is not None else -math.inf
        s._buckets = {int(k): n for k, n in d["buckets"].items()}
        return s

    def __eq__(self, other) -> bool:
        if not isinstance(other, QuantileSketch):
            return NotImplemented
        return (self.rel_err == other.rel_err
                and self.min_value == other.min_value
                and self._zero == other._zero
                and self._count == other._count
                and self._buckets == other._buckets)

    def __len__(self) -> int:
        return self._count

    def __repr__(self) -> str:
        return (f"QuantileSketch(rel_err={self.rel_err}, n={self._count}, "
                f"buckets={len(self._buckets)})")
