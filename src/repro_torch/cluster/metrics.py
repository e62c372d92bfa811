"""Per-request records and cluster-level summary metrics.

TTFT percentiles use the deterministic nearest-rank definition (ceil(q*n)-th
order statistic) so a given record set always summarises to the same numbers
— no interpolation-mode ambiguity across numpy versions.

Fleet additions (DESIGN.md §Fleet): records carry the owning tenant, the
serving node, and the hot-tier token split, so `summarize` rolls up object-
storage egress and hot-serving rates and `per_tenant` breaks any record set
into per-tenant `ClusterMetrics` — the isolation view a multi-tenant cache
economy is judged on.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Sequence


@dataclasses.dataclass
class RequestRecord:
    """One request's life through the simulator (all times absolute sim
    seconds; durations derived)."""

    req_id: str
    context: int
    hit_rate: float
    arrival_s: float
    admit_s: float = math.nan  # left the admission queue / joined the pool
    flow_done_s: float = math.nan  # last wire byte landed
    prefill_done_s: float = math.nan  # first token
    layer_compute_s: float = 0.0  # per-layer window actually served (post-replan)
    num_layers: int = 0
    bytes_total: float = 0.0  # wire bytes actually fetched (post-replan)
    replanned: bool = False
    tenant: str = ""  # owning tenant ("" outside multi-tenant traces)
    node: int = -1  # serving node index (-1 outside fleet runs)
    hot_tokens: int = 0  # matched tokens served from the node hot tier

    @property
    def done(self) -> bool:
        return not math.isnan(self.prefill_done_s)

    @property
    def ttft_s(self) -> float:
        return self.prefill_done_s - self.arrival_s

    @property
    def queue_s(self) -> float:
        return self.admit_s - self.arrival_s

    @property
    def stall_s(self) -> float:
        """GPU-visible wait after admission: everything that is not compute
        (admission->first-layer latency plus per-layer pipeline stalls)."""
        return (self.prefill_done_s - self.admit_s
                - self.num_layers * self.layer_compute_s)

    @property
    def cached_tokens(self) -> int:
        return int(self.context * self.hit_rate + 1e-9)


def percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile: the ceil(q*n)-th smallest value."""
    if not xs:
        return math.nan
    s = sorted(xs)
    k = max(1, math.ceil(q * len(s)))
    return s[k - 1]


@dataclasses.dataclass(frozen=True)
class ClusterMetrics:
    n: int
    ttft_p50_s: float
    ttft_p95_s: float
    ttft_p99_s: float
    ttft_mean_s: float
    total_ttft_s: float
    added_ttft_total_s: float  # vs the supplied per-request baseline
    queue_total_s: float
    stall_total_s: float
    goodput_rps: float  # completed requests / makespan (NaN when undefined)
    makespan_s: float
    replanned: int
    egress_bytes: float = 0.0  # wire bytes fetched from object storage
    hot_tokens: int = 0  # tokens served out of node hot tiers
    hot_token_rate: float = 0.0  # hot_tokens / total context tokens


def summarize(records: Sequence[RequestRecord],
              baseline_ttft_s: Optional[Mapping[str, float]] = None
              ) -> ClusterMetrics:
    """Aggregate completed records.  ``baseline_ttft_s`` maps req_id to a
    reference TTFT (e.g. unthrottled layerwise, or `ttft_opt_local`); added
    TTFT is ``sum(ttft - baseline)`` over requests with a baseline."""
    done = [r for r in records if r.done]
    ttfts = [r.ttft_s for r in done]
    added = 0.0
    if baseline_ttft_s:
        added = sum(r.ttft_s - baseline_ttft_s[r.req_id] for r in done
                    if r.req_id in baseline_ttft_s)
    makespan = (max(r.prefill_done_s for r in done)
                - min(r.arrival_s for r in done)) if done else 0.0
    hot = sum(r.hot_tokens for r in done)
    ctx = sum(r.context for r in done)
    return ClusterMetrics(
        n=len(done),
        ttft_p50_s=percentile(ttfts, 0.50),
        ttft_p95_s=percentile(ttfts, 0.95),
        ttft_p99_s=percentile(ttfts, 0.99),
        ttft_mean_s=sum(ttfts) / len(ttfts) if ttfts else math.nan,
        total_ttft_s=sum(ttfts),
        added_ttft_total_s=added,
        queue_total_s=sum(r.queue_s for r in done),
        stall_total_s=sum(r.stall_s for r in done),
        # a single request (or simultaneous completion) has zero makespan —
        # rate is undefined there, and NaN says so; inf claimed infinite
        # throughput, which poisoned downstream ratios silently
        goodput_rps=len(done) / makespan if makespan > 0 else math.nan,
        makespan_s=makespan,
        replanned=sum(1 for r in done if r.replanned),
        egress_bytes=sum(r.bytes_total for r in done),
        hot_tokens=hot,
        hot_token_rate=hot / ctx if ctx else 0.0)


def per_tenant(records: Sequence[RequestRecord],
               baseline_ttft_s: Optional[Mapping[str, float]] = None
               ) -> dict[str, ClusterMetrics]:
    """Break a record set into per-tenant summaries (tenant "" collects
    records from single-tenant traces)."""
    groups: dict[str, list[RequestRecord]] = {}
    for r in records:
        groups.setdefault(r.tenant, []).append(r)
    return {t: summarize(rs, baseline_ttft_s)
            for t, rs in sorted(groups.items())}
