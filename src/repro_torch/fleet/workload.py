"""Seeded Zipfian multi-tenant trace generators (DESIGN.md §Fleet).

At population scale the cache economy is driven by *skew*: a few system
prompts / RAG documents absorb most traffic (the KV-cache management survey,
arXiv:2607.02574, and LMCache's production traces both report Zipf-like
popularity).  These generators emit the existing `cluster/trace.py` replay
format (`TraceRequest`, v2 fields ``tenant``/``prefix_id``) so every fleet
workload can be committed as JSON and replayed bit-identically.

Three regimes:

* :func:`zipf_system_prompt_trace` — tenants (Zipf over tenants) each own a
  prompt population (Zipf over prompts): the chat-product shape where a
  tenant's system prompt is the shared prefix.
* :func:`rag_trace` — a global document corpus shared *across* tenants
  (Zipf over documents): cross-tenant dedup through content addressing.
* :func:`tenant_churn_trace` — cohorts of tenants activate and retire over
  time, shifting the hot working set — the regime that separates recency
  from frequency policies.

Determinism: one ``random.Random(seed)`` per call; same arguments, same
trace, bit-identical floats.
"""
from __future__ import annotations

import bisect
import itertools
import random
from typing import Optional, Sequence

from repro_torch.cluster.trace import TraceRequest


class ZipfSampler:
    """Zipf(alpha) over ranks 0..n-1: P(rank k) ∝ 1/(k+1)^alpha.

    Precomputed CDF + bisect — O(log n) per draw, no numpy, fully
    deterministic under the caller's `random.Random`.
    """

    def __init__(self, n: int, alpha: float) -> None:
        if n <= 0:
            raise ValueError("need a positive population")
        self.n, self.alpha = n, alpha
        weights = [1.0 / (k + 1) ** alpha for k in range(n)]
        total = sum(weights)
        self._cdf = list(itertools.accumulate(w / total for w in weights))
        self._cdf[-1] = 1.0  # guard fp undershoot

    def sample(self, rng: random.Random) -> int:
        return bisect.bisect_left(self._cdf, rng.random())


def _arrivals(rng: random.Random, n: int, rate_rps: float) -> list[float]:
    out, t = [], 0.0
    for _ in range(n):
        t += rng.expovariate(rate_rps)
        out.append(t)
    return out


def zipf_system_prompt_trace(
        n: int, rate_rps: float, *,
        num_tenants: int = 16, tenant_alpha: float = 0.8,
        prompts_per_tenant: int = 8, prompt_alpha: float = 1.0,
        prompt_tokens: int = 2048, context: int = 4096,
        chunk_tokens: int = 64, seed: int = 0) -> list[TraceRequest]:
    """Popularity-skewed system prompts: tenant ~ Zipf(tenant_alpha), then
    one of the tenant's prompts ~ Zipf(prompt_alpha).  The prompt is the
    shareable prefix (``prefix_id = "t<i>/p<j>"``); the remaining
    ``context - prompt_tokens`` tokens are a unique per-request suffix."""
    if prompt_tokens > context:
        raise ValueError("prompt_tokens cannot exceed context")
    rng = random.Random(seed)
    tenants = ZipfSampler(num_tenants, tenant_alpha)
    prompts = ZipfSampler(prompts_per_tenant, prompt_alpha)
    out = []
    for i, t in enumerate(_arrivals(rng, n, rate_rps)):
        tid = tenants.sample(rng)
        pid = prompts.sample(rng)
        out.append(TraceRequest(
            f"r{i}", t, context, prompt_tokens / context, chunk_tokens,
            tenant=f"t{tid}", prefix_id=f"t{tid}/p{pid}"))
    return out


def rag_trace(n: int, rate_rps: float, *,
              num_docs: int = 256, doc_alpha: float = 1.0,
              num_tenants: int = 16, tenant_alpha: float = 0.8,
              doc_tokens: int = 3072, query_tokens: int = 1024,
              chunk_tokens: int = 64, seed: int = 0) -> list[TraceRequest]:
    """RAG document reuse: the retrieved document is the shared prefix and
    the corpus is *global* — two tenants hitting the same document address
    the same chunk objects (``prefix_id = "doc<k>"``), the cross-tenant
    dedup property of content addressing."""
    rng = random.Random(seed)
    docs = ZipfSampler(num_docs, doc_alpha)
    tenants = ZipfSampler(num_tenants, tenant_alpha)
    context = doc_tokens + query_tokens
    out = []
    for i, t in enumerate(_arrivals(rng, n, rate_rps)):
        d = docs.sample(rng)
        tid = tenants.sample(rng)
        out.append(TraceRequest(
            f"r{i}", t, context, doc_tokens / context, chunk_tokens,
            tenant=f"t{tid}", prefix_id=f"doc{d}"))
    return out


def tenant_churn_trace(n: int, rate_rps: float, *,
                       cohort: int = 8, cohort_life_s: float = 30.0,
                       overlap: int = 1, tenant_alpha: float = 1.0,
                       prompt_tokens: int = 2048, context: int = 4096,
                       chunk_tokens: int = 64, seed: int = 0
                       ) -> list[TraceRequest]:
    """Tenant churn: at time t, the active tenants are cohorts
    ``floor(t/cohort_life_s) - overlap .. floor(t/cohort_life_s)`` (``cohort``
    tenants each).  Every cohort turnover retires one prompt working set and
    introduces a fresh one — sustained pressure on the eviction layer, and
    the trace that separates recency (LRU/TTL) from frequency (LFU/GDSF)
    policies."""
    rng = random.Random(seed)
    zipf = ZipfSampler(cohort * (overlap + 1), tenant_alpha)
    out = []
    for i, t in enumerate(_arrivals(rng, n, rate_rps)):
        epoch = int(t / cohort_life_s)
        lo = max(0, epoch - overlap) * cohort
        hi = (epoch + 1) * cohort
        active = hi - lo
        tid = lo + zipf.sample(rng) % active
        out.append(TraceRequest(
            f"r{i}", t, context, prompt_tokens / context, chunk_tokens,
            tenant=f"t{tid}", prefix_id=f"t{tid}/sys"))
    return out


def working_set_chunks(trace: Sequence[TraceRequest],
                       chunk_tokens: Optional[int] = None) -> int:
    """Distinct shared-prefix chunks a trace touches — the capacity a hot
    tier would need to never evict (sizing aid for benchmarks)."""
    seen: set[tuple[str, int]] = set()
    for tr in trace:
        g = chunk_tokens or tr.chunk_tokens
        for c in range(tr.cached_tokens // g):
            seen.add((tr.prefix_id or tr.req_id, c))
    return len(seen)
