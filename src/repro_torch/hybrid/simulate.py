"""Paper-scale simulation of hybrid prefill (DESIGN.md §Compute-or-load).

Glues the split planner to `core.simulator`'s workload grid so the Cake-style
crossover becomes a runnable benchmark: pure fetch wins when bandwidth is
plentiful, pure recompute wins as bandwidth approaches zero, and the hybrid
planner is never worse than either (it optimises over both endpoints).
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core.compute_model import PaperComputeModel
from repro_torch.core.simulator import ServingSimulator, WorkloadRequest
from repro_torch.core.transport import S3_RDMA_AGG, TransportProfile

from .planner import HybridSplit, plan_split


def hybrid_workload_ttft(w: WorkloadRequest,
                         profile: TransportProfile = S3_RDMA_AGG,
                         rate: Optional[float] = None,
                         compute: Optional[PaperComputeModel] = None,
                         method: str = "closed_form") -> HybridSplit:
    """Plan the compute-or-load split for one grid request at ``rate``."""
    compute = compute or PaperComputeModel()
    sim = ServingSimulator(compute)
    spec = sim.kv_spec(w.chunk_tokens)
    n_chunks = w.cached_tokens // w.chunk_tokens
    return plan_split(w.context, n_chunks, spec, compute, profile, rate,
                      method=method)


def crossover_sweep(w: WorkloadRequest, rates: Sequence[float],
                    profile: TransportProfile = S3_RDMA_AGG,
                    compute: Optional[PaperComputeModel] = None,
                    method: str = "closed_form") -> list[dict]:
    """TTFT of pure-fetch / pure-recompute / hybrid across a bandwidth sweep.

    One dict per rate: {rate, fetch_s, recompute_s, hybrid_s, fetch_chunks,
    total_chunks}.  ``hybrid_s <= min(fetch_s, recompute_s)`` holds pointwise
    by construction — the planner's scan includes both endpoints.
    """
    rows = []
    for rate in rates:
        split = hybrid_workload_ttft(w, profile, rate, compute, method)
        rows.append({
            "rate": rate,
            "fetch_s": split.fetch_ttft_s,
            "recompute_s": split.recompute_ttft_s,
            "hybrid_s": split.ttft_s,
            "fetch_chunks": split.fetch_chunks,
            "total_chunks": split.total_chunks,
        })
    return rows
