"""Paper-scale event-driven serving simulator.

Reproduces the paper's end-to-end TTFT methodology (§5.5–5.7) with the
calibrated transport profiles, the Table A8 compute model, and the bandwidth
scheduler — so Figures 13/14/16 and Tables A9–A12 become runnable benchmarks.

The simulator composes, per request:

  startup  = control plane + (RDMA session setup for layerwise S3 paths)
  per-layer transfer X_l from the 3-stage aggregation pipeline (or one bulk
  chunkwise transfer), possibly rate-limited by the scheduler allocation
  per-layer compute  C_l from the compute model (suffix prefill / L)

and evaluates TTFT by event-stepping (overlap.pipeline_ttft), which reduces to
Eq. 3 when per-layer times are constant.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from .compute_model import PaperComputeModel
from .overlap import gated_layerwise_schedule, pipeline_ttft
from .scheduler import Policy, allocate
from .transport import (LOCAL_DRAM, RDMA_SESSION_SETUP_S, S3_RDMA_AGG,
                        S3_RDMA_BATCH, TransportProfile)
from .types import FlowRequest, KVSpec


@dataclasses.dataclass(frozen=True)
class WorkloadRequest:
    """One request of the paper's evaluation grid."""

    req_id: str
    context: int  # C, tokens
    hit_rate: float  # r
    chunk_tokens: int = 64  # G

    @property
    def cached_tokens(self) -> int:
        return int(self.context * self.hit_rate)


@dataclasses.dataclass
class TTFTResult:
    req_id: str
    ttft_s: float
    startup_s: float
    transfer_per_layer_s: float
    compute_per_layer_s: float
    stalled: bool


class ServingSimulator:
    """TTFT for Llama 3.1 8B per the paper's measured constants.

    ``codec`` selects the KV wire codec (DESIGN.md §Codec): transfer terms
    see the encoded byte counts while compute windows are untouched, so a
    quantized codec shrinks every wire/storage stage by ``spec.wire_ratio``.
    """

    def __init__(self, compute: Optional[PaperComputeModel] = None,
                 codec: str = "identity") -> None:
        self.compute = compute or PaperComputeModel()
        self.codec = codec

    # -- spec helpers ---------------------------------------------------------
    def kv_spec(self, G: int) -> KVSpec:
        return KVSpec(num_layers=self.compute.num_layers, chunk_tokens=G,
                      num_kv_heads=8, head_dim=128, dtype_bytes=2,
                      codec=self.codec)

    def flow_request(self, w: WorkloadRequest) -> FlowRequest:
        spec = self.kv_spec(w.chunk_tokens)
        return FlowRequest(
            req_id=w.req_id,
            bytes_per_layer=self.compute.bytes_per_layer(w.context, w.hit_rate)
            * spec.wire_ratio,
            layer_compute_s=self.compute.layer_compute_s(w.context, w.hit_rate),
            num_layers=self.compute.num_layers)

    # -- single-request paths -------------------------------------------------
    def ttft_layerwise(self, w: WorkloadRequest,
                       profile: TransportProfile = S3_RDMA_AGG,
                       rate_limit: Optional[float] = None,
                       session_setup: bool = True) -> TTFTResult:
        """S3Agg-LW / Local-DRAM-LW: per-layer pipeline + overlap.

        Constant-stride codecs use the Eq. 3 steady closed form; a
        variable-rate codec (per-layer wire sizes, DESIGN.md §Codec) uses
        the gated per-layer schedule — the same recurrence the cluster
        simulator integrates, so the two agree at 1e-9 either way."""
        spec = self.kv_spec(w.chunk_tokens)
        n_chunks = w.cached_tokens // w.chunk_tokens
        L = spec.num_layers
        c = self.compute.layer_compute_s(w.context, w.hit_rate)
        extra = RDMA_SESSION_SETUP_S \
            if session_setup and profile is not LOCAL_DRAM else 0.0

        if spec.is_variable_rate:
            per_layer = [n_chunks * spec.wire_layer_bytes(l) for l in range(L)]
            startup, avail, wire = profile.layer_pipeline(
                n_chunks, per_layer, rate_limit, startup_extra_s=extra)
            ready, finish = gated_layerwise_schedule(avail, wire, [c] * L)
            stage = (ready[-1] - ready[0]) / (L - 1) if L > 1 else 0.0
            return TTFTResult(w.req_id, finish[-1], startup, stage, c,
                              stalled=any(r > f for r, f in
                                          zip(ready[1:], finish)))

        layer_bytes = n_chunks * spec.wire_per_layer_chunk_bytes
        # 3-stage pipeline per layer (storage read -> assemble -> wire).
        startup, first, stage = profile.stage_times(n_chunks, layer_bytes,
                                                    rate_limit)
        startup += extra
        ready = [startup + first + l * stage for l in range(L)]
        compute = [c] * L
        ttft = pipeline_ttft(ready, compute)
        return TTFTResult(w.req_id, ttft, startup, stage, c, stalled=stage > c)

    def ttft_chunkwise(self, w: WorkloadRequest,
                       profile: TransportProfile = S3_RDMA_BATCH,
                       rate_limit: Optional[float] = None) -> TTFTResult:
        """S3Batch-CW / Local-DRAM-CW: full prefix before compute (Fig. 7a)."""
        spec = self.kv_spec(w.chunk_tokens)
        n_chunks = w.cached_tokens // w.chunk_tokens
        total = n_chunks * spec.wire_chunk_bytes
        timing = profile.batch_get(n_chunks, total, rate_limit)
        c_total = self.compute.suffix_compute_s(w.context, w.hit_rate)
        ttft = timing.total_s + c_total
        L = spec.num_layers
        return TTFTResult(w.req_id, ttft, timing.control_plane_s,
                          timing.total_s / L, c_total / L, stalled=True)

    def ttft_recompute(self, w: WorkloadRequest) -> TTFTResult:
        """Pure-recompute baseline: ignore the cache hit entirely and prefill
        the whole context from scratch (no transfer, no startup) — the m=0
        endpoint of the compute-or-load planner."""
        c_total = self.compute.suffix_compute_s(w.context, 0.0)
        L = self.compute.num_layers
        return TTFTResult(w.req_id, c_total, 0.0, 0.0, c_total / L,
                          stalled=False)

    def ttft_opt_local(self, w: WorkloadRequest) -> float:
        """opt-local-LW baseline (§5.5): pre-aggregated layer-major KV in
        pinned host memory — only H2D transfer, no aggregation cost."""
        r = self.ttft_layerwise(w, profile=LOCAL_DRAM, session_setup=False)
        return r.ttft_s

    # -- multi-tenant scheduling (§5.7) ----------------------------------------
    def run_workload(self, requests: Sequence[WorkloadRequest], cap_bps: float,
                     policy: Policy, margin_bps: float = 0.0,
                     profile: TransportProfile = S3_RDMA_AGG
                     ) -> dict[str, TTFTResult]:
        flows = [self.flow_request(w) for w in requests]
        alloc = allocate(flows, cap_bps, policy, margin_bps)
        out = {}
        for w in requests:
            out[w.req_id] = self.ttft_layerwise(w, profile=profile,
                                                rate_limit=alloc[w.req_id])
        return out

    def workload_total_ttft(self, requests: Sequence[WorkloadRequest],
                            cap_bps: float, policy: Policy,
                            margin_bps: float = 0.0) -> float:
        res = self.run_workload(requests, cap_bps, policy, margin_bps)
        return sum(r.ttft_s for r in res.values())

    def unthrottled_total_ttft(self, requests: Sequence[WorkloadRequest]) -> float:
        return sum(self.ttft_layerwise(w).ttft_s for w in requests)


# The paper's three scheduler workloads (§5.7).
WORKLOAD_A = ([WorkloadRequest("16K,50%", 16384, 0.5),
               WorkloadRequest("16K,87.5%", 16384, 0.875),
               WorkloadRequest("64K,50%", 65536, 0.5),
               WorkloadRequest("64K,87.5%", 65536, 0.875)], 80e9 / 8)
WORKLOAD_B = (WORKLOAD_A[0], 50e9 / 8)
WORKLOAD_C = ([*WORKLOAD_A[0],
               WorkloadRequest("32K,50%", 32768, 0.5),
               WorkloadRequest("32K,87.5%", 32768, 0.875)], 50e9 / 8)
# 5 Gbps calibration margin, chosen from the S3Agg-LW rate sweep (Fig. 15).
PAPER_MARGIN_BPS = 5e9 / 8
