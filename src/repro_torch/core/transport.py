"""Transport and storage-tier service-time models.

The paper's prototype runs on a 100 Gbps RoCE cluster (NIXL + Ceph RGW + DAOS).
This container has no NIC, so the *timing* of every path is modelled by
calibrated profiles while the *bytes* still move for real through the
in-process object store (correctness stays end-to-end real).

Profiles are calibrated against the paper's measurements:

* Fig. 8  — raw DAOS: RDMA approaches the 100 Gbps line (12.5 GB/s) at ~1 MB
  blocks; TCP lags consistently.
* Fig. 9  — S3 paths: S3RDMA-Direct approaches NIC capacity at 4 MB / C=32;
  S3TCP limited by the gateway streaming HTTP path; S3RDMA-Buffer pays
  server-side staging.
* Fig. 10 — per-request breakdown: after RDMA removes data movement, fixed
  control-plane work (HTTP + RGW metadata) dominates small objects.
* Fig. 11/A8 — server-side aggregation sustains ≈5 GB/s at G=64 (lower at
  G=16, ≈10 GB/s peak at G=256 with 2 MB payloads).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

from .types import Timing

GBPS = 1e9 / 8  # 1 Gbps in bytes/s
LINK_100G = 100 * GBPS  # 12.5 GB/s


class VirtualClock:
    """Deterministic clock for event-driven simulation."""

    def __init__(self, start: float = 0.0) -> None:
        self._now = start

    def now(self) -> float:
        return self._now

    def advance_to(self, t: float) -> None:
        if t > self._now:
            self._now = t

    def advance(self, dt: float) -> None:
        self._now += dt


class WallClock:
    def now(self) -> float:
        return time.monotonic()

    def advance_to(self, t: float) -> None:  # wall time cannot be steered
        pass


@dataclasses.dataclass(frozen=True)
class StorageProfile:
    """Backend (DAOS-like) service model."""

    range_read_s: float  # fixed service time per range read (random offsets)
    queue_depth: int  # concurrent I/O the backend sustains
    stream_bandwidth: float  # striped-SSD streaming bandwidth (B/s)
    assemble_bandwidth: float  # server-side gather/memcpy rate (B/s)

    def io_time(self, n_ranges: int, total_bytes: int) -> float:
        """Time to service ``n_ranges`` random range reads of ``total_bytes``."""
        seek = self.range_read_s * n_ranges / self.queue_depth
        stream = total_bytes / self.stream_bandwidth
        return seek + stream

    def assemble_time(self, total_bytes: int) -> float:
        return total_bytes / self.assemble_bandwidth


@dataclasses.dataclass(frozen=True)
class TransportProfile:
    """One S3-compatible path (§4.1)."""

    name: str
    wire_bandwidth: float  # effective data-plane bandwidth (B/s)
    control_plane_s: float  # fixed per-request S3/HTTP/RGW cost
    per_object_s: float  # marginal metadata cost per object named in a request
    staging_bandwidth: Optional[float]  # extra gateway staging pass (Buffer path)
    storage: StorageProfile

    def effective_wire_rate(self, rate_limit: Optional[float] = None) -> float:
        """Fluid-model data-plane rate (B/s): the harmonic combination of the
        (possibly rate-limited) wire and the optional staging pass, such that
        ``wire_time(n, r) == n / effective_wire_rate(r)`` exactly.  The cluster
        simulator integrates transfer progress at this rate between events."""
        bw = self.wire_bandwidth if rate_limit is None else min(self.wire_bandwidth, rate_limit)
        if bw <= 0.0:
            return 0.0
        if self.staging_bandwidth is None:
            return bw
        return 1.0 / (1.0 / bw + 1.0 / self.staging_bandwidth)

    def wire_time(self, nbytes: int, rate_limit: Optional[float] = None) -> float:
        bw = self.wire_bandwidth if rate_limit is None else min(self.wire_bandwidth, rate_limit)
        t = nbytes / bw
        if self.staging_bandwidth is not None:
            t += nbytes / self.staging_bandwidth
        return t

    def pipeline_components(self, n_objects: int, payload_bytes: int
                            ) -> tuple[float, float, float]:
        """(startup, io, asm) — the rate-independent parts of the 3-stage
        layerwise pipeline.  The cluster simulator needs them separately from
        the wire term (whose rate varies between reallocation events);
        ``stage_times`` composes the same numbers, so the event-driven and
        closed-form paths cannot drift apart."""
        startup = self.control_plane_s + self.per_object_s * n_objects
        io = self.storage.io_time(n_objects, payload_bytes)
        asm = self.storage.assemble_time(payload_bytes)
        return startup, io, asm

    def layer_pipeline(self, n_objects: int, per_layer_bytes,
                       rate_limit: Optional[float] = None,
                       startup_extra_s: float = 0.0
                       ) -> tuple[float, list[float], list[float]]:
        """Per-layer generalisation of :meth:`stage_times` for payloads whose
        bytes differ across layers (variable-rate codecs, DESIGN.md §Codec).

        Returns ``(startup, avail, wire)``: ``avail[l]`` is the absolute time
        (including ``startup``) at which layer l's payload has been range-read
        and assembled — the storage-side 2-stage recurrence of
        `aggregation.StorageServer.execute_layerwise`, rate-independent —
        and ``wire[l]`` its wire transmit time at the allocated rate.  Feed
        both to `overlap.gated_layerwise_schedule` for layer-ready times; at
        constant per-layer bytes that composition reproduces
        ``startup + first + l*stage`` exactly (up to fp associativity).
        """
        startup = (self.control_plane_s + self.per_object_s * n_objects
                   + startup_extra_s)
        t_read = t_asm = startup
        avail: list[float] = []
        wire: list[float] = []
        for nbytes in per_layer_bytes:
            t_read = t_read + self.storage.io_time(n_objects, nbytes)
            t_asm = max(t_asm, t_read) + self.storage.assemble_time(nbytes)
            avail.append(t_asm)
            wire.append(self.wire_time(nbytes, rate_limit))
        return startup, avail, wire

    def stage_times(self, n_objects: int, payload_bytes: int,
                    rate_limit: Optional[float] = None
                    ) -> tuple[float, float, float]:
        """(startup, first, stage) of the 3-stage layerwise pipeline
        (storage read -> assemble -> wire): ``startup`` is the fixed
        control-plane cost, ``first`` the fill latency of layer 0, ``stage``
        the steady-state per-layer cadence.  Shared by the TTFT simulator and
        the compute-or-load planner so the two can never drift apart."""
        startup, io, asm = self.pipeline_components(n_objects, payload_bytes)
        wire = self.wire_time(payload_bytes, rate_limit)
        return startup, io + asm + wire, max(io, asm, wire)

    # -- single / batched object timing (non-aggregated paths) ---------------
    def single_get(self, nbytes: int, rate_limit: Optional[float] = None) -> Timing:
        return Timing(
            control_plane_s=self.control_plane_s + self.per_object_s,
            storage_s=self.storage.io_time(1, nbytes),
            network_s=self.wire_time(nbytes, rate_limit),
        )

    def batch_get(self, nobjects: int, nbytes: int,
                  rate_limit: Optional[float] = None) -> Timing:
        """One request naming many objects; one HTTP header, one RDMA burst."""
        return Timing(
            control_plane_s=self.control_plane_s + self.per_object_s * nobjects,
            storage_s=self.storage.io_time(nobjects, nbytes),
            network_s=self.wire_time(nbytes, rate_limit),
        )


# ---------------------------------------------------------------------------
# Calibrated profiles (see module docstring for the anchoring measurements).
# ---------------------------------------------------------------------------
_DAOS = StorageProfile(
    range_read_s=400e-6,  # random-offset reads within chunk objects (§4.5)
    queue_depth=16,
    stream_bandwidth=28e9,  # 4 striped NVMe SSDs
    assemble_bandwidth=12e9,  # server-side gather memcpy
)

S3_TCP = TransportProfile(
    name="S3TCP", wire_bandwidth=4.2e9, control_plane_s=1.1e-3,
    per_object_s=150e-6, staging_bandwidth=None, storage=_DAOS)

S3_RDMA_BUFFER = TransportProfile(
    name="S3RDMA-Buffer", wire_bandwidth=11.5e9, control_plane_s=0.8e-3,
    per_object_s=100e-6, staging_bandwidth=9e9, storage=_DAOS)

S3_RDMA_DIRECT = TransportProfile(
    name="S3RDMA-Direct", wire_bandwidth=11.5e9, control_plane_s=0.65e-3,
    per_object_s=80e-6, staging_bandwidth=None, storage=_DAOS)

S3_RDMA_BATCH = TransportProfile(
    name="S3RDMA-Batch", wire_bandwidth=11.5e9, control_plane_s=0.65e-3,
    per_object_s=25e-6, staging_bandwidth=None, storage=_DAOS)

S3_RDMA_AGG = TransportProfile(
    name="S3RDMA-Agg", wire_bandwidth=11.5e9, control_plane_s=0.65e-3,
    per_object_s=2e-6,  # descriptor keys are 16 B each; parsing is trivial
    staging_bandwidth=None, storage=_DAOS)

# Local DRAM baselines (pinned host memory → device).  Calibrated to the
# paper's A100 H2D microbenchmark (Appendix Fig. A3: ~12 GB/s PCIe Gen4 x8).
LOCAL_DRAM = TransportProfile(
    name="Local-DRAM", wire_bandwidth=12e9, control_plane_s=15e-6,
    per_object_s=0.5e-6,
    staging_bandwidth=None,
    storage=StorageProfile(range_read_s=0.3e-6, queue_depth=64,
                           stream_bandwidth=80e9, assemble_bandwidth=25e9))

PROFILES = {p.name: p for p in
            (S3_TCP, S3_RDMA_BUFFER, S3_RDMA_DIRECT, S3_RDMA_BATCH, S3_RDMA_AGG,
             LOCAL_DRAM)}

# Fixed client-side cost of a layerwise S3Agg request: RDMA session setup,
# per-layer receive-buffer registration, and the descriptor control-plane
# exchange.  §5.5 attributes the bulk of the 4K-context gap (+56–75 ms over
# opt-local-LW while the payload is only ~100s of MB) to exactly these fixed
# costs; 55 ms reproduces that band while keeping the 64 K overhead within the
# paper's 0.1–5.6 % envelope (see benchmarks/bench_ttft.py).
RDMA_SESSION_SETUP_S = 55e-3
