"""Server-side layer aggregation (paper §3.3, Appendix Table A3).

The storage server executes a descriptor by assembling one payload per model
layer: for each layer l it range-fetches [l*S, (l+1)*S) from every matched
chunk in parallel, appends the slices in prefix order, RDMA-writes the payload
into the client buffer, and notifies the serving node that the layer is ready.
The notification is on the inference critical path — it is what lets the GPU
start layer l without waiting for the whole prefix.

Timing is a three-stage pipeline (storage read → assemble → wire write): the
server reads layer l+1 while assembling layer l and writing layer l-1.  The
recurrences below model exactly that; bytes are moved for real.

Wire codecs (DESIGN.md §Codec) are transparent here: stored objects are
encoded, the descriptor's per-layer stride is the *encoded* stride, and the
server aggregates and delivers compressed layer payloads — every byte count
below is wire bytes.  Decode happens on the client.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from .descriptor import Descriptor
from .object_store import ObjectStore
from .transport import TransportProfile
from .types import Delivery, LayerReady, Timing


@dataclasses.dataclass
class AggResult:
    """Everything the client needs: real payloads + layer-ready schedule."""

    payloads: list[bytes]  # one layer-major payload per layer (prefix order)
    events: list[LayerReady]  # ready time of each layer (relative to start)
    timing: Timing  # aggregate breakdown

    @property
    def completion_s(self) -> float:
        return self.events[-1].t_ready_s if self.events else 0.0


class StorageServer:
    """Executes ObjectCache descriptors against an object store.

    All runtime policy (chunkwise vs layerwise, §3.4; bandwidth shares, §3.6)
    lives here, keeping gateway and client stateless w.r.t. scheduling.
    """

    def __init__(self, store: ObjectStore, profile: TransportProfile) -> None:
        self.store = store
        self.profile = profile

    # -- layerwise aggregated execution (Table A3) ---------------------------
    def execute_layerwise(self, desc: Descriptor,
                          rate_limit: Optional[float] = None,
                          start_s: float = 0.0) -> AggResult:
        L, N = desc.num_layers, desc.num_chunks
        storage = self.profile.storage

        payloads: list[bytes] = []
        events: list[LayerReady] = []
        # Pipeline state: completion time of each stage for the previous layer.
        t_read_done = start_s + self.profile.control_plane_s + self.profile.per_object_s * N
        t_asm_done = t_read_done
        t_wire_done = t_asm_done
        io_s = asm_s = net_s = 0.0
        offset = 0
        for layer in range(L):
            # Stage 1: N parallel range reads of the layer's table slot
            # [offset, offset + S_l) — constant stride is the degenerate
            # single-entry table, so this loop is codec-agnostic.
            S_l = desc.chunk_layer_bytes(0, layer)
            layer_bytes = N * S_l
            parts = [self.store.range_get(key, offset, S_l)
                     for key in desc.chunk_keys]
            offset += S_l
            dt_read = storage.io_time(N, layer_bytes)
            t_read_done = t_read_done + dt_read
            # Stage 2: append slices in prefix order (server-side memcpy).
            payload = b"".join(parts)
            dt_asm = storage.assemble_time(layer_bytes)
            t_asm_done = max(t_asm_done, t_read_done) + dt_asm
            # Stage 3: RDMA-write to the client buffer at the allocated rate.
            dt_wire = self.profile.wire_time(layer_bytes, rate_limit)
            t_wire_done = max(t_wire_done, t_asm_done) + dt_wire
            payloads.append(payload)
            events.append(LayerReady(layer, t_wire_done, layer_bytes))
            io_s += dt_read
            asm_s += dt_asm
            net_s += dt_wire
        timing = Timing(
            control_plane_s=self.profile.control_plane_s + self.profile.per_object_s * N,
            storage_s=io_s, network_s=net_s + asm_s)
        return AggResult(payloads, events, timing)

    # -- chunkwise batched execution (below-threshold mode, §3.4) ------------
    def execute_chunkwise(self, desc: Descriptor,
                          rate_limit: Optional[float] = None,
                          start_s: float = 0.0,
                          batch_profile: Optional[TransportProfile] = None) -> AggResult:
        """Whole chunks in one batched request; every layer becomes ready only
        when the full matched prefix has arrived (Fig. 7a)."""
        prof = batch_profile or self.profile
        N = desc.num_chunks
        total = desc.total_bytes
        timing = prof.batch_get(N, total, rate_limit)
        done = start_s + timing.total_s
        chunks = [self.store.get(key) for key in desc.chunk_keys]
        # Reorganize to per-layer payloads for a uniform client interface;
        # slice bounds come from the size table (constant stride degenerate).
        payloads, events = [], []
        lo = 0
        for l in range(desc.num_layers):
            hi = lo + desc.chunk_layer_bytes(0, l)
            payloads.append(b"".join(c[lo:hi] for c in chunks))
            events.append(LayerReady(l, done, desc.layer_payload_nbytes(l)))
            lo = hi
        return AggResult(payloads, events, timing)

    def execute(self, desc: Descriptor, rate_limit: Optional[float] = None,
                start_s: float = 0.0) -> AggResult:
        if desc.delivery is Delivery.LAYERWISE:
            return self.execute_layerwise(desc, rate_limit, start_s)
        return self.execute_chunkwise(desc, rate_limit, start_s)


# ---------------------------------------------------------------------------
# Mode selection (paper §3.4, Eq. 2)
# ---------------------------------------------------------------------------
# Θ — the payload size at which network transfer at line rate becomes
# comparable to the prefill compute window; ≈512 MB on the paper's 100 Gbps
# prototype with Llama 3.1 8B.  A deployment knob, not a universal constant.
DEFAULT_THETA_BYTES = 512 * 1024 * 1024


def select_mode(total_payload_bytes: int, theta: int = DEFAULT_THETA_BYTES) -> Delivery:
    """mode(W) = chunkwise if W < Θ else layerwise+aggregation (Eq. 2)."""
    return Delivery.CHUNKWISE if total_payload_bytes < theta else Delivery.LAYERWISE
