"""S3-compatible gateway (paper §4.3).

The gateway terminates the S3 control plane (auth, bucket/object naming),
parses the ObjectCache descriptor carried in request headers, and forwards the
multi-object request to the storage server.  HTTP carries control; the
assembled layer payloads travel "RDMA" (here: in-process) directly from the
storage server to the client buffer.  The gateway is deliberately thin and
stateless with respect to scheduling — all delivery policy lives on the
storage server.

Five S3-compatible paths (§4.1):
  S3TCP          — standard S3 GET over HTTP/TCP.
  S3RDMA Buffer  — single object, gateway stages payload before RDMA.
  S3RDMA Direct  — single object, storage RDMA path without staging.
  S3RDMA Batch   — one request naming many objects; one header + RDMA burst.
  S3RDMA Agg     — ObjectCache: server-side layer-major aggregation.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

from .aggregation import AggResult, StorageServer
from .descriptor import Descriptor
from .object_store import ObjectStore
from .transport import (S3_RDMA_AGG, S3_RDMA_BATCH, S3_RDMA_BUFFER,
                        S3_RDMA_DIRECT, S3_TCP, TransportProfile)
from .types import Delivery, Timing


class S3Path(enum.Enum):
    TCP = "S3TCP"
    RDMA_BUFFER = "S3RDMA-Buffer"
    RDMA_DIRECT = "S3RDMA-Direct"
    RDMA_BATCH = "S3RDMA-Batch"
    RDMA_AGG = "S3RDMA-Agg"


_PATH_PROFILE: dict[S3Path, TransportProfile] = {
    S3Path.TCP: S3_TCP,
    S3Path.RDMA_BUFFER: S3_RDMA_BUFFER,
    S3Path.RDMA_DIRECT: S3_RDMA_DIRECT,
    S3Path.RDMA_BATCH: S3_RDMA_BATCH,
    S3Path.RDMA_AGG: S3_RDMA_AGG,
}


@dataclasses.dataclass
class GetResult:
    data: bytes
    timing: Timing


class Gateway:
    """Ceph-RGW stand-in: S3 control plane + descriptor forwarding."""

    def __init__(self, store: ObjectStore,
                 profiles: Optional[dict[S3Path, TransportProfile]] = None) -> None:
        self.store = store
        self.profiles = dict(_PATH_PROFILE)
        if profiles:
            self.profiles.update(profiles)
        self._servers = {path: StorageServer(store, prof)
                         for path, prof in self.profiles.items()}
        self.requests_served = 0
        # nullable obs tracer (DESIGN.md §Observability): one instant per
        # control-plane request, stamped by the tracer's own clock
        self.tracer = None
        self.trace_track = "gateway"

    def _emit(self, name: str, **args) -> None:
        if self.tracer is not None:
            self.tracer.instant(self.trace_track, name, cat="gateway", **args)

    # -- plain object ops (single-object request model) ----------------------
    def put(self, key: bytes, data: bytes, path: S3Path = S3Path.RDMA_DIRECT) -> Timing:
        prof = self.profiles[path]
        self.store.put(key, data)
        self.requests_served += 1
        self._emit("put", path=path.value, bytes=len(data))
        # PUT cost symmetric to GET for our purposes.
        return prof.single_get(len(data))

    def delete(self, key: bytes) -> None:
        """Control-plane DELETE — evicted chunk objects must actually leave
        the store, or index eviction silently leaks storage forever."""
        self.store.delete(key)
        self.requests_served += 1
        self._emit("delete")

    def get(self, key: bytes, path: S3Path = S3Path.RDMA_DIRECT,
            rate_limit: Optional[float] = None) -> GetResult:
        prof = self.profiles[path]
        data = self.store.get(key)
        self.requests_served += 1
        self._emit("get", path=path.value, bytes=len(data))
        return GetResult(data, prof.single_get(len(data), rate_limit))

    def range_get(self, key: bytes, offset: int, length: int,
                  path: S3Path = S3Path.RDMA_DIRECT) -> GetResult:
        prof = self.profiles[path]
        data = self.store.range_get(key, offset, length)
        self.requests_served += 1
        return GetResult(data, prof.single_get(length))

    def batch_get(self, keys: list[bytes], path: S3Path = S3Path.RDMA_BATCH,
                  rate_limit: Optional[float] = None) -> tuple[list[bytes], Timing]:
        """One S3 request naming multiple objects (S3RDMA Batch)."""
        prof = self.profiles[path]
        datas = [self.store.get(k) for k in keys]
        self.requests_served += 1
        return datas, prof.batch_get(len(keys), sum(len(d) for d in datas), rate_limit)

    # -- the ObjectCache path -------------------------------------------------
    def objectcache_get(self, descriptor_wire: bytes,
                        rate_limit: Optional[float] = None,
                        start_s: float = 0.0) -> AggResult:
        """Parse the descriptor from the request header and execute it on the
        storage server (S3RDMA Agg for layerwise, S3RDMA Batch for chunkwise).
        """
        desc = Descriptor.from_wire(descriptor_wire)
        self.requests_served += 1
        self._emit("objectcache_get", delivery=desc.delivery.name,
                   chunks=len(desc.chunk_keys), rate_limit=rate_limit)
        if desc.delivery is Delivery.LAYERWISE:
            return self._servers[S3Path.RDMA_AGG].execute_layerwise(
                desc, rate_limit, start_s)
        return self._servers[S3Path.RDMA_AGG].execute_chunkwise(
            desc, rate_limit, start_s,
            batch_profile=self.profiles[S3Path.RDMA_BATCH])
