"""The ObjectCache request descriptor (paper §3.2, Table 1).

The descriptor extends a normal S3-compatible request: it names the matched
chunk keys, the model layout, the delivery order, and the RDMA target.  It is
intentionally *arithmetic rather than manifest-heavy* — because every chunk of
one deployment has the same per-layer sizes, the server derives every byte
range from the header without per-object manifests.

Versions (all decodable; `to_wire` can emit any of them for stored caches):

  v1  constant per-layer stride, identity codec only (pre-codec format).
  v2  v1 + a one-byte wire-codec id (DESIGN.md §Codec).
  v3  the stride generalises to a per-(chunk, layer) *size table* so
      per-layer wire bytes may differ (variable-rate codecs, e.g. mixed-bit).
      The table is mode-tagged: mode 0 stores one uint32 (the degenerate
      constant stride — exactly the v2 arithmetic property), mode 1 stores L
      uint32 entries shared by every chunk (our codecs are content-independent
      so all chunks agree), mode 2 stores the full N x L table (reserved for
      content-dependent codecs, e.g. entropy-coded residuals).  Lookup is
      always `chunk_layer_bytes(chunk, layer)`; the modes only compress the
      storage of identical rows.

Wire format: a compact binary header (as would ride an HTTP header /
`x-amz-meta-objectcache` field), plus JSON for debugging.
"""
from __future__ import annotations

import dataclasses
import json
import struct

from .hashing import KEY_BYTES
from .types import Delivery, KVSpec

_MAGIC = b"OBJC"
VERSION = 3
# v1: magic, version, num_keys, num_layers, chunk_tokens, per_layer_bytes,
#     delivery, rdma_addr, rdma_rkey, rdma_len
_HEADER_V1 = struct.Struct("<4sBIIIIBQIQ")
# v2 inserts the codec id after the version byte
_HEADER_V2 = struct.Struct("<4sBBIIIIBQIQ")
# v3 drops the inline stride and appends a table-mode byte; the size table
# (uint32 entries, count by mode) follows the header, then the chunk keys
_HEADER_V3 = struct.Struct("<4sBBIIIBQIQB")
TABLE_CONSTANT, TABLE_PER_LAYER, TABLE_PER_CHUNK_LAYER = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class RdmaTarget:
    """Client buffer the storage server writes into (address, rkey, length)."""

    addr: int
    rkey: int
    length: int


@dataclasses.dataclass(frozen=True)
class Descriptor:
    """Table 1 of the paper.

    ``per_layer_chunk_bytes`` is the constant encoded stride S_wire;
    ``layer_bytes`` (when non-empty) is the per-layer size table of one chunk
    and overrides it.  All chunks of a deployment share the table (mode 1) —
    content-independent codecs produce identical sizes for every chunk.
    """

    chunk_keys: tuple[bytes, ...]  # [H_0 .. H_{N-1}], matched prefix chunks
    num_layers: int  # L
    chunk_tokens: int  # G
    per_layer_chunk_bytes: int  # S_wire: constant per-layer stride (or 0)
    delivery: Delivery
    rdma_target: RdmaTarget
    codec_id: int = 0  # wire codec of the stored chunks (DESIGN.md §Codec)
    layer_bytes: tuple[int, ...] = ()  # v3 size table (empty = constant S)

    def __post_init__(self):
        if self.layer_bytes and len(self.layer_bytes) != self.num_layers:
            raise ValueError(
                f"size table has {len(self.layer_bytes)} entries for "
                f"{self.num_layers} layers")

    # -- derived ------------------------------------------------------------
    @property
    def num_chunks(self) -> int:
        return len(self.chunk_keys)

    def chunk_layer_bytes(self, chunk: int, layer: int) -> int:
        """Size-table lookup: encoded bytes of layer ``layer`` of chunk
        ``chunk``.  The constant stride is the degenerate table."""
        del chunk  # all chunks share the row (content-independent codecs)
        if self.layer_bytes:
            return self.layer_bytes[layer]
        return self.per_layer_chunk_bytes

    def layer_offset(self, layer: int) -> int:
        """Start of layer ``layer``'s slice inside any stored chunk."""
        if self.layer_bytes:
            return sum(self.layer_bytes[:layer])
        return layer * self.per_layer_chunk_bytes

    @property
    def chunk_wire_bytes(self) -> int:
        """Encoded bytes of one whole stored chunk (sum of the table row)."""
        if self.layer_bytes:
            return sum(self.layer_bytes)
        return self.num_layers * self.per_layer_chunk_bytes

    @property
    def total_bytes(self) -> int:
        """W = N * sum_l S_wire(l) (Eq. 2, over the encoded layout)."""
        return self.num_chunks * self.chunk_wire_bytes

    def layer_payload_nbytes(self, layer: int) -> int:
        """Bytes of one aggregated (encoded) layer payload (N slices)."""
        return self.num_chunks * self.chunk_layer_bytes(0, layer)

    @property
    def layer_payload_bytes(self) -> int:
        """Constant-stride aggregated layer payload size (N * S_wire); only
        defined when the table is degenerate."""
        if self.layer_bytes and len(set(self.layer_bytes)) > 1:
            raise ValueError("variable size table: use layer_payload_nbytes")
        return self.num_chunks * self.chunk_layer_bytes(0, 0)

    # -- wire ----------------------------------------------------------------
    def to_wire(self, version: int = VERSION) -> bytes:
        lw = 1 if self.delivery is Delivery.LAYERWISE else 0
        rt = self.rdma_target
        if version == 1:
            if self.codec_id != 0 or self.layer_bytes:
                raise ValueError("v1 descriptors carry neither a codec id "
                                 "nor a size table")
            head = _HEADER_V1.pack(
                _MAGIC, 1, self.num_chunks, self.num_layers,
                self.chunk_tokens, self.per_layer_chunk_bytes, lw,
                rt.addr, rt.rkey, rt.length)
        elif version == 2:
            if self.layer_bytes and len(set(self.layer_bytes)) > 1:
                raise ValueError("variable size table needs a v3 descriptor")
            stride = self.chunk_layer_bytes(0, 0)
            head = _HEADER_V2.pack(
                _MAGIC, 2, self.codec_id, self.num_chunks, self.num_layers,
                self.chunk_tokens, stride, lw, rt.addr, rt.rkey, rt.length)
        elif version == 3:
            if self.layer_bytes:
                mode, entries = TABLE_PER_LAYER, self.layer_bytes
            else:
                mode, entries = TABLE_CONSTANT, (self.per_layer_chunk_bytes,)
            head = _HEADER_V3.pack(
                _MAGIC, 3, self.codec_id, self.num_chunks, self.num_layers,
                self.chunk_tokens, lw, rt.addr, rt.rkey, rt.length, mode)
            head += struct.pack(f"<{len(entries)}I", *entries)
        else:
            raise ValueError(f"unknown descriptor version {version}")
        return head + b"".join(self.chunk_keys)

    @classmethod
    def from_wire(cls, buf: bytes) -> "Descriptor":
        magic, ver = struct.unpack_from("<4sB", buf, 0)
        if magic != _MAGIC:
            raise ValueError("not an ObjectCache descriptor")
        codec_id, layer_bytes = 0, ()
        if ver == 1:
            _, _, n, L, G, S, lw, addr, rkey, length = _HEADER_V1.unpack_from(buf, 0)
            off = _HEADER_V1.size
        elif ver == 2:
            _, _, codec_id, n, L, G, S, lw, addr, rkey, length = \
                _HEADER_V2.unpack_from(buf, 0)
            off = _HEADER_V2.size
        elif ver == 3:
            (_, _, codec_id, n, L, G, lw, addr, rkey, length,
             mode) = _HEADER_V3.unpack_from(buf, 0)
            off = _HEADER_V3.size
            count = {TABLE_CONSTANT: 1, TABLE_PER_LAYER: L,
                     TABLE_PER_CHUNK_LAYER: n * L}.get(mode)
            if count is None:
                raise ValueError(f"unknown size-table mode {mode}")
            entries = struct.unpack_from(f"<{count}I", buf, off)
            off += 4 * count
            if mode == TABLE_CONSTANT:
                S = entries[0]
            elif mode == TABLE_PER_LAYER:
                S, layer_bytes = 0, entries
            else:  # per-(chunk, layer): content-independent codecs emit
                # identical rows; heterogeneous rows are reserved for future
                # content-dependent codecs and rejected here
                rows = {entries[i * L:(i + 1) * L] for i in range(n)}
                if len(rows) > 1:
                    raise ValueError(
                        "heterogeneous per-chunk size tables unsupported")
                S, layer_bytes = 0, next(iter(rows), (0,) * L)
        else:
            raise ValueError(f"unknown descriptor version {ver}")
        keys = tuple(buf[off + i * KEY_BYTES: off + (i + 1) * KEY_BYTES]
                     for i in range(n))
        if len(buf) != off + n * KEY_BYTES:
            raise ValueError("descriptor length mismatch")
        return cls(keys, L, G, S,
                   Delivery.LAYERWISE if lw else Delivery.CHUNKWISE,
                   RdmaTarget(addr, rkey, length), codec_id,
                   tuple(layer_bytes))

    def to_json(self) -> str:
        return json.dumps({
            "chunk_keys": [k.hex() for k in self.chunk_keys],
            "num_layers": self.num_layers,
            "chunk_tokens": self.chunk_tokens,
            "per_layer_chunk_bytes": self.per_layer_chunk_bytes,
            "layer_bytes": list(self.layer_bytes),
            "delivery": self.delivery.value,
            "codec_id": self.codec_id,
            "rdma_target": dataclasses.asdict(self.rdma_target),
        })


def descriptor_overhead_bytes(desc: Descriptor) -> dict[str, int]:
    """Metadata cost of each encoding of ``desc`` (the ROADMAP's
    "measure before paying" question; reported by bench_codec)."""
    keys = desc.num_chunks * KEY_BYTES
    v3 = len(desc.to_wire(3))
    full_table = _HEADER_V3.size + 4 * desc.num_chunks * desc.num_layers + keys
    out = {"keys": keys, "v3": v3, "v3_metadata": v3 - keys,
           "v3_full_table": full_table,
           "v3_full_table_metadata": full_table - keys}
    if not (desc.layer_bytes and len(set(desc.layer_bytes)) > 1):
        out["v2"] = len(desc.to_wire(2))
        out["v2_metadata"] = out["v2"] - keys
    return out


def make_descriptor(chunk_keys: list[bytes] | tuple[bytes, ...], spec: KVSpec,
                    delivery: Delivery, rdma: RdmaTarget | None = None) -> Descriptor:
    """Descriptor for ``spec``'s deployment: the byte arithmetic (strides,
    RDMA buffer length) is over the *encoded* layout, since that is what the
    storage server range-reads and what crosses the wire.  Variable-rate
    codecs populate the v3 per-layer size table; constant-rate codecs keep
    the degenerate arithmetic stride."""
    rdma = rdma or RdmaTarget(0, 0, len(chunk_keys) * spec.wire_chunk_bytes)
    if spec.is_variable_rate:
        table = tuple(spec.wire_layer_bytes(l) for l in range(spec.num_layers))
        stride = 0
    else:
        table = ()
        stride = spec.wire_layer_bytes(0)
    return Descriptor(tuple(chunk_keys), spec.num_layers, spec.chunk_tokens,
                      stride, delivery, rdma, spec.codec_id, table)
