"""Shared value types for the ObjectCache core.

Terminology follows the paper (§2.1, Eq. 1):

    KV_token       = 2 * L * n_kv * d * p          bytes of KV state per token
    S_layer_chunk  = 2 * G * n_kv * d * p          bytes of one layer's slice of a chunk

A *chunk* is the immutable unit of storage: ``G`` consecutive tokens' KV for all
``L`` layers, laid out ``KV_L2TD`` (Layer-major, the 2 K/V matrices concatenated
per layer, then Token position, then hidden Dim).
"""
from __future__ import annotations

import dataclasses
import enum
import functools
from typing import Optional

GiB = 1024**3
MiB = 1024**2
KiB = 1024


# Wire-codec identifiers (DESIGN.md §Codec).  The *arithmetic* of each codec
# (bits per value, scale layout) lives here next to Eq. 1 so that KVSpec and
# Descriptor can size wire payloads without importing `repro_torch.codec`; the
# actual byte transforms live in `src/repro/codec/`.
#
# Codec spec grammar (one string selects codec + parameters):
#
#   identity                      raw model dtype, bit-exact
#   int8 | int4                   symmetric quant, per-channel fp16 scales
#   gw8[/gN] | gw4[/gN]           group-wise scales: one fp16 scale per N
#                                 consecutive channels (default N=128)
#   mixed/<digits>[/gN]           per-layer bit map, one digit in {4, 8} per
#                                 layer (layer 0 first); optional group-wise
#                                 scales (default per-channel)
#   mixed/<digits>/gN1,N2,...     per-layer scale groups too: one entry per
#                                 layer (must match the bit-map length)
#
# e.g. "gw4/g64", "mixed/8844/g128", "mixed/8844/g64,64,128,128".  The
# descriptor's one-byte codec id
# names the *family* (decode algorithm); the parameters (group size, bit
# map) are deployment state carried by KVSpec, exactly like (L, G, d).
CODEC_IDENTITY = "identity"
CODEC_INT8 = "int8"
CODEC_INT4 = "int4"
CODEC_GW8 = "gw8"
CODEC_GW4 = "gw4"
CODEC_MIXED = "mixed"
DEFAULT_SCALE_GROUP = 128  # the ROADMAP's per-128-channel-group default

# codec family -> descriptor wire id
CODEC_WIRE_IDS: dict[str, int] = {CODEC_IDENTITY: 0, CODEC_INT8: 1,
                                  CODEC_INT4: 2, CODEC_GW8: 3, CODEC_GW4: 4,
                                  CODEC_MIXED: 5}
CODEC_NAMES: dict[int, str] = {v: k for k, v in CODEC_WIRE_IDS.items()}


@dataclasses.dataclass(frozen=True)
class CodecFormat:
    """Parsed codec spec: everything sizing needs, nothing codec-specific.

    ``group`` counts *channels sharing one fp16 scale* (1 = per-channel, the
    finest); ``bit_map`` is the per-layer bits of a mixed codec (None for
    uniform codecs, whose every layer uses ``bits``); ``group_map`` is the
    per-layer scale group of a mixed codec whose layers quantize at
    different granularities (None = every layer uses ``group``).
    """

    family: str  # key of CODEC_WIRE_IDS
    bits: int  # uniform quantized bits per value (0 = raw model dtype)
    group: int = 1
    bit_map: Optional[tuple[int, ...]] = None
    group_map: Optional[tuple[int, ...]] = None

    def layer_bits(self, layer: int) -> int:
        return self.bit_map[layer] if self.bit_map is not None else self.bits

    def layer_group(self, layer: int) -> int:
        """Scale group of layer ``layer`` (mixed maps can vary per layer)."""
        return self.group_map[layer] if self.group_map is not None \
            else self.group

    @property
    def is_variable_rate(self) -> bool:
        """True when per-layer wire strides differ (descriptor needs v3)."""
        return (self.bit_map is not None and len(set(self.bit_map)) > 1) or \
            (self.group_map is not None and len(set(self.group_map)) > 1)


@functools.lru_cache(maxsize=None)
def parse_codec(codec: str) -> CodecFormat:
    """Parse a codec spec string (grammar above); raises ValueError."""
    parts = codec.split("/")
    name, rest = parts[0], parts[1:]

    def take_group(default: int) -> int:
        if not rest:
            return default
        g = rest.pop(0)
        if not (g.startswith("g") and g[1:].isdigit() and int(g[1:]) > 0):
            raise ValueError(f"bad scale-group suffix {g!r} in codec {codec!r}")
        return int(g[1:])

    if name == CODEC_IDENTITY:
        fmt = CodecFormat(CODEC_IDENTITY, 0)
    elif name in (CODEC_INT8, CODEC_INT4):
        fmt = CodecFormat(name, int(name[3:]))
    elif name in (CODEC_GW8, CODEC_GW4):
        fmt = CodecFormat(name, int(name[2:]), take_group(DEFAULT_SCALE_GROUP))
    elif name == CODEC_MIXED:
        if not rest:
            raise ValueError(f"mixed codec needs a bit map: {codec!r}")
        digits = rest.pop(0)
        if not digits or any(d not in "48" for d in digits):
            raise ValueError(
                f"mixed bit map must be digits in {{4,8}}, got {digits!r}")
        bit_map = tuple(int(d) for d in digits)
        group, group_map = 1, None
        if rest:  # g<N> (uniform) or g<N1>,<N2>,... (one entry per layer)
            g = rest.pop(0)
            vals = g[1:].split(",") if g.startswith("g") else []
            if not vals or any(not v.isdigit() or int(v) <= 0 for v in vals):
                raise ValueError(
                    f"bad scale-group suffix {g!r} in codec {codec!r}")
            if len(vals) == 1:
                group = int(vals[0])
            elif len(vals) == len(bit_map):
                groups = tuple(int(v) for v in vals)
                group, group_map = groups[0], groups
            else:
                raise ValueError(
                    f"per-layer scale groups need one entry per bit-map "
                    f"digit ({len(bit_map)}), got {len(vals)} in {codec!r}")
        fmt = CodecFormat(CODEC_MIXED, 0, group, bit_map, group_map)
    else:
        raise ValueError(f"unknown wire codec {codec!r}; "
                         f"families: {sorted(CODEC_WIRE_IDS)}")
    if rest:
        raise ValueError(f"trailing codec spec parts {rest!r} in {codec!r}")
    return fmt


def codec_wire_id(codec: str) -> int:
    return CODEC_WIRE_IDS[parse_codec(codec).family]


class Delivery(enum.Enum):
    """Delivery order requested by a descriptor (paper Table 1, §3.4).

    ``HYBRID`` is a *serving-side* mode (DESIGN.md §Compute-or-load): the
    fetch-span of a prefix travels LAYERWISE while the rest is recomputed on
    the GPU.  Descriptors never carry it — the fetched span is an ordinary
    layerwise descriptor for a shorter prefix.
    """

    CHUNKWISE = "chunkwise"
    LAYERWISE = "layerwise"
    HYBRID = "hybrid"


@dataclasses.dataclass(frozen=True)
class KVSpec:
    """Geometry of the KV cache for one model deployment.

    Every chunk in the same deployment has identical shape, which is what lets
    the descriptor stay "arithmetic rather than manifest-heavy" (§3.2): the byte
    range of layer ``l`` inside any chunk is ``[l*S, (l+1)*S)``.
    """

    num_layers: int  # L
    chunk_tokens: int  # G
    num_kv_heads: int  # n_kv
    head_dim: int  # d
    dtype_bytes: int = 2  # p (bf16 default)
    codec: str = CODEC_IDENTITY  # wire codec (DESIGN.md §Codec)

    def __post_init__(self):
        fmt = parse_codec(self.codec)  # raises on an unknown/garbled spec
        if fmt.family == CODEC_IDENTITY:
            return
        for g in set(fmt.group_map) if fmt.group_map is not None \
                else {fmt.group}:
            if self.width % g:
                raise ValueError(
                    f"scale group {g} does not divide width {self.width} "
                    f"(codec {self.codec!r})")
        if fmt.bit_map is not None and len(fmt.bit_map) != self.num_layers:
            raise ValueError(
                f"mixed bit map has {len(fmt.bit_map)} entries for "
                f"{self.num_layers} layers (codec {self.codec!r})")
        bits = set(fmt.bit_map) if fmt.bit_map is not None else {fmt.bits}
        if 4 in bits and self.width % 2:
            raise ValueError(f"4-bit packing needs an even width, "
                             f"got {self.width} (codec {self.codec!r})")

    @property
    def width(self) -> int:
        """Payload width of one token row of one matrix (n_kv * d values)."""
        return self.num_kv_heads * self.head_dim

    @property
    def per_layer_chunk_bytes(self) -> int:
        """S = 2 * G * n_kv * d * p (Eq. 1) — the *decoded* per-layer size."""
        return 2 * self.chunk_tokens * self.width * self.dtype_bytes

    @property
    def chunk_bytes(self) -> int:
        return self.num_layers * self.per_layer_chunk_bytes

    @property
    def bytes_per_token(self) -> int:
        """KV_token = 2 * L * n_kv * d * p (Eq. 1)."""
        return 2 * self.num_layers * self.width * self.dtype_bytes

    @property
    def bytes_per_token_per_layer(self) -> int:
        return 2 * self.width * self.dtype_bytes

    def matched_payload_bytes(self, num_chunks: int) -> int:
        """W = N * L * S (Eq. 2) — total *decoded* bytes of a matched prefix."""
        return num_chunks * self.chunk_bytes

    # -- wire sizing (DESIGN.md §Codec) --------------------------------------
    # Quantized codecs store, per layer slice of a chunk, one fp16 scale per
    # channel *group* per matrix (K and V separately) followed by the two
    # quantized [G, width] matrices.  Every chunk of a deployment has the
    # same per-layer wire sizes, but a mixed-bit codec makes the sizes differ
    # *across layers* — the descriptor's arithmetic stride then becomes a
    # per-layer size table (Descriptor v3), of which the constant stride is
    # the degenerate single-entry case.
    @property
    def codec_format(self) -> CodecFormat:
        return parse_codec(self.codec)

    @property
    def codec_id(self) -> int:
        return CODEC_WIRE_IDS[self.codec_format.family]

    @property
    def scale_groups(self) -> int:
        """fp16 scales per matrix per layer slice (width / channel group).
        Only defined when every layer shares one group size; per-layer
        callers use :meth:`layer_scale_groups`."""
        fmt = self.codec_format
        if fmt.group_map is not None and len(set(fmt.group_map)) > 1:
            raise ValueError(
                f"codec {self.codec!r} has per-layer scale groups; "
                f"use layer_scale_groups(layer)")
        return 0 if fmt.bits == 0 and fmt.bit_map is None \
            else self.width // fmt.group

    def layer_scale_groups(self, layer: int) -> int:
        """fp16 scales per matrix in layer ``layer``'s slice of a chunk."""
        fmt = self.codec_format
        return 0 if fmt.bits == 0 and fmt.bit_map is None \
            else self.width // fmt.layer_group(layer)

    @property
    def scale_bytes_per_layer(self) -> int:
        return 2 * self.scale_groups * 2  # 2 matrices * groups * fp16

    def layer_scale_bytes(self, layer: int) -> int:
        return 2 * self.layer_scale_groups(layer) * 2

    def wire_layer_bytes(self, layer: int) -> int:
        """Encoded bytes of layer ``layer``'s slice of any chunk (the entry
        of the descriptor-v3 size table)."""
        bits = self.codec_format.layer_bits(layer)
        if bits == 0:
            return self.per_layer_chunk_bytes
        per_matrix = (self.chunk_tokens * self.width * bits + 7) // 8
        return self.layer_scale_bytes(layer) + 2 * per_matrix

    @functools.cached_property
    def wire_layer_offsets(self) -> tuple[int, ...]:
        """Prefix sums of the per-layer wire sizes: layer ``l`` of any stored
        chunk occupies bytes [offsets[l], offsets[l+1])."""
        off, total = [0], 0
        for l in range(self.num_layers):
            total += self.wire_layer_bytes(l)
            off.append(total)
        return tuple(off)

    @property
    def is_variable_rate(self) -> bool:
        """True when per-layer wire strides differ (needs the v3 table)."""
        return self.codec_format.is_variable_rate

    @property
    def wire_per_layer_chunk_bytes(self) -> int:
        """S_wire — the constant per-layer encoded stride.  Only defined for
        constant-rate codecs; variable-rate callers must use
        :meth:`wire_layer_bytes` / :attr:`wire_layer_offsets`."""
        if self.is_variable_rate:
            raise ValueError(
                f"codec {self.codec!r} has variable per-layer wire sizes; "
                f"use wire_layer_bytes(layer) / wire_layer_offsets")
        return self.wire_layer_bytes(0)

    @property
    def wire_chunk_bytes(self) -> int:
        return self.wire_layer_offsets[-1]

    @property
    def mean_wire_layer_bytes(self) -> float:
        """Average encoded per-layer stride — the scalar per-layer demand a
        bandwidth scheduler sees (exact, not rounded: * L recovers the chunk
        total)."""
        return self.wire_chunk_bytes / self.num_layers

    @property
    def wire_bytes_per_token_per_layer(self) -> float:
        """Codec-adjusted analogue of Eq. 1's 2*n_kv*d*p byte density."""
        return self.mean_wire_layer_bytes / self.chunk_tokens

    def matched_wire_bytes(self, num_chunks: int) -> int:
        """W_wire = N * sum_l S_wire(l) — bytes that actually cross the wire."""
        return num_chunks * self.wire_chunk_bytes

    @property
    def wire_ratio(self) -> float:
        """W_wire / W — < 1 under compression (the bytes-on-the-wire lever)."""
        return self.wire_chunk_bytes / self.chunk_bytes


@dataclasses.dataclass(frozen=True)
class MatchResult:
    """Result of a radix-tree prefix lookup (§2.1)."""

    chunk_keys: tuple[bytes, ...]
    matched_tokens: int

    @property
    def num_chunks(self) -> int:
        return len(self.chunk_keys)

    @property
    def is_hit(self) -> bool:
        return self.matched_tokens > 0


@dataclasses.dataclass
class Timing:
    """Per-request latency breakdown (paper Fig. 10 splits these components)."""

    control_plane_s: float = 0.0
    storage_s: float = 0.0
    network_s: float = 0.0

    @property
    def total_s(self) -> float:
        return self.control_plane_s + self.storage_s + self.network_s

    def __add__(self, other: "Timing") -> "Timing":
        return Timing(
            self.control_plane_s + other.control_plane_s,
            self.storage_s + other.storage_s,
            self.network_s + other.network_s,
        )


@dataclasses.dataclass
class LayerReady:
    """A layer-ready notification: layer ``l``'s payload landed at ``t_ready_s``."""

    layer: int
    t_ready_s: float
    nbytes: int


@dataclasses.dataclass(frozen=True)
class FlowRequest:
    """One layerwise retrieval competing for shared bandwidth (§3.6).

    ``bytes_per_layer`` is s_i; ``layer_compute_s`` is c_i.  Both are
    approximately constant across layers because every layer has the same KV
    head count and block structure (paper footnote 1).
    """

    req_id: str
    bytes_per_layer: float  # s_i
    layer_compute_s: float  # c_i
    num_layers: int

    @property
    def zero_stall_rate(self) -> float:
        """r_i* = s_i / c_i — bandwidth beyond this yields no TTFT benefit."""
        return self.bytes_per_layer / self.layer_compute_s

    @property
    def total_bytes(self) -> float:
        return self.bytes_per_layer * self.num_layers
