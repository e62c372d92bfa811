"""Codec interface + identity codec + registry (DESIGN.md §Codec).

A codec maps one chunk's per-layer K/V slices to the layer-major bytes that
live in the object store.  The layer-major *envelope* (KV_L2TD, §3.3) is
shared by every codec — only the per-layer strides change
(``spec.wire_layer_bytes``; constant for the uniform codecs, a per-layer size
table for mixed-bit) — so server-side aggregation stays pure range arithmetic
whatever the codec.

Codecs are parameterised by their spec string (core.types.parse_codec
grammar): ``get_codec("gw4/g64")`` builds the group-wise int4 codec with
64-channel scale groups on first use and memoises it.  Each codec module
registers a *family builder* so the registry never hard-codes the set.

Encode runs once, at commit time, against the model-dtype arrays; decode runs
per aggregated layer payload on the client (numpy here; the serving engine
prefers the fused Pallas dequant kernel when the build supports it).
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Callable

import numpy as np

from repro_torch.core.layout import pack_chunk, unpack_layer_payload, wire_dtype
from repro_torch.core.types import (CODEC_IDENTITY, CodecFormat, KVSpec,
                              codec_wire_id, parse_codec)


def to_wire_words(arr: np.ndarray) -> np.ndarray:
    """Reinterpret to the unsigned word of the same width (bit-exact; bf16
    crosses as uint16)."""
    arr = np.asarray(arr)
    word = {1: np.uint8, 2: np.uint16, 4: np.uint32}[arr.dtype.itemsize]
    return arr.view(word)


class KVCodec(ABC):
    """One wire codec: name, wire id, and the two byte transforms."""

    name: str
    bits: int  # uniform quantized bits per value; 0 = raw model dtype

    @property
    def codec_id(self) -> int:
        return codec_wire_id(self.name)

    @property
    def lossless(self) -> bool:
        return self.bits == 0

    def layer_bits(self, spec: KVSpec, layer: int) -> int:
        """Quantized bits of layer ``layer`` (uniform codecs ignore it)."""
        del spec, layer
        return self.bits

    def layer_group(self, spec: KVSpec, layer: int) -> int:
        """Scale group of layer ``layer``.  Mixed-bit maps can carry
        per-layer group sizes, so every dequant path — fused attention,
        standalone kernel, numpy fallback — must resolve the group through
        this per layer rather than reading a codec-wide attribute once per
        payload."""
        del spec, layer
        return getattr(self, "group", 1)

    @abstractmethod
    def encode_chunk(self, k: np.ndarray, v: np.ndarray, spec: KVSpec) -> bytes:
        """``k``/``v``: [L, G, width] arrays in the model dtype (bf16
        arrives as uint16 wire words, or widened to fp32) →
        ``spec.wire_chunk_bytes`` encoded bytes."""

    @abstractmethod
    def decode_layer_payload(self, payload: bytes, num_chunks: int,
                             spec: KVSpec, dtype, layer: int = 0
                             ) -> tuple[np.ndarray, np.ndarray]:
        """One aggregated layer payload (N encoded layer slices in prefix
        order) → (k, v) [N*G, width] arrays of ``dtype``.  ``layer`` selects
        the per-layer parameters of a variable-rate codec; uniform codecs
        ignore it."""


class IdentityCodec(KVCodec):
    """Bit-exact raw codec — the KV_L2TD layout of `core.layout` unchanged."""

    name = CODEC_IDENTITY
    bits = 0

    def encode_chunk(self, k, v, spec):
        return pack_chunk(to_wire_words(k), to_wire_words(v), spec)

    def decode_layer_payload(self, payload, num_chunks, spec, dtype, layer=0):
        del layer
        k, v = unpack_layer_payload(payload, num_chunks, spec)
        dtype = np.dtype(dtype)
        assert wire_dtype(spec.dtype_bytes).itemsize == dtype.itemsize, \
            (spec.dtype_bytes, dtype)
        return k.view(dtype), v.view(dtype)  # bit view, never a value cast


CODECS: dict[str, KVCodec] = {}
# codec family (CODEC_WIRE_IDS key) -> builder(name, CodecFormat) -> KVCodec;
# populated by each codec module at import time so parameterised spec
# strings ("gw4/g64", "mixed/8844") construct on demand.
FAMILY_BUILDERS: dict[str, Callable[[str, CodecFormat], KVCodec]] = {}


def register(codec: KVCodec) -> KVCodec:
    CODECS[codec.name] = codec
    return codec


def register_family(family: str,
                    builder: Callable[[str, CodecFormat], KVCodec]) -> None:
    FAMILY_BUILDERS[family] = builder


def get_codec(name: str) -> KVCodec:
    codec = CODECS.get(name)
    if codec is not None:
        return codec
    fmt = parse_codec(name)  # raises ValueError on garbage
    builder = FAMILY_BUILDERS.get(fmt.family)
    if builder is None:
        raise ValueError(f"unknown wire codec {name!r}; "
                         f"known: {sorted(CODECS)}")
    return register(builder(name, fmt))


def codec_for_id(codec_id: int) -> KVCodec:
    """Resolve a descriptor's one-byte wire id to the family's *canonical*
    codec (e.g. id 3 -> ``gw8`` at the default group).

    The id names only the decode family; the parameters (scale group, bit
    map) are deployment state carried by ``KVSpec`` — decode paths must use
    ``get_codec(spec.codec)``.  Families with no canonical parameterisation
    (mixed-bit: the bit map is per-deployment) are refused rather than
    guessed."""
    from repro_torch.core.types import CODEC_NAMES
    name = CODEC_NAMES.get(codec_id)
    if name is None:
        raise ValueError(f"unknown wire codec id {codec_id}")
    if name not in CODECS:
        raise ValueError(
            f"wire codec family {name!r} (id {codec_id}) has no canonical "
            f"instance; resolve via get_codec(spec.codec)")
    return CODECS[name]


register(IdentityCodec())
