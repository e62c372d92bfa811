"""Group-wise-scale quantized KV codecs (DESIGN.md §Codec).

The classic ``int8``/``int4`` codecs store one fp16 scale per channel per
matrix — 2·width·2 bytes per layer slice, a fixed tax that dominates at
small chunk granularity G (the ROADMAP's "cut the fp16 scale overhead at
small G" lever).  ``gw8``/``gw4`` share one scale across ``group``
consecutive channels instead (absmax over the token axis and the group), so
the scale block shrinks by ``group``x at a bounded accuracy cost: within a
group the worst channel's scale quantizes its neighbours, which is why the
default group (128, LMCache-style) still tracks per-channel error closely on
real KV while an entire-width group would not.

Spec strings: ``gw8`` / ``gw4`` (group 128), ``gw8/g<N>`` / ``gw4/g<N>``
for explicit groups; N must divide the payload width.
"""
from __future__ import annotations

from repro_torch.core.types import (CODEC_GW4, CODEC_GW8, DEFAULT_SCALE_GROUP,
                              CodecFormat)

from .base import register, register_family
from .quant import _QuantCodec


class GroupwiseCodec(_QuantCodec):
    """Symmetric integer codec with per-(channel-group) fp16 scales."""

    def __init__(self, name: str, bits: int, group: int) -> None:
        self.name = name
        self.bits = bits
        self.group = group


def _build(name: str, fmt: CodecFormat) -> GroupwiseCodec:
    return GroupwiseCodec(name, fmt.bits, fmt.group)


register_family(CODEC_GW8, _build)
register_family(CODEC_GW4, _build)
# the default-group variants, eagerly registered like int8/int4
register(GroupwiseCodec(CODEC_GW8, 8, DEFAULT_SCALE_GROUP))
register(GroupwiseCodec(CODEC_GW4, 4, DEFAULT_SCALE_GROUP))
