"""Mixed-bit (variable-rate) KV wire codec (DESIGN.md §Codec).

Early transformer layers are more error-sensitive than late ones (the
ROADMAP's per-layer bit-allocation lever; CacheGen/LMCache observe the same
gradient), so a uniform bit width wastes bytes where they buy nothing.
``MixedBitCodec`` carries one bits entry per layer — each layer's slice is
encoded exactly like the uniform codecs at that layer's width, with the same
(optionally group-wise) scale layout — which makes per-layer wire sizes
*differ*: the descriptor's arithmetic stride generalises to the v3 size
table, and every byte-accounting consumer (planner, pool, cluster sim) sees
per-layer wire bytes.

Spec strings: ``mixed/<digits>[/g<N>]`` — one digit in {4, 8} per layer,
layer 0 first (e.g. ``mixed/88444444/g128``) — or
``mixed/<digits>/g<N1>,<N2>,...`` to vary the scale group per layer too
(coarser groups on the layers already taking the 4-bit hit buys nothing;
finer groups on the sensitive early layers do).  `codec/allocate.py` picks
the map from calibration data under a wire-byte budget.
"""
from __future__ import annotations

from typing import Iterable, Optional, Union

from repro_torch.core.types import CODEC_MIXED, CodecFormat, KVSpec

from .base import register_family
from .quant import _QuantCodec


def mixed_codec_name(bit_map: Iterable[int],
                     group: Union[int, Iterable[int], None] = None) -> str:
    """The spec string selecting ``bit_map`` (+ optional scale group, either
    one int for every layer or one per layer)."""
    digits = "".join(str(b) for b in bit_map)
    if any(d not in "48" for d in digits):
        raise ValueError(f"mixed bit map must contain only 4/8, got {digits!r}")
    base = f"{CODEC_MIXED}/{digits}"
    if group is None:
        return base
    if isinstance(group, int):
        return base + (f"/g{group}" if group > 1 else "")
    groups = list(group)
    if len(groups) != len(digits):
        raise ValueError(f"per-layer groups need {len(digits)} entries, "
                         f"got {len(groups)}")
    if len(set(groups)) == 1:
        return mixed_codec_name(bit_map, groups[0])
    return base + "/g" + ",".join(str(g) for g in groups)


class MixedBitCodec(_QuantCodec):
    """Per-layer bit allocation over the shared quantizer machinery."""

    bits = 0  # no uniform width; per-layer bits come from the map

    def __init__(self, name: str, bit_map: tuple[int, ...], group: int,
                 group_map: Optional[tuple[int, ...]] = None) -> None:
        self.name = name
        self.bit_map = bit_map
        self.group = group
        self.group_map = group_map

    @property
    def lossless(self) -> bool:
        return False  # bits == 0 means "no uniform width", not "raw"

    def layer_bits(self, spec: KVSpec, layer: int) -> int:
        del spec
        return self.bit_map[layer]

    def layer_group(self, spec: KVSpec, layer: int) -> int:
        del spec
        return self.group_map[layer] if self.group_map is not None \
            else self.group


register_family(CODEC_MIXED, lambda name, fmt: MixedBitCodec(
    name, fmt.bit_map, fmt.group, fmt.group_map))
