"""A frozen copy of the int8 KV codec's arithmetic (DESIGN.md Codec), in
torch: per 256-token chunk of one layer's K (or V) [G, KV*dh], one scale per
channel, the absolute maximum over the chunk's tokens over 127 rounded to
fp16 (capped at fp16's largest), codes rounded half to even and clipped to
[-127, 127].  The reference applies it to its own fp32 prefix KV.
"""
from __future__ import annotations

import torch

QMAX = 127
FP16_MAX = 65504.0


def int8_round_trip(x: torch.Tensor, chunk_tokens: int) -> torch.Tensor:
    """x [P, KV, dh] fp32, P a multiple of ``chunk_tokens`` -> the values
    the int8 wire gives back for it, fp32."""
    P, KV, dh = x.shape
    xc = x.reshape(P // chunk_tokens, chunk_tokens, KV * dh)
    scale = (xc.abs().amax(dim=1, keepdim=True) / QMAX).clamp(max=FP16_MAX)
    scale = scale.to(torch.float16).float()
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xc / safe), -QMAX, QMAX)
    return (q * scale).reshape(P, KV, dh)


def round_trip(codec: str, x: torch.Tensor, chunk_tokens: int
               ) -> torch.Tensor:
    if codec == "identity":  # lossless: the prefix comes back as it went
        return x
    if codec == "int8":
        return int8_round_trip(x, chunk_tokens)
    raise ValueError(f"the reference has no copy of codec {codec!r}")
