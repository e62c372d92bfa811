"""Unified model interface (port of the reference's ``models/api.py``).

    prefill(params, batch, prefix, plen)    -> (logits, cache)
    decode_step(params, cache, token, pos)  -> (logits, cache)
    init_params(generator)                  -> params
    init_cache(batch, seq_len)              -> zero [L,2,B,S,KV,dh] cache

``batch`` is a dict with ``tokens`` (and ``embeds`` for the VLM frontend).
Only the dense and vlm families are ported; the others raise.  A model lives
on one device, ``"cuda"`` unless the caller asks for another.
"""
from __future__ import annotations

import dataclasses

import torch

from . import dense
from .config import ModelConfig

PORTED_FAMILIES = ("dense", "vlm")


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises for a CUDA device that is not there
    (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           f"available; pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device

    def init_params(self, generator: torch.Generator):
        """Random weights drawn from ``generator`` (a generator on the
        model's device)."""
        return dense.init_params(self.cfg, generator, self.device)

    def prefill(self, params, batch, prefix=None, prefix_len: int = 0):
        return dense.prefill(params, self.cfg, batch["tokens"], prefix,
                             prefix_len, embeds=batch.get("embeds"))

    def decode_step(self, params, cache, token, pos):
        return dense.decode_step(params, self.cfg, cache, token, pos)

    def init_cache(self, batch: int, seq_len: int):
        return dense.init_cache(self.cfg, batch, seq_len, self.device)


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ported: "
            f"{', '.join(PORTED_FAMILIES)}); see ROADMAP.md")
    return Model(cfg, resolve_device(device))
