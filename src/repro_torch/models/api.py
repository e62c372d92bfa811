"""Unified model interface (port of the reference's ``models/api.py``).

    loss(params, batch, remat=False)        -> scalar (differentiable)
    prefill(params, batch, prefix, plen)    -> (logits, cache)
    decode_step(params, cache, token, pos)  -> (logits, cache)
    init_params(generator)                  -> params
    init_cache(batch, seq_len)              -> zero cache
    param_spec() / cache_spec(batch, seq_len) -> the same trees on ``meta``

``batch`` is a dict with ``tokens`` (``labels`` and an optional
``loss_mask`` for ``loss``; ``embeds`` for the VLM frontend and the Whisper
encoder).  Every family of the registry is ported: dense and vlm (`dense`),
moe, ssm, hybrid and encdec, and DeepSeek-V2's latent attention (`mla`, an
`MLAConfig` of family moe); the cache is a [L,2,B,S,KV,dh] tensor for
dense/vlm/moe, one latent a layer [L,B,S,W] for `mla`, and a dict of states
for the others.  Gradients of ``loss``
come from ``torch.autograd`` (``training.train_step``).  A model lives on
one device, ``"cuda"`` unless the caller asks for another.  ``param_spec``
and ``cache_spec`` build the trees on the ``meta`` device (shapes and
dtypes, no storage), where the reference's ``jax.eval_shape`` gives
``ShapeDtypeStruct``s, so the dry run can shard terabyte caches it never
allocates.
"""
from __future__ import annotations

import dataclasses

import torch

from . import dense, encdec, hybrid, mla, moe, ssm
from .config import MLAConfig, ModelConfig

_MODULES = {"dense": dense, "vlm": dense, "moe": moe, "ssm": ssm,
            "hybrid": hybrid, "encdec": encdec}
PORTED_FAMILIES = tuple(_MODULES)


def _module(cfg: ModelConfig):
    """The module of ``cfg``'s model functions: its family's, or `mla`."""
    return mla if isinstance(cfg, MLAConfig) else _MODULES[cfg.family]


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

    @property
    def _mod(self):
        return _module(self.cfg)

    def init_params(self, generator: torch.Generator):
        """Random weights drawn from ``generator`` (a generator on the
        model's device)."""
        return self._mod.init_params(self.cfg, generator, self.device)

    def loss(self, params, batch, *, remat: bool = False):
        """Mean token cross-entropy (+ the load-balance term for MoE);
        ``remat`` recomputes layer activations in the backward."""
        if self.cfg.family == "moe":
            return self._mod.loss(params, self.cfg, batch, remat=remat,
                                  dispatch=self.cfg_dispatch())
        return self._mod.loss(params, self.cfg, batch, remat=remat)

    def cfg_dispatch(self) -> str:
        return getattr(self.cfg, "moe_dispatch", "ragged")

    def prefill(self, params, batch, prefix=None, prefix_len: int = 0):
        cfg = self.cfg
        if cfg.family == "encdec":
            return encdec.prefill(params, cfg, batch["tokens"],
                                  batch["embeds"], prefix, prefix_len)
        if cfg.family in ("dense", "vlm"):
            return dense.prefill(params, cfg, batch["tokens"], prefix,
                                 prefix_len, embeds=batch.get("embeds"))
        return self._mod.prefill(params, cfg, batch["tokens"], prefix,
                                 prefix_len)

    def decode_step(self, params, cache, token, pos):
        return self._mod.decode_step(params, self.cfg, cache, token, pos)

    def init_cache(self, batch: int, seq_len: int):
        return self._mod.init_cache(self.cfg, batch, seq_len, self.device)

    def param_spec(self):
        """`init_params`' tree on the ``meta`` device."""
        return self._mod.init_params(self.cfg, torch.Generator(),
                                     torch.device("meta"))

    def cache_spec(self, batch: int, seq_len: int):
        """`init_cache`'s tree on the ``meta`` device."""
        return self._mod.init_cache(self.cfg, batch, seq_len,
                                    torch.device("meta"))

    def param_count(self) -> int:
        return self.cfg.param_count()


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    if cfg.family not in _MODULES:
        raise ValueError(f"unknown family {cfg.family!r} (known: "
                         f"{', '.join(PORTED_FAMILIES)})")
    return Model(cfg, resolve_device(device))
