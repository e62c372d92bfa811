"""AdamW with decoupled weight decay, global-norm clipping, and configurable
moment dtype (bf16 moments halve optimizer memory for the 400B config).

Port of the reference's ``training/optimizer.py``: the same arithmetic,
op for op, in fp32 under ``torch.no_grad()``.  Functional like the
reference: `adamw_update` returns new parameter and state trees and leaves
its arguments untouched.  It works one leaf at a time, and a large leaf in
blocks of _BLOCK elements, so its fp32 temporaries stay small (at
llama3-1-8b's width the embedding alone is 2.1 GB per fp32 copy); every op
is elementwise, so the blocks change no bit.  For the same reason a DTensor
leaf is updated shard by shard: each rank updates its local shards of the
gradient, moments and parameter (which share one placement) and wraps the
results in DTensors of that placement.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.distributed.tensor import DTensor

from .tree import tree_leaves, tree_map

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
# elements `adamw_update` updates at once
_BLOCK = 1 << 25


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"  # bf16 halves optimizer state memory
    warmup_steps: int = 100
    # linear warmup then cosine to lr_min
    lr_min_ratio: float = 0.1
    total_steps: int = 10_000


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """fp32 learning rate at ``step`` (a number or a tensor)."""
    step = torch.as_tensor(step).float()
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr * (cfg.lr_min_ratio + (1 - cfg.lr_min_ratio) * 0.5 *
                    (1 + torch.cos(math.pi * frac)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params, cfg: AdamWConfig):
    """Zero moments in ``cfg.moment_dtype`` and a 0-d int32 step, on the
    parameters' device."""
    mdt = _DTYPES[cfg.moment_dtype]
    zeros = lambda p: torch.zeros_like(p, dtype=mdt)  # noqa: E731
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (sorted-key order) of each leaf's fp32
    sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def _update_block(g, m, v, p, decay: bool, *, cfg, scale, lr, bc1, bc2):
    """The reference's ``upd`` on one block of elements: (new p, new m,
    new v) in fp32.
    In-place ops only reuse fresh fp32 copies; each computes what the
    reference's op computes."""
    f32 = lambda t: t.to(torch.float32, copy=True)  # noqa: E731
    g = f32(g).mul_(scale)
    m32 = f32(m).mul_(cfg.b1).add_(g * (1 - cfg.b1))
    v32 = f32(v).mul_(cfg.b2).add_(g.square_().mul_(1 - cfg.b2))
    delta = (m32 / bc1).div_((v32 / bc2).sqrt_().add_(cfg.eps))
    if decay:
        delta.add_(f32(p).mul_(cfg.weight_decay))
    return f32(p).sub_(delta.mul_(lr)), m32, v32


@torch.no_grad()
def adamw_update(grads, state, params, cfg: AdamWConfig):
    """Returns (new_params, new_state, metrics)."""
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    gnorm = global_norm(grads)
    # a tensor divided by a tensor (`number / tensor` multiplies by the
    # reciprocal, a different rounding)
    scale = torch.clamp_max(
        gnorm.new_tensor(cfg.clip_norm) / torch.clamp_min(gnorm, 1e-9), 1.0)
    mdt = _DTYPES[cfg.moment_dtype]
    bc1 = 1.0 - cfg.b1 ** step.float()
    bc2 = 1.0 - cfg.b2 ** step.float()
    consts = dict(cfg=cfg, scale=_full(scale), lr=_full(lr), bc1=_full(bc1),
                  bc2=_full(bc2))

    def upd(g, m, v, p):
        if isinstance(p, DTensor):
            new = upd(*(t.to_local() for t in (g, m, v, p)))
            return tuple(DTensor.from_local(
                t, p.device_mesh, p.placements, run_check=False,
                shape=p.shape, stride=p.stride()) for t in new)
        new = [torch.empty(p.shape, dtype=dt, device=p.device)
               for dt in (p.dtype, mdt, mdt)]
        decay = p.ndim >= 2  # decay matrices only (norms/bias excluded)
        flat = [t.reshape(-1) for t in (g, m, v, p)]
        for i in range(0, p.numel(), _BLOCK):
            b = slice(i, i + _BLOCK)
            outs = _update_block(*(t[b] for t in flat), decay, **consts)
            for dst, src in zip(new, outs):
                dst.view(-1)[b] = src
        return tuple(new)

    out = tree_map(upd, grads, state["m"], state["v"], params)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return _pick(out, 0), {"m": _pick(out, 1), "v": _pick(out, 2),
                           "step": step}, metrics


def _full(t):
    """A scalar DTensor's value on every rank (a plain tensor as it is)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _pick(tree, i):
    """Element ``i`` of every (p, m, v) leaf tuple of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
