"""Zamba2-style hybrid: Mamba2 backbone + ONE weight-shared attention+MLP
block applied every ``shared_attn_every`` Mamba layers.

Port of the reference's ``models/hybrid.py``.  Layout for L Mamba layers
with stride k (lead = L % k leading Mamba layers):

    [mamba x lead]  then  groups of { shared_attn_block ; mamba x k }

The shared block's *weights* are reused at every application, but each
application keeps its own KV cache (weights shared, state not).  As in the
reference, the per-application LoRA and the concat-with-embedding input of
the released Zamba2 are left out (DESIGN.md).
"""
from __future__ import annotations

import torch

from . import dense
from . import layers as nn
from . import ssm
from .config import ModelConfig


def _layout(cfg: ModelConfig) -> tuple[int, int]:
    k = cfg.shared_attn_every
    return cfg.num_layers % k, cfg.num_layers // k


def _group(tree, lead: int, groups: int, k: int):
    """The [lead:] part of a stacked [L, ...] tree as [groups, k, ...]."""
    if isinstance(tree, dict):
        return {n: _group(v, lead, groups, k) for n, v in tree.items()}
    return tree[lead:].reshape(groups, k, *tree.shape[1:])


def _head(tree, lead: int):
    if isinstance(tree, dict):
        return {n: _head(v, lead) for n, v in tree.items()}
    return tree[:lead]


def init_params(cfg: ModelConfig, generator: torch.Generator, device):
    lead, groups = _layout(cfg)
    embed = nn.init_embedding(cfg, generator, device)
    mamba = ssm.init_ssm_layer(cfg, generator, device, (cfg.num_layers,))
    return {
        "embed": embed,
        "lead": _head(mamba, lead),
        "groups": _group(mamba, lead, groups, cfg.shared_attn_every),
        # ONE block, applied `groups` times
        "shared": dense.init_layer(cfg, generator, device),
        "final_norm": nn.init_rmsnorm(cfg.d_model, nn.pdt(cfg), device),
    }


def forward(params, cfg: ModelConfig, tokens, *, remat: bool = False):
    """[B,S] -> hidden [B,S,d].  ``remat`` checkpoints each group (the
    shared block and its k Mamba layers), as the reference does; the shared
    block's gradient sums over its applications."""
    x = nn.embed(params["embed"], cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for p in dense.unstack(params["lead"]):
        x, _ = ssm.ssm_block(p, cfg, x)

    def group_body(shared, group_p, h):
        h, _ = dense.block(shared, cfg, h, positions)
        for p in dense.unstack(group_p):
            h, _ = ssm.ssm_block(p, cfg, h)
        return h

    group_body = nn.remat(group_body, remat)
    for group_p in dense.unstack(params["groups"]):
        x = group_body(params["shared"], group_p, x)
    return nn.rmsnorm(params["final_norm"], x)


def loss(params, cfg: ModelConfig, batch, *, remat: bool = False):
    x = forward(params, cfg, batch["tokens"], remat=remat)
    lg = nn.logits(params["embed"], cfg, x)
    return nn.cross_entropy(lg, batch["labels"], batch.get("loss_mask"))


def prefill(params, cfg: ModelConfig, tokens, prefix_cache=None,
            prefix_len: int = 0):
    """Returns (last logits [B, V] fp32, cache).  Cache:
    {lead: ssm states [lead], groups: ssm states [G, k],
     attn: [G, 2, B, S, KV, dh]}.

    ``prefix_cache``: optional snapshot of the same structure: SSM states
    replace recomputation; attention KV is injected as prefix."""
    x = nn.embed(params["embed"], cfg, tokens)
    S = x.shape[1]
    positions = prefix_len + torch.arange(S, device=x.device)[None, :]
    pc = prefix_cache
    x, lead_states = ssm.run_layers(params["lead"], cfg, x,
                                    None if pc is None else pc["lead"])
    _, groups = _layout(cfg)
    group_states, segs = [], []
    for g in range(groups):
        pkv = None if pc is None else (pc["attn"][g, 0], pc["attn"][g, 1])
        x, seg = dense.block(params["shared"], cfg, x, positions,
                             prefix_kv=pkv)
        x, st = ssm.run_layers(dense.take(params["groups"], g), cfg, x,
                               None if pc is None
                               else dense.take(pc["groups"], g))
        group_states.append(st)
        segs.append(torch.stack(seg))
    seg_kv = torch.stack(segs)
    x = nn.rmsnorm(params["final_norm"], x)
    lg = nn.logits(params["embed"], cfg, x[:, -1:, :])[:, 0, :]
    if pc is not None:
        seg_kv = torch.cat([pc["attn"].to(seg_kv.dtype), seg_kv], dim=3)
    return lg, {"lead": lead_states,
                "groups": ssm.stack_states(group_states), "attn": seg_kv}


def decode_step(params, cfg: ModelConfig, cache, token, pos):
    """One token; each application's KV is written into ``cache["attn"]``
    in place.  Returns (logits [B, V] fp32, new cache)."""
    x = nn.embed(params["embed"], cfg, token)
    x, lead_states = ssm.run_layers(params["lead"], cfg, x, cache["lead"],
                                    decode=True)
    _, groups = _layout(cfg)
    group_states = []
    for g in range(groups):
        kv = cache["attn"][g]
        x, _, _ = dense.decode_block(params["shared"], cfg, x, kv[0], kv[1],
                                     pos)
        x, st = ssm.run_layers(dense.take(params["groups"], g), cfg, x,
                               dense.take(cache["groups"], g), decode=True)
        group_states.append(st)
    x = nn.rmsnorm(params["final_norm"], x)
    lg = nn.logits(params["embed"], cfg, x)[:, 0, :]
    return lg, {"lead": lead_states,
                "groups": ssm.stack_states(group_states),
                "attn": cache["attn"]}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device):
    lead, groups = _layout(cfg)
    k = cfg.shared_attn_every
    g = ssm.empty_states(cfg, batch, groups * k, device)
    return {
        "lead": ssm.empty_states(cfg, batch, lead, device),
        "groups": {n: a.reshape(groups, k, *a.shape[1:])
                   for n, a in g.items()},
        "attn": torch.zeros((groups, 2, batch, seq_len, cfg.num_kv_heads,
                             cfg.head_dim), dtype=nn.dt(cfg), device=device),
    }
