"""Dense decoder-only transformer (Qwen3 / SmolLM / Gemma / Llama families).

Port of the reference's ``models/dense.py``.  Layer parameters stay stacked
along a leading L axis, as in the reference; ``lax.scan`` becomes a Python
loop over layers.  Entry points:

  ``prefill``      — full or suffix prefill; optional ObjectCache prefix KV
                     injection [L,2,B,P,KV,dh]; returns last logits + cache
  ``decode_step``  — one token against a [L,2,B,S,KV,dh] cache
"""
from __future__ import annotations

import torch

from . import layers as nn
from .config import ModelConfig


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, generator: torch.Generator, device):
    """Random weights with the reference's shapes and standard deviations
    (``layers.init_linear`` / ``init_embedding``); layers stacked on [L]."""
    L = (cfg.num_layers,)
    return {
        "embed": nn.init_embedding(cfg, generator, device),
        "layers": {
            "ln1": nn.init_rmsnorm(cfg.d_model, nn.pdt(cfg), device, L),
            "attn": nn.init_attention(cfg, generator, device, L),
            "ln2": nn.init_rmsnorm(cfg.d_model, nn.pdt(cfg), device, L),
            "mlp": nn.init_mlp(cfg, generator, device, L),
        },
        "final_norm": nn.init_rmsnorm(cfg.d_model, nn.pdt(cfg), device),
    }


def layer_params(params, l: int):
    """Layer ``l``'s slice of the stacked [L, ...] layer parameters."""
    def take(tree):
        if isinstance(tree, dict):
            return {k: take(v) for k, v in tree.items()}
        return tree[l]
    return take(params["layers"])


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def block(p, cfg: ModelConfig, x, positions, prefix_kv=None):
    """Pre-norm transformer block; returns (x, (k, v) of this segment)."""
    h, seg_kv = nn.attention(p["attn"], cfg, nn.rmsnorm(p["ln1"], x),
                             positions=positions, causal=True,
                             prefix_kv=prefix_kv)
    x = x + h
    x = x + nn.mlp(p["mlp"], nn.rmsnorm(p["ln2"], x), cfg.mlp_kind)
    return x, seg_kv


def decode_block(p, cfg: ModelConfig, x, k_cache, v_cache, pos):
    h, (k_cache, v_cache) = nn.decode_attention(
        p["attn"], cfg, nn.rmsnorm(p["ln1"], x), k_cache, v_cache, pos)
    x = x + h
    x = x + nn.mlp(p["mlp"], nn.rmsnorm(p["ln2"], x), cfg.mlp_kind)
    return x, k_cache, v_cache


# ---------------------------------------------------------------------------
# model fns
# ---------------------------------------------------------------------------
def prefill(params, cfg: ModelConfig, tokens, prefix_kv=None,
            prefix_len: int = 0, embeds=None):
    """Compute the (suffix) prompt; returns (last-token logits [B, V] fp32,
    kv [L,2,B,S_total,KV,dh]).

    ``prefix_kv``: ObjectCache-matched KV [L, 2, B, P, KV, dh] (or None).
    The returned cache contains prefix + suffix so decode sees the full context.
    """
    x = nn.embed(params["embed"], cfg, tokens)
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    S = x.shape[1]
    positions = prefix_len + torch.arange(S, device=x.device)[None, :]
    segs = []
    for l in range(cfg.num_layers):
        pkv = None if prefix_kv is None else (prefix_kv[l, 0], prefix_kv[l, 1])
        x, seg = block(layer_params(params, l), cfg, x, positions,
                       prefix_kv=pkv)
        segs.append(torch.stack(seg))  # [2, B, S, KV, dh]
    seg_kv = torch.stack(segs)
    x = nn.rmsnorm(params["final_norm"], x)
    lg = nn.logits(params["embed"], cfg, x[:, -1:, :])[:, 0, :]
    if prefix_kv is not None:
        full_kv = torch.cat([prefix_kv.to(seg_kv.dtype), seg_kv], dim=3)
    else:
        full_kv = seg_kv
    return lg, full_kv


def decode_step(params, cfg: ModelConfig, cache, token, pos):
    """One decode step.  cache: [L, 2, B, S, KV, dh]; token: [B, 1]; pos: [B].

    Writes the new token's K/V into ``cache`` in place and returns
    (logits [B, V] fp32, cache).
    """
    x = nn.embed(params["embed"], cfg, token)
    for l in range(cfg.num_layers):
        x, _, _ = decode_block(layer_params(params, l), cfg, x, cache[l, 0],
                               cache[l, 1], pos)
    x = nn.rmsnorm(params["final_norm"], x)
    lg = nn.logits(params["embed"], cfg, x)[:, 0, :]
    return lg, cache


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device):
    return torch.zeros((cfg.num_layers, 2, batch, seq_len, cfg.num_kv_heads,
                        cfg.head_dim), dtype=nn.dt(cfg), device=device)
