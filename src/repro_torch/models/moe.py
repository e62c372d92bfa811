"""Mixture-of-experts decoder (Qwen3-MoE 128e/top-8, Llama4-Maverick
128e/top-1 + shared expert, alternating dense/MoE layers).

Port of the reference's ``models/moe.py`` for serving: the router and the
dropless ragged dispatch.  The reference's ``lax.ragged_dot`` is an XLA
product, not a Pallas kernel, so the expert products stay ``torch.matmul``,
one per expert that has tokens: tokens are sorted by expert, the counts come
to the host once per layer, and empty experts are skipped.  The k expert
outputs of a token are gathered back through the inverse permutation and
summed over k in a fixed order (no atomic ``index_add_``), so the same
tokens at the same shapes give the same bits on every run.

Parameter layout as in the reference (so ``bridge.params_from_reference``
carries weights across unchanged): router [d, E] fp32, experts [E, d, f]
and [E, f, d]; layers stacked on [L] (``moe_every == 1``) or on [L/2]
super-layers ``{"dense", "moe"}`` (``moe_every == 2``, llama4).

The capacity dispatch and ``loss`` are training and are not ported yet
(ROADMAP.md Queue 1 item 5).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import dense
from . import layers as nn
from .config import ModelConfig


# ---------------------------------------------------------------------------
# expert MLP with router
# ---------------------------------------------------------------------------
def init_moe_mlp(cfg: ModelConfig, generator, device, lead: tuple = ()):
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts

    def normal(shape, stddev, dtype):
        return nn.normal_(torch.empty(lead + shape, dtype=dtype,
                                      device=device), stddev, generator)
    p = {
        "router": normal((d, E), d ** -0.5, torch.float32),
        "wi_gate": normal((E, d, f), d ** -0.5, nn.pdt(cfg)),
        "wi_up": normal((E, d, f), d ** -0.5, nn.pdt(cfg)),
        "wo": normal((E, f, d), f ** -0.5, nn.pdt(cfg)),
    }
    if cfg.shared_expert_d_ff:
        p["shared"] = nn.init_mlp(cfg, generator, device, lead,
                                  d_ff=cfg.shared_expert_d_ff)
    return p


def _route(p, cfg: ModelConfig, xf):
    """Router: returns (topw [T,k] renormalised, topi [T,k], aux loss)."""
    E, k = cfg.num_experts, cfg.experts_per_token
    T = xf.shape[0]
    router_logits = xf.float() @ p["router"].float()  # [T, E]
    probs = torch.softmax(router_logits, dim=-1)
    topw, topi = torch.topk(probs, k, dim=-1)  # [T, k]
    topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)
    # load-balance auxiliary loss (Switch style): E * sum_e f_e * P_e
    f_e = torch.bincount(topi.reshape(-1), minlength=E).float() / (T * k)
    P_e = probs.mean(0)
    aux = E * torch.sum(f_e * P_e)
    return topw, topi, aux


def _moe_ragged(p, cfg: ModelConfig, xf, topw, topi):
    """Dropless dispatch: exactly causal (no capacity drops), as the serving
    path needs, and only the active T*k*d*f work."""
    T, d = xf.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    flat_e = topi.reshape(T * k)
    order = torch.argsort(flat_e, stable=True)
    stok = order // k  # token of each expert-sorted entry
    counts = torch.bincount(flat_e, minlength=E).tolist()  # one host sync
    xs = xf[stok]  # [T*k, d] in expert-sorted order
    out = torch.empty_like(xs)
    start = 0
    for e, n in enumerate(counts):
        if n == 0:
            continue
        seg = xs[start:start + n]
        h = F.silu(seg @ p["wi_gate"][e].to(seg.dtype)) \
            * (seg @ p["wi_up"][e].to(seg.dtype))
        out[start:start + n] = h @ p["wo"][e].to(h.dtype)
        start += n
    # back to token order through the inverse permutation: [T, k, d]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * k, device=order.device)
    contrib = out[inv].view(T, k, d) * topw.to(xf.dtype)[..., None]
    y = contrib[:, 0]
    for j in range(1, k):  # a fixed order of the k adds
        y = y + contrib[:, j]
    return y


def moe_mlp(p, cfg: ModelConfig, x, dispatch: str = "ragged"):
    """x: [B, S, d] -> (y, aux_loss)."""
    if dispatch != "ragged":
        raise NotImplementedError(
            f"dispatch={dispatch!r}: only the ragged dispatch is ported (the "
            f"capacity dispatch is training; see ROADMAP.md)")
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    topw, topi, aux = _route(p, cfg, xf)
    y = _moe_ragged(p, cfg, xf, topw, topi)
    if "shared" in p:
        y = y + nn.mlp(p["shared"], xf, "swiglu")
    return y.reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# layers: homogeneous (moe_every == 1) or alternating dense/MoE super-layers
# ---------------------------------------------------------------------------
def init_moe_layer(cfg: ModelConfig, generator, device, lead: tuple = ()):
    return {
        "ln1": nn.init_rmsnorm(cfg.d_model, nn.pdt(cfg), device, lead),
        "attn": nn.init_attention(cfg, generator, device, lead),
        "ln2": nn.init_rmsnorm(cfg.d_model, nn.pdt(cfg), device, lead),
        "moe": init_moe_mlp(cfg, generator, device, lead),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator, device):
    embed = nn.init_embedding(cfg, generator, device)
    if cfg.moe_every == 1:
        layers = init_moe_layer(cfg, generator, device, (cfg.num_layers,))
    else:
        assert cfg.moe_every == 2 and cfg.num_layers % 2 == 0
        lead = (cfg.num_layers // cfg.moe_every,)
        layers = {"dense": dense.init_layer(cfg, generator, device, lead),
                  "moe": init_moe_layer(cfg, generator, device, lead)}
    return {"embed": embed, "layers": layers,
            "final_norm": nn.init_rmsnorm(cfg.d_model, nn.pdt(cfg), device)}


def moe_block(p, cfg: ModelConfig, x, positions, prefix_kv=None,
              dispatch: str = "ragged"):
    """Pre-norm attention + MoE block; returns (x, (k, v) of this segment,
    aux)."""
    h, seg_kv = nn.attention(p["attn"], cfg, nn.rmsnorm(p["ln1"], x),
                             positions=positions, causal=True,
                             prefix_kv=prefix_kv)
    x = x + h
    y, aux = moe_mlp(p["moe"], cfg, nn.rmsnorm(p["ln2"], x), dispatch)
    return x + y, seg_kv, aux


def moe_decode_block(p, cfg: ModelConfig, x, k_cache, v_cache, pos):
    h, (k_cache, v_cache) = nn.decode_attention(
        p["attn"], cfg, nn.rmsnorm(p["ln1"], x), k_cache, v_cache, pos)
    x = x + h
    y, _ = moe_mlp(p["moe"], cfg, nn.rmsnorm(p["ln2"], x))
    return x + y, k_cache, v_cache


# ---------------------------------------------------------------------------
# model fns (mirror dense.py)
# ---------------------------------------------------------------------------
def _super_layer_params(params, cfg: ModelConfig, l: int):
    """Attention layer ``l``'s parameters and whether it is an MoE layer."""
    if cfg.moe_every == 1:
        return dense.take(params["layers"], l), True
    half = "moe" if l % cfg.moe_every else "dense"
    return dense.take(params["layers"][half], l // cfg.moe_every), \
        half == "moe"


def prefill(params, cfg: ModelConfig, tokens, prefix_kv=None,
            prefix_len: int = 0):
    """Returns (last-token logits [B, V] fp32, kv [L,2,B,S_total,KV,dh]);
    ``prefix_kv`` as in `dense.prefill`."""
    x = nn.embed(params["embed"], cfg, tokens)
    positions = prefix_len + torch.arange(x.shape[1], device=x.device)[None]
    segs = []
    for l in range(cfg.num_layers):
        p, is_moe = _super_layer_params(params, cfg, l)
        pkv = None if prefix_kv is None else (prefix_kv[l, 0], prefix_kv[l, 1])
        if is_moe:
            x, seg, _ = moe_block(p, cfg, x, positions, pkv)
        else:
            x, seg = dense.block(p, cfg, x, positions, pkv)
        segs.append(torch.stack(seg))
    seg_kv = torch.stack(segs)
    x = nn.rmsnorm(params["final_norm"], x)
    lg = nn.logits(params["embed"], cfg, x[:, -1:, :])[:, 0, :]
    if prefix_kv is not None:
        seg_kv = torch.cat([prefix_kv.to(seg_kv.dtype), seg_kv], dim=3)
    return lg, seg_kv


def decode_step(params, cfg: ModelConfig, cache, token, pos):
    """One decode step against a [L, 2, B, S, KV, dh] cache, written in
    place; returns (logits [B, V] fp32, cache)."""
    x = nn.embed(params["embed"], cfg, token)
    for l in range(cfg.num_layers):
        p, is_moe = _super_layer_params(params, cfg, l)
        step = moe_decode_block if is_moe else dense.decode_block
        x, _, _ = step(p, cfg, x, cache[l, 0], cache[l, 1], pos)
    x = nn.rmsnorm(params["final_norm"], x)
    lg = nn.logits(params["embed"], cfg, x)[:, 0, :]
    return lg, cache


init_cache = dense.init_cache
