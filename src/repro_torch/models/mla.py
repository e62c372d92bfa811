"""DeepSeek-V2: multi-head latent attention (MLA) with YaRN rotary
embeddings, and a stack of ``first_dense_layers`` dense layers, then MoE
layers with shared experts (`moe.moe_mlp`, the router's top-k weights not
renormalised).

Follows ``modeling_deepseek.py`` of the DeepSeek-V2 model repository
(``DeepseekV2Attention`` without ``q_lora_rank``,
``DeepseekV2YarnRotaryEmbedding``):

- queries: one projection ``wq`` to ``num_heads`` heads of qk_nope +
  qk_rope;
- keys and values from a latent: ``wkv_a`` projects x to c_kv
  (``kv_lora_rank``) and one k_pe (qk_rope) that every head shares; c_kv
  passes through ``kv_norm`` (the checkpoint's ``kv_a_layernorm``), and
  ``wkv_b`` projects it to each head's k_nope and v;
- RoPE on the rope dims of q and k only, after de-interleaving their pairs
  (the checkpoint's order), with YaRN's frequencies and cos/sin factor;
- the softmax scale (qk_nope + qk_rope)^-0.5 times YaRN's mscale squared
  (`MLAConfig.softmax_scale`).

A layer caches the latent: c_kv after its norm and k_pe after RoPE,
``kv_lora_rank + qk_rope_head_dim`` values a token.  Attention up-projects
the latent of every key it reads, a fetched prefix's included, through
``wkv_b`` (the form ``modeling_deepseek.py`` writes, not the absorbed one)
and attends with ``layers.attention_scores``.  The prefix's up-projection
is the region ``expand`` of a timed step (`timing`).

Parameters: ``{"embed", "layers": {"dense": [k], "moe": [L - k]},
"final_norm"}``, each layer ``{"ln1", "attn", "ln2"}`` and ``"mlp"`` or
``"moe"``; the cache is one latent a layer, [L, B, S, latent_dim].  The
model functions mirror `moe`'s.
"""
from __future__ import annotations

import functools
import math

import torch

from . import dense, moe, timing
from . import layers as nn
from .config import MLAConfig, yarn_mscale


def init_attention(cfg: MLAConfig, generator, device, lead: tuple = ()):
    d, H, r = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dt = nn.pdt(cfg)
    return {
        "wq": nn.init_linear(d, H * (dn + dr), dt, generator, device,
                             lead=lead),
        "wkv_a": nn.init_linear(d, r + dr, dt, generator, device, lead=lead),
        "kv_norm": nn.init_rmsnorm(r, dt, device, lead),
        "wkv_b": nn.init_linear(r, H * (dn + dv), dt, generator, device,
                                lead=lead),
        "wo": nn.init_linear(H * dv, d, dt, generator, device, lead=lead),
    }


@functools.cache
def _yarn(cfg: MLAConfig, device: torch.device) -> tuple[torch.Tensor, float]:
    """YaRN's inverse frequencies [qk_rope / 2] (fp32, on ``device``, made
    once) and its cos/sin factor: the base's frequencies where a dim turns
    more than ``rope_beta_fast`` times over the original context, those
    divided by ``rope_factor`` where it turns fewer than ``rope_beta_slow``
    times, a linear ramp between."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta

    def correction_dim(rotations):
        return dim * math.log(cfg.rope_original_max
                              / (rotations * 2 * math.pi)) \
            / (2 * math.log(base))
    low = max(math.floor(correction_dim(cfg.rope_beta_fast)), 0)
    high = min(math.ceil(correction_dim(cfg.rope_beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    extra = 1.0 / base ** exps
    inter = 1.0 / (cfg.rope_factor * base ** exps)
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    keep = 1.0 - ramp  # the share of the base frequency
    scale = yarn_mscale(cfg.rope_factor, cfg.rope_mscale) \
        / yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim)
    return (inter * (1 - keep) + extra * keep).to(device), scale


def rope(x: torch.Tensor, positions: torch.Tensor, cfg: MLAConfig
         ) -> torch.Tensor:
    """x [B, S, n, qk_rope] at ``positions`` ([B, S] or [S]): the pairs
    de-interleaved, then split-half RoPE at YaRN's frequencies, angles in
    fp32."""
    d = x.shape[-1]
    half = d // 2
    x = x.unflatten(-1, (half, 2)).transpose(-1, -2).flatten(-2)
    inv_freq, scale = _yarn(cfg, x.device)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * inv_freq
    cos = (torch.cos(ang) * scale)[:, :, None, :]
    sin = (torch.sin(ang) * scale)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def queries(p, cfg: MLAConfig, x, positions):
    """x [B, S, d] -> q [B, S, H, qk_nope + qk_rope], the rope dims
    rotated."""
    B, S, _ = x.shape
    dn = cfg.qk_nope_head_dim
    q = nn.linear(p["wq"], x).view(B, S, cfg.num_heads, -1)
    return torch.cat([q[..., :dn], rope(q[..., dn:], positions, cfg)], -1)


def latent(p, cfg: MLAConfig, x, positions):
    """x [B, S, d] -> the latent a layer caches [B, S, latent_dim]: c_kv
    after ``kv_norm``, then k_pe after RoPE."""
    r = cfg.kv_lora_rank
    ckv = nn.linear(p["wkv_a"], x)
    c = nn.rmsnorm(p["kv_norm"], ckv[..., :r])
    k_pe = rope(ckv[..., None, r:], positions, cfg)[..., 0, :]
    return torch.cat([c, k_pe], dim=-1)


def expand(p, cfg: MLAConfig, lat):
    """latent [B, S, latent_dim] -> k [B, S, H, qk_nope + qk_rope] (k_nope
    from ``wkv_b``, k_pe repeated over the heads), v [B, S, H, v_head_dim]."""
    B, S, _ = lat.shape
    H, r, dn = cfg.num_heads, cfg.kv_lora_rank, cfg.qk_nope_head_dim
    kv = nn.linear(p["wkv_b"], lat[..., :r]).view(B, S, H, -1)
    k_pe = lat[..., None, r:].expand(B, S, H, cfg.qk_rope_head_dim)
    return torch.cat([kv[..., :dn], k_pe], dim=-1), kv[..., dn:]


def attention(p, cfg: MLAConfig, x, positions, prefix=None):
    """Causal attention of x [B, S, d] at ``positions`` over an optional
    fetched latent ``prefix`` [B, P, latent_dim] and itself.  Returns (out
    [B, S, d], the latent of this segment [B, S, latent_dim])."""
    B, S, _ = x.shape
    q = queries(p, cfg, x, positions)
    lat = latent(p, cfg, x, positions)
    k, v = expand(p, cfg, lat)
    if prefix is not None and prefix.shape[1]:
        with timing.region("expand", prefix_tokens=prefix.shape[1]):
            pk, pv = expand(p, cfg, prefix)
        k, v = torch.cat([pk, k], dim=1), torch.cat([pv, v], dim=1)
    Sk = k.shape[1]
    # absolute key position j visible to query i when j <= i + P
    iq = torch.arange(S, device=x.device)[:, None] + (Sk - S)
    mask = (torch.arange(Sk, device=x.device)[None, :] <= iq)[None, None]
    out = nn.attention_scores(q, k, v, mask, scale=cfg.softmax_scale)
    return nn.linear(p["wo"], out.reshape(B, S, -1)), lat


def decode_attention(p, cfg: MLAConfig, x, cache, pos):
    """One token x [B, 1, d] at ``pos`` [B] against a latent cache [B, S,
    latent_dim], into which its latent is written in place.  Returns (out
    [B, 1, d], cache)."""
    B = x.shape[0]
    q = queries(p, cfg, x, pos[:, None])
    pos = pos.long()
    nn.write_token(cache, latent(p, cfg, x, pos[:, None])[:, 0], pos)
    k, v = expand(p, cfg, cache)
    cols = torch.arange(cache.shape[1], device=cache.device)
    mask = (cols[None, :] <= pos[:, None])[:, None, None, :]
    out = nn.attention_scores(q, k, v, mask, scale=cfg.softmax_scale)
    return nn.linear(p["wo"], out.reshape(B, 1, -1)), cache


# ---------------------------------------------------------------------------
# layers: leading dense layers, then MoE layers
# ---------------------------------------------------------------------------
def _init_layers(cfg: MLAConfig, generator, device, n: int, ffn: str):
    lead = (n,)
    p = {"ln1": nn.init_rmsnorm(cfg.d_model, nn.pdt(cfg), device, lead),
         "attn": init_attention(cfg, generator, device, lead),
         "ln2": nn.init_rmsnorm(cfg.d_model, nn.pdt(cfg), device, lead)}
    p[ffn] = (moe.init_moe_mlp if ffn == "moe" else nn.init_mlp)(
        cfg, generator, device, lead)
    return p


def init_params(cfg: MLAConfig, generator: torch.Generator, device):
    k = cfg.first_dense_layers
    embed = nn.init_embedding(cfg, generator, device)
    layers = {"dense": _init_layers(cfg, generator, device, k, "mlp"),
              "moe": _init_layers(cfg, generator, device,
                                  cfg.num_layers - k, "moe")}
    return {"embed": embed, "layers": layers,
            "final_norm": nn.init_rmsnorm(cfg.d_model, nn.pdt(cfg), device)}


def layer_params(params, cfg: MLAConfig, l: int):
    """Layer ``l``'s parameters: a leading dense layer's or an MoE
    layer's."""
    k = cfg.first_dense_layers
    if l < k:
        return dense.take(params["layers"]["dense"], l)
    return dense.take(params["layers"]["moe"], l - k)


def _ffn(p, cfg: MLAConfig, h, dispatch: str = "ragged"):
    """The experts ("moe" in p) or a leading layer's dense MLP: (y, aux)."""
    if "moe" in p:
        return moe.moe_mlp(p["moe"], cfg, h, dispatch,
                           renormalise=cfg.norm_topk_prob,
                           scale=cfg.routed_scaling_factor)
    return nn.mlp(p["mlp"], h, cfg.mlp_kind), \
        torch.zeros((), dtype=torch.float32, device=h.device)


def block(p, cfg: MLAConfig, x, positions, prefix=None,
          dispatch: str = "ragged"):
    """A layer: pre-norm MLA over an optional latent ``prefix`` [B, P,
    latent_dim], then the MLP.  Returns (x, the segment's latent, aux)."""
    h, lat = attention(p["attn"], cfg, nn.rmsnorm(p["ln1"], x), positions,
                       prefix)
    x = x + h
    y, aux = _ffn(p, cfg, nn.rmsnorm(p["ln2"], x), dispatch)
    return x + y, lat, aux


def decode_block(p, cfg: MLAConfig, x, cache, pos):
    """`block` for one token against a latent cache [B, S, latent_dim]
    written in place."""
    h, cache = decode_attention(p["attn"], cfg, nn.rmsnorm(p["ln1"], x),
                                cache, pos)
    x = x + h
    return x + _ffn(p, cfg, nn.rmsnorm(p["ln2"], x))[0], cache


# ---------------------------------------------------------------------------
# model fns (mirror moe.py)
# ---------------------------------------------------------------------------
def forward(params, cfg: MLAConfig, tokens, *, remat: bool = False,
            dispatch: str = "ragged"):
    """[B,S] -> (hidden [B,S,d], the summed aux loss of the MoE layers)."""
    x = nn.embed(params["embed"], cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    step = nn.remat(lambda p, h: block(p, cfg, h, positions, None,
                                       dispatch)[::2], remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for l in range(cfg.num_layers):
        x, a = step(layer_params(params, cfg, l), x)
        aux = aux + a
    return nn.rmsnorm(params["final_norm"], x), aux


def loss(params, cfg: MLAConfig, batch, *, remat: bool = False,
         dispatch: str = "ragged"):
    """Cross-entropy + LOAD_BALANCE_COEF x the layers' summed aux loss."""
    x, aux = forward(params, cfg, batch["tokens"], remat=remat,
                     dispatch=dispatch)
    lg = nn.logits(params["embed"], cfg, x)
    ce = nn.cross_entropy(lg, batch["labels"], batch.get("loss_mask"))
    return ce + moe.LOAD_BALANCE_COEF * aux


def prefill(params, cfg: MLAConfig, tokens, prefix_kv=None,
            prefix_len: int = 0):
    """Returns (last-token logits [B, V] fp32, the latents [L, B, S_total,
    latent_dim]); ``prefix_kv`` the prefix's latents [L, B, P,
    latent_dim]."""
    x = nn.embed(params["embed"], cfg, tokens)
    positions = prefix_len + torch.arange(x.shape[1], device=x.device)[None]
    lats = []
    for l in range(cfg.num_layers):
        x, lat, _ = block(layer_params(params, cfg, l), cfg, x, positions,
                          None if prefix_kv is None else prefix_kv[l])
        lats.append(lat)
    seg = torch.stack(lats)
    x = nn.rmsnorm(params["final_norm"], x)
    lg = nn.logits(params["embed"], cfg, x[:, -1:, :])[:, 0, :]
    if prefix_kv is not None:
        seg = torch.cat([prefix_kv.to(seg.dtype), seg], dim=2)
    return lg, seg


def decode_step(params, cfg: MLAConfig, cache, token, pos):
    """One decode step against a latent cache [L, B, S, latent_dim], written
    in place; returns (logits [B, V] fp32, cache)."""
    x = nn.embed(params["embed"], cfg, token)
    for l in range(cfg.num_layers):
        x, _ = decode_block(layer_params(params, cfg, l), cfg, x, cache[l],
                            pos)
    x = nn.rmsnorm(params["final_norm"], x)
    lg = nn.logits(params["embed"], cfg, x)[:, 0, :]
    return lg, cache


def init_cache(cfg: MLAConfig, batch: int, seq_len: int, device):
    return torch.zeros((cfg.num_layers, batch, seq_len, cfg.latent_dim),
                       dtype=nn.dt(cfg), device=device)
