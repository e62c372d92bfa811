"""Whisper-style encoder-decoder.

Port of the reference's ``models/encdec.py``.  The conv/mel frontend is a
stub: the caller supplies precomputed frame embeddings [B, S_audio, d] (one
linear projection stands in for the post-conv feature map).  Sinusoidal
absolute positions, bidirectional encoder, causal decoder with
cross-attention; plain-GELU MLPs; MHA (kv == H).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import dense
from . import layers as nn
from .config import ModelConfig


def sinusoids(length: int, channels: int, device="cpu") -> torch.Tensor:
    half = channels // 2
    scale = math.log(10000.0) / max(half - 1, 1)
    inv = torch.exp(-scale * torch.arange(half, dtype=torch.float32,
                                          device=device))
    pos = torch.arange(length, dtype=torch.float32,
                       device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(pos), torch.cos(pos)], dim=-1)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_enc_layer(cfg, generator, device, lead):
    return {
        "ln1": nn.init_layernorm(cfg.d_model, nn.pdt(cfg), device, lead),
        "attn": nn.init_attention(cfg, generator, device, lead),
        "ln2": nn.init_layernorm(cfg.d_model, nn.pdt(cfg), device, lead),
        "mlp": nn.init_mlp(cfg, generator, device, lead, kind="gelu"),
    }


def _init_dec_layer(cfg, generator, device, lead):
    return {
        "ln1": nn.init_layernorm(cfg.d_model, nn.pdt(cfg), device, lead),
        "self_attn": nn.init_attention(cfg, generator, device, lead),
        "ln_cross": nn.init_layernorm(cfg.d_model, nn.pdt(cfg), device, lead),
        "cross_attn": nn.init_attention(cfg, generator, device, lead),
        "ln2": nn.init_layernorm(cfg.d_model, nn.pdt(cfg), device, lead),
        "mlp": nn.init_mlp(cfg, generator, device, lead, kind="gelu"),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator, device):
    d = cfg.d_model
    return {
        "embed": nn.init_embedding(cfg, generator, device),
        "frontend": nn.init_linear(d, d, nn.pdt(cfg), generator, device),
        "enc_layers": _init_enc_layer(cfg, generator, device,
                                      (cfg.encoder_layers,)),
        "enc_norm": nn.init_layernorm(d, nn.pdt(cfg), device),
        "dec_layers": _init_dec_layer(cfg, generator, device,
                                      (cfg.num_layers,)),
        "final_norm": nn.init_layernorm(d, nn.pdt(cfg), device),
    }


# ---------------------------------------------------------------------------
# encoder / decoder stacks
# ---------------------------------------------------------------------------
def encode(params, cfg: ModelConfig, audio_embeds):
    """audio_embeds: [B, S_a, d] (stub frontend features)."""
    x = nn.linear(params["frontend"], audio_embeds.to(nn.dt(cfg)))
    x = x + sinusoids(x.shape[1], cfg.d_model, x.device).to(x.dtype)[None]
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for p in dense.unstack(params["enc_layers"]):
        a, _ = nn.attention(p["attn"], cfg, nn.layernorm(p["ln1"], x),
                            positions=positions, causal=False, use_rope=False)
        x = x + a
        x = x + nn.mlp(p["mlp"], nn.layernorm(p["ln2"], x), "gelu")
    return nn.layernorm(params["enc_norm"], x)


def _dec_block(p, cfg, x, enc_out, positions, prefix_kv=None):
    a, seg = nn.attention(p["self_attn"], cfg, nn.layernorm(p["ln1"], x),
                          positions=positions, causal=True,
                          prefix_kv=prefix_kv, use_rope=False)
    x = x + a
    c, cross_kv = nn.attention(p["cross_attn"], cfg,
                               nn.layernorm(p["ln_cross"], x),
                               positions=positions, causal=False,
                               kv_x=enc_out, use_rope=False)
    x = x + c
    x = x + nn.mlp(p["mlp"], nn.layernorm(p["ln2"], x), "gelu")
    return x, seg, cross_kv


def decode_stack(params, cfg: ModelConfig, tokens, enc_out, prefix_kv=None,
                 prefix_len: int = 0, collect_kv: bool = False):
    """Returns (hidden [B, S, d] after the final norm, (self kv, cross kv)
    each [L, 2, B, ., KV, dh] if ``collect_kv`` else None)."""
    x = nn.embed(params["embed"], cfg, tokens)
    S = x.shape[1]
    x = x + sinusoids(prefix_len + S, cfg.d_model,
                      x.device).to(x.dtype)[None, prefix_len:]
    positions = prefix_len + torch.arange(S, device=x.device)[None, :]
    selfs, crosses = [], []
    for l, p in enumerate(dense.unstack(params["dec_layers"])):
        pkv = None if prefix_kv is None else (prefix_kv[l, 0], prefix_kv[l, 1])
        x, seg, cross = _dec_block(p, cfg, x, enc_out, positions, pkv)
        if collect_kv:
            selfs.append(torch.stack(seg))
            crosses.append(torch.stack(cross))
    x = nn.layernorm(params["final_norm"], x)
    kv = (torch.stack(selfs), torch.stack(crosses)) if collect_kv else None
    return x, kv


# ---------------------------------------------------------------------------
# model API
# ---------------------------------------------------------------------------
def loss(params, cfg: ModelConfig, batch, *, remat: bool = False):
    """Decoder cross-entropy over the audio ``embeds``; ``remat`` is
    ignored, as in the reference."""
    enc_out = encode(params, cfg, batch["embeds"])
    x, _ = decode_stack(params, cfg, batch["tokens"], enc_out)
    lg = nn.logits(params["embed"], cfg, x)
    return nn.cross_entropy(lg, batch["labels"], batch.get("loss_mask"))


def prefill(params, cfg: ModelConfig, tokens, audio_embeds, prefix_kv=None,
            prefix_len: int = 0):
    """Returns (last logits [B, V] fp32, cache = {self: [L,2,B,S,KV,dh],
    cross: [L,2,B,S_audio,KV,dh]})."""
    enc_out = encode(params, cfg, audio_embeds)
    x, (seg_kv, cross_kv) = decode_stack(params, cfg, tokens, enc_out,
                                         prefix_kv, prefix_len,
                                         collect_kv=True)
    if prefix_kv is not None:
        seg_kv = torch.cat([prefix_kv.to(seg_kv.dtype), seg_kv], dim=3)
    lg = nn.logits(params["embed"], cfg, x[:, -1:, :])[:, 0, :]
    return lg, {"self": seg_kv, "cross": cross_kv}


def decode_step(params, cfg: ModelConfig, cache, token, pos):
    """token: [B,1]; cache = {self, cross}; pos: [B].  The new token's K/V
    are written into ``cache["self"]`` in place; the cross cache is
    read-only.  Returns (logits [B, V] fp32, cache)."""
    x = nn.embed(params["embed"], cfg, token)
    pos_emb = sinusoids(cache["self"].shape[3] + 1, cfg.d_model, x.device)
    x = x + pos_emb[pos.long()][:, None, :].to(x.dtype)
    for l in range(cfg.num_layers):
        p = dense.take(params["dec_layers"], l)
        kv, cross = cache["self"][l], cache["cross"][l]
        a, _ = nn.decode_attention(p["self_attn"], cfg,
                                   nn.layernorm(p["ln1"], x), kv[0], kv[1],
                                   pos, use_rope=False)
        x = x + a
        c, _ = nn.decode_attention(p["cross_attn"], cfg,
                                   nn.layernorm(p["ln_cross"], x), cross[0],
                                   cross[1], pos, cross=True)
        x = x + c
        x = x + nn.mlp(p["mlp"], nn.layernorm(p["ln2"], x), "gelu")
    x = nn.layernorm(params["final_norm"], x)
    lg = nn.logits(params["embed"], cfg, x)[:, 0, :]
    return lg, cache


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device,
               cross_len: Optional[int] = None):
    shape = (cfg.num_layers, 2, batch, seq_len, cfg.num_kv_heads,
             cfg.head_dim)
    cross = (cfg.num_layers, 2, batch, cross_len or cfg.cross_kv_len,
             cfg.num_kv_heads, cfg.head_dim)
    return {"self": torch.zeros(shape, dtype=nn.dt(cfg), device=device),
            "cross": torch.zeros(cross, dtype=nn.dt(cfg), device=device)}
