"""Shared neural-net building blocks in PyTorch (functional, dict params).

Port of the reference's ``models/layers.py`` with the same names, layouts and
numerics:
  * activations [B, S, d] in ``compute_dtype``; reductions, softmax, RoPE and
    the norm scale in fp32;
  * weights in ``x @ w`` layout [d_in, d_out];
  * attention logits are fp32 products of the (exactly widened) inputs, masked
    with ``finfo(float32).min``; logits of the padded vocab are masked too.

``attn_impl="blocked"`` / ``decode_impl="blocked"`` are XLA tuning variants for
the TPU and are not ported (ROADMAP.md lists what is still to port).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .config import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dt(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.compute_dtype]


def pdt(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def _check_impl(cfg: ModelConfig) -> None:
    if cfg.attn_impl != "naive" or cfg.decode_impl != "naive":
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} / decode_impl={cfg.decode_impl!r}: "
            f"the blocked XLA variants are not ported (see ROADMAP.md); "
            f"use 'naive'")


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
def normal_(out: torch.Tensor, stddev: float,
            generator: torch.Generator) -> torch.Tensor:
    """Fill ``out`` with N(0, stddev) drawn in fp32 and cast, one leading
    slice at a time so a stacked [L, ...] weight needs no fp32 copy."""
    slices = out if out.ndim > 2 else out[None]
    for s in slices:
        s.copy_(torch.randn(s.shape, generator=generator, device=s.device,
                            dtype=torch.float32) * stddev)
    return out


def init_linear(d_in: int, d_out: int, dtype, generator, device,
                scale: float | None = None, lead: tuple = ()):
    stddev = scale if scale is not None else d_in ** -0.5
    w = torch.empty(lead + (d_in, d_out), dtype=dtype, device=device)
    return {"w": normal_(w, stddev, generator)}


def linear(p, x):
    return x @ p["w"].to(x.dtype)


def init_rmsnorm(d: int, dtype, device, lead: tuple = ()):
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps: float = 1e-6):
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: [B, S, H, dh]; positions: [B, S] or [S].  Split halves (not
    interleaved pairs), angles in fp32."""
    dh = x.shape[-1]
    half = dh // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), exps)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs  # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (MHA / GQA / MQA, qk-norm, prefix-KV injection, KV cache decode)
# ---------------------------------------------------------------------------
def init_attention(cfg: ModelConfig, generator, device, lead: tuple = ()):
    d = cfg.d_model
    H, KV, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": init_linear(d, H * dh, pdt(cfg), generator, device, lead=lead),
        "wk": init_linear(d, KV * dh, pdt(cfg), generator, device, lead=lead),
        "wv": init_linear(d, KV * dh, pdt(cfg), generator, device, lead=lead),
        "wo": init_linear(H * dh, d, pdt(cfg), generator, device,
                          scale=(H * dh) ** -0.5, lead=lead),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(dh, pdt(cfg), device, lead)
        p["k_norm"] = init_rmsnorm(dh, pdt(cfg), device, lead)
    return p


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def attention_scores(q, k, v, mask, softcap: float = 0.0):
    """q: [B,Sq,H,dh], k/v: [B,Sk,H,dh], mask: broadcastable [B,1,Sq,Sk]."""
    dh = q.shape[-1]
    # fp32 products of exactly widened inputs: the reference's
    # preferred_element_type=float32 contraction
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / math.sqrt(dh)
    if softcap > 0.0:
        logits = torch.tanh(logits / softcap) * softcap
    logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def project_qkv(p, cfg: ModelConfig, x, kv_x=None):
    """Returns q [B,S,H,dh], k/v [B,S_kv,KV,dh] after qk-norm (pre-RoPE)."""
    B, S, _ = x.shape
    H, KV, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kv_in = x if kv_x is None else kv_x
    q = linear(p["wq"], x).reshape(B, S, H, dh)
    k = linear(p["wk"], kv_in).reshape(B, kv_in.shape[1], KV, dh)
    v = linear(p["wv"], kv_in).reshape(B, kv_in.shape[1], KV, dh)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    return q, k, v


def attention(p, cfg: ModelConfig, x, *, positions, causal: bool = True,
              prefix_kv=None, kv_x=None, use_rope: bool = True):
    """Full-sequence attention with optional prefix-KV injection.

    ``prefix_kv``: optional (k, v) each [B, P, KV, dh] — the ObjectCache
    prefix: queries of this (suffix) segment attend over prefix + suffix.
    Returns (out [B,S,d], (k, v) of THIS segment).
    """
    _check_impl(cfg)
    B, S, _ = x.shape
    H, KV, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = project_qkv(p, cfg, x, kv_x)
    if use_rope and kv_x is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    seg_kv = (k, v)
    if prefix_kv is not None:
        k = torch.cat([prefix_kv[0].to(k.dtype), k], dim=1)
        v = torch.cat([prefix_kv[1].to(v.dtype), v], dim=1)
    Sk = k.shape[1]
    P = Sk - S
    kr, vr = _repeat_kv(k, H // KV), _repeat_kv(v, H // KV)
    if causal and kv_x is None:
        # absolute key position j visible to suffix-query i when j <= i+P
        iq = torch.arange(S, device=x.device)[:, None] + P
        jk = torch.arange(Sk, device=x.device)[None, :]
        mask = (jk <= iq)[None, None, :, :]
    else:
        mask = torch.ones((1, 1, S, Sk), dtype=torch.bool, device=x.device)
    out = attention_scores(q, kr, vr, mask, cfg.logit_softcap)
    out = linear(p["wo"], out.reshape(B, S, H * dh))
    return out, seg_kv


def decode_attention(p, cfg: ModelConfig, x, k_cache, v_cache, pos,
                     *, cross: bool = False, use_rope: bool = True,
                     cache_len_mask=None):
    """One-token attention against a [B, S, KV, dh] cache.

    ``pos``: [B] int — index of the new token.  Unlike the reference (whose
    arrays are immutable) the new token's K/V are written into ``k_cache`` /
    ``v_cache`` IN PLACE, which spares a copy of the whole cache per step.
    Returns (out [B,1,d], (k_cache, v_cache)); a cross-attention cache is
    read-only.
    """
    _check_impl(cfg)
    B = x.shape[0]
    H, KV, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = project_qkv(p, cfg, x)
    S = k_cache.shape[1]
    if not cross:
        if use_rope:
            q = rope(q, pos[:, None], cfg.rope_theta)
            k = rope(k, pos[:, None], cfg.rope_theta)
        rows = torch.arange(B, device=x.device)
        pos = pos.long()
        k_cache[rows, pos] = k[:, 0].to(k_cache.dtype)
        v_cache[rows, pos] = v[:, 0].to(v_cache.dtype)
        cols = torch.arange(S, device=x.device)
        mask = (cols[None, :] <= pos[:, None])[:, None, None, :]
    else:
        mask = torch.ones((B, 1, 1, S), dtype=torch.bool, device=x.device)
        if cache_len_mask is not None:
            mask = cache_len_mask[:, None, None, :]
    out = attention_scores(q, _repeat_kv(k_cache.to(q.dtype), H // KV),
                           _repeat_kv(v_cache.to(q.dtype), H // KV),
                           mask, cfg.logit_softcap)
    out = linear(p["wo"], out.reshape(B, 1, H * dh))
    return out, (k_cache, v_cache)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU / plain GELU)
# ---------------------------------------------------------------------------
def init_mlp(cfg: ModelConfig, generator, device, lead: tuple = ()):
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.mlp_kind in ("swiglu", "geglu"):
        return {"wi_gate": init_linear(d, ff, pdt(cfg), generator, device,
                                       lead=lead),
                "wi_up": init_linear(d, ff, pdt(cfg), generator, device,
                                     lead=lead),
                "wo": init_linear(ff, d, pdt(cfg), generator, device,
                                  scale=ff ** -0.5, lead=lead)}
    return {"wi": init_linear(d, ff, pdt(cfg), generator, device, lead=lead),
            "wo": init_linear(ff, d, pdt(cfg), generator, device,
                              scale=ff ** -0.5, lead=lead)}


def mlp(p, x, kind: str = "swiglu"):
    if kind == "swiglu":
        h = F.silu(linear(p["wi_gate"], x)) * linear(p["wi_up"], x)
    elif kind == "geglu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(linear(p["wi_gate"], x), approximate="tanh") \
            * linear(p["wi_up"], x)
    else:
        h = F.gelu(linear(p["wi"], x), approximate="tanh")
    return linear(p["wo"], h)


# ---------------------------------------------------------------------------
# embeddings / logits
# ---------------------------------------------------------------------------
def init_embedding(cfg: ModelConfig, generator, device):
    shape = (cfg.padded_vocab, cfg.d_model)
    p = {"table": normal_(torch.empty(shape, dtype=pdt(cfg), device=device),
                          0.02, generator)}
    if not cfg.tie_embeddings:
        p["unembed"] = normal_(torch.empty(shape, dtype=pdt(cfg),
                                           device=device), 0.02, generator)
    return p


def embed(p, cfg: ModelConfig, tokens):
    x = p["table"].to(dt(cfg))[tokens.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt(cfg),
                             device=x.device)
    return x


def logits(p, cfg: ModelConfig, x):
    """[B, S, d] -> fp32 [B, S, padded_vocab], padded entries masked."""
    table = p.get("unembed", p["table"])
    out = torch.einsum("bsd,vd->bsv", x.float(), table.to(x.dtype).float())
    if cfg.padded_vocab != cfg.vocab_size:
        out[..., cfg.vocab_size:] = torch.finfo(torch.float32).min
    return out
