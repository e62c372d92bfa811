"""Shared neural-net building blocks in PyTorch (functional, dict params).

Port of the reference's ``models/layers.py`` with the same names, layouts and
numerics:
  * activations [B, S, d] in ``compute_dtype``; reductions, softmax, RoPE and
    the norm scale in fp32;
  * weights in ``x @ w`` layout [d_in, d_out];
  * attention logits are fp32 products of the (exactly widened) inputs, masked
    with ``finfo(float32).min``; logits of the padded vocab are masked too;
  * `cross_entropy` is the training loss (fp32), and `remat` runs a layer
    body under activation checkpointing where the reference uses
    ``jax.checkpoint``.

``attn_impl="blocked"`` / ``decode_impl="blocked"`` are XLA tuning variants for
the TPU and are not ported (ROADMAP.md lists what is still to port).

Packed-resident prefixes (`attention_packed_prefix`,
`decode_attention_packed_prefix`) attend to the prefix through the fused
dequant-attention ops of ``kernels.ops`` (K7 / K6) and to the fp suffix with
`attention_partials`, and merge the two exactly with
`merge_attention_partials`.  The reference's composed fallback
(``use_fused=False``) is not ported: the op's dispatch decides.
"""
from __future__ import annotations

import math

import torch
import torch._dynamo  # noqa: F401  (see `remat`)
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops as kernel_ops

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
# elements of the largest fp32 draw `normal_` makes at once (1 GiB)
_MAX_DRAW = 1 << 28


def normal_(out: torch.Tensor, stddev: float,
            generator: torch.Generator) -> torch.Tensor:
    """Fill ``out`` with N(0, stddev) drawn in fp32 and cast, one leading
    slice at a time so a stacked [L, ...] weight needs no fp32 copy; a
    slice above _MAX_DRAW elements (an [E, d, f] expert stack at llama4's
    width) is drawn one of its own leading slices at a time."""
    slices = out if out.ndim > 2 else out[None]
    for s in slices:
        if s.ndim > 2 and s.numel() > _MAX_DRAW:
            normal_(s, stddev, generator)
            continue
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


def init_layernorm(d: int, dtype, device, lead: tuple = ()):
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device),
            "bias": torch.zeros(lead + (d,), dtype=dtype, device=device)}


def layernorm(p, x, eps: float = 1e-5):
    """Mean and (population) variance in fp32."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


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


def attention_partials(q, k, v, mask, softcap: float = 0.0):
    """Softmax attention over one key segment, returning partials.

    q: [B,Sq,H,dh], k/v: [B,Sk,H,dh] (heads already repeated), mask
    broadcastable to [B,1,Sq,Sk].  Returns (o, m, l): the *normalized* fp32
    output [B,Sq,H,dh] plus the running-softmax residuals m/l [B,Sq,H], so
    attention over disjoint key segments (a packed-resident prefix and an fp
    suffix) composes exactly via `merge_attention_partials` — the same
    (m, l) contract the fused kernels return."""
    dh = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / math.sqrt(dh)
    if softcap > 0.0:
        logits = torch.tanh(logits / softcap) * softcap
    logits = torch.where(mask, logits, float("-inf"))
    m = logits.amax(dim=-1)  # [B,H,Sq]
    safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(torch.isfinite(logits),
                    torch.exp(logits - safe[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o = o / l.clamp_min(1e-30)[..., None].transpose(1, 2)
    return o, m.transpose(1, 2), l.transpose(1, 2)


def merge_attention_partials(parts):
    """Combine per-segment (o, m, l) partials into the exact full softmax.

    Each part: o [..., H, dh] normalized, m/l [..., H] (prefill [B,Sq,H] and
    decode [B,H] both work).  Log-sum-exp merge: with global max m_g, each
    segment re-weights by exp(m - m_g) * l."""
    m_g = parts[0][1]
    for _, m, _ in parts[1:]:
        m_g = torch.maximum(m_g, m)
    num = 0.0
    denom = 0.0
    for o, m, l in parts:
        w = torch.where(torch.isfinite(m), torch.exp(m - m_g), 0.0) * l
        num = num + w[..., None] * o.float()
        denom = denom + w
    return num / denom.clamp_min(1e-30)[..., None]


def attention_packed_prefix(p, cfg: ModelConfig, x, packed_kv, *, positions,
                            bits: int, group: int, chunk_tokens: int):
    """Suffix attention over a *quantized-resident* prefix (prefill form).

    ``packed_kv``: (k_q, v_q, k_scales, v_scales), the wire image of the
    prefix as `serving.kv_chunks.PackedLayerKV.as_tuple()` yields it, with
    x's batch size (the engines serve one sequence).  The
    prefix half runs the fused `flash_attention_quant` op (K7; its output is
    rounded to the activation dtype, as the reference's kernel rounds it),
    the suffix half is causal attention over this segment's own KV, and the
    two merge exactly via the softmax residuals.  Requires
    ``cfg.logit_softcap == 0`` (the fused kernels do not implement softcap).

    Returns (out [B,S,d], seg_kv) like `attention`.
    """
    B, S, _ = x.shape
    H, KV, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = project_qkv(p, cfg, x)
    # packed prefixes always carry RoPE'd KV (they were committed post-RoPE)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    seg_kv = (k, v)
    k_q, v_q, k_scales, v_scales = packed_kv
    # every prefix position precedes every suffix query: non-causal
    o_p, m_p, l_p = kernel_ops.flash_attention_quant_op(
        q, k_q, v_q, k_scales, v_scales, bits=bits, group=group,
        chunk_tokens=chunk_tokens, causal=False, return_residuals=True)
    iq = torch.arange(S, device=x.device)[:, None]
    mask = (torch.arange(S, device=x.device)[None, :] <= iq)[None, None]
    kr = _repeat_kv(k, H // KV).float()
    vr = _repeat_kv(v, H // KV).float()
    o_s, m_s, l_s = attention_partials(q.float(), kr, vr, mask)
    out = merge_attention_partials([(o_p.float(), m_p, l_p),
                                    (o_s, m_s, l_s)])
    out = linear(p["wo"], out.to(x.dtype).reshape(B, S, H * dh))
    return out, seg_kv


def decode_attention_packed_prefix(p, cfg: ModelConfig, x, packed_kv,
                                   sk_cache, sv_cache, pos, *, bits: int,
                                   group: int, chunk_tokens: int):
    """One-token attention over a packed prefix + an fp suffix cache.

    The decode form of `attention_packed_prefix`: the prefix stays
    quantized-resident (read by the fused `decode_attention_quant` op, K6);
    only this request's *suffix* lives in an fp cache [B, S_suf, KV, dh].
    The new token's K/V are written at ``pos - P`` IN PLACE, as
    `decode_attention` writes at ``pos``.  Returns (out [B,1,d],
    (sk_cache, sv_cache))."""
    B = x.shape[0]
    H, KV, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    k_q, v_q, k_scales, v_scales = packed_kv
    P = k_q.shape[1]
    q, k, v = project_qkv(p, cfg, x)
    q = rope(q, pos[:, None], cfg.rope_theta)
    k = rope(k, pos[:, None], cfg.rope_theta)
    spos = pos.long() - P  # suffix-local write slot
    rows = torch.arange(B, device=x.device)
    sk_cache[rows, spos] = k[:, 0].to(sk_cache.dtype)
    sv_cache[rows, spos] = v[:, 0].to(sv_cache.dtype)
    lengths = torch.full((B,), P, dtype=torch.int32, device=x.device)
    o_p, m_p, l_p = kernel_ops.decode_attention_quant_op(
        q[:, 0], k_q, v_q, k_scales, v_scales, lengths, bits=bits,
        group=group, chunk_tokens=chunk_tokens, return_residuals=True)
    Ss = sk_cache.shape[1]
    cols = torch.arange(Ss, device=x.device)
    mask = (cols[None, :] <= spos[:, None])[:, None, None, :]
    o_s, m_s, l_s = attention_partials(
        q.float(), _repeat_kv(sk_cache.float(), H // KV),
        _repeat_kv(sv_cache.float(), H // KV), mask)
    out = merge_attention_partials([
        (o_p.float()[:, None], m_p[:, None], l_p[:, None]), (o_s, m_s, l_s)])
    out = linear(p["wo"], out.to(x.dtype).reshape(B, 1, H * dh))
    return out, (sk_cache, sv_cache)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU / plain GELU)
# ---------------------------------------------------------------------------
def init_mlp(cfg: ModelConfig, generator, device, lead: tuple = (), *,
             d_ff: int | None = None, d_model: int | None = None,
             kind: str | None = None):
    d = d_model or cfg.d_model
    ff = d_ff or cfg.d_ff
    kind = kind or cfg.mlp_kind
    if kind in ("swiglu", "geglu"):
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
    # F.embedding's backward sums the rows of repeated tokens in a fixed
    # order (sorted indices), where indexing's accumulating `index_put_`
    # may add them in any order on the card
    x = F.embedding(tokens.long(), p["table"].to(dt(cfg)))
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt(cfg),
                             device=x.device)
    return x


def logits(p, cfg: ModelConfig, x):
    """[B, S, d] -> fp32 [B, S, padded_vocab], padded entries masked.

    The mask is written in place after the product, whose backward keeps
    its inputs, not its output; the overwritten columns get zero gradient,
    as the reference's ``jnp.where`` gives them."""
    table = p.get("unembed", p["table"])
    out = torch.einsum("bsd,vd->bsv", x.float(), table.to(x.dtype).float())
    if cfg.padded_vocab != cfg.vocab_size:
        out[..., cfg.vocab_size:] = torch.finfo(torch.float32).min
    return out


def cross_entropy(logit_f32: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy in fp32; labels [B,S] int.  ``mask`` [B,S]
    weights each token's NLL (the mean over the mask's sum, at least 1)."""
    logz = torch.logsumexp(logit_f32, dim=-1)
    gold = torch.gather(logit_f32, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.to(nll.dtype)
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)


# ---------------------------------------------------------------------------
# rematerialisation
# ---------------------------------------------------------------------------
def remat(body, enabled: bool):
    """``body``, or ``body`` under activation checkpointing (the reference's
    ``jax.checkpoint``): its activations are recomputed in the backward
    instead of kept.

    ``checkpoint`` imports ``torch._dynamo`` on its first call unless it is
    loaded already, and that import leaves a reference cycle through the
    calling frames (``torch.fx.wrap`` keeps its own frame), which would keep
    the first remat call's tensors (parameters, gradients, logits) alive
    until a full garbage collection; so this module imports it first."""
    if not enabled:
        return body
    return lambda *args: checkpoint(body, *args, use_reentrant=False)
