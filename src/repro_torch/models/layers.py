"""Shared neural-net building blocks in PyTorch (functional, dict params).

Port of the reference's ``models/layers.py`` with the same names, layouts and
numerics:
  * activations [B, S, d] in ``compute_dtype``; reductions, softmax, RoPE and
    the norm scale in fp32;
  * weights in ``x @ w`` layout [d_in, d_out];
  * attention logits and the vocab logits are products of the compute-dtype
    inputs with an fp32 result (`matmul_f32`, the reference's
    ``preferred_element_type=float32``), masked with ``finfo(float32).min``;
    logits of the padded vocab are masked too.  On the CPU (and for fp32
    operands) that product is its plain version, the operands widened
    exactly to fp32;
  * query heads attend to the [B, S, KV, dh] keys and values grouped per KV
    head (`grouped_scores`, `grouped_values`): nothing repeats or widens K/V
    (the reference repeats them; the products are the same);
  * `cross_entropy` is the training loss (fp32), and `remat` runs a layer
    body under activation checkpointing where the reference uses
    ``jax.checkpoint``.

``attn_impl="blocked"`` (`attention_scores_blocked`: query tiles, each over
its causal KV horizon, with an online softmax over KV tiles under `remat`),
``attn_seq_shard`` (q sequence-sharded over 'model' before RoPE when the
activations are DTensors) and ``decode_impl="blocked"``
(`_decode_scores_blocked`: per-block partials, then a merge) are the
reference's plain-op variants, in plain PyTorch as the reference has them
in plain XLA ops.

The sharded steps (`launch.steps`) pass DTensors through the same
functions.  Where DTensor's op-by-op sharding would replicate work or
refuses a layout that GSPMD handles, a hook places the tensors as GSPMD
would: `gather_fsdp`, `_reduce_partial`, `split_dim`, `_per_shard`,
`write_token`, `_logsumexp` and `_gold`.  Each returns at once for a plain
tensor.

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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops as kernel_ops

from .config import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dt(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.compute_dtype]


def pdt(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


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
    return x @ gather_fsdp(p["w"]).to(x.dtype)


def gather_fsdp(w):
    """A DTensor weight gathered over the 'data' (FSDP) mesh axis, its other
    placements kept: ZeRO-3's gather at use, whose backward reduce-scatters
    the gradient, as GSPMD places it for `distributed.sharding`'s rules.  A
    plain tensor as it is."""
    if not isinstance(w, DTensor) or "data" not in (
            w.device_mesh.mesh_dim_names or ()):
        return w
    i = w.device_mesh.mesh_dim_names.index("data")
    if w.placements[i].is_replicate():
        return w
    want = list(w.placements)
    want[i] = Replicate()
    return w.redistribute(w.device_mesh, tuple(want))


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
    """[B, S, KV, dh] -> [B, S, KV * n_rep, dh], each head n_rep times in a
    row (``repeat_interleave``'s order, as an expand and a reshape, which
    DTensor has sharding rules for)."""
    if n_rep == 1:
        return k
    B, S, KV, dh = k.shape
    return k[:, :, :, None, :].expand(B, S, KV, n_rep, dh) \
        .reshape(B, S, KV * n_rep, dh)


# ---------------------------------------------------------------------------
# products with an fp32 result
# ---------------------------------------------------------------------------
def _mm(a, b):
    """a @ b (2-D, or batched 3-D) of bf16 (or fp16) operands with an fp32
    result: ``aten::mm.dtype`` / ``aten::bmm.dtype``."""
    return (torch.bmm if a.ndim == 3 else torch.mm)(
        a, b, out_dtype=torch.float32)


class _ProductF32(torch.autograd.Function):
    """a @ b of bf16 (or fp16) operands with fp32 accumulation and an fp32
    result.  The out_dtype overloads have no derivative formula.  The
    backward rounds the fp32 cotangent to the operands' dtype, as a TPU's
    default precision does, and multiplies on the tensor cores with an fp32
    result that is rounded once to the operand's dtype, as the reference's
    transposed product is."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = _mm(g, b.mT).to(a.dtype) if ctx.needs_input_grad[0] else None
        gb = _mm(a.mT, g).to(b.dtype) if ctx.needs_input_grad[1] else None
        return ga, gb


def matmul_f32(a, b):
    """a @ b with an fp32 result for 2-D or batched 3-D operands of one
    dtype: the reference's ``preferred_element_type=jnp.float32`` product.
    On the card (and on meta) bf16 operands are multiplied as they are,
    with fp32 accumulation (`_ProductF32`).  The out_dtype overloads have
    no CPU kernel, so a CPU tensor takes the plain version: both operands
    widened exactly and multiplied in fp32.  A product of two bf16 values
    is exact in fp32, so the two differ only in the order of their sums.
    fp32 operands take the plain product on every device (nothing to
    widen), so an fp32 model issues the same ops on the CPU and on meta."""
    if a.device.type == "cpu" or a.dtype == torch.float32:
        return torch.matmul(a.float(), b.float())
    return _ProductF32.apply(a, b)


def _query_groups(q, KV: int):
    """q [B,Sq,H,dh] -> [B*KV, H/KV*Sq, dh]: the query heads of each KV head
    (``_repeat_kv``'s order: head h reads KV head h // (H/KV)), head-major,
    one copy of q."""
    B, Sq, H, dh = q.shape
    return q.reshape(B, Sq, KV, H // KV, dh).movedim(1, 3) \
        .reshape(-1, H // KV * Sq, dh)


def _group_scores(qg, k):
    """`_query_groups` [B*KV, H/KV*Sq, dh] . k [B,Sk,KV,dh] -> fp32
    [B*KV, H/KV*Sq, Sk] (`matmul_f32`); k is copied head-major only for
    more than one row."""
    return matmul_f32(qg, k.movedim(1, 3).reshape(-1, k.shape[3], k.shape[1]))


def grouped_scores(q, k):
    """q [B,Sq,H,dh] . k [B,Sk,KV,dh] -> fp32 [B,H,Sq,Sk]: each query head
    against the keys of its KV head, with no repeated copy of k.  One query
    (decode) reads the cache where it lies, a product per KV head batched
    over the rows (k[:, :, j] has one batch stride); more queries fold
    (row, KV head) into one product's batch (`_query_groups`,
    `_group_scores`: their score matrix is the larger tensor, and comes out
    in place)."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1:3]
    rep = H // KV
    if Sq == 1:
        return torch.stack([matmul_f32(q[:, 0, j * rep:(j + 1) * rep],
                                       k[:, :, j].mT) for j in range(KV)],
                           dim=1).view(B, H, Sq, Sk)
    return _group_scores(_query_groups(q, KV), k).view(B, H, Sq, Sk)


def grouped_values(p, v, f32: bool):
    """p [B,H,Sq,Sk] . v [B,Sk,KV,dh] -> [B,H,Sq,dh], grouped as
    `grouped_scores`: an fp32 result (`matmul_f32`) with ``f32``, else one
    in the operands' dtype."""
    B, H, Sq, Sk = p.shape
    KV, dh = v.shape[2:]
    rep = H // KV

    def product(a, b):
        return matmul_f32(a, b) if f32 else torch.bmm(a, b)
    if Sq == 1:
        return torch.stack([product(p[:, j * rep:(j + 1) * rep, 0],
                                    v[:, :, j]) for j in range(KV)],
                           dim=1).view(B, H, Sq, dh)
    return product(p.reshape(-1, rep * Sq, Sk),
                   v.movedim(1, 2).reshape(-1, Sk, dh)).view(B, H, Sq, dh)


def attention_scores(q, k, v, mask, softcap: float = 0.0):
    """q: [B,Sq,H,dh], k/v: [B,Sk,KV,dh] with KV dividing H, mask:
    broadcastable [B,1,Sq,Sk].  The logits are the fp32 product of the
    inputs; the probabilities are rounded to v's dtype for the value
    product, as the reference rounds them."""
    dh = q.shape[-1]
    logits = grouped_scores(q, k) / math.sqrt(dh)
    if softcap > 0.0:
        logits = torch.tanh(logits / softcap) * softcap
    logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return grouped_values(probs, v, f32=False).transpose(1, 2)


def _blocked_attn_one_qblock(qblk, k, v, *, causal, rows, block_k, softcap):
    """Online softmax over the KV prefix for one q tile.

    The KV loop is a Python loop whose body runs under `remat`, so the
    [Sq, Sk] score matrix never materialises, not even for the backward.
    Both products have fp32 results (`matmul_f32`); p is rounded to v's
    dtype before its product, as the reference's p travels in bf16.
    """
    B, bq, H, dh = qblk.shape
    nb = k.shape[1] // block_k
    scale = 1.0 / math.sqrt(dh)
    qg = _query_groups(qblk, k.shape[2])  # once for every KV tile

    def body(m_prev, l_prev, acc, kblk, vblk, i: int):
        s = _group_scores(qg, kblk).view(B, H, bq, block_k) * scale
        if softcap > 0.0:
            s = torch.tanh(s / softcap) * softcap
        if causal:
            cols = i * block_k + torch.arange(block_k, device=rows.device)
            s = torch.where((cols[None, :] <= rows[:, None])[None, None], s,
                            float("-inf"))
        m_cur = s.amax(dim=-1)  # [B,H,bq]
        m_new = torch.maximum(m_prev, m_cur)
        safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(torch.isfinite(s), torch.exp(s - safe[..., None]),
                        0.0)
        alpha = torch.where(torch.isfinite(m_prev), torch.exp(m_prev - safe),
                            0.0)
        l_new = l_prev * alpha + p.sum(dim=-1)
        pv = grouped_values(p.to(vblk.dtype), vblk, f32=True)
        return m_new, l_new, acc * alpha[..., None] + pv

    body = remat(body, True)
    dev = qblk.device
    m = torch.full((B, H, bq), float("-inf"), dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, bq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, bq, dh), dtype=torch.float32, device=dev)
    for i in range(nb):
        blk = slice(i * block_k, (i + 1) * block_k)
        m, l, acc = body(m, l, acc, k[:, blk], v[:, blk], i)
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2)  # [B,bq,H,dh] fp32


def attention_scores_blocked(q, k, v, *, causal: bool, q_offset: int,
                             block_k: int = 512, softcap: float = 0.0,
                             num_q_blocks: int = 4):
    """Flash-style blocked attention in plain PyTorch ops (the reference's
    optimisation O1).

    Two-level tiling: a static loop over ``num_q_blocks`` query tiles (each
    tile attends ONLY to its causal KV prefix, so above-diagonal blocks are
    skipped structurally, about 2x fewer FLOPs at long Sq), and an online
    softmax over KV tiles inside (`_blocked_attn_one_qblock`).
    q: [B,Sq,H,dh], k/v: [B,Sk,KV,dh] with KV dividing H.
    """
    B, Sq, H, dh = q.shape
    Sk = k.shape[1]
    if Sk % block_k:
        raise ValueError(f"Sk={Sk} is not a multiple of block_k={block_k}")
    dev = q.device
    if not causal or Sq % num_q_blocks != 0 or Sq // num_q_blocks < 1:
        rows = q_offset + torch.arange(Sq, device=dev)
        out = _blocked_attn_one_qblock(q, k, v, causal=causal, rows=rows,
                                       block_k=block_k, softcap=softcap)
        return out.to(v.dtype)
    bq = Sq // num_q_blocks
    outs = []
    for i in range(num_q_blocks):
        qblk = q[:, i * bq:(i + 1) * bq]
        rows = q_offset + i * bq + torch.arange(bq, device=dev)
        # causal KV horizon of this q tile, rounded up to a whole KV block
        hi = min(Sk, ((q_offset + (i + 1) * bq + block_k - 1)
                      // block_k) * block_k)
        outs.append(_blocked_attn_one_qblock(
            qblk, k[:, :hi], v[:, :hi], causal=True, rows=rows,
            block_k=block_k, softcap=softcap))
    return torch.cat(outs, dim=1).to(v.dtype)


def _constrain(x, spec: tuple):
    """The reference's ``with_sharding_constraint``: a DTensor is
    redistributed to ``spec`` (a tuple of mesh axis names, one entry per
    dim); a plain tensor, which has no mesh, is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    from repro_torch.distributed.sharding import spec_placements
    mesh = x.device_mesh
    return x.redistribute(mesh, spec_placements(spec, mesh))


def split_dim(x, d: int, sizes: tuple):
    """Dim ``d`` of x viewed as ``sizes``.  A DTensor sharded on dim d in
    pieces that ``sizes[0]`` does not divide (heads over a mesh dim that the
    head count does not divide) is first gathered on that dim: DTensor
    cannot split such a shard, where GSPMD would shard the inner dim
    instead."""
    d %= x.ndim
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        ways = 1
        for i, pl in enumerate(x.placements):
            if pl.is_shard(d):
                ways *= mesh.size(i)
        if sizes[0] % ways:
            x = x.redistribute(mesh, tuple(
                Replicate() if pl.is_shard(d) else pl
                for pl in x.placements))
    return x.reshape(*x.shape[:d], *sizes, *x.shape[d + 1:])


def _per_shard(fn, q, kv: tuple, batch_args: tuple = ()):
    """``fn(q, *kv, *batch_args, q0=...)`` on each rank's shards, for
    attention: q [B, Sq, H, dh] and kv [B, Sk, KV, dh] (KV heads repeated to
    q's where q's heads are split over ranks); ``batch_args`` are [B, ...]
    (positions, masks); ``q0`` is the global index of the first local query
    row. Per mesh dim: batch sharding where any input has it; else q's head
    sharding (kv sliced to match); else q's query-sequence sharding (kv
    replicated: the reference's O2); else replicated. Key sequence shards
    are gathered first. Returns fn's [B, Sq, H, ...] result placed like q, a
    query-sequence sharding moved to the heads; plain tensors go straight to
    fn (q0 = 0). (Run as DTensor ops, the products would flatten a batch and
    a head dim that are both sharded, which DTensor refuses; GSPMD keeps
    them.)"""
    if not isinstance(q, DTensor):
        return fn(q, *kv, *batch_args, q0=0)
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = q.device_mesh
    want, other, rows = [], [], []
    for i in range(mesh.ndim):
        if any(t.placements[i] == Shard(0) for t in (q, *kv)):
            want.append(Shard(0))
        elif q.placements[i] in (Shard(2), Shard(1)):
            want.append(q.placements[i])
        else:
            want.append(Replicate())
        other.append(Replicate() if want[-1] == Shard(1) else want[-1])
        rows.append(want[-1] if want[-1] == Shard(0) else Replicate())
    if any(w == Shard(2) and mesh.size(i) > 1 for i, w in enumerate(want)):
        # q's heads split over ranks: kv with fewer heads is repeated to
        # q's, so that each rank holds its heads' groups
        kv = tuple(_repeat_kv(t, q.shape[2] // t.shape[2]) for t in kv)
    q = q.redistribute(mesh, want)
    q0 = compute_local_shape_and_global_offset(q.shape, mesh, want)[1][1]
    local = [q.to_local()] + [t.redistribute(mesh, other).to_local()
                              for t in kv]
    local += [a.redistribute(mesh, rows).to_local()
              if isinstance(a, DTensor) else a for a in batch_args]
    out = DTensor.from_local(fn(*local, q0=q0), mesh, want, run_check=False)
    if Shard(1) not in want:
        return out
    # query rows back to heads, as the output projection's input wants
    # them (its product would flatten a sharded batch and sequence)
    return out.redistribute(mesh, tuple(
        (Shard(2) if out.shape[2] % mesh.size(i) == 0 else Replicate())
        if pl == Shard(1) else pl for i, pl in enumerate(want)))


class _Reduced(torch.autograd.Function):
    """x redistributed to ``placements``; the gradient passes through
    as it comes (its value is the gradient of x's value whatever its
    placement; DTensor's own backward would turn it into x's masked
    partial placement, which it cannot)."""

    @staticmethod
    def forward(ctx, x, placements):
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _reduce_partial(x):
    """A DTensor whose placements hold pending partial sums, with those sums
    reduced (one all-reduce), and a plain tensor as it is.  Applied where a
    row-parallel product leaves partial sums (attention's and the MLP's
    output projections: the Megatron all-reduce, which keeps DTensor from
    replicating the next product's weight instead) and to the
    vocab-parallel embedding's and cross-entropy's masked lookups, which
    DTensor cannot reduce-scatter."""
    if not isinstance(x, DTensor) or not any(p.is_partial()
                                             for p in x.placements):
        return x
    return _Reduced.apply(x, tuple(
        Replicate() if p.is_partial() else p for p in x.placements))


def project_qkv(p, cfg: ModelConfig, x, kv_x=None):
    """Returns q [B,S,H,dh], k/v [B,S_kv,KV,dh] after qk-norm (pre-RoPE)."""
    B, S, _ = x.shape
    H, KV, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kv_in = x if kv_x is None else kv_x
    q = split_dim(linear(p["wq"], x), -1, (H, dh))
    k = split_dim(linear(p["wk"], kv_in), -1, (KV, dh))
    v = split_dim(linear(p["wv"], kv_in), -1, (KV, dh))
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
    B, S, _ = x.shape
    H, dh = cfg.num_heads, cfg.head_dim
    q, k, v = project_qkv(p, cfg, x, kv_x)
    if cfg.attn_impl == "blocked" and cfg.attn_seq_shard:
        # O2, placed BEFORE RoPE: the fp32 position math must already be
        # Sq-sharded, or the fp32 full-head tensors are gathered per layer
        q = _constrain(q, (None, "model", None, None))
        # K/V: batch stays on 'data'; replicated over 'model' only
        k = _constrain(k, ("data", None, None, None))
        v = _constrain(v, ("data", None, None, None))
    if use_rope and kv_x is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    seg_kv = (k, v)
    if prefix_kv is not None:
        k = torch.cat([prefix_kv[0].to(k.dtype), k], dim=1)
        v = torch.cat([prefix_kv[1].to(v.dtype), v], dim=1)
    Sk = k.shape[1]
    P = Sk - S
    if cfg.attn_impl == "blocked" and Sk % cfg.attn_block_k == 0:
        out = _per_shard(lambda q_, k_, v_, q0: attention_scores_blocked(
            q_, k_, v_, causal=(causal and kv_x is None), q_offset=P + q0,
            block_k=cfg.attn_block_k, softcap=cfg.logit_softcap), q, (k, v))
    else:
        if causal and kv_x is None:
            # absolute key position j visible to suffix-query i when j <= i+P
            iq = torch.arange(S, device=x.device)[:, None] + P
            jk = torch.arange(Sk, device=x.device)[None, :]
            mask = (jk <= iq)[None, None, :, :]
        else:
            mask = torch.ones((1, 1, S, Sk), dtype=torch.bool,
                              device=x.device)
        out = _per_shard(lambda q_, k_, v_, q0: attention_scores(
            q_, k_, v_, mask[:, :, q0:q0 + q_.shape[1]], cfg.logit_softcap),
            q, (k, v))
    out = _reduce_partial(linear(p["wo"], out.reshape(B, S, H * dh)))
    return out, seg_kv


def write_token(cache, new, pos) -> None:
    """cache[b, pos[b]] = new[b] for every row b, IN PLACE.  cache: [B, S,
    ...], new: [B, ...], pos: [B] int.

    A DTensor cache (B and S sharded, as `distributed.sharding`'s cache
    rule places them) is written shard by shard: each rank takes the whole
    new row and position (small all-gathers), and writes its rows whose
    position falls in its slice of S; a row whose position lies elsewhere
    rewrites its clamped slot with the value it holds.  Nothing depends on
    the values, so it runs on meta tensors too."""
    if not isinstance(cache, DTensor):
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, pos.long()] = new.to(cache.dtype)
        return
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    local = cache.to_local()
    (Bl, Sl), (b0, s0) = (
        t[:2] for t in compute_local_shape_and_global_offset(
            cache.shape, cache.device_mesh, cache.placements))
    full = new.full_tensor() if isinstance(new, DTensor) else new
    p = pos.full_tensor() if isinstance(pos, DTensor) else pos
    lp = p.long()[b0:b0 + Bl] - s0
    inside = (lp >= 0) & (lp < Sl)
    idx = lp.clamp(0, Sl - 1)
    rows = torch.arange(Bl, device=local.device)
    old = local[rows, idx]
    keep = inside.reshape((Bl,) + (1,) * (old.ndim - 1))
    local[rows, idx] = torch.where(keep, full[b0:b0 + Bl].to(local.dtype),
                                   old)


def _decode_block_partials(q, k_cache, v_cache, pos, n_blocks: int,
                           s0: int = 0):
    """Per-block softmax partials of one query against a cache whose first
    position is ``s0``: (m, l) [B,KV,rep,nb] and o [B,KV,rep,nb,dh], products
    with fp32 results (`matmul_f32`), p rounded to the cache's dtype before
    its product."""
    B, H, dh = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    nb = n_blocks
    sb = S // nb
    rep = H // KV
    s = grouped_scores(q[:, None], k_cache).view(B, KV, rep, nb, sb) \
        / math.sqrt(dh)
    dev = q.device
    cols = s0 + (torch.arange(nb, device=dev)[:, None] * sb
                 + torch.arange(sb, device=dev)[None, :])
    valid = cols[None] <= pos[:, None, None]  # [B,nb,sb]
    s = torch.where(valid[:, None, None], s, float("-inf"))
    m_blk = s.amax(dim=-1)  # [B,KV,rep,nb]
    safe = torch.where(torch.isfinite(m_blk), m_blk, 0.0)
    p = torch.where(torch.isfinite(s), torch.exp(s - safe[..., None]), 0.0)
    l_blk = p.sum(dim=-1)  # [B,KV,rep,nb]
    # per KV head, one product batched over (row, block): v's blocks of a
    # KV head have one batch stride
    pb = p.to(v_cache.dtype).permute(1, 0, 3, 2, 4) \
        .reshape(KV, B * nb, rep, sb)
    vb = v_cache.reshape(B * nb, sb, KV, dh)
    o_blk = torch.stack([matmul_f32(pb[j], vb[:, :, j]) for j in range(KV)])
    return m_blk, l_blk, o_blk.view(KV, B, nb, rep, dh).permute(1, 0, 3, 2, 4)


def _merge_blocks(m_blk, l_blk, o_blk):
    """The cross-block merge of `_decode_block_partials` -> [B,KV,rep,dh]."""
    m_g = m_blk.amax(dim=-1, keepdim=True)
    w = torch.where(torch.isfinite(m_blk), torch.exp(m_blk - m_g), 0.0)
    denom = (w * l_blk).sum(dim=-1)  # [B,KV,rep]
    num = (w[..., None] * o_blk).sum(dim=-2)  # [B,KV,rep,dh]
    return num / denom.clamp_min(1e-30)[..., None]


def _decode_scores_blocked(q, k_cache, v_cache, pos, n_blocks: int):
    """Flash-decoding in plain ops (the reference's optimisation O3).

    The cache sequence dim is viewed as [n_blocks, S/n_blocks]; every
    per-block partial (m, l, o) treats the block index as a BATCH dim, so a
    sequence-sharded cache keeps all heavy work local and only the small
    [B,H]-sized partial merge crosses the mesh: on DTensors each rank
    computes the partials of its own blocks (`_decode_block_partials`) and
    the merge runs as DTensor reductions over the block dim.

    q: [B,H,dh]; caches: [B,S,KV,dh]; pos: [B] -> [B,H,dh] fp32.
    """
    B, H, dh = q.shape
    KV = k_cache.shape[2]
    if not isinstance(k_cache, DTensor):
        out = _merge_blocks(*_decode_block_partials(q, k_cache, v_cache, pos,
                                                    n_blocks))
        return out.reshape(B, H, dh)
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = k_cache.device_mesh
    # batch stays sharded where the cache's is, blocks where its sequence
    # is; everything else (q's heads) is gathered
    rows = [Shard(0) if pl == Shard(0) else Replicate()
            for pl in k_cache.placements]
    cache_pl = [pl if pl in (Shard(0), Shard(1)) else Replicate()
                for pl in k_cache.placements]
    kc, vc = (c.redistribute(mesh, cache_pl) for c in (k_cache, v_cache))
    local_k = kc.to_local()
    (_, S_l), (_, s0) = (t[:2] for t in compute_local_shape_and_global_offset(
        kc.shape, mesh, kc.placements))
    nb_l = n_blocks * S_l // kc.shape[1]
    if nb_l * kc.shape[1] != n_blocks * S_l:
        raise ValueError(f"a cache shard of {S_l} positions is not a whole "
                         f"number of the {n_blocks} blocks")
    ql, pl_ = (t.redistribute(mesh, rows).to_local()
               if isinstance(t, DTensor) else t for t in (q, pos))
    parts = _decode_block_partials(ql, local_k, vc.to_local(), pl_, nb_l, s0)
    blocks = [Shard(3) if pl == Shard(1) else r
              for pl, r in zip(cache_pl, rows)]
    m_blk, l_blk, o_blk = (DTensor.from_local(t, mesh, blocks,
                                              run_check=False)
                           for t in parts)
    return _merge_blocks(m_blk, l_blk, o_blk).reshape(B, H, dh)


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
    B = x.shape[0]
    H, dh = cfg.num_heads, cfg.head_dim
    q, k, v = project_qkv(p, cfg, x)
    S = k_cache.shape[1]
    if not cross:
        if use_rope:
            q = rope(q, pos[:, None], cfg.rope_theta)
            k = rope(k, pos[:, None], cfg.rope_theta)
        pos = pos.long()
        write_token(k_cache, k[:, 0], pos)
        write_token(v_cache, v[:, 0], pos)
        if cfg.decode_impl == "blocked" and S % cfg.decode_blocks == 0:
            out = _decode_scores_blocked(q[:, 0], k_cache, v_cache, pos,
                                         cfg.decode_blocks).to(x.dtype)
            out = _reduce_partial(linear(p["wo"], out.reshape(B, 1, H * dh)))
            return out, (k_cache, v_cache)

        def mask_of(pos_):
            cols = torch.arange(S, device=pos_.device)
            return (cols[None, :] <= pos_[:, None])[:, None, None, :]
        mask_args = (pos,)
    else:
        if cache_len_mask is not None:
            def mask_of(m):
                return m[:, None, None, :]
            mask_args = (cache_len_mask,)
        else:
            def mask_of():
                return torch.ones((1, 1, 1, S), dtype=torch.bool,
                                  device=x.device)
            mask_args = ()
    out = _per_shard(
        lambda q_, k_, v_, *m, q0: attention_scores(q_, k_, v_, mask_of(*m),
                                                    cfg.logit_softcap),
        q, (k_cache.to(q.dtype), v_cache.to(q.dtype)), mask_args)
    out = _reduce_partial(linear(p["wo"], out.reshape(B, 1, H * dh)))
    return out, (k_cache, v_cache)


def attention_partials(q, k, v, mask, softcap: float = 0.0):
    """Softmax attention over one key segment, returning partials.

    q: [B,Sq,H,dh], k/v: [B,Sk,KV,dh] with KV dividing H, mask broadcastable
    to [B,1,Sq,Sk].  Returns (o, m, l): the *normalized* fp32 output
    [B,Sq,H,dh] plus the running-softmax residuals m/l [B,Sq,H], so
    attention over disjoint key segments (a packed-resident prefix and an fp
    suffix) composes exactly via `merge_attention_partials` — the same
    (m, l) contract the fused kernels return.  The logits are the fp32
    product of the inputs; the value product is fp32, p times v widened, as
    the reference's is."""
    dh = q.shape[-1]
    logits = grouped_scores(q, k) / math.sqrt(dh)
    if softcap > 0.0:
        logits = torch.tanh(logits / softcap) * softcap
    logits = torch.where(mask, logits, float("-inf"))
    m = logits.amax(dim=-1)  # [B,H,Sq]
    safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(torch.isfinite(logits),
                    torch.exp(logits - safe[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = grouped_values(p, v.float(), f32=True).transpose(1, 2)
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
    H, dh = cfg.num_heads, cfg.head_dim
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
    o_s, m_s, l_s = attention_partials(q, k, v, mask)
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
    H, dh = cfg.num_heads, cfg.head_dim
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
    o_s, m_s, l_s = attention_partials(q, sk_cache, sv_cache, mask)
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
    return _reduce_partial(linear(p["wo"], h))


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
    x = _reduce_partial(F.embedding(tokens.long(),
                                    gather_fsdp(p["table"]).to(dt(cfg))))
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt(cfg),
                             device=x.device)
    return x


def logits(p, cfg: ModelConfig, x):
    """[B, S, d] -> fp32 [B, S, padded_vocab], padded entries masked.

    The mask is written in place after the product, whose backward keeps
    its inputs, not its output; the overwritten columns get zero gradient,
    as the reference's ``jnp.where`` gives them."""
    table = gather_fsdp(p.get("unembed", p["table"]))
    out = _vocab_product(x, table.to(x.dtype))
    if cfg.padded_vocab != cfg.vocab_size:
        out[..., cfg.vocab_size:] = torch.finfo(torch.float32).min
    return out


class _GradOverRows(torch.autograd.Function):
    """x as it is; its gradient, partial over the mesh dims that split the
    vocab, reduce-scattered there over the batch rows where they divide
    evenly (else reduced).  The layers' backward then splits its rows over
    those dims too: a partial or replicated gradient makes DTensor gather
    each layer's weights and repeat the full products on every rank of the
    dim.  (The token dim is no alternative: torch 2.11 refuses to flatten
    a batch and a token dim that are both sharded.)"""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh = g.device_mesh
        rows, want = g.shape[0], []
        for i, p in enumerate(g.placements):
            if p.is_partial():
                p = Shard(0) if rows % mesh.size(i) == 0 else Replicate()
            if p.is_shard(0):
                rows //= mesh.size(i)
            want.append(p)
        return g.redistribute(mesh, tuple(want))


def _vocab_product(x, table):
    """x [B,S,d] . table [V,d] -> fp32 [B,S,V] (`matmul_f32`).  DTensors
    are multiplied shard by shard, since DTensor has no sharding rule for
    the out_dtype products: per mesh dim, x keeps a batch or sequence
    sharding, else the table keeps its vocab sharding (the vocab-parallel
    logits GSPMD gives), and anything else is gathered first."""
    if not isinstance(x, DTensor):
        return matmul_f32(x.reshape(-1, x.shape[-1]), table.mT) \
            .view(*x.shape[:-1], -1)
    mesh = x.device_mesh
    # per mesh dim: x's and the table's placements, the result's, and those
    # of x's and the table's local gradients (a sum over the other operand's
    # shards is partial)
    per_dim = []
    for xs, ts in zip(x.placements, table.placements):
        if xs.is_shard() and xs.dim < x.ndim - 1:
            per_dim.append((xs, Replicate(), xs, xs, Partial()))
        elif ts.is_shard(0):
            per_dim.append((Replicate(), ts, Shard(x.ndim - 1), Partial(),
                            ts))
        else:
            per_dim.append((Replicate(),) * 5)
    xp, tp, op, xg, tg = zip(*per_dim)
    if xp != tuple(x.placements):
        x = x.redistribute(mesh, xp)
    out = _vocab_product(
        _GradOverRows.apply(x).to_local(grad_placements=xg),
        table.redistribute(mesh, tp).to_local(grad_placements=tg))
    return DTensor.from_local(out, mesh, op, run_check=False)


def _logsumexp(logit_f32):
    """logsumexp over the last dim; for a DTensor as a max, an exp and a
    sum, reductions DTensor runs on the vocab shards (its logsumexp would
    gather the whole vocab on every device first)."""
    if not isinstance(logit_f32, DTensor):
        return torch.logsumexp(logit_f32, dim=-1)
    m = logit_f32.amax(dim=-1, keepdim=True).detach()
    return torch.log(torch.exp(logit_f32 - m).sum(-1)) + m[..., 0]


def _gold(logit_f32, labels):
    """logit_f32[..., labels]: a gather, or for a DTensor the sum of the
    logits times a one-hot of the labels built on the logits' vocab
    sharding (a gather's backward would scatter into a zero tensor of the
    GLOBAL logits' size on every device)."""
    if not isinstance(logit_f32, DTensor):
        return torch.gather(logit_f32, -1, labels.long()[..., None])[..., 0]
    d = logit_f32.ndim - 1
    vocab = DTensor.from_local(
        torch.arange(logit_f32.shape[-1], device=logit_f32.to_local().device),
        logit_f32.device_mesh, [Replicate()] * logit_f32.device_mesh.ndim,
        run_check=False).redistribute(
            logit_f32.device_mesh,
            [Shard(0) if p.is_shard(d) else Replicate()
             for p in logit_f32.placements])
    hot = labels.long()[..., None] == vocab
    return _reduce_partial((logit_f32 * hot).sum(-1))


def cross_entropy(logit_f32: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy in fp32; labels [B,S] int.  ``mask`` [B,S]
    weights each token's NLL (the mean over the mask's sum, at least 1)."""
    nll = _logsumexp(logit_f32) - _gold(logit_f32, labels)
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
