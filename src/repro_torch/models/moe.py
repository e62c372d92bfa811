"""Mixture-of-experts decoder (Qwen3-MoE 128e/top-8, Llama4-Maverick
128e/top-1 + shared expert, alternating dense/MoE layers).

Port of the reference's ``models/moe.py``: the router, the dropless ragged
dispatch (serving and, by default, training) and the sort-based capacity
dispatch (training).  The reference's ``lax.ragged_dot`` and einsums are XLA
products, not Pallas kernels, so the expert products are PyTorch's own.  In
the ragged dispatch (`_expert_chain`) a tensor off the CPU (the card, and
bf16 on meta for the dry run) runs the reference's three ragged products as
three grouped products, ``torch._grouped_mm`` over the stacked weights with
the group offsets kept on the device (no host sync); a CPU tensor runs the
plain version, one product chain per expert that has tokens (the counts
come to the host, empty experts are skipped).  The capacity dispatch runs
one batched product over [E, C, d] buffers.

Both dispatches gather with permutations only (the capacity buffers' empty
slots read a zero row), so their backward adds no two live rows into one,
and they give each token's k expert outputs back through
the inverse permutation and sum them over k in a fixed order (no atomic
``index_add_``): the same tokens at the same shapes give the same bits on
every run, forward and backward.

Parameter layout as in the reference (so ``bridge.params_from_reference``
carries weights across unchanged): router [d, E] fp32, experts [E, d, f]
and [E, f, d]; layers stacked on [L] (``moe_every == 1``) or on [L/2]
super-layers ``{"dense", "moe"}`` (``moe_every == 2``, llama4).
DeepSeek-V2's stack (`mla`) reuses the expert MLP, with the router's top-k
weights left as the softmax gave them (``renormalise=False``).

The routed experts of a layer (router, dispatch, products and combine, the
shared experts aside) are the region ``experts`` of a timed step
(`timing`).

On DTensors (a sharded step, `launch.steps`) the ragged dispatch is expert
parallel (`_moe_sharded`): tokens replicated over the 'model' axis, each
rank runs its own experts' products on its local tokens, and the outputs
are summed over 'model'.  On the meta device there are no routing counts
to read, so there each expert takes an equal share of the (token, rank)
pairs (the balanced routing a load-balance loss aims at).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import dense
from . import layers as nn
from . import timing
from .config import ModelConfig

LOAD_BALANCE_COEF = 0.01


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


def _route(p, cfg: ModelConfig, xf, renormalise: bool = True,
           scale: float = 1.0):
    """Router: returns (topw [T,k], topi [T,k], aux loss).  The top-k
    weights are renormalised, or (``renormalise`` False, DeepSeek-V2) left
    as the softmax gave them, times ``scale``."""
    E, k = cfg.num_experts, cfg.experts_per_token
    T = xf.shape[0]
    router_logits = xf.float() @ p["router"].float()  # [T, E]
    probs = torch.softmax(router_logits, dim=-1)
    topw, topi = torch.topk(probs, k, dim=-1)  # [T, k]
    if renormalise:
        topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)
    elif scale != 1.0:
        topw = topw * scale
    # load-balance auxiliary loss (Switch style): E * sum_e f_e * P_e
    f_e = _expert_counts(topi, E).float() / (T * k)
    P_e = probs.mean(0)
    aux = E * torch.sum(f_e * P_e)
    return topw, topi, aux


def _expert_counts(topi, E: int):
    """How many entries of ``topi`` [T, k] name each of E experts: a sum of
    ones into E bins (the card's bincount reads the largest entry to the
    host first), or for a DTensor (which has no rule for either) a sum of
    comparisons."""
    if not isinstance(topi, nn.DTensor):
        flat = topi.reshape(-1)
        return torch.zeros(E, dtype=torch.long, device=flat.device) \
            .scatter_add_(0, flat, torch.ones_like(flat))
    experts = torch.arange(E, device=topi.to_local().device)
    return (topi[..., None] == experts).sum((0, 1))


def _sorted_rows(xf, order, k: int):
    """Row ``order[i] // k`` of xf for each i: the token of each
    expert-sorted (token, rank) entry.  Gathered from the k-fold repeat by
    the permutation ``order``, so the backward writes each repeated row
    once and sums a token's k rows in rank order."""
    T, d = xf.shape
    return xf[:, None].expand(T, k, d).reshape(T * k, d)[order]


def _combine(out, order, topw, k: int):
    """Expert-sorted outputs [T*k, d] -> [T, d]: back to token order through
    the inverse permutation, weighted, summed over the k ranks in order."""
    T = topw.shape[0]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * k, device=order.device)
    contrib = out[inv].view(T, k, -1) * topw.to(out.dtype)[..., None]
    y = contrib[:, 0]
    for j in range(1, k):  # a fixed order of the k adds
        y = y + contrib[:, j]
    return y


def grouped_dispatch(x) -> bool:
    """Whether the ragged dispatch runs ``x``'s experts as grouped products
    (`_expert_grouped`) rather than as the plain per-expert chain
    (`_expert_loop`): every tensor off the CPU, except a meta tensor of
    another dtype than bf16, for which ``torch._grouped_mm`` has no meta
    kernel (fp32 smoke configs in the dry run's tests)."""
    if x.device.type == "cpu":
        return False
    return x.device.type != "meta" or x.dtype == torch.bfloat16


def _expert_loop(xs, key, weights, counts=None):
    """The plain version: one product chain per expert that has pairs.
    ``xs`` [T*k, d] sorted stably by ``key`` (each pair's expert among the
    E_l at hand, or E_l for one held elsewhere); ``counts``: pairs per
    expert, host ints (from a bincount of ``key`` when None).  The pairs of
    experts held elsewhere, last, give zero rows."""
    wg, wu, wo = (w.unbind(0) for w in weights)
    E_l = len(wg)
    if counts is None:
        counts = torch.bincount(key, minlength=E_l + 1)[:E_l].tolist()
    outs, start = [], 0
    for e, n in enumerate(counts):
        if n == 0:
            continue
        seg = xs[start:start + n]
        h = F.silu(seg @ wg[e].to(seg.dtype)) * (seg @ wu[e].to(seg.dtype))
        outs.append(h @ wo[e].to(h.dtype))
        start += n
    if start < xs.shape[0]:
        outs.append(xs.new_zeros((xs.shape[0] - start, wo[0].shape[-1])))
    return torch.cat(outs)


def _expert_grouped(xs, key, weights, counts=None):
    """`_expert_loop`'s function as three grouped products over the
    stacked weights (gate, up, out; [E_l, d, f], [E_l, f, d]), the
    reference's three ``ragged_dot`` calls.  The group ends are the
    positions of each expert's last pair in the sorted ``key`` (a
    ``searchsorted`` on the device: no count reaches the host).  A grouped
    product leaves the rows past the last group undefined, so those rows
    (the pairs of experts held elsewhere) are set to zero at the input and
    after each product, which also keeps their gradient zero.  ``counts``
    (host ints) is given only on meta, where there is no key to read
    (balanced routing): the products then run on the rows in groups alone,
    so that `roofline.CostMode` counts what the pairs need."""
    wg, wu, wo = weights
    E_l, M = wg.shape[0], xs.shape[0]
    if counts is not None:
        rows = sum(counts)
        offs = torch.tensor(counts, dtype=torch.int32,
                            device=xs.device).cumsum(0, dtype=torch.int32)
        h = F.silu(torch._grouped_mm(xs[:rows], wg.to(xs.dtype), offs=offs)) \
            * torch._grouped_mm(xs[:rows], wu.to(xs.dtype), offs=offs)
        out = torch._grouped_mm(h, wo.to(h.dtype), offs=offs)
        return torch.cat([out, out.new_zeros((M - rows, out.shape[1]))])
    ends = torch.arange(1, E_l + 1, dtype=key.dtype, device=key.device)
    offs = torch.searchsorted(key.sort(stable=True).values, ends,
                              out_int32=True)
    valid = (torch.arange(M, device=xs.device) < offs[-1])[:, None]

    def product(a, w):
        return torch.where(valid, torch._grouped_mm(a, w.to(a.dtype),
                                                    offs=offs), 0)

    xs = torch.where(valid, xs, 0)
    return product(F.silu(product(xs, wg)) * product(xs, wu), wo)


def _expert_chain(xf, topw, key, weights, counts=None):
    """The ragged dispatch's body over the E_l experts whose stacked
    weights ``weights`` (gate, up, out; [E_l, ...]) are at hand: ``key``
    [T*k] is each (token, rank) pair's expert among them, or E_l for an
    expert held elsewhere.  The pairs sorted stably by key, the expert MLP
    on each (`grouped_dispatch` chooses grouped products or the per-expert
    chain; ``counts``, host ints, only on meta), the other pairs'
    contributions zero; combined back to [T, d]."""
    k = topw.shape[1]
    order = torch.argsort(key, stable=True)
    xs = _sorted_rows(xf, order, k)  # [T*k, d] in expert-sorted order
    run = _expert_grouped if grouped_dispatch(xs) else _expert_loop
    return _combine(run(xs, key, weights, counts), order, topw, k)


def _moe_ragged(p, cfg: ModelConfig, xf, topw, topi):
    """Dropless dispatch: exactly causal (no capacity drops), as the serving
    path needs, and only the active T*k*d*f work.  On the CPU the counts
    come to the host (one sync); indexing expert e of a stacked [E, ...]
    weight would allocate a whole-stack zero gradient per expert in the
    backward, so `_expert_loop` unbinds each weight once."""
    return _expert_chain(xf, topw, topi.reshape(-1),
                         [p[n] for n in ("wi_gate", "wi_up", "wo")])


def _moe_sharded(p, cfg: ModelConfig, xf, topw, topi):
    """The ragged dispatch over DTensors, expert parallel: xf [T, d] rows
    sharded over 'data', replicated over 'model' (`moe_mlp` places them);
    the expert stacks gathered over 'data' (`layers.gather_fsdp`) keep
    their E axis sharded over 'model'.  Each rank runs `_expert_chain` on
    its local (token, rank) pairs and its own experts; the pairs of other
    ranks' experts contribute zero rows, and the sum over 'model' (one
    all-reduce) completes every token."""
    mesh = xf.device_mesh
    rows = xf.placements
    topw, topi = (t.redistribute(mesh, rows) for t in (topw, topi))
    ws = [nn.gather_fsdp(p[n]) for n in ("wi_gate", "wi_up", "wo")]
    E, k = cfg.num_experts, cfg.experts_per_token
    E_l = ws[0].to_local().shape[0]
    e0 = 0
    for i, pl in enumerate(ws[0].placements):
        if pl.is_shard(0):
            e0 = mesh.get_local_rank(i) * E_l
    xl, flat_e = xf.to_local(), topi.to_local().reshape(-1)
    key = torch.where((flat_e >= e0) & (flat_e < e0 + E_l), flat_e - e0,
                      E_l)  # other ranks' experts last
    counts = None
    if xl.device.type == "meta":  # no keys to read: balanced routing
        counts = [xl.shape[0] * k // E] * E_l
    y = _expert_chain(xl, topw.to_local(), key, [w.to_local() for w in ws],
                      counts)
    # each expert shard's rank holds part of every token's sum
    sums = tuple(nn.Partial() if pl.is_shard(0) else r
                 for pl, r in zip(ws[0].placements, rows))
    return nn._reduce_partial(nn.DTensor.from_local(
        y, mesh, sums, run_check=False, shape=xf.shape, stride=xf.stride()))


def capacity_slots(topi, E: int, C: int):
    """The capacity dispatch's placement (the reference's ``_moe_capacity``):
    (order, slot).  ``order`` sorts the flat (token, rank) entries by expert,
    stably; sorted entry i takes buffer slot ``expert * C + rank within its
    expert`` if that rank is below C, else the trash slot E*C (dropped)."""
    flat_e = topi.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    counts = torch.bincount(flat_e, minlength=E)
    seg_start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(flat_e.numel(), device=topi.device) - seg_start[se]
    slot = torch.where(pos < C, se * C + pos, E * C)
    return order, slot


def _moe_capacity(p, cfg: ModelConfig, xf, topw, topi):
    """Sort-based capacity-C dispatch into dense [E, C, d] buffers; tokens
    over capacity are dropped, so it is NOT causal across batch shapes
    (training only, as in the reference)."""
    T, d = xf.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    C = max(1, int(T * k / E * cfg.capacity_factor))  # static capacity
    order, slot = capacity_slots(topi, E, C)
    # each slot's sorted entry; T*k (a zero row) where no entry landed, and
    # the trash slot's writes are cut off
    src = torch.full((E * C + 1,), T * k, dtype=torch.long, device=xf.device)
    src[slot] = torch.arange(T * k, device=xf.device)
    xs = torch.cat([_sorted_rows(xf, order, k), xf.new_zeros((1, d))])
    ein = xs[src[:E * C]].view(E, C, d)  # expert inputs
    h = F.silu(torch.einsum("ecd,edf->ecf", ein, p["wi_gate"].to(ein.dtype))) \
        * torch.einsum("ecd,edf->ecf", ein, p["wi_up"].to(ein.dtype))
    eout = torch.einsum("ecf,efd->ecd", h, p["wo"].to(h.dtype))
    # each sorted entry's output (zero for a dropped one), then token order
    out = torch.cat([eout.reshape(E * C, d), xf.new_zeros((1, d))])[slot]
    return _combine(out, order, topw, k)


def moe_mlp(p, cfg: ModelConfig, x, dispatch: str = "ragged", *,
            renormalise: bool = True, scale: float = 1.0):
    """x: [B, S, d] -> (y, aux_loss); ``dispatch`` "ragged" (dropless) or
    "capacity"; ``renormalise`` and ``scale`` as in `_route`."""
    B, S, d = x.shape
    if isinstance(x, nn.DTensor):  # rows over 'data' only (`_moe_sharded`)
        x = x.redistribute(x.device_mesh, tuple(
            nn.Shard(0) if pl.is_shard(0) else nn.Replicate()
            for pl in x.placements))
    xf = x.reshape(B * S, d)
    with timing.region("experts", tokens=B * S):
        topw, topi, aux = _route(p, cfg, xf, renormalise, scale)
        if isinstance(xf, nn.DTensor):
            if dispatch != "ragged":
                raise ValueError("only the ragged dispatch runs on DTensors")
            y = _moe_sharded(p, cfg, xf, topw, topi)
        elif dispatch == "ragged":
            y = _moe_ragged(p, cfg, xf, topw, topi)
        else:
            y = _moe_capacity(p, cfg, xf, topw, topi)
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


def forward(params, cfg: ModelConfig, tokens, *, remat: bool = False,
            dispatch: str = "ragged"):
    """[B,S] -> (hidden [B,S,d], the summed aux loss of the MoE layers).
    ``remat`` checkpoints each layer (``moe_every == 1``) or super-layer, as
    the reference does; the recomputation routes the same tokens again (the
    routing is deterministic), on the CPU its host sync of the ragged
    counts included."""
    x = nn.embed(params["embed"], cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]

    def body(p, h):
        if cfg.moe_every != 1:
            h, _ = dense.block(p["dense"], cfg, h, positions)
            p = p["moe"]
        h, _, aux = moe_block(p, cfg, h, positions, None, dispatch)
        return h, aux

    body = nn.remat(body, remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in dense.unstack(params["layers"]):
        x, a = body(p, x)
        aux = aux + a
    return nn.rmsnorm(params["final_norm"], x), aux


def loss(params, cfg: ModelConfig, batch, *, remat: bool = False,
         dispatch: str = "ragged"):
    """Cross-entropy + LOAD_BALANCE_COEF x the layers' summed aux loss."""
    x, aux = forward(params, cfg, batch["tokens"], remat=remat,
                     dispatch=dispatch)
    lg = nn.logits(params["embed"], cfg, x)
    ce = nn.cross_entropy(lg, batch["labels"], batch.get("loss_mask"))
    return ce + LOAD_BALANCE_COEF * aux


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
