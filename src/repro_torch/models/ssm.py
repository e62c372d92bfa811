"""Mamba2 (SSD: state-space duality) language model.

Port of the reference's ``models/ssm.py``.  Prefill uses the *chunked* SSD
algorithm: the work inside a chunk is dense products over [chunk x chunk]
and [chunk x state] tiles, and a Python loop over chunks (the reference's
``lax.scan``) carries the [heads, state, headdim] state from one chunk to
the next.  Decode uses the O(1) recurrent form.

Training (`loss`) runs the same chunked form under autograd.

The reusable "prefix state" is the fixed-size (conv_state, ssm_state)
snapshot at a chunk boundary (DESIGN.md §Arch-applicability).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import dense
from . import layers as nn
from .config import ModelConfig


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_ssm_layer(cfg: ModelConfig, generator, device, lead: tuple = ()):
    d, di, ds, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * ds
    f32 = torch.float32
    # dt bias: softplus^-1 of dt log-uniform in [1e-3, 0.1]
    u = torch.rand(lead + (nh,), generator=generator, device=device,
                   dtype=f32)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, device=device,
                                     dtype=f32)).expand(lead + (nh,))
    conv_w = torch.empty(lead + (cfg.ssm_conv, conv_dim), dtype=nn.pdt(cfg),
                         device=device)
    return {
        "ln": nn.init_rmsnorm(d, nn.pdt(cfg), device, lead),
        "in_proj": nn.init_linear(d, 2 * di + 2 * ds + nh, nn.pdt(cfg),
                                  generator, device, lead=lead),
        "conv_w": nn.normal_(conv_w, conv_dim ** -0.5, generator),
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=nn.pdt(cfg),
                              device=device),
        "A_log": a_log.contiguous(),
        "dt_bias": dt_bias,
        "D": torch.ones(lead + (nh,), dtype=f32, device=device),
        "gate_norm": nn.init_rmsnorm(di, nn.pdt(cfg), device, lead),
        "out_proj": nn.init_linear(di, d, nn.pdt(cfg), generator, device,
                                   scale=di ** -0.5, lead=lead),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator, device):
    return {"embed": nn.init_embedding(cfg, generator, device),
            "layers": init_ssm_layer(cfg, generator, device,
                                     (cfg.num_layers,)),
            "final_norm": nn.init_rmsnorm(cfg.d_model, nn.pdt(cfg), device)}


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------
def _segsum(dA):
    """dA: [..., q] -> lower-triangular segment sums
    S[i,j] = sum_{k=j+1..i} dA_k (-inf above the diagonal)."""
    q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    S = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dA.device))
    return torch.where(mask, S, -math.inf)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, h0=None):
    """Chunked state-space-duality scan.

    x:  [b, s, h, p]   inputs per head
    dt: [b, s, h]      softplus'd timestep
    A:  [h]            negative per-head decay
    Bm: [b, s, n]      input projection (shared across heads, n_groups=1)
    Cm: [b, s, n]      output projection
    h0: optional initial state [b, h, n, p]
    Returns (y [b, s, h, p], final_state [b, h, n, p] fp32).
    """
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk
    f32 = torch.float32
    xc = x.reshape(b, nc, chunk, h, p).to(f32)
    dtc = dt.reshape(b, nc, chunk, h).to(f32)
    Bc = Bm.reshape(b, nc, chunk, n).to(f32)
    Cc = Cm.reshape(b, nc, chunk, n).to(f32)

    dA = dtc * A[None, None, None, :]  # [b,nc,q,h]
    dA_cs = torch.cumsum(dA, dim=2)  # inclusive cumsum within chunk

    # -- intra-chunk (quadratic within the chunk, batched products) -----------
    L = torch.exp(_segsum(dA.movedim(-1, 2)))  # [b,nc,h,q,q]
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)  # [b,nc,q,q]
    M = CB[:, :, None] * L * dtc.movedim(-1, 2)[:, :, :, None, :]
    y_intra = torch.einsum("bchij,bcjhp->bcihp", M, xc)

    # -- chunk states ------------------------------------------------------------
    suffix = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)  # decay from t to chunk end
    states = torch.einsum("bcjn,bcjh,bcjhp->bchnp", Bc, dtc * suffix, xc)

    # -- inter-chunk recurrence: the state entering each chunk -------------------
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])  # [b,nc,h]
    carry = torch.zeros((b, h, n, p), dtype=f32, device=x.device) \
        if h0 is None else h0.to(f32)
    entering = []
    for c in range(nc):
        entering.append(carry)
        carry = chunk_decay[:, c, :, None, None] * carry + states[:, c]
    h_prev = torch.stack(entering, dim=1)  # [b,nc,h,n,p]

    y_inter = torch.einsum("bcin,bchnp->bcihp", Cc, h_prev) \
        * torch.exp(dA_cs)[..., None]
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y.to(x.dtype), carry


def ssd_recurrent_step(x, dt, A, Bm, Cm, h):
    """One decode step.  x: [b,h,p], dt: [b,h], Bm/Cm: [b,n], h: [b,h,n,p]."""
    dA = torch.exp(dt * A[None, :])  # [b,h]
    upd = dt[..., None, None] * Bm[:, None, :, None] * x[:, :, None, :]
    h = dA[..., None, None] * h + upd
    y = torch.einsum("bn,bhnp->bhp", Cm, h)
    return y, h


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------
def _split_proj(cfg: ModelConfig, zxbcdt):
    di, ds, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return torch.split(zxbcdt, [di, di + 2 * ds, nh], dim=-1)


def _causal_conv(xBC, w, b, conv_state=None):
    """Depthwise causal conv over time.  xBC: [B,S,C]; w: [k,C].

    ``conv_state``: optional [B, k-1, C] history (decode/prefill continuation).
    Returns (out [B,S,C], new_state [B,k-1,C]).
    """
    k = w.shape[0]
    B, S, C = xBC.shape
    if conv_state is None:
        conv_state = torch.zeros((B, k - 1, C), dtype=xBC.dtype,
                                 device=xBC.device)
    ext = torch.cat([conv_state.to(xBC.dtype), xBC], dim=1)
    w = w.to(xBC.dtype)
    out = ext[:, 0:S, :] * w[0]
    for i in range(1, k):
        out = out + ext[:, i:i + S, :] * w[i]
    out = out + b.to(xBC.dtype)
    new_state = ext[:, -(k - 1):, :] if k > 1 else conv_state
    return F.silu(out), new_state


def ssm_block(p, cfg: ModelConfig, x, state=None):
    """Mamba2 block.  state: optional dict(conv [B,k-1,C], ssm [B,h,n,p]).
    Returns (y, new_state)."""
    di, ds, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    B, S, _ = x.shape
    h = nn.rmsnorm(p["ln"], x)
    z, xBC, dt = _split_proj(cfg, nn.linear(p["in_proj"], h))
    conv_in = None if state is None else state["conv"]
    xBC, conv_state = _causal_conv(xBC, p["conv_w"], p["conv_b"], conv_in)
    xs, Bm, Cm = torch.split(xBC, [di, ds, ds], dim=-1)
    xs = xs.reshape(B, S, nh, hd)
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    h0 = None if state is None else state["ssm"]
    y, ssm_state = ssd_chunked(xs, dt, A, Bm, Cm, min(cfg.ssm_chunk, S), h0=h0)
    y = y + p["D"][None, None, :, None].to(y.dtype) * xs
    y = y.reshape(B, S, di)
    y = nn.rmsnorm(p["gate_norm"], y * F.silu(z))
    out = nn.linear(p["out_proj"], y)
    return x + out, {"conv": conv_state, "ssm": ssm_state}


def ssm_decode_block(p, cfg: ModelConfig, x, state):
    """One-token Mamba2 step.  x: [B,1,d]."""
    di, ds, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    B = x.shape[0]
    f32 = torch.float32
    h = nn.rmsnorm(p["ln"], x)
    z, xBC, dt = _split_proj(cfg, nn.linear(p["in_proj"], h))
    xBC, conv_state = _causal_conv(xBC, p["conv_w"], p["conv_b"],
                                   state["conv"])
    xs, Bm, Cm = torch.split(xBC[:, 0], [di, ds, ds], dim=-1)
    xs = xs.reshape(B, nh, hd).to(f32)
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, ssm_state = ssd_recurrent_step(xs, dt, A, Bm.to(f32), Cm.to(f32),
                                      state["ssm"].to(f32))
    y = y + p["D"][None, :, None] * xs
    y = y.reshape(B, 1, di).to(x.dtype)
    y = nn.rmsnorm(p["gate_norm"], y * F.silu(z))
    return x + nn.linear(p["out_proj"], y), {"conv": conv_state,
                                             "ssm": ssm_state}


def stack_states(states):
    """A list of per-layer state dicts -> one dict stacked on a new leading
    axis (the reference's scan output)."""
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}


def run_layers(stacked_p, cfg: ModelConfig, x, states=None, decode=False):
    """The Mamba2 blocks of a stacked [n, ...] parameter tree in order, each
    with its slice of ``states`` (a stacked state dict, or None).  Returns
    (x, new states stacked on [n])."""
    n = stacked_p["ln"]["scale"].shape[0]
    new = []
    for i in range(n):
        st = None if states is None else dense.take(states, i)
        if decode:
            x, s = ssm_decode_block(dense.take(stacked_p, i), cfg, x, st)
        else:
            x, s = ssm_block(dense.take(stacked_p, i), cfg, x, st)
        new.append(s)
    return x, stack_states(new) if new else empty_states(cfg, x.shape[0], 0,
                                                         x.device)


# ---------------------------------------------------------------------------
# model fns
# ---------------------------------------------------------------------------
def forward(params, cfg: ModelConfig, tokens, *, remat: bool = False):
    """[B,S] -> hidden [B,S,d] (``S % min(ssm_chunk, S) == 0``); ``remat``
    checkpoints each Mamba2 block."""
    x = nn.embed(params["embed"], cfg, tokens)
    body = nn.remat(lambda p, h: ssm_block(p, cfg, h)[0], remat)
    for p in dense.unstack(params["layers"]):
        x = body(p, x)
    return nn.rmsnorm(params["final_norm"], x)


def loss(params, cfg: ModelConfig, batch, *, remat: bool = False):
    x = forward(params, cfg, batch["tokens"], remat=remat)
    lg = nn.logits(params["embed"], cfg, x)
    return nn.cross_entropy(lg, batch["labels"], batch.get("loss_mask"))


def prefill(params, cfg: ModelConfig, tokens, prefix_state=None,
            prefix_len: int = 0):
    """Returns (last logits [B, V] fp32, per-layer state stacked over L).

    ``prefix_state``: optional state snapshot {conv: [L,B,k-1,C], ssm:
    [L,B,h,n,p]}; it replaces prefix recomputation entirely (the SSM
    analogue of prefix-KV reuse).  ``prefix_len`` is unused: the state is
    positionless."""
    x = nn.embed(params["embed"], cfg, tokens)
    x, states = run_layers(params["layers"], cfg, x, prefix_state)
    x = nn.rmsnorm(params["final_norm"], x)
    lg = nn.logits(params["embed"], cfg, x[:, -1:, :])[:, 0, :]
    return lg, states


def decode_step(params, cfg: ModelConfig, cache, token, pos):
    """pos is unused (the state is positionless) but kept for the common
    signature.  Returns (logits [B, V] fp32, new cache)."""
    x = nn.embed(params["embed"], cfg, token)
    x, new_cache = run_layers(params["layers"], cfg, x, cache, decode=True)
    x = nn.rmsnorm(params["final_norm"], x)
    lg = nn.logits(params["embed"], cfg, x)[:, 0, :]
    return lg, new_cache


def empty_states(cfg: ModelConfig, batch: int, n: int, device):
    """Zero states of ``n`` Mamba2 layers: conv in the compute dtype, ssm in
    fp32."""
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros((n, batch, cfg.ssm_conv - 1, conv_dim),
                            dtype=nn.dt(cfg), device=device),
        "ssm": torch.zeros((n, batch, cfg.ssm_heads, cfg.ssm_state,
                            cfg.ssm_headdim), dtype=torch.float32,
                           device=device),
    }


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device):
    """The SSM cache is O(1) in sequence length."""
    return empty_states(cfg, batch, cfg.num_layers, device)
