"""Plain PyTorch reference of the Qwen3 decoders, dense and MoE, in fp32.

Follows the published architecture (Hugging Face ``Qwen3ForCausalLM`` /
``Qwen3MoeForCausalLM``): pre-norm RMSNorm blocks, per-head RMSNorm of
queries and keys before RoPE (split halves), grouped-query causal attention,
a SwiGLU MLP or a softmax router over the experts with the top-k weights
renormalised, a final RMSNorm and untied output logits.  It reads the
configuration's dict and the benchmark's weight tree and imports nothing of
the program.

It runs layer by layer over a set of prompt groups: a group is one shared
prefix and the suffixes that follow it.  Each prefix is computed once per
layer; its K and V pass through the configuration's codec (`codec`) before
the suffixes attend to them, as the fetched prefix does in the served
system; each suffix attends causally to the prefix and to itself.  Every
matrix product runs in fp32 with TF32 off, attention in query blocks.

``fp8=True`` is the control: every matrix product's operands rounded to
float8 e4m3 (one scale per row of the left operand and per column of the
right, as an fp8 GEMM takes them) and multiplied with fp32 accumulation.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .codec import round_trip

ATTN_BLOCK = 1024  # query rows per attention block
ROW_BLOCK = 8192  # rows per block of the MLP and of the logits
FP8_MAX = 448.0  # largest float8 e4m3 value


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``,
    back in fp32."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def mm(a, b, fp8: bool):
    """a @ b in fp32; with ``fp8`` both operands rounded first (a per row,
    b per column)."""
    if fp8:
        a, b = fp8_round(a, -1), fp8_round(b, -2)
    return a @ b


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, pos, theta):
    """x [S, n, dh] at absolute positions ``pos`` [S]: split halves."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, offset: int, fp8: bool):
    """Causal attention of q [Sq, H, dh] over k, v [Sk, KV, dh], query i at
    absolute position ``offset + i`` seeing keys 0..offset+i."""
    Sq, H, dh = q.shape
    Sk, KV, _ = k.shape
    rep = H // KV
    kt = k.permute(1, 2, 0)[:, None]  # [KV, 1, dh, Sk]
    vt = v.permute(1, 0, 2)[:, None]  # [KV, 1, Sk, dh]
    keys = torch.arange(Sk, device=q.device)
    out = []
    for i0 in range(0, Sq, ATTN_BLOCK):
        qb = q[i0:i0 + ATTN_BLOCK]
        b = qb.shape[0]
        qg = qb.reshape(b, KV, rep, dh).permute(1, 2, 0, 3)  # [KV,rep,b,dh]
        s = mm(qg, kt, fp8) / math.sqrt(dh)
        rows = offset + i0 + torch.arange(b, device=q.device)
        s = s.masked_fill(keys[None, :] > rows[:, None], float("-inf"))
        o = mm(torch.softmax(s, dim=-1), vt, fp8)  # [KV, rep, b, dh]
        out.append(o.permute(2, 0, 1, 3).reshape(b, H * dh))
    return torch.cat(out)


class Layer:
    """Layer ``l``'s weights in fp32 (in fp8 mode rounded per output column
    once), and its two halves."""

    def __init__(self, params, cfg: dict, l: int, fp8: bool):
        self.cfg, self.fp8 = cfg, fp8
        p = params["layers"]

        def w(t):
            t = t[l].float()
            return fp8_round(t, -2) if fp8 else t
        a = p["attn"]
        self.ln1, self.ln2 = p["ln1"]["scale"][l].float(), \
            p["ln2"]["scale"][l].float()
        self.q_norm = a["q_norm"]["scale"][l].float()
        self.k_norm = a["k_norm"]["scale"][l].float()
        self.wq, self.wk, self.wv, self.wo = (w(a[n]["w"]) for n in
                                              ("wq", "wk", "wv", "wo"))
        if "moe" in p:
            m = p["moe"]
            self.router = w(m["router"])
            self.wg, self.wu, self.wd = (w(m[n]) for n in
                                         ("wi_gate", "wi_up", "wo"))
        else:
            m = p["mlp"]
            self.wg, self.wu, self.wd = (w(m[n]["w"]) for n in
                                         ("wi_gate", "wi_up", "wo"))

    def _act(self, x, w):  # activation x rounded per row, weight already
        return (fp8_round(x, -1) if self.fp8 else x) @ w

    def attn(self, x, start: int, prefix_kv=None):
        """x [S, d] at positions start..start+S-1 over an optional prefix
        (k, v); returns (x + attention, k, v of this segment)."""
        cfg = self.cfg
        S = x.shape[0]
        H, KV, dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                     cfg["head_dim"])
        eps = cfg["rms_norm_eps"]
        h = rmsnorm(x, self.ln1, eps)
        q = rmsnorm(self._act(h, self.wq).view(S, H, dh), self.q_norm, eps)
        k = rmsnorm(self._act(h, self.wk).view(S, KV, dh), self.k_norm, eps)
        v = self._act(h, self.wv).view(S, KV, dh)
        pos = start + torch.arange(S, device=x.device)
        q, k = rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"])
        kk, vv = k, v
        if prefix_kv is not None:
            kk = torch.cat([prefix_kv[0], k])
            vv = torch.cat([prefix_kv[1], v])
        o = attention(q, kk, vv, kk.shape[0] - S, self.fp8)
        return x + self._act(o, self.wo), k, v

    def ffn(self, x):
        h = rmsnorm(x, self.ln2, self.cfg["rms_norm_eps"])
        if hasattr(self, "router"):
            return x + self._moe(h)
        g = F.silu(self._act(h, self.wg)) * self._act(h, self.wu)
        return x + self._act(g, self.wd)

    def _moe(self, h):
        k = self.cfg["num_experts_per_tok"]
        probs = torch.softmax(self._act(h, self.router), dim=-1)
        topw, topi = torch.topk(probs, k, dim=-1)
        if self.cfg.get("norm_topk_prob", True):
            topw = topw / topw.sum(-1, keepdim=True)
        flat = topi.reshape(-1)
        order = torch.argsort(flat, stable=True)
        counts = torch.bincount(flat, minlength=self.wg.shape[0]).tolist()
        tok, wts = order // k, topw.reshape(-1)[order]
        y = torch.zeros_like(h)
        start = 0
        for e, n in enumerate(counts):
            if n == 0:
                continue
            rows = tok[start:start + n]
            xe = h[rows]
            g = F.silu(self._act(xe, self.wg[e])) * self._act(xe, self.wu[e])
            y.index_add_(0, rows, self._act(g, self.wd[e])
                         * wts[start:start + n, None])
            start += n
        return y


def forward(params, cfg: dict, groups, *, fp8: bool = False):
    """Final normed hidden states of every prompt in ``groups`` (a list of
    (prefix tokens [P], [suffix tokens [S_i], ...]); P may be 0).

    Returns, per group, (None, [each suffix's last row [1, d]])."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    table = params["embed"]["table"]
    dev = table.device

    def emb(t):
        return table[torch.as_tensor(t, device=dev)].float()
    xp = [emb(p) for p, _ in groups]
    xs = [[emb(s) for s in sufs] for _, sufs in groups]
    for l in range(cfg["num_hidden_layers"]):
        W = Layer(params, cfg, l, fp8)
        for g, (ptok, sufs) in enumerate(groups):
            P = len(ptok)
            pkv = None
            if P:
                xp[g], k, v = W.attn(xp[g], 0)
                pkv = (round_trip(cfg["codec"], k, cfg["chunk_tokens"]),
                       round_trip(cfg["codec"], v, cfg["chunk_tokens"]))
            for i in range(len(sufs)):
                xs[g][i] = W.attn(xs[g][i], P, pkv)[0]
        parts = [x for x in xp] + [x for row in xs for x in row]
        sizes = [x.shape[0] for x in parts]
        full = torch.cat(parts)
        full = torch.cat([W.ffn(full[i:i + ROW_BLOCK])
                          for i in range(0, full.shape[0], ROW_BLOCK)])
        it = iter(torch.split(full, sizes))
        xp = [next(it) for _ in xp]
        xs = [[next(it) for _ in row] for row in xs]
        del W
    scale, eps = params["final_norm"]["scale"].float(), cfg["rms_norm_eps"]
    return [(None, [rmsnorm(x[-1:], scale, eps) for x in xs[g]])
            for g in range(len(groups))]


class Logits:
    """fp32 logits over the real vocabulary (the unembedding's first
    ``vocab_size`` rows)."""

    def __init__(self, params, cfg: dict, fp8: bool = False):
        emb = params["embed"]
        table = emb.get("unembed", emb["table"])[:cfg["vocab_size"]]
        self.w = table.float().t()  # [d, V]
        if fp8:
            self.w = fp8_round(self.w, -2)
        self.fp8 = fp8

    def __call__(self, h):
        if self.fp8:
            h = fp8_round(h, -1)
        return h @ self.w

