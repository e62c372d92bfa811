"""Plain PyTorch reference of DeepSeek-V2 (``DeepseekV2ForCausalLM``), fp32.

Follows ``modeling_deepseek.py`` of the DeepSeek-V2 model repository:
pre-norm RMSNorm blocks; multi-head latent attention without
``q_lora_rank`` (q_proj to heads of qk_nope + qk_rope; kv_a_proj_with_mqa
to c_kv and one shared k_pe; kv_a_layernorm on c_kv; kv_b_proj to each
head's k_nope and v; o_proj); RoPE on the rope dims after de-interleaving
their pairs, rotate-half, at ``DeepseekV2YarnRotaryEmbedding``'s
frequencies and cos/sin factor; causal softmax at (qk_nope +
qk_rope)^-0.5 times yarn_get_mscale(factor, mscale_all_dim) squared; a
SwiGLU MLP in the first ``first_k_dense_replace`` layers, then
``DeepseekV2MoE``: a softmax router in fp32, greedy top-k, the top-k
weights renormalised only with ``norm_topk_prob``, else times
``routed_scaling_factor``, the routed experts' weighted sum plus the shared
experts (one SwiGLU MLP of ``n_shared_experts`` x the expert width); a final
RMSNorm and untied output logits.  It reads the configuration's dict and
the benchmark's weight tree and imports nothing of the program.

Departures from DeepSeek's code:
- every tensor is fp32 and every matrix product runs in fp32 with TF32 off
  (the published model computes in bf16);
- weights are the benchmark's tree ([d_in, d_out] matrices, layers stacked,
  the leading dense layers under ``dense`` and the MoE layers under
  ``moe``), not the checkpoint's module names;
- no KV cache and no batching: it runs layer by layer over prompt groups (a
  shared prefix and the suffixes that follow it), each prefix computed once
  a layer; the prefix's latent (c_kv after its norm, k_pe after RoPE) passes
  through the configuration's codec (`codec`) before the suffixes attend to
  it, as the fetched prefix does in the served system; attention runs in
  query blocks and every key's latent is up-projected through kv_b_proj
  (the form DeepSeek's code writes);
- the routed experts run one expert at a time over the tokens routed to it
  (``moe_infer``'s order), with an ``index_add_`` combine;
- the RMSNorm multiplies its scale in fp32 (DeepSeek's casts the normed
  input to the input dtype first, which is fp32 here too);
- ``fp8=True`` is the control: every matrix product's operands rounded to
  float8 e4m3, the router's included, as in `qwen3.py`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .codec import round_trip
from .qwen3 import ATTN_BLOCK, ROW_BLOCK, Logits, fp8_round, mm, rmsnorm

__all__ = ["forward", "Logits"]


def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_inv_freq(cfg: dict) -> tuple[torch.Tensor, float]:
    """``DeepseekV2YarnRotaryEmbedding``'s inverse frequencies [dim / 2] and
    its cos/sin factor."""
    rs = cfg["rope_scaling"]
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    factor, orig = rs["factor"], rs["original_max_position_embeddings"]

    def correction_dim(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) \
            / (2 * math.log(base))
    low = max(math.floor(correction_dim(rs["beta_fast"])), 0)
    high = min(math.ceil(correction_dim(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    freq_extra = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float32)
                                / dim)
    freq_inter = 1.0 / (factor * base ** (
        torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    mask = 1.0 - ramp
    inv_freq = freq_inter * (1 - mask) + freq_extra * mask
    return inv_freq, yarn_mscale(factor, rs["mscale"]) \
        / yarn_mscale(factor, rs["mscale_all_dim"])


def softmax_scale(cfg: dict) -> float:
    rs = cfg["rope_scaling"]
    m = yarn_mscale(rs["factor"], rs["mscale_all_dim"])
    return (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5 * m * m


def rope(x, pos, cfg):
    """x [S, n, d] at absolute positions ``pos`` [S]: pairs de-interleaved,
    then rotate-half at YaRN's frequencies."""
    S, n, d = x.shape
    x = x.view(S, n, d // 2, 2).transpose(-1, -2).reshape(S, n, d)
    inv_freq, scale = yarn_inv_freq(cfg)
    freqs = torch.outer(pos.float(), inv_freq.to(x.device))
    emb = torch.cat([freqs, freqs], dim=-1)
    cos = (emb.cos() * scale)[:, None]
    sin = (emb.sin() * scale)[:, None]
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rot * sin


def attention(q, k, v, offset: int, scale: float, fp8: bool):
    """Causal attention of q [Sq, H, dq] over k [Sk, H, dq], v [Sk, H, dv],
    query i at absolute position ``offset + i`` seeing keys 0..offset+i."""
    Sq, H, _ = q.shape
    Sk = k.shape[0]
    kt, vt = k.permute(1, 2, 0), v.permute(1, 0, 2)  # [H,dq,Sk], [H,Sk,dv]
    keys = torch.arange(Sk, device=q.device)
    out = []
    for i0 in range(0, Sq, ATTN_BLOCK):
        qb = q[i0:i0 + ATTN_BLOCK].permute(1, 0, 2)  # [H, b, dq]
        b = qb.shape[1]
        s = mm(qb, kt, fp8) * scale
        rows = offset + i0 + torch.arange(b, device=q.device)
        s = s.masked_fill(keys[None, :] > rows[:, None], float("-inf"))
        o = mm(torch.softmax(s, dim=-1), vt, fp8)  # [H, b, dv]
        out.append(o.permute(1, 0, 2).reshape(b, -1))
    return torch.cat(out)


class Layer:
    """Layer ``l``'s weights in fp32 (in fp8 mode rounded per output column
    once), and its two halves."""

    def __init__(self, params, cfg: dict, l: int, fp8: bool):
        self.cfg, self.fp8 = cfg, fp8
        k = cfg["first_k_dense_replace"]
        part, i = ("dense", l) if l < k else ("moe", l - k)
        p = params["layers"][part]

        def w(t):
            t = t[i].float()
            return fp8_round(t, -2) if fp8 else t
        a = p["attn"]
        self.ln1, self.ln2 = p["ln1"]["scale"][i].float(), \
            p["ln2"]["scale"][i].float()
        self.kv_norm = a["kv_norm"]["scale"][i].float()
        self.wq, self.wkv_a, self.wkv_b, self.wo = (
            w(a[n]["w"]) for n in ("wq", "wkv_a", "wkv_b", "wo"))
        if part == "moe":
            m = p["moe"]
            self.router = w(m["router"])
            self.wg, self.wu, self.wd = (w(m[n]) for n in
                                         ("wi_gate", "wi_up", "wo"))
            m = m["shared"]
        else:
            m = p["mlp"]
        self.mg, self.mu, self.md = (w(m[n]["w"]) for n in
                                     ("wi_gate", "wi_up", "wo"))

    def _act(self, x, w):  # activation x rounded per row, weight already
        return (fp8_round(x, -1) if self.fp8 else x) @ w

    def latent(self, h, start: int):
        """Normed input h [S, d] -> its latent [S, kv_lora_rank + rope]."""
        cfg = self.cfg
        r = cfg["kv_lora_rank"]
        ckv = self._act(h, self.wkv_a)
        c = rmsnorm(ckv[:, :r], self.kv_norm, cfg["rms_norm_eps"])
        pos = start + torch.arange(h.shape[0], device=h.device)
        k_pe = rope(ckv[:, None, r:], pos, cfg)[:, 0]
        return torch.cat([c, k_pe], dim=-1)

    def expand(self, lat):
        """latent [S, r + rope] -> k [S, H, nope + rope], v [S, H, v]."""
        cfg = self.cfg
        S = lat.shape[0]
        H, r, dn = (cfg["num_attention_heads"], cfg["kv_lora_rank"],
                    cfg["qk_nope_head_dim"])
        kv = self._act(lat[:, :r], self.wkv_b).view(S, H, -1)
        k_pe = lat[:, None, r:].expand(S, H, cfg["qk_rope_head_dim"])
        return torch.cat([kv[..., :dn], k_pe], dim=-1), kv[..., dn:]

    def attn(self, x, start: int, prefix_lat=None):
        """x [S, d] at positions start..start+S-1 over an optional prefix
        latent; returns (x + attention, this segment's latent)."""
        cfg = self.cfg
        S = x.shape[0]
        H, dn = cfg["num_attention_heads"], cfg["qk_nope_head_dim"]
        h = rmsnorm(x, self.ln1, cfg["rms_norm_eps"])
        q = self._act(h, self.wq).view(S, H, -1)
        pos = start + torch.arange(S, device=x.device)
        q = torch.cat([q[..., :dn], rope(q[..., dn:], pos, cfg)], dim=-1)
        lat = self.latent(h, start)
        keys = lat if prefix_lat is None else torch.cat([prefix_lat, lat])
        k, v = self.expand(keys)
        o = attention(q, k, v, keys.shape[0] - S, softmax_scale(cfg),
                      self.fp8)
        return x + self._act(o, self.wo), lat

    def ffn(self, x):
        h = rmsnorm(x, self.ln2, self.cfg["rms_norm_eps"])
        y = self._mlp(h, self.mg, self.mu, self.md)
        if hasattr(self, "router"):
            y = y + self._moe(h)
        return x + y

    def _mlp(self, h, wg, wu, wd):
        return self._act(F.silu(self._act(h, wg)) * self._act(h, wu), wd)

    def _moe(self, h):
        cfg = self.cfg
        k = cfg["num_experts_per_tok"]
        probs = torch.softmax(self._act(h, self.router), dim=-1)
        topw, topi = torch.topk(probs, k, dim=-1)
        if cfg["norm_topk_prob"]:
            topw = topw / topw.sum(-1, keepdim=True)
        else:
            topw = topw * cfg["routed_scaling_factor"]
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
            out = self._mlp(h[rows], self.wg[e], self.wu[e], self.wd[e])
            y.index_add_(0, rows, out * wts[start:start + n, None])
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
    width = cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]

    def emb(t):
        return table[torch.as_tensor(t, device=dev)].float()
    xp = [emb(p) for p, _ in groups]
    xs = [[emb(s) for s in sufs] for _, sufs in groups]
    for l in range(cfg["num_hidden_layers"]):
        W = Layer(params, cfg, l, fp8)
        for g, (ptok, sufs) in enumerate(groups):
            P = len(ptok)
            lat = None
            if P:
                xp[g], lat = W.attn(xp[g], 0)
                lat = round_trip(cfg["codec"], lat.view(P, 1, width),
                                 cfg["chunk_tokens"]).view(P, width)
            for i in range(len(sufs)):
                xs[g][i] = W.attn(xs[g][i], P, lat)[0]
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
