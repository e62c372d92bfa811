"""DeepSeek-V2 (``DeepseekV2ForCausalLM``): multi-head latent attention
with YaRN rotary embeddings, ``first_k_dense_replace`` dense layers, then
MoE layers of routed experts (softmax router, greedy top-k) and shared
experts.  A layer caches one latent a token: c_kv and the shared k_pe."""
from __future__ import annotations

import dataclasses

import torch

from ocbench.weights import dtype, padded_vocab

ARCHITECTURES = ("DeepseekV2ForCausalLM",)
REFERENCE = "deepseek_v2"

# what the program's MLA and router implement; another value is refused
SUPPORTED = {"q_lora_rank": None, "topk_method": "greedy",
             "scoring_func": "softmax", "n_group": 1, "topk_group": 1,
             "moe_layer_freq": 1, "hidden_act": "silu",
             "attention_bias": False, "rms_norm_eps": 1e-6}


def _sizes(cfg: dict) -> tuple:
    return (cfg["hidden_size"], cfg["num_hidden_layers"],
            cfg["num_attention_heads"], cfg["kv_lora_rank"],
            cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
            cfg["v_head_dim"])


def program_config(cfg: dict):
    """The program's `MLAConfig` of a configuration file: the registry
    entry ``arch`` with every size the file gives."""
    from repro_torch.configs import get_config
    wrong = {k: cfg.get(k) for k, v in SUPPORTED.items() if cfg.get(k) != v}
    rs = cfg["rope_scaling"]
    if wrong or rs.get("type", rs.get("rope_type")) != "yarn":
        raise ValueError(f"the program implements {SUPPORTED} and YaRN; "
                         f"the configuration has {wrong}, {rs}")
    d, L, H, r, dn, dr, dv = _sizes(cfg)
    return dataclasses.replace(
        get_config(cfg["arch"]), num_layers=L, d_model=d, num_heads=H,
        num_kv_heads=cfg["num_key_value_heads"], head_dim=dn + dr,
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        rope_theta=float(cfg["rope_theta"]),
        tie_embeddings=cfg["tie_word_embeddings"],
        num_experts=cfg["n_routed_experts"],
        experts_per_token=cfg["num_experts_per_tok"],
        moe_d_ff=cfg["moe_intermediate_size"],
        shared_expert_d_ff=cfg["n_shared_experts"]
        * cfg["moe_intermediate_size"],
        kv_lora_rank=r, qk_nope_head_dim=dn, qk_rope_head_dim=dr,
        v_head_dim=dv, first_dense_layers=cfg["first_k_dense_replace"],
        norm_topk_prob=cfg["norm_topk_prob"],
        routed_scaling_factor=float(cfg["routed_scaling_factor"]),
        rope_factor=float(rs["factor"]),
        rope_original_max=rs["original_max_position_embeddings"],
        rope_beta_fast=float(rs["beta_fast"]),
        rope_beta_slow=float(rs["beta_slow"]),
        rope_mscale=float(rs["mscale"]),
        rope_mscale_all_dim=float(rs["mscale_all_dim"]),
        param_dtype=cfg["torch_dtype"], compute_dtype=cfg["torch_dtype"])


def weight_shapes(cfg: dict) -> dict:
    """The tree of (shape, dtype, mean, std) the weights are drawn from, in
    the program's order: the embeddings, the leading dense layers, the MoE
    layers, the final norm."""
    d, L, H, r, dn, dr, dv = _sizes(cfg)
    k = cfg["first_k_dense_replace"]
    dt = dtype(cfg)

    def mat(*shape, dtype=dt):  # N(0, 1/d_in), d_in the next-to-last dim
        return (shape, dtype, 0.0, shape[-2] ** -0.5)

    def norm(*shape):
        return (shape, dt, 1.0, 0.1)

    def swiglu(n, ff):
        return {"wi_gate": {"w": mat(n, d, ff)}, "wi_up": {"w": mat(n, d, ff)},
                "wo": {"w": mat(n, ff, d)}}

    def layers(n, ffn):
        return {"ln1": {"scale": norm(n, d)},
                "attn": {"wq": {"w": mat(n, d, H * (dn + dr))},
                         "wkv_a": {"w": mat(n, d, r + dr)},
                         "kv_norm": {"scale": norm(n, r)},
                         "wkv_b": {"w": mat(n, r, H * (dn + dv))},
                         "wo": {"w": mat(n, H * dv, d)}},
                "ln2": {"scale": norm(n, d)}, **ffn}

    E, f = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    moe = {"router": mat(L - k, d, E, dtype=torch.float32),
           "wi_gate": mat(L - k, E, d, f), "wi_up": mat(L - k, E, d, f),
           "wo": mat(L - k, E, f, d),
           "shared": swiglu(L - k, cfg["n_shared_experts"] * f)}
    Vp = padded_vocab(cfg)
    embed = {"table": ((Vp, d), dt, 0.0, 0.02)}
    if not cfg["tie_word_embeddings"]:
        embed["unembed"] = ((Vp, d), dt, 0.0, 0.02)
    return {"embed": embed,
            "layers": {"dense": layers(k, {"mlp": swiglu(
                k, cfg["intermediate_size"])}),
                "moe": layers(L - k, {"moe": moe})},
            "final_norm": {"scale": norm(d)}}


def attn_params(cfg: dict) -> int:
    d, L, H, r, dn, dr, dv = _sizes(cfg)
    return d * H * (dn + dr) + d * (r + dr) + r * H * (dn + dv) + H * dv * d


def active_nonembed_params(cfg: dict) -> int:
    """Matrix parameters one token multiplies by, embedding and unembedding
    left out: attention (q, kv_a, kv_b, o), and the dense MLP or the router,
    the experts it picks and the shared experts."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    k, f = cfg["first_k_dense_replace"], cfg["moe_intermediate_size"]
    moe = d * cfg["n_routed_experts"] + 3 * d * f * (
        cfg["num_experts_per_tok"] + cfg["n_shared_experts"])
    return L * attn_params(cfg) + k * 3 * d * cfg["intermediate_size"] \
        + (L - k) * moe


def prefill_flops(cfg: dict, prefix_len: int, computed: int) -> float:
    """Useful FLOPs of a prefill that computes ``computed`` tokens after a
    reused prefix of ``prefix_len``: the matrix products of each computed
    token, causal attention (scores over qk_nope + qk_rope, values over
    v_head_dim, each head) of each over the prefix and the computed tokens
    before it, and the last token's logits.  The prefix latent's
    up-projection is not counted: an absorbed implementation does without
    it, so the count is the same whatever implements it."""
    d, L, H, r, dn, dr, dv = _sizes(cfg)
    S, P = computed, prefix_len
    keys = S * P + S * (S + 1) // 2  # keys each computed query sees
    return (2.0 * active_nonembed_params(cfg) * S
            + 2.0 * H * (dn + dr + dv) * L * keys
            + 2.0 * d * cfg["vocab_size"])


def kv_tensors(cfg: dict) -> tuple[int, list[int]]:
    """Every layer stores one latent, ``kv_lora_rank + qk_rope_head_dim``
    wide a token."""
    return cfg["num_hidden_layers"], [cfg["kv_lora_rank"]
                                      + cfg["qk_rope_head_dim"]]
