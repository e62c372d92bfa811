"""The Qwen3 decoders, dense and MoE: grouped-query attention with a per-head
RMSNorm of queries and keys, and a SwiGLU MLP or a softmax router over
experts with no shared expert."""
from __future__ import annotations

import dataclasses

import torch

from ocbench.weights import dtype, padded_vocab

ARCHITECTURES = ("Qwen3ForCausalLM", "Qwen3MoeForCausalLM")
REFERENCE = "qwen3"


def is_moe(cfg: dict) -> bool:
    return cfg.get("num_experts", 0) > 0


def kv_width(cfg: dict) -> int:
    return cfg["num_key_value_heads"] * cfg["head_dim"]


def program_config(cfg: dict):
    """The program's ``ModelConfig`` of a configuration file: the registry
    entry ``arch`` with every size the file gives."""
    from repro_torch.configs import get_config
    if cfg["rms_norm_eps"] != 1e-6 or not cfg.get("norm_topk_prob", True):
        raise ValueError("the program's RMSNorm takes eps 1e-6 and its "
                         "router renormalises the top-k weights")
    sizes = dict(num_layers=cfg["num_hidden_layers"],
                 d_model=cfg["hidden_size"],
                 num_heads=cfg["num_attention_heads"],
                 num_kv_heads=cfg["num_key_value_heads"],
                 head_dim=cfg["head_dim"], vocab_size=cfg["vocab_size"],
                 rope_theta=cfg["rope_theta"], qk_norm=True,
                 tie_embeddings=cfg["tie_word_embeddings"],
                 param_dtype=cfg["torch_dtype"],
                 compute_dtype=cfg["torch_dtype"])
    if is_moe(cfg):
        sizes.update(d_ff=0, num_experts=cfg["num_experts"],
                     experts_per_token=cfg["num_experts_per_tok"],
                     moe_d_ff=cfg["moe_intermediate_size"], moe_every=1)
    else:
        sizes.update(d_ff=cfg["intermediate_size"])
    return dataclasses.replace(get_config(cfg["arch"]), **sizes)


def weight_shapes(cfg: dict) -> dict:
    """The tree of (shape, dtype, mean, std) the weights are drawn from."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    H, KV, dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    dt = dtype(cfg)

    def mat(*shape, dtype=dt):  # N(0, 1/d_in), d_in the next-to-last dim
        return (shape, dtype, 0.0, shape[-2] ** -0.5)

    def norm(*shape):
        return (shape, dt, 1.0, 0.1)

    Vp = padded_vocab(cfg)
    layers = {
        "ln1": {"scale": norm(L, d)},
        "attn": {"wq": {"w": mat(L, d, H * dh)},
                 "wk": {"w": mat(L, d, KV * dh)},
                 "wv": {"w": mat(L, d, KV * dh)},
                 "wo": {"w": mat(L, H * dh, d)},
                 "q_norm": {"scale": norm(L, dh)},
                 "k_norm": {"scale": norm(L, dh)}},
        "ln2": {"scale": norm(L, d)},
    }
    if is_moe(cfg):
        E, f = cfg["num_experts"], cfg["moe_intermediate_size"]
        layers["moe"] = {"router": mat(L, d, E, dtype=torch.float32),
                         "wi_gate": mat(L, E, d, f), "wi_up": mat(L, E, d, f),
                         "wo": mat(L, E, f, d)}
    else:
        ff = cfg["intermediate_size"]
        layers["mlp"] = {"wi_gate": {"w": mat(L, d, ff)},
                         "wi_up": {"w": mat(L, d, ff)},
                         "wo": {"w": mat(L, ff, d)}}
    embed = {"table": ((Vp, d), dt, 0.0, 0.02)}
    if not cfg["tie_word_embeddings"]:
        embed["unembed"] = ((Vp, d), dt, 0.0, 0.02)
    return {"embed": embed, "layers": layers,
            "final_norm": {"scale": norm(d)}}


def attn_params(cfg: dict) -> int:
    d, H, KV, dh = (cfg["hidden_size"], cfg["num_attention_heads"],
                    cfg["num_key_value_heads"], cfg["head_dim"])
    return 2 * d * H * dh + 2 * d * KV * dh


def active_nonembed_params(cfg: dict) -> int:
    """Matrix parameters one token multiplies by, embedding and unembedding
    left out: attention, and the dense MLP or the router and the experts it
    picks."""
    d = cfg["hidden_size"]
    if is_moe(cfg):
        mlp = d * cfg["num_experts"] + cfg["num_experts_per_tok"] * 3 * d \
            * cfg["moe_intermediate_size"]
    else:
        mlp = 3 * d * cfg["intermediate_size"]
    return cfg["num_hidden_layers"] * (attn_params(cfg) + mlp)


def prefill_flops(cfg: dict, prefix_len: int, computed: int) -> float:
    """Useful FLOPs of a prefill that computes ``computed`` tokens after a
    reused prefix of ``prefix_len``: the matrix products of each computed
    token, causal attention (scores and values) of each over the prefix and
    the computed tokens before it, and the last token's logits."""
    H, dh, L = (cfg["num_attention_heads"], cfg["head_dim"],
                cfg["num_hidden_layers"])
    S, P = computed, prefix_len
    keys = S * P + S * (S + 1) // 2  # keys each computed query sees
    return (2.0 * active_nonembed_params(cfg) * S + 4.0 * H * dh * L * keys
            + 2.0 * cfg["hidden_size"] * cfg["vocab_size"])


def kv_tensors(cfg: dict) -> tuple[int, list[int]]:
    """Every layer stores K and V, each ``num_key_value_heads * head_dim``
    wide a token."""
    return cfg["num_hidden_layers"], [kv_width(cfg), kv_width(cfg)]
