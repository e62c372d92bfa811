"""The yardstick's arithmetic: FLOPs from shapes, wire sizes, and the frozen
bf16 peak of one NVIDIA H100 SXM (data sheet, dense, 700 W).

Every function reads a configuration file's dict (``configs/<name>.json``,
Hugging Face keys), never the program's objects.
"""
from __future__ import annotations

H100_BF16_FLOPS = 989e12


def is_moe(cfg: dict) -> bool:
    return cfg.get("num_experts", 0) > 0


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


def kv_width(cfg: dict) -> int:
    return cfg["num_key_value_heads"] * cfg["head_dim"]


def wire_chunk_bytes(cfg: dict) -> int:
    """Bytes of one stored chunk object (all layers) under the config's
    codec: bf16 K and V for identity; int8 codes plus one fp16 scale per
    channel of K and of V for int8."""
    G, W, L = cfg["chunk_tokens"], kv_width(cfg), cfg["num_hidden_layers"]
    if cfg["codec"] == "identity":
        per_layer = 2 * G * W * 2
    elif cfg["codec"] == "int8":
        per_layer = 2 * W * 2 + 2 * G * W
    else:
        raise ValueError(f"no wire size for codec {cfg['codec']!r}")
    return L * per_layer

