"""Random weights for a configuration, made on the device from the run's
seed: one ``normal_`` call per stacked leaf, in the type they are served in.

The tree has the program's parameter layout (layers stacked on a leading
[L]); the same tensors go to the program and to the reference.
"""
from __future__ import annotations

import torch

from ocbench.counts import is_moe

VOCAB_PAD = 256  # the program pads its tables to a multiple of 256 rows

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype(cfg: dict) -> torch.dtype:
    return _DTYPES[cfg["torch_dtype"]]


def padded_vocab(cfg: dict) -> int:
    return -(-cfg["vocab_size"] // VOCAB_PAD) * VOCAB_PAD


def shapes(cfg: dict) -> dict:
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


def make(cfg: dict, seed: int, device) -> dict:
    """The weights of ``cfg`` from ``seed``, drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        shape, dt, mean, std = node
        return torch.empty(shape, dtype=dt, device=device).normal_(
            mean, std, generator=gen)
    return fill(shapes(cfg))


def same_layout(tree, spec) -> list[str]:
    """Where ``tree`` differs from ``spec`` (the program's own parameter
    tree on the meta device) in keys, shapes or dtypes."""
    if isinstance(spec, dict):
        if not isinstance(tree, dict) or set(tree) != set(spec):
            return [f"keys {sorted(tree) if isinstance(tree, dict) else tree}"
                    f" != {sorted(spec)}"]
        return [f"{k}/{e}" for k in spec for e in same_layout(tree[k], spec[k])]
    if tree.shape != spec.shape or tree.dtype != spec.dtype:
        return [f"{tuple(tree.shape)} {tree.dtype} != "
                f"{tuple(spec.shape)} {spec.dtype}"]
    return []
