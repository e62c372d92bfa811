"""Smoke-size cells for the CPU tests: the two configurations at the
registry's smoke widths (fp32, a few layers), with traffic of the same
shape at a few dozen tokens."""
from __future__ import annotations

import copy

from ocbench.harness import Cell

DENSE = {
    "name": "qwen3-14b.smoke", "arch": "qwen3-14b",
    "architectures": ["Qwen3ForCausalLM"], "hidden_size": 96,
    "num_hidden_layers": 3, "num_attention_heads": 6,
    "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 192,
    "vocab_size": 256, "rope_theta": 1000000.0, "rms_norm_eps": 1e-06,
    "tie_word_embeddings": False, "torch_dtype": "float32", "codec": "int8",
    "kv_resident": "packed", "chunk_tokens": 16, "link_gbps": 100}
MOE = {
    "name": "qwen3-30b-a3b.smoke", "arch": "qwen3-moe-30b-a3b",
    "architectures": ["Qwen3MoeForCausalLM"],
    "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 0,
    "moe_intermediate_size": 32, "num_experts": 8, "num_experts_per_tok": 2,
    "norm_topk_prob": True, "vocab_size": 256, "rope_theta": 1000000.0,
    "rms_norm_eps": 1e-06, "tie_word_embeddings": False,
    "torch_dtype": "float32", "codec": "identity", "kv_resident": "fp",
    "chunk_tokens": 16, "link_gbps": 100}
SHARED = {"name": "shared.smoke", "prefixes": 4, "prefix_tokens": [32, 96],
          "prefix_multiple": 16, "prefix_alpha": 1.0,
          "suffix_tokens": [16, 40], "rate_rps": 6.0, "schedule_seed": 3,
          "check_tokens": 600}
UNSHARED = {"name": "unshared.smoke", "prefixes": 0, "prefix_alpha": 1.0,
            "suffix_tokens": [8, 64], "rate_rps": 6.0, "schedule_seed": 3,
            "check_tokens": 600}
METRICS = ["served_tok_s", "setup_s", "layer_compute_ms", "commit_ms",
           "prefill_mfu_pct", "device_idle_pct"]
PER_LAYER = METRICS[2:]
# fp32 smoke models against the fp32 reference
LIMITS = {"logit_rel_err": 1e-4, "logit_gap": 1e-3}


def cell(config: dict, mix: dict) -> Cell:
    metrics = [{"name": n, "unit": "", "kind": "per_layer" if n in PER_LAYER
                else "end_to_end"} for n in METRICS]
    return Cell(f"{config['name']}.{mix['name']}", 1, copy.deepcopy(config),
                copy.deepcopy(mix), dict(LIMITS), metrics)
