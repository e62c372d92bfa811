"""The DeepSeek-V2 architecture module, its reference and its cell, on the
CPU: the configuration resolves to ``archs/deepseek_v2.py``; its weight tree
is the program's at the smoke size and holds the published parameter count
at full size; its wire chunk is the program's `KVSpec`'s; its FLOPs match
two counts by hand; the reference agrees with transformers'
``DeepseekV2ForCausalLM``; a smoke cell is correct and reads its two new
per-layer metrics."""
import copy
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from ocbench import archs, counts, harness, weights
from ocbench.archs import deepseek_v2 as arch
from ocbench.harness import Cell
from ocbench.reference import deepseek_v2 as reference
from ocbench.tests.smoke import LIMITS, SHARED
from repro_torch.models import build_model

HERE = Path(__file__).resolve().parent.parent
NAME = "deepseek-v2-lite.identity"
SEED = 2**31 + 17
SMOKE = {
    "name": "deepseek-v2-lite.smoke", "arch": "deepseek-v2-lite",
    "architectures": ["DeepseekV2ForCausalLM"], "attention_bias": False,
    "first_k_dense_replace": 1, "hidden_act": "silu", "hidden_size": 64,
    "intermediate_size": 128, "kv_lora_rank": 32,
    "moe_intermediate_size": 32, "moe_layer_freq": 1, "n_group": 1,
    "n_routed_experts": 8, "n_shared_experts": 1, "norm_topk_prob": False,
    "num_attention_heads": 4, "num_experts_per_tok": 3,
    "num_hidden_layers": 2, "num_key_value_heads": 4, "q_lora_rank": None,
    "qk_nope_head_dim": 32, "qk_rope_head_dim": 16, "rms_norm_eps": 1e-06,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                     "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "rope_theta": 10000, "routed_scaling_factor": 1,
    "scoring_func": "softmax", "topk_group": 1, "topk_method": "greedy",
    "v_head_dim": 32, "vocab_size": 512, "tie_word_embeddings": False,
    "torch_dtype": "float32", "codec": "identity", "kv_resident": "fp",
    "chunk_tokens": 16, "link_gbps": 100}


def config(name=NAME):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def flat(tree, path=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in flat(v, f"{path}{k}/")]
    return [(path[:-1], tree)]


def test_the_configuration_resolves_to_the_module():
    cfg = config()
    assert archs.of(cfg) is not None
    assert archs.of(cfg).__file__ == str(HERE / "archs" / "deepseek_v2.py")
    assert archs.reference(cfg) is reference


def test_smoke_weight_tree_is_the_programs_in_draw_order():
    model = build_model(arch.program_config(SMOKE), device="cpu")
    spec = model.param_spec()
    assert weights.same_layout(weights.make(SMOKE, SEED, "cpu"), spec) == []
    assert [p for p, _ in flat(weights.shapes(SMOKE))] == \
        [p for p, _ in flat(spec)]


def test_full_size_parameters_and_wire_chunk():
    cfg = config()
    mats = sum(math.prod(shape) for p, (shape, *_) in
               flat(weights.shapes(cfg)) if not p.endswith("scale"))
    assert mats == 15_706_357_760
    program = arch.program_config(cfg)
    assert program.param_count() == mats
    assert counts.active_nonembed_params(cfg) == 2_241_593_344
    assert arch.kv_tensors(cfg) == (27, [576])
    spec = program.kv_spec(cfg["chunk_tokens"], codec=cfg["codec"])
    assert counts.wire_chunk_bytes(cfg) == spec.wire_chunk_bytes == 7_962_624
    assert spec.bytes_per_token == 31_104  # 27 layers x 576 values x 2 B


def test_prefill_flops_by_hand():
    cfg = config()
    # one token, no prefix: 2 x 2,241,593,344 active products, one
    # (query, key) pair a layer at 2 x 16 x (192 + 128), the logits
    assert counts.prefill_flops(cfg, 0, 1) == \
        4_483_186_688 + 27 * 10_240 + 419_430_400
    # 256 tokens after 4096: 256 x 4096 + 256 x 257 / 2 = 1,081,472 pairs
    assert counts.prefill_flops(cfg, 4096, 256) == \
        256 * 4_483_186_688 + 27 * 10_240 * 1_081_472 + 419_430_400


def _hf_model(params):
    """transformers' DeepseekV2ForCausalLM at the smoke size, with the
    benchmark's weights mapped across, and the softmax scale of DeepSeek's
    own code: transformers' port leaves YaRN's mscale^2 out of it."""
    transformers = pytest.importorskip("transformers")
    c = SMOKE
    hf_cfg = transformers.DeepseekV2Config(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        intermediate_size=c["intermediate_size"],
        moe_intermediate_size=c["moe_intermediate_size"],
        num_hidden_layers=c["num_hidden_layers"],
        num_attention_heads=c["num_attention_heads"],
        num_key_value_heads=c["num_key_value_heads"],
        n_shared_experts=c["n_shared_experts"],
        n_routed_experts=c["n_routed_experts"],
        routed_scaling_factor=c["routed_scaling_factor"],
        kv_lora_rank=c["kv_lora_rank"], q_lora_rank=None,
        qk_rope_head_dim=c["qk_rope_head_dim"],
        v_head_dim=c["v_head_dim"], qk_nope_head_dim=c["qk_nope_head_dim"],
        topk_method="greedy", n_group=1, topk_group=1,
        num_experts_per_tok=c["num_experts_per_tok"],
        first_k_dense_replace=c["first_k_dense_replace"],
        norm_topk_prob=False, max_position_embeddings=163840,
        rms_norm_eps=c["rms_norm_eps"], tie_word_embeddings=False,
        rope_theta=c["rope_theta"],
        rope_scaling=dict(c["rope_scaling"], factor=40.0, beta_fast=32.0,
                          beta_slow=1.0), attention_bias=False)
    hf_cfg._attn_implementation = "eager"
    model = transformers.DeepseekV2ForCausalLM(hf_cfg).float().eval()
    V = c["vocab_size"]

    def put(module, t):
        module.weight.data.copy_(t)
    m = model.model
    put(m.embed_tokens, params["embed"]["table"][:V])
    put(model.lm_head, params["embed"]["unembed"][:V])
    put(m.norm, params["final_norm"]["scale"])
    k = c["first_k_dense_replace"]
    for l, layer in enumerate(m.layers):
        part, i = ("dense", l) if l < k else ("moe", l - k)
        p = params["layers"][part]
        a, sa = p["attn"], layer.self_attn
        put(layer.input_layernorm, p["ln1"]["scale"][i])
        put(layer.post_attention_layernorm, p["ln2"]["scale"][i])
        put(sa.q_proj, a["wq"]["w"][i].T)
        put(sa.kv_a_proj_with_mqa, a["wkv_a"]["w"][i].T)
        put(sa.kv_a_layernorm, a["kv_norm"]["scale"][i])
        put(sa.kv_b_proj, a["wkv_b"]["w"][i].T)
        put(sa.o_proj, a["wo"]["w"][i].T)
        sa.scaling = reference.softmax_scale(c)

        def mlp(module, tree, e=None):
            w = {n: (tree[n]["w"][i] if e is None else tree[n][i, e])
                 for n in ("wi_gate", "wi_up", "wo")}
            put(module.gate_proj, w["wi_gate"].T)
            put(module.up_proj, w["wi_up"].T)
            put(module.down_proj, w["wo"].T)
        if part == "dense":
            mlp(layer.mlp, p["mlp"])
            continue
        put(layer.mlp.gate, p["moe"]["router"][i].T)
        for e, expert in enumerate(layer.mlp.experts):
            mlp(expert, p["moe"], e)
        mlp(layer.mlp.shared_experts, p["moe"]["shared"])
    return model


def test_the_reference_is_transformers_deepseek_v2():
    """fp32 on both sides; the sums run in other orders (attention in
    query blocks, the routed experts' combine), so the logits agree to
    rounding (7.8e-7 relative when written): 1e-5, where the mscale^2 left
    out of the scale moves them by 0.77."""
    params = weights.make(SMOKE, SEED, "cpu")
    model = _hf_model(params)
    toks = np.random.default_rng(3).integers(0, SMOKE["vocab_size"], 77)
    with torch.no_grad():
        hf = model(torch.as_tensor(toks)[None]).logits[0, -1].double()
        h = reference.forward(params, SMOKE, [(toks[:0], [toks])])
        ref = reference.Logits(params, SMOKE)(h[0][1][0])[0].double()
        # the same prompt as a prefix of 64 and a suffix
        h = reference.forward(params, SMOKE, [(toks[:64], [toks[64:]])])
        split = reference.Logits(params, SMOKE)(h[0][1][0])[0].double()
    assert float((ref - hf).norm() / hf.norm()) < 1e-5
    assert float((split - hf).norm() / hf.norm()) < 1e-5


def _cell(trace_metrics: bool) -> Cell:
    names = ["served_tok_s", "setup_s"]
    if trace_metrics:
        names = ["layer_compute_ms", "latent_expand_ms", "routed_experts_ms"]
    kind = "per_layer" if trace_metrics else "end_to_end"
    return Cell("deepseek-v2-lite.smoke.shared", 1, copy.deepcopy(SMOKE),
                copy.deepcopy(SHARED), dict(LIMITS),
                [{"name": n, "unit": "ms", "kind": kind} for n in names])


@pytest.mark.parametrize("trace", [False, True])
def test_the_smoke_cell_is_correct_and_reads_its_layers(trace):
    out = harness.run_cell(_cell(trace), SEED, 2.0, trace, "cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["checks"]["logit_rel_err"][0] <= 1e-5
    if trace:
        for name in ("layer_compute_ms", "latent_expand_ms",
                     "routed_experts_ms"):
            assert out["metrics"][name]["value"] > 0, name
