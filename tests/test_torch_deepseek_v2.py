"""DeepSeek-V2-Lite in the port at the smoke size on the CPU, held to the
benchmark's plain fp32 reference (``ocbench/reference/deepseek_v2.py``) on
last-token logits, with the benchmark's seeded random weights
(``ocbench/weights.py``: norm scales, ``kv_a_layernorm``'s included, drawn
N(1, 0.1^2)):

- a cold prefill through `ServingEngine.submit`;
- a warm layerwise hit over a prefix committed as identity (latent) objects
  through the `Orchestrator`, fetched layer by layer;
- a prefill, then 8 greedy decode steps through the latent cache, each
  step's logits against the reference's full forward over the prompt and
  the tokens decoded so far;
- the training forward's hidden states against the prefill's.

Tolerance: both sides compute in fp32 on the CPU, and the port's products
and sums are the reference's up to their order (heads grouped, the
experts' combine), so they agree to rounding (the prefills read 0 when
written).  ``REL`` 1e-5 on the relative L2 distance of the logits leaves
room for that, and is 10^4 times below what a wrong piece of the layer
moves: a dropped mscale^2, a renormalised router, a missing
``kv_a_layernorm``, RoPE without YaRN and missing shared experts moved the
cold prompt's logits by 0.78, 0.11, 0.57, 0.17 and 0.77.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from ocbench import weights  # noqa: E402
from ocbench.archs import deepseek_v2 as arch  # noqa: E402
from ocbench.reference import deepseek_v2 as reference  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.core import Delivery  # noqa: E402
from repro_torch.models import build_model, mla  # noqa: E402
from repro_torch.models import layers as nn  # noqa: E402
from repro_torch.serving import Orchestrator, ServingEngine  # noqa: E402

REL = 1e-5
G = 16  # chunk tokens
SEED = 2**31 + 11
# the smoke preset's sizes (`configs/deepseek_v2_lite.py` SMOKE) under the
# published configuration's keys
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
    "chunk_tokens": G, "link_gbps": 100}


def _stack():
    model = build_model(arch.program_config(SMOKE), device="cpu")
    return model, weights.make(SMOKE, SEED, "cpu")


def _prompts():
    rng = np.random.default_rng(5)
    shared = rng.integers(0, 512, size=5 * G)
    cold = np.concatenate([shared, rng.integers(0, 512, size=7)])
    warm = np.concatenate([shared, rng.integers(0, 512, size=G + 9)])
    return cold, warm


def _reference(params, prompt, prefix_len=0):
    """The reference's last-token logits of ``prompt``, its first
    ``prefix_len`` tokens a shared prefix passed through the codec."""
    prompt = np.asarray(prompt)
    h = reference.forward(params, SMOKE, [(prompt[:prefix_len],
                                           [prompt[prefix_len:]])])
    return reference.Logits(params, SMOKE)(h[0][1][0])[0].numpy()


def _rel(got, want):
    got = np.asarray(got, np.float64)[:SMOKE["vocab_size"]]
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _engine(model, params):
    store = core.InMemoryStore()
    spec = model.cfg.kv_spec(G, dtype_bytes=4, codec="identity")
    orch = Orchestrator(core.RadixIndex(G), core.Gateway(store), spec,
                        theta_bytes=0)
    return ServingEngine(model, params, orch), store


def test_the_program_tree_is_the_benchmarks():
    model, params = _stack()
    assert weights.same_layout(params, model.param_spec()) == []


def test_cold_prefill_through_submit():
    model, params = _stack()
    engine, _ = _engine(model, params)
    cold, _ = _prompts()
    r = engine.submit(cold, "cold")
    assert not r.hit
    assert _rel(r.logits, _reference(params, cold)) < REL


def test_warm_layerwise_hit_over_latent_objects():
    model, params = _stack()
    engine, store = _engine(model, params)
    cold, warm = _prompts()
    engine.submit(cold, "cold")
    # every complete chunk of the cold prompt went in as one object of L
    # latent slices, [G, latent_dim] each
    assert len(store._data) == len(cold) // G
    assert {len(v) for v in store._data.values()} == \
        {engine.spec.wire_chunk_bytes}
    r = engine.submit(warm, "warm")
    assert r.delivery is Delivery.LAYERWISE and r.matched_tokens == 5 * G
    assert _rel(r.logits, _reference(params, warm, 5 * G)) < REL


def test_prefill_then_decode_through_the_latent_cache():
    model, params = _stack()
    engine, _ = _engine(model, params)
    cold, _ = _prompts()
    seen = []

    def logged(cache, token, pos):  # each step's logits
        lg, cache = model.decode_step(params, cache, token, pos)
        seen.append(lg[0].numpy().copy())
        return lg, cache
    engine.runner.decode = logged
    r = engine.submit(cold, "cold", max_new_tokens=9)
    assert len(r.new_tokens) == 9 and len(seen) == 8
    assert engine._last_kv[1].shape == (2, 1, len(cold),
                                        model.cfg.latent_dim)
    for i, lg in enumerate(seen):
        prompt = np.concatenate([cold, r.new_tokens[:i + 1]])
        assert _rel(lg, _reference(params, prompt)) < REL, i


def test_the_training_forward_is_the_prefill():
    model, params = _stack()
    cold, _ = _prompts()
    tokens = torch.as_tensor(cold)[None]
    lg, _ = model.prefill(params, {"tokens": tokens})
    x, aux = mla.forward(params, model.cfg, tokens)
    last = nn.logits(params["embed"], model.cfg, x[:, -1:])[0, 0]
    np.testing.assert_allclose(last.numpy(), lg[0].numpy(), rtol=0,
                               atol=1e-6)
    assert float(aux) > 0
    assert float(model.loss(params, {"tokens": tokens[:, :-1],
                                     "labels": tokens[:, 1:]})) > 0


def test_the_latent_stack_has_a_module_of_its_own():
    """`models.api` runs an `MLAConfig` through `mla`; every other MoE
    config keeps `moe`'s functions and carries no latent field."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe
    model, _ = _stack()
    assert model._mod is mla
    qwen = get_smoke_config("qwen3-moe-30b-a3b")
    assert build_model(qwen, device="cpu")._mod is moe
    for name in ("kv_lora_rank", "first_dense_layers", "norm_topk_prob",
                 "routed_scaling_factor"):
        assert not hasattr(qwen, name)


@pytest.mark.parametrize("renormalise,scale", [(True, 1.0), (False, 1.0),
                                               (False, 2.5)])
def test_router_weights(renormalise, scale):
    """The top-k weights renormalised (the default, Qwen3-MoE), or left as
    the softmax gave them times ``scale`` (DeepSeek-V2)."""
    from repro_torch.models import moe
    cfg = _stack()[0].cfg
    g = torch.Generator().manual_seed(3)
    p = {"router": torch.randn(cfg.d_model, cfg.num_experts, generator=g)}
    xf = torch.randn(11, cfg.d_model, generator=g)
    topw, topi, _ = moe._route(p, cfg, xf, renormalise, scale)
    want = torch.softmax(xf @ p["router"], -1).gather(1, topi)
    want = want / want.sum(-1, keepdim=True) if renormalise else \
        want * scale
    torch.testing.assert_close(topw, want)
