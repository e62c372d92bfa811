"""The one-tensor (latent) KV layout of multi-head latent attention in the
port: `LatentKVSpec`'s Eq. 1/2 arithmetic and layer byte ranges, the byte
round trip of latent wire images through `serving.kv_chunks`, the refusals
of a quantized codec and of packed residence, and the engine's
`compute.expand` and `compute.experts` spans with their counters in a
traced CPU run.  The two-matrix layout's numbers stay as they were."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import core  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import KVSpec, LatentKVSpec, layer_range  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402
from repro_torch.serving import (AsyncEngine, Orchestrator,  # noqa: E402
                                 ServingEngine, kv_chunks)

ARCH = "deepseek-v2-lite"
G = 8


def test_latent_spec_eq1_eq2():
    spec = get_config(ARCH).kv_spec(256)
    assert isinstance(spec, LatentKVSpec) and spec.width == 576
    assert spec.per_layer_chunk_bytes == 256 * 576 * 2 == 294_912
    assert spec.chunk_bytes == 27 * 294_912 == 7_962_624
    assert spec.bytes_per_token == 27 * 576 * 2 == 31_104
    assert spec.bytes_per_token_per_layer == 1152
    assert spec.matched_payload_bytes(32) == spec.matched_wire_bytes(32) \
        == 32 * 7_962_624
    assert spec.wire_layer_bytes(5) == 294_912 and spec.wire_ratio == 1.0
    assert [layer_range(l, spec) for l in (0, 26)] == \
        [(0, 294_912), (26 * 294_912, 7_962_624)]


def test_two_matrix_spec_is_unchanged():
    spec = get_config("qwen3-14b").kv_spec(256)
    assert type(spec) is KVSpec and spec.kv_tensors == 2
    assert spec.per_layer_chunk_bytes == 2 * 256 * 1024 * 2
    assert spec.bytes_per_token == 163_840
    assert get_config("qwen3-14b").kv_spec(256, codec="int8") \
        .wire_chunk_bytes == 21_135_360


@pytest.mark.parametrize("codec", ["int8", "int4", "gw8/g64", "mixed/84"])
def test_a_latent_layer_refuses_a_quantized_codec(codec):
    with pytest.raises(ValueError, match="one-tensor \\(latent\\)"):
        LatentKVSpec(num_layers=2, chunk_tokens=G, num_kv_heads=1,
                     head_dim=48, codec=codec)
    with pytest.raises(ValueError, match="latent"):
        get_smoke_config(ARCH).kv_spec(G, codec=codec)


@functools.lru_cache(maxsize=None)
def _model():
    model = build_model(get_smoke_config(ARCH), device="cpu")
    return model, model.init_params(torch.Generator().manual_seed(0))


def _orch(tracer=None):
    model, _ = _model()
    spec = model.cfg.kv_spec(G, dtype_bytes=4)
    return Orchestrator(core.RadixIndex(G), core.Gateway(core.InMemoryStore()),
                        spec, theta_bytes=0, tracer=tracer)


def test_the_engines_refuse_packed_residence_and_the_async_path():
    model, params = _model()
    with pytest.raises(ValueError, match="one-tensor \\(latent\\)"):
        ServingEngine(model, params, _orch(), kv_resident="packed")
    with pytest.raises(ValueError, match="one-tensor \\(latent\\)"):
        AsyncEngine(model, params, _orch(), compute=None)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_latent_wire_images_round_trip_byte_for_byte(dtype):
    L, W, N = 3, 48, 4
    spec = LatentKVSpec(num_layers=L, chunk_tokens=G, num_kv_heads=1,
                        head_dim=W, dtype_bytes=dtype.itemsize)
    cache = torch.randn((L, 2, N * G + 3, W)).to(dtype)  # two rows
    images = kv_chunks.cache_to_wire_images(cache, N, spec, batch_row=1)
    assert images.shape == (N, spec.wire_chunk_bytes)
    keys = [bytes([i]) for i in range(N)]
    objs = kv_chunks.wire_images_to_objects(images, keys)
    word = np.uint16 if dtype == torch.bfloat16 else np.uint32
    rows = cache[:, 1].contiguous().view(
        torch.int16 if dtype == torch.bfloat16 else torch.int32).numpy() \
        .view(word)
    for i, key in enumerate(keys):  # KV_L2TD with one matrix a layer
        want = np.concatenate([rows[l, i * G:(i + 1) * G] for l in range(L)])
        assert objs[key] == want.tobytes()
    # a layer payload: the layer's byte range of each chunk, in order
    payloads = [b"".join(objs[k][slice(*layer_range(l, spec))]
                         for k in keys) for l in range(L)]
    for l, payload in enumerate(payloads):
        (c,) = kv_chunks.layer_payload_to_device_kv(payload, N, spec, dtype,
                                                    layer=l, device="cpu")
        assert c.shape == (N * G, W)
        assert torch.equal(c, cache[l, 1, :N * G])
    prefix = kv_chunks.prefix_kv_from_payloads(payloads, N, spec, dtype,
                                               device="cpu")
    assert torch.equal(prefix, cache[:, 1:2, :N * G])


def _prompts():
    rng = np.random.default_rng(3)
    shared = rng.integers(0, 500, size=4 * G)
    return (np.concatenate([shared, rng.integers(0, 500, size=5)]),
            np.concatenate([shared, rng.integers(0, 500, size=G + 6)]))


@functools.lru_cache(maxsize=None)
def _traced():
    model, params = _model()
    tracer = Tracer()
    engine = ServingEngine(model, params, _orch(tracer))
    cold, warm = _prompts()
    return tracer, engine.submit(cold, "cold"), engine.submit(warm, "warm")


def test_each_layer_step_of_a_warm_hit_holds_one_expand():
    tracer, _, warm = _traced()
    computes = tracer.spans("warm", "compute")
    expands = tracer.spans("warm", "compute.expand")
    assert warm.matched_tokens == 4 * G and len(computes) == 2
    assert len(expands) == 2
    for c, e in zip(computes, expands):
        assert c.contains(e) and e.cat == "engine"
        assert e.args == {"layer": c.args["layer"],
                          "prefix_tokens": 4 * G}
    assert tracer.spans("cold", "compute.expand") == []  # no prefix


def test_each_moe_layer_holds_one_experts_span():
    tracer, cold, warm = _traced()
    cold_len, warm_len = (len(p) for p in _prompts())
    (c,) = tracer.spans("cold", "compute")
    (e,) = tracer.spans("cold", "compute.experts")  # layer 1 of 2
    assert c.contains(e) and e.args == {"tokens": cold_len}
    computes = tracer.spans("warm", "compute")
    (e,) = tracer.spans("warm", "compute.experts")
    assert computes[1].contains(e)
    assert e.args == {"layer": 1, "tokens": warm_len - warm.matched_tokens}


def test_a_tracer_changes_no_answer():
    model, params = _model()
    _, cold, warm = _traced()
    engine = ServingEngine(model, params, _orch())
    for traced, prompt in zip((cold, warm), _prompts()):
        np.testing.assert_array_equal(engine.submit(prompt).logits,
                                      traced.logits)
