"""The port's serving path against the JAX reference: wire bytes, the
codec x delivery matrix, warm hits served across the two engines, span
names, and the port's serve launcher.

Model: the 2-layer ``qwen3-0.6b`` smoke config (fp32) that the reference's
own engine tests use, with reference-initialised parameters bridged to torch.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as ref_core  # noqa: E402
import repro.obs.trace as ref_trace  # noqa: E402
import repro.serving as ref_serving  # noqa: E402
import repro.serving.kv_chunks as ref_kv  # noqa: E402
from repro.configs import get_smoke_config as ref_get_smoke  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.bridge import params_from_reference  # noqa: E402
from repro_torch.codec import get_codec  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import Delivery  # noqa: E402
from repro_torch.models import Model, build_model  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402
from repro_torch.serving import Orchestrator, ServingEngine  # noqa: E402
from repro_torch.serving import kv_chunks  # noqa: E402

ARCH = "qwen3-0.6b"
G = 8  # chunk tokens
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODECS = ["identity", "int8", "int4", "gw8/g16", "gw4/g16", "mixed/84/g16"]


@functools.lru_cache(maxsize=None)
def _models():
    """One reference init per module, bridged once: (ref model, ref params,
    port model, port params)."""
    ref_model = ref_build_model(ref_get_smoke(ARCH))
    ref_params = jax.jit(ref_model.init_params)(jax.random.PRNGKey(0))
    params = params_from_reference(jax.tree.map(np.asarray, ref_params),
                                   device="cpu")
    return (ref_model, ref_params,
            build_model(get_smoke_config(ARCH), device="cpu"), params)


def _port_engine(codec="identity", theta=0, tracer=None, kv_resident="fp"):
    _, _, model, params = _models()
    spec = model.cfg.kv_spec(G, dtype_bytes=4, codec=codec)
    store = core.InMemoryStore()
    orch = Orchestrator(core.RadixIndex(G), core.Gateway(store), spec,
                        theta_bytes=theta, tracer=tracer)
    return ServingEngine(model, params, orch,
                         kv_resident=kv_resident), store


def _ref_engine(codec="identity", theta=0, tracer=None, kv_resident="fp"):
    ref_model, ref_params, _, _ = _models()
    spec = ref_model.cfg.kv_spec(G, dtype_bytes=4, codec=codec)
    store = ref_core.InMemoryStore()
    orch = ref_serving.Orchestrator(
        ref_core.RadixIndex(G), ref_core.Gateway(store), spec,
        theta_bytes=theta, tracer=tracer)
    return ref_serving.ServingEngine(ref_model, ref_params, orch,
                                     kv_resident=kv_resident), store


def _cache(seed, dtype):
    """A [L, 2, 1, S, KV, dh] cache as (reference jnp array, port tensor)
    holding the same bits."""
    cfg = get_smoke_config(ARCH)
    x = np.random.default_rng(seed).standard_normal(
        (cfg.num_layers, 2, 1, 3 * G, cfg.num_kv_heads, cfg.head_dim)
    ).astype(np.float32) * 2
    if dtype == "float32":
        return jnp.asarray(x), torch.from_numpy(x)
    ref = jnp.asarray(x, jnp.bfloat16)
    words = np.asarray(ref).view(np.int16)
    return ref, torch.from_numpy(words.copy()).view(torch.bfloat16)


class TestWireBytes:
    """The port's copy of the codecs writes the reference's bytes and reads
    them back to the same values."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("codec", CODECS)
    def test_commit_and_decode_identical(self, codec, dtype):
        cfg = get_smoke_config(ARCH)
        nbytes = 4 if dtype == "float32" else 2
        spec = cfg.kv_spec(G, dtype_bytes=nbytes, codec=codec)
        ref_spec = ref_get_smoke(ARCH).kv_spec(G, dtype_bytes=nbytes,
                                               codec=codec)
        ref_cache, cache = _cache(11, dtype)
        keys = [bytes([i]) * 16 for i in range(3)]
        want = ref_kv.cache_to_chunks(np.asarray(ref_cache), keys, ref_spec)
        got = kv_chunks.cache_to_chunks(cache, keys, spec)
        assert list(got) == list(want)
        for key in keys:
            assert got[key] == want[key], key
        # one aggregated layer payload per layer, decoded both ways
        t_dtype = torch.float32 if dtype == "float32" else torch.bfloat16
        for layer in range(spec.num_layers):
            lo, hi = spec.wire_layer_offsets[layer:layer + 2]
            payload = b"".join(got[k][lo:hi] for k in keys)
            wk, wv = ref_kv.layer_payload_to_device_kv(
                payload, 3, ref_spec, jnp.dtype(dtype), layer)
            host = kv_chunks.layer_payload_to_kv(payload, 3, spec, t_dtype,
                                                 layer)
            device = kv_chunks.layer_payload_to_device_kv(
                payload, 3, spec, t_dtype, layer, device="cpu")
            for gk, gv in (host, device):
                assert gk.dtype == t_dtype and gk.device.type == "cpu"
                np.testing.assert_array_equal(
                    gk.float().numpy(), np.asarray(wk.astype(jnp.float32)))
                np.testing.assert_array_equal(
                    gv.float().numpy(), np.asarray(wv.astype(jnp.float32)))

    def test_unknown_width_raises(self):
        with pytest.raises(ValueError, match="known widths"):
            kv_chunks._dequant_op_for(2)


class TestCodecConformanceMatrix:
    """The reference's delivery x codec matrix, with its bounds, on the
    port's engine.  Identity is held to 1e-4 rather than bit-equality: the
    reference's own bit-equality case does not pass today (ROADMAP.md,
    Queue 3), and its cache-hit bound is 1e-4."""

    CODEC_BOUNDS = [("identity", 1e-4), ("int8", 0.02), ("int4", 0.35),
                    ("gw8/g16", 0.03), ("gw4/g16", 0.4),
                    ("mixed/84/g16", 0.1)]

    @pytest.mark.parametrize("delivery", ["layerwise", "chunkwise"])
    @pytest.mark.parametrize("codec,bound", CODEC_BOUNDS)
    def test_matrix(self, delivery, codec, bound):
        theta = 0 if delivery == "layerwise" else 1 << 60
        engine, store = _port_engine(codec, theta)
        rng = np.random.default_rng(23)
        prompt = rng.integers(0, 200, size=48)
        cold = engine.submit(prompt, "cold")
        warm = engine.submit(prompt, "warm")
        assert warm.hit and warm.matched_tokens == 40
        want = (Delivery.LAYERWISE if delivery == "layerwise"
                else Delivery.CHUNKWISE)
        assert warm.delivery is want
        err = float(np.abs(warm.logits - cold.logits).max())
        print(f"max_abs_diff warm vs cold {codec} {delivery}: {err:.3g}")
        if codec == "identity":
            assert err <= bound, err
        else:
            assert 0.0 < err < bound, (codec, delivery, err)
        assert store.stats.snapshot()["bytes_written"] \
            == engine.stats.commits * engine.spec.wire_chunk_bytes

    def test_decode_after_hit_matches_cold(self):
        engine, _ = _port_engine()
        prompt = np.random.default_rng(5).integers(0, 200, size=32)
        cold = engine.submit(prompt, "c", max_new_tokens=4)
        warm = engine.submit(prompt, "w", max_new_tokens=4)
        assert warm.hit and cold.new_tokens == warm.new_tokens



def _packed_refusal(make_cfg_pair, codec, resident="packed"):
    """The ValueError each engine raises for one bad packed configuration:
    (port message, reference message)."""
    cfg, ref_cfg = make_cfg_pair()
    msgs = []
    port_orch = Orchestrator(core.RadixIndex(G),
                             core.Gateway(core.InMemoryStore()),
                             cfg.kv_spec(G, dtype_bytes=4, codec=codec))
    with pytest.raises(ValueError) as port_err:
        ServingEngine(Model(cfg, torch.device("cpu")), {}, port_orch,
                      kv_resident=resident)
    msgs.append(str(port_err.value))
    ref_orch = ref_serving.Orchestrator(
        ref_core.RadixIndex(G), ref_core.Gateway(ref_core.InMemoryStore()),
        ref_cfg.kv_spec(G, dtype_bytes=4, codec=codec))
    with pytest.raises(ValueError) as ref_err:
        ref_serving.ServingEngine(ref_build_model(ref_cfg), None, ref_orch,
                                  kv_resident=resident)
    msgs.append(str(ref_err.value))
    return msgs


class TestPackedRefusals:
    """`kv_resident="packed"` refuses what the reference refuses, with the
    reference's messages."""

    def test_lossless_codec(self):
        port, ref = _packed_refusal(
            lambda: (get_smoke_config(ARCH), ref_get_smoke(ARCH)), "identity")
        assert port == ref and "quantized codec" in port

    def test_non_dense_family(self):
        moe = "qwen3-moe-30b-a3b"
        port, ref = _packed_refusal(
            lambda: (get_smoke_config(moe), ref_get_smoke(moe)), "int8")
        assert port == ref and "dense/vlm" in port

    def test_logit_softcap(self):
        port, ref = _packed_refusal(lambda: (
            dataclasses.replace(get_smoke_config(ARCH), logit_softcap=30.0),
            dataclasses.replace(ref_get_smoke(ARCH), logit_softcap=30.0)),
            "int8")
        assert port == ref and "softcap" in port

    def test_unknown_residency(self):
        port, ref = _packed_refusal(
            lambda: (get_smoke_config(ARCH), ref_get_smoke(ARCH)), "int8",
            resident="half")
        assert port == ref and "kv_resident" in port


def _shared_prompts():
    rng = np.random.default_rng(7)
    shared = rng.integers(0, 200, size=32)
    cold = np.concatenate([shared, rng.integers(0, 200, size=8)])
    warm = np.concatenate([shared, rng.integers(0, 200, size=12)])
    return cold, warm


class TestCrossEngine:
    """A warm hit committed by one engine is served by the other: the
    serving side's orchestrator takes the committing side's exact objects
    through ``commit``.  Logits within 1e-4; matched tokens, delivery,
    greedy tokens and bytes written equal."""

    @staticmethod
    def _move(tokens, src_store, dst_orch):
        keys = core.chunk_keys(np.asarray(tokens, np.int32), G)
        objs = {k: src_store.get(k) for k in keys if src_store.contains(k)}
        assert objs, "the cold request committed nothing"
        dst_orch.commit(np.asarray(tokens, np.int32), objs)

    @pytest.mark.parametrize("codec", ["identity", "gw4/g16"])
    @pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
    def test_warm_hit_across_engines(self, codec, direction):
        cold, warm = _shared_prompts()
        ref, ref_store = _ref_engine(codec)
        port, port_store = _port_engine(codec)
        if direction == "ref_to_port":
            ref.submit(cold, "cold")
            self._move(cold, ref_store, port.orch)
        else:
            port.submit(cold, "cold")
            self._move(cold, port_store, ref.orch)
        # whichever side did not serve the cold request saw only the moved
        # objects; the other side serves its own warm hit from its own store
        assert ref_store.stats.snapshot()["bytes_written"] \
            == port_store.stats.snapshot()["bytes_written"]
        r = ref.submit(warm, "warm", max_new_tokens=4)
        p = port.submit(warm, "warm", max_new_tokens=4)
        assert p.matched_tokens == r.matched_tokens == 32
        assert p.delivery is Delivery.LAYERWISE
        assert r.delivery.name == p.delivery.name
        diff = float(np.abs(p.logits - r.logits).max())
        print(f"max_abs_diff port vs reference warm {codec} {direction}: "
              f"{diff:.3g}")
        assert diff <= 1e-4, diff
        assert p.new_tokens == r.new_tokens
        assert ref_store.stats.snapshot()["bytes_written"] \
            == port_store.stats.snapshot()["bytes_written"]

    def test_span_names_match_reference(self):
        cold, warm = _shared_prompts()
        names = []
        for make, tracer_cls in ((_ref_engine, ref_trace.Tracer),
                                 (_port_engine, Tracer)):
            tracer = tracer_cls()
            engine, _ = make("int8", tracer=tracer)
            engine.submit(cold, "cold")
            engine.submit(warm, "warm")
            names.append([(type(r).__name__, r.track, r.name,
                           r.args.get("layer")) for r in tracer.records])
        # the port's own spans inside `commit` and `compute`, and the time
        # to the logits, have no counterpart in the reference
        port_only = {"commit.d2h", "commit.encode", "commit.put",
                     "compute.launch", "to_logits"}
        assert port_only <= {n for _, _, n, _ in names[1]}
        assert [r for r in names[1] if r[2] not in port_only] == names[0]
        assert {"plan", "fetch", "dequant", "compute", "commit"} <= \
            {n for _, _, n, _ in names[1]}


PACKED_CODECS = ["int8", "int4", "gw8/g16", "gw4/g16", "mixed/84/g16"]


@functools.lru_cache(maxsize=None)
def _ref_packed_warm(codec):
    """The reference's packed engine (its fused Pallas kernels in interpret
    mode): the cold prompt, then the warm one with 4 greedy tokens.
    Returns (store, warm result)."""
    cold, warm = _shared_prompts()
    engine, store = _ref_engine(codec, kv_resident="packed")
    engine.submit(cold, "cold")
    return store, engine.submit(warm, "warm", max_new_tokens=4)


class TestPackedEngine:
    """`ServingEngine(kv_resident="packed")`: the prefix of a layerwise hit
    stays wire-sized on the device and attention reads it through the
    fused ops (their plain versions on the CPU)."""

    @pytest.mark.parametrize("codec", PACKED_CODECS)
    def test_matches_reference_packed_engine(self, codec):
        cold, warm = _shared_prompts()
        _, r = _ref_packed_warm(codec)
        engine, store = _port_engine(codec, kv_resident="packed")
        engine.submit(cold, "cold")
        p = engine.submit(warm, "warm", max_new_tokens=4)
        assert p.matched_tokens == r.matched_tokens == 32
        assert p.delivery is Delivery.LAYERWISE
        diff = float(np.abs(p.logits - r.logits).max())
        print(f"max_abs_diff port vs reference packed warm {codec}: "
              f"{diff:.3g}")
        assert diff <= 1e-4, diff
        assert p.new_tokens == r.new_tokens and len(p.new_tokens) == 4
        assert store.stats.snapshot()["bytes_written"] \
            == engine.stats.commits * engine.spec.wire_chunk_bytes
        packed_layers, _, P = engine._last_kv
        assert P == 32 and len(packed_layers) == engine.cfg.num_layers
        bits = [pkv.bits for pkv in packed_layers]
        assert bits == [get_codec(codec).layer_bits(engine.spec, l)
                        for l in range(engine.cfg.num_layers)]

    @pytest.mark.parametrize("codec", PACKED_CODECS)
    def test_matches_fp_resident_engine(self, codec):
        """Residency is a memory layout, not a numerics choice: at fp32 the
        packed warm logits equal the fp-resident ones to the order of the
        sums (the reference's bar, 1e-4), and the prefix it holds is
        smaller."""
        cold, warm = _shared_prompts()
        results = {}
        for resident in ("fp", "packed"):
            engine, _ = _port_engine(codec, kv_resident=resident)
            engine.submit(cold, "cold")
            results[resident] = engine.submit(warm, "warm", max_new_tokens=4)
            if resident == "packed":
                held = sum(pkv.resident_bytes
                           for pkv in engine._last_kv[0])
        diff = float(np.abs(results["packed"].logits
                            - results["fp"].logits).max())
        print(f"max_abs_diff packed vs fp warm {codec}: {diff:.3g}")
        assert diff <= 1e-4, diff
        assert results["packed"].new_tokens == results["fp"].new_tokens
        cfg = get_smoke_config(ARCH)
        fp_bytes = cfg.num_layers * 2 * 32 * cfg.num_kv_heads \
            * cfg.head_dim * 4
        assert held < fp_bytes

    def test_repeat_warm_hit_puts_nothing(self):
        engine, store = _port_engine("gw8/g16", kv_resident="packed")
        prompt = np.random.default_rng(37).integers(0, 200, size=48)
        engine.submit(prompt, "cold")
        puts = store.stats.puts
        warm = engine.submit(prompt, "warm")
        assert warm.hit and warm.delivery is Delivery.LAYERWISE
        assert store.stats.puts == puts

    def test_chunkwise_and_miss_stay_fp_resident(self):
        engine, _ = _port_engine("int8", theta=1 << 60, kv_resident="packed")
        cold, warm = _shared_prompts()
        engine.submit(cold, "cold", max_new_tokens=2)
        assert engine._last_kv[0] is None
        r = engine.submit(warm, "warm", max_new_tokens=2)
        assert r.delivery is Delivery.CHUNKWISE
        assert engine._last_kv[0] is None and len(r.new_tokens) == 2

    @pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
    def test_packed_warm_hit_across_engines(self, direction):
        """One side commits the cold prompt, the other serves the warm hit
        packed-resident; both warm results agree within 1e-4."""
        codec = "gw4/g16"
        cold, warm = _shared_prompts()
        if direction == "ref_to_port":
            ref_store, r = _ref_packed_warm(codec)
            port, _ = _port_engine(codec, kv_resident="packed")
            TestCrossEngine._move(cold, ref_store, port.orch)
            p = port.submit(warm, "warm", max_new_tokens=4)
        else:
            port, port_store = _port_engine(codec, kv_resident="packed")
            port.submit(cold, "cold")
            p = port.submit(warm, "warm", max_new_tokens=4)
            ref, _ = _ref_engine(codec, kv_resident="packed")
            TestCrossEngine._move(cold, port_store, ref.orch)
            r = ref.submit(warm, "warm", max_new_tokens=4)
        assert p.matched_tokens == r.matched_tokens == 32
        assert p.delivery is Delivery.LAYERWISE
        assert r.delivery.name == p.delivery.name
        diff = float(np.abs(p.logits - r.logits).max())
        print(f"max_abs_diff packed warm across engines {direction}: "
              f"{diff:.3g}")
        assert diff <= 1e-4, diff
        assert p.new_tokens == r.new_tokens


def test_serve_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--requests", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("arch=llama3-1-8b-smoke device=cpu")
    assert "mode=layerwise" in lines[2]
    assert any(ln.startswith("store:") for ln in lines)


def test_port_config_is_a_copy_not_an_import():
    """The port's ModelConfig is its own class with the same fields."""
    ours, ref = get_smoke_config(ARCH), ref_get_smoke(ARCH)
    assert type(ours) is not type(ref)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
