"""The port's mixture-of-experts family against the JAX reference: the
router, the ragged expert MLP, prefill and decode, the serving engines
(layerwise, chunkwise, over a compute-or-load fetch span) and the
concurrent engine.

Models: the fp32 smoke configs of ``qwen3-moe-30b-a3b`` (8 experts, top-2,
homogeneous layers) and ``llama4-maverick-400b-a17b`` (top-1, shared
expert, alternating dense/MoE layers), reference-initialised and bridged.
Tolerances: routing (`topi`) identical and its weights within 1e-6;
activations, logits and caches within TOL = 1e-4 (the reference's own
cache-hit bound: two fp32 implementations sum in other orders); the
concurrent engine's virtual timeline within 1e-9 of the port's
`ClusterSim` (host arithmetic).
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as ref_core  # noqa: E402
import repro.core.compute_model as ref_compute_model  # noqa: E402
import repro.core.scheduler as ref_scheduler  # noqa: E402
import repro.core.transport as ref_transport  # noqa: E402
import repro.hybrid as ref_hybrid  # noqa: E402
import repro.serving as ref_serving  # noqa: E402
from repro.configs import get_smoke_config as ref_get_smoke  # noqa: E402
from repro.configs import list_archs as ref_list_archs  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch import core, serving  # noqa: E402
from repro_torch.bridge import params_from_reference  # noqa: E402
from repro_torch.cluster import ClusterSim, TraceRequest  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import Delivery  # noqa: E402
from repro_torch.core import compute_model, scheduler, transport  # noqa
from repro_torch.hybrid import HybridPlanner  # noqa: E402
from repro_torch.models import build_model, moe  # noqa: E402

TOL = 1e-4
QWEN, LLAMA4 = "qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b"
ARCHS = [QWEN, LLAMA4]
G = 8  # chunk tokens


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    diff = float(np.abs(got - want).max()) if got.size else 0.0
    print(f"max_abs_diff {what}: {diff:.3g}")
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@functools.lru_cache(maxsize=None)
def _bridged(arch):
    """(reference model, reference params, port model, port params)."""
    ref_model = ref_build_model(ref_get_smoke(arch))
    ref_params = jax.jit(ref_model.init_params)(jax.random.PRNGKey(0))
    params = params_from_reference(jax.tree.map(np.asarray, ref_params),
                                   device="cpu")
    return (ref_model, ref_params,
            build_model(get_smoke_config(arch), device="cpu"), params)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _moe_params(arch):
    """The first MoE layer's expert MLP, both sides."""
    _, ref_params, model, params = _bridged(arch)
    if model.cfg.moe_every == 1:
        return (jax.tree.map(lambda a: a[0], ref_params["layers"]["moe"]),
                moe.dense.take(params["layers"]["moe"], 0))
    return (jax.tree.map(lambda a: a[0], ref_params["layers"]["moe"]["moe"]),
            moe.dense.take(params["layers"]["moe"]["moe"], 0))


def _x(arch, T, seed):
    cfg = get_smoke_config(arch)
    return np.random.default_rng(seed).standard_normal(
        (T, cfg.d_model)).astype(np.float32)


class TestRouter:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_route(self, arch):
        ref_p, p = _moe_params(arch)
        xf = _x(arch, 40, 0)
        wtw, wti, waux = ref_moe._route(ref_p, ref_get_smoke(arch),
                                        jnp.asarray(xf))
        gtw, gti, gaux = moe._route(p, get_smoke_config(arch), _t(xf))
        np.testing.assert_array_equal(gti.numpy(), np.asarray(wti))
        _close(gtw.numpy(), wtw, f"route {arch} weights", tol=1e-6)
        _close(float(gaux), float(waux), f"route {arch} aux", tol=1e-6)

    @pytest.mark.parametrize("arch", ARCHS)
    @pytest.mark.parametrize("S", [1, 9])
    def test_moe_mlp(self, arch, S):
        ref_p, p = _moe_params(arch)
        x = _x(arch, 2 * S, 1).reshape(2, S, -1)
        want, _ = ref_moe.moe_mlp(ref_p, ref_get_smoke(arch), jnp.asarray(x))
        got, _ = moe.moe_mlp(p, get_smoke_config(arch), _t(x))
        _close(got.numpy(), want, f"moe_mlp {arch} S={S}")

    def test_ragged_skips_empty_experts(self):
        """One token routes to k of E experts: the others get no rows and
        no product; the result is still the reference's."""
        ref_p, p = _moe_params(QWEN)
        x = _x(QWEN, 1, 2)[None]
        want, _ = ref_moe.moe_mlp(ref_p, ref_get_smoke(QWEN), jnp.asarray(x))
        got, _ = moe.moe_mlp(p, get_smoke_config(QWEN), _t(x))
        _close(got.numpy(), want, "moe_mlp one token")

    def test_same_bits_on_every_call(self):
        """The combine has no atomics: a second call gives the same bits."""
        _, p = _moe_params(QWEN)
        x = _t(_x(QWEN, 64, 4)[None])
        a, _ = moe.moe_mlp(p, get_smoke_config(QWEN), x)
        b, _ = moe.moe_mlp(p, get_smoke_config(QWEN), x)
        assert torch.equal(a, b)


class TestModel:
    @pytest.mark.parametrize("arch", ARCHS)
    @pytest.mark.parametrize("P", [0, 8])
    def test_prefill(self, arch, P):
        ref_model, ref_params, model, params = _bridged(arch)
        cfg = model.cfg
        rng = np.random.default_rng(5)
        B, S = 2, 7
        tokens = rng.integers(0, cfg.vocab_size, size=(B, S))
        prefix = None
        if P:
            prefix = rng.standard_normal(
                (cfg.num_layers, 2, B, P, cfg.num_kv_heads, cfg.head_dim)
            ).astype(np.float32)
        want_lg, want_kv = ref_model.prefill(
            ref_params, {"tokens": jnp.asarray(tokens)},
            None if prefix is None else jnp.asarray(prefix), P)
        got_lg, got_kv = model.prefill(
            params, {"tokens": _t(tokens)},
            None if prefix is None else _t(prefix), P)
        _close(got_lg.numpy(), want_lg, f"prefill {arch} P={P} logits")
        _close(got_kv.numpy(), want_kv, f"prefill {arch} P={P} cache")

    @pytest.mark.parametrize("arch", ARCHS)
    def test_decode_step(self, arch):
        ref_model, ref_params, model, params = _bridged(arch)
        cfg = model.cfg
        rng = np.random.default_rng(6)
        B, S = 2, 12
        cache = rng.standard_normal(
            (cfg.num_layers, 2, B, S, cfg.num_kv_heads, cfg.head_dim)
        ).astype(np.float32)
        token = rng.integers(0, cfg.vocab_size, size=(B, 1))
        pos = np.array([5, 9])
        want_lg, want_cache = ref_model.decode_step(
            ref_params, jnp.asarray(cache), jnp.asarray(token),
            jnp.asarray(pos, jnp.int32))
        got_lg, got_cache = model.decode_step(params, _t(cache.copy()),
                                              _t(token), _t(pos))
        _close(got_lg.numpy(), want_lg, f"decode_step {arch} logits")
        _close(got_cache.numpy(), want_cache, f"decode_step {arch} cache")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _planner(ns, spec):
    compute = ns.compute.MeasuredCompute(
        num_layers=spec.num_layers, base_s=0.0, per_token_s=1e-4,
        bytes_per_token_per_layer=spec.bytes_per_token_per_layer)
    return ns.HybridPlanner(compute, ns.transport.LOCAL_DRAM,
                            session_setup=False)


class _Port:
    """The classes the port's stack is built from."""
    core, serving, sched = core, serving, scheduler
    compute, transport = compute_model, transport
    HybridPlanner = HybridPlanner


class _Ref:
    """The same for the reference's stack."""
    core, serving, sched = ref_core, ref_serving, ref_scheduler
    compute, transport = ref_compute_model, ref_transport
    HybridPlanner = ref_hybrid.HybridPlanner


def _engine(side, arch, codec="identity", theta=0, hybrid=False):
    ns = _Port if side == "port" else _Ref
    ref_model, ref_params, model, params = _bridged(arch)
    if side == "ref":
        model, params = ref_model, ref_params
    spec = model.cfg.kv_spec(G, dtype_bytes=4, codec=codec)
    kw = {}
    if hybrid:
        kw = dict(bandwidth_cap=1.28e6, hybrid=_planner(ns, spec))
    store = ns.core.InMemoryStore()
    orch = ns.serving.Orchestrator(ns.core.RadixIndex(G),
                                   ns.core.Gateway(store), spec,
                                   theta_bytes=theta, **kw)
    return ns.serving.ServingEngine(model, params, orch), store


def _prompts(seed=7, n_shared=32):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 200, size=n_shared)
    cold = np.concatenate([shared, rng.integers(0, 200, size=8)])
    warm = np.concatenate([shared, rng.integers(0, 200, size=12)])
    return cold, warm


class TestEngine:
    """The port's `ServingEngine` and the reference's on the same prompts:
    delivery, matched tokens and greedy tokens equal, logits within TOL."""

    CASES = [(QWEN, "identity", 0, False, "LAYERWISE"),
             (QWEN, "int8", 0, False, "LAYERWISE"),
             (QWEN, "int4", 0, False, "LAYERWISE"),
             (LLAMA4, "identity", 0, False, "CHUNKWISE"),
             (LLAMA4, "int8", 0, False, "CHUNKWISE"),
             (LLAMA4, "identity", 0, True, "CHUNKWISE"),
             (QWEN, "identity", 1 << 60, False, "CHUNKWISE")]

    @pytest.mark.parametrize("arch,codec,theta,hybrid,delivery", CASES)
    def test_warm_hit_matches_reference(self, arch, codec, theta, hybrid,
                                        delivery):
        cold, warm = _prompts()
        out = {}
        for side in ("ref", "port"):
            engine, store = _engine(side, arch, codec, theta, hybrid)
            c = engine.submit(cold, "cold", max_new_tokens=3)
            w = engine.submit(warm, "warm", max_new_tokens=3)
            out[side] = (c, w, store.stats.snapshot()["bytes_written"],
                         engine.orch.stats.snapshot())
        (rc, rw, rbytes, rstats), (pc, pw, pbytes, pstats) = \
            out["ref"], out["port"]
        assert pw.delivery.name == rw.delivery.name == delivery
        assert pw.matched_tokens == rw.matched_tokens
        if hybrid:  # a strict sub-span of the 32 matched tokens was fetched
            assert pstats["hybrid_splits"] == rstats["hybrid_splits"] == 1
            assert 0 < pw.matched_tokens < 32
        else:
            assert pw.matched_tokens == 32
        _close(pc.logits, rc.logits, f"engine {arch} {codec} cold")
        _close(pw.logits, rw.logits, f"engine {arch} {codec} warm")
        assert pc.new_tokens == rc.new_tokens
        assert pw.new_tokens == rw.new_tokens
        assert pbytes == rbytes

    def test_layerwise_equals_chunkwise_bitwise(self):
        """The same warm prompt through the per-layer steps and through one
        chunkwise prefill: the same ops at the same shapes on the same
        bytes, so the same bits."""
        cold, warm = _prompts()
        logits = {}
        for theta in (0, 1 << 60):
            engine, _ = _engine("port", QWEN, "int8", theta)
            engine.submit(cold, "cold")
            logits[theta] = engine.submit(warm, "warm").logits
        np.testing.assert_array_equal(logits[0], logits[1 << 60])

    @pytest.mark.parametrize("arch", ref_list_archs(include_extra=True))
    def test_layerwise_gate_matches_reference(self, arch):
        ref_cfg = ref_get_smoke(arch)
        ref_model = ref_build_model(ref_cfg)
        ref_orch = ref_serving.Orchestrator(
            ref_core.RadixIndex(G), ref_core.Gateway(ref_core.InMemoryStore()),
            ref_cfg.kv_spec(G, dtype_bytes=4))
        want = ref_serving.ServingEngine(ref_model, None,
                                         ref_orch)._layerwise_ok
        assert serving.engine.layerwise_ok(get_smoke_config(arch)) == want

    @pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b",
                                      "whisper-large-v3"])
    def test_stateful_families_refused(self, arch):
        cfg = get_smoke_config(arch)
        orch = serving.Orchestrator(core.RadixIndex(G),
                                    core.Gateway(core.InMemoryStore()),
                                    cfg.kv_spec(G, dtype_bytes=4))
        with pytest.raises(ValueError, match="model level"):
            serving.ServingEngine(build_model(cfg, device="cpu"), {}, orch)


class TestAsync:
    """`AsyncEngine` on the MoE smoke model: its virtual timeline equals
    the port's `ClusterSim`, its logits are within TOL of the reference's
    `AsyncEngine` and bit-equal to the port's sequential engine."""

    def _stack(self, side):
        ns = _Port if side == "port" else _Ref
        ref_model, ref_params, model, params = _bridged(QWEN)
        if side == "ref":
            model, params = ref_model, ref_params
        spec = model.cfg.kv_spec(G, dtype_bytes=4, codec="int8")
        comp = ns.compute.PaperComputeModel(num_layers=spec.num_layers)
        cap = 2.0 * 4 * spec.mean_wire_layer_bytes \
            / comp.layer_compute_s(36, 32 / 36)
        pool = ns.sched.BandwidthPool(cap, ns.sched.Policy.CAL_STALL_OPT)
        orch = ns.serving.Orchestrator(
            ns.core.RadixIndex(G), ns.core.Gateway(ns.core.InMemoryStore()),
            spec, theta_bytes=0, pool=pool,
            clock=ns.transport.VirtualClock())
        seq = ns.serving.ServingEngine(model, params, orch)
        eng = ns.serving.AsyncEngine(model, params, orch, compute=comp,
                                     profile=ns.transport.S3_RDMA_AGG,
                                     session_setup=True)
        return seq, eng, spec, comp, cap

    def test_matches_cluster_sim_and_reference(self):
        rng = np.random.default_rng(11)
        warm = [rng.integers(0, 200, size=4 * G) for _ in range(3)]
        prompts = [np.concatenate([w, rng.integers(0, 200, size=4)])
                   for w in warm]
        arrivals = [0.0, 0.001, 0.0025]
        results = {}
        for side in ("ref", "port"):
            ns = _Port if side == "port" else _Ref
            seq, eng, spec, comp, cap = self._stack(side)
            for i, w in enumerate(warm):
                seq.submit(w, req_id=f"warm{i}")
            reqs = [ns.serving.AsyncRequest(f"r{i}", tuple(map(int, p)),
                                            arrivals[i], max_new_tokens=3)
                    for i, p in enumerate(prompts)]
            results[side] = eng.serve(reqs)
        port, ref = results["port"], results["ref"]
        trace = [TraceRequest(f"r{i}", arrivals[i], 36, 32 / 36,
                              chunk_tokens=G) for i in range(3)]
        oracle = ClusterSim(cap_bps=cap,
                            policy=scheduler.Policy.CAL_STALL_OPT,
                            compute=comp, profile=transport.S3_RDMA_AGG,
                            spec=spec, mode="layerwise",
                            session_setup=True).run(trace).by_id()
        # a fresh port stack warmed the same way, served one at a time
        seq_eng = self._stack("port")[0]
        for i, w in enumerate(warm):
            seq_eng.submit(w, req_id=f"warm{i}")
        for i, p in enumerate(prompts):
            rid = f"r{i}"
            r, w = port[rid], ref[rid]
            assert r.delivery is Delivery.LAYERWISE
            assert r.matched_tokens == w.matched_tokens == 4 * G
            for f in ("admit_s", "flow_done_s", "prefill_done_s", "ttft_s"):
                assert getattr(r.record, f) == pytest.approx(
                    getattr(oracle[rid], f), rel=1e-9, abs=1e-9), (rid, f)
            _close(r.logits, w.logits, f"async {rid} vs reference")
            assert r.new_tokens == w.new_tokens
            s = seq_eng.submit(p, req_id=rid, max_new_tokens=3)
            np.testing.assert_array_equal(s.logits, r.logits)
            assert s.new_tokens == r.new_tokens
