"""The port's dense model against the JAX reference on the same inputs.

Parameters are initialised by the reference and bridged (a JAX PRNGKey cannot
be reproduced in torch); inputs come from numpy seeds.  Tolerance on logits
and activations: 1e-4 absolute, the reference's own bound for cache-hit
logits in fp32 (``tests/test_serving_engine.py``); the two frameworks sum in
other orders, so bit-equality is not expected.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import get_smoke_config as ref_get_smoke  # noqa: E402
from repro.configs.registry import _MODULES as REF_ARCH_MODULES  # noqa: E402
from repro.configs.registry import list_archs as ref_list_archs  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import dense as ref_dense  # noqa: E402
from repro.models import layers as ref_nn  # noqa: E402
from repro_torch.bridge import params_from_reference  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.registry import list_archs  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import dense, layers as nn  # noqa: E402

TOL = 1e-4


def _close(got, want, what):
    """Assert |got - want| <= TOL elementwise; prints the largest difference
    (shown with ``pytest -s``)."""
    got, want = np.asarray(got), np.asarray(want)
    diff = float(np.abs(got - want).max()) if got.size else 0.0
    print(f"max_abs_diff {what}: {diff:.3g}")
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


# GQA 8/2 untied (4 layers); qk-norm, tied; the bitwise-equality arch
ARCHS = ["llama3-1-8b", "qwen3-0.6b", "smollm-135m"]


@functools.lru_cache(maxsize=None)
def _bridged(arch: str):
    """Reference params (numpy tree) and their bridged torch copy."""
    cfg = ref_get_smoke(arch)
    ref_params = jax.jit(ref_build_model(cfg).init_params)(
        jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, ref_params)
    return ref_params, params_from_reference(np_params, device="cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


class TestLayers:
    def test_rmsnorm(self):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
        scale = rng.standard_normal(64).astype(np.float32)
        want = ref_nn.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
        got = nn.rmsnorm({"scale": _t(scale)}, _t(x))
        _close(got.numpy(), want, "rmsnorm")

    @pytest.mark.parametrize("pos_ndim", [1, 2])
    def test_rope(self, pos_ndim):
        rng = np.random.default_rng(1)
        x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
        pos = np.arange(100, 106)
        if pos_ndim == 2:
            pos = np.stack([pos, pos + 7])
        want = ref_nn.rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0)
        got = nn.rope(_t(x), _t(pos), 500_000.0)
        _close(got.numpy(), want, "rope")

    @pytest.mark.parametrize("arch", ARCHS)
    @pytest.mark.parametrize("with_prefix", [False, True])
    def test_attention(self, arch, with_prefix):
        cfg = get_smoke_config(arch)
        ref_params, params = _bridged(arch)
        rng = np.random.default_rng(2)
        B, S, P = 2, 6, 8 if with_prefix else 0
        x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        pos = P + np.arange(S)[None, :]
        kw_ref, kw = {}, {}
        if with_prefix:
            shape = (B, P, cfg.num_kv_heads, cfg.head_dim)
            pk = rng.standard_normal(shape).astype(np.float32)
            pv = rng.standard_normal(shape).astype(np.float32)
            kw_ref["prefix_kv"] = (jnp.asarray(pk), jnp.asarray(pv))
            kw["prefix_kv"] = (_t(pk), _t(pv))
        want, (wk, wv) = ref_nn.attention(
            _layer0(ref_params["layers"])["attn"], ref_get_smoke(arch),
            jnp.asarray(x), positions=jnp.asarray(pos), **kw_ref)
        got, (gk, gv) = nn.attention(
            dense.layer_params(params, 0)["attn"], cfg, _t(x),
            positions=_t(pos), **kw)
        what = f"attention {arch} prefix={with_prefix}"
        _close(got.numpy(), want, what)
        _close(gk.numpy(), wk, what + " k")
        _close(gv.numpy(), wv, what + " v")

    def test_blocked_variants_raise(self):
        """The blocked variants run: a blocked layer's attention equals the
        reference's blocked attention and the port's naive one (full
        coverage in tests/test_torch_blocked.py)."""
        cfg = dataclasses.replace(get_smoke_config("qwen3-0.6b"),
                                  attn_impl="blocked", attn_block_k=4)
        ref_params, params = _bridged("qwen3-0.6b")
        x = np.random.default_rng(3).standard_normal(
            (1, 8, cfg.d_model)).astype(np.float32)
        got, _ = nn.attention(dense.layer_params(params, 0)["attn"], cfg,
                              _t(x), positions=torch.arange(8))
        ref_cfg = dataclasses.replace(ref_get_smoke("qwen3-0.6b"),
                                      attn_impl="blocked", attn_block_k=4)
        want, _ = ref_nn.attention(
            jax.tree.map(lambda a: a[0], ref_params["layers"])["attn"],
            ref_cfg, jnp.asarray(x), positions=jnp.arange(8))
        _close(got.numpy(), np.asarray(want), "blocked attention")
        naive, _ = nn.attention(
            dense.layer_params(params, 0)["attn"],
            get_smoke_config("qwen3-0.6b"), _t(x), positions=torch.arange(8))
        _close(got.numpy(), naive.numpy(), "blocked vs naive")

    def test_padded_vocab_masked(self):
        cfg = get_smoke_config("llama3-1-8b")
        _, params = _bridged("llama3-1-8b")
        x = torch.ones((1, 1, cfg.d_model))
        lg = nn.logits(params["embed"], cfg, x)
        assert lg.shape[-1] == cfg.padded_vocab
        if cfg.padded_vocab != cfg.vocab_size:
            assert bool((lg[..., cfg.vocab_size:]
                         == torch.finfo(torch.float32).min).all())


class TestDense:
    @pytest.mark.parametrize("arch", ARCHS)
    @pytest.mark.parametrize("P", [0, 8])
    def test_prefill(self, arch, P):
        cfg, ref_cfg = get_smoke_config(arch), ref_get_smoke(arch)
        ref_params, params = _bridged(arch)
        rng = np.random.default_rng(3)
        B, S = 2, 7
        tokens = rng.integers(0, cfg.vocab_size, size=(B, S))
        prefix = None
        if P:
            prefix = rng.standard_normal(
                (cfg.num_layers, 2, B, P, cfg.num_kv_heads, cfg.head_dim)
            ).astype(np.float32)
        want_lg, want_kv = ref_dense.prefill(
            ref_params, ref_cfg, jnp.asarray(tokens),
            None if prefix is None else jnp.asarray(prefix), P)
        got_lg, got_kv = dense.prefill(
            params, cfg, _t(tokens), None if prefix is None else _t(prefix),
            P)
        _close(got_lg.numpy(), want_lg, f"prefill {arch} P={P} logits")
        _close(got_kv.numpy(), want_kv, f"prefill {arch} P={P} cache")

    @pytest.mark.parametrize("arch", ARCHS)
    def test_decode_step(self, arch):
        cfg, ref_cfg = get_smoke_config(arch), ref_get_smoke(arch)
        ref_params, params = _bridged(arch)
        rng = np.random.default_rng(4)
        B, S = 2, 12
        cache = rng.standard_normal(
            (cfg.num_layers, 2, B, S, cfg.num_kv_heads, cfg.head_dim)
        ).astype(np.float32)
        token = rng.integers(0, cfg.vocab_size, size=(B, 1))
        pos = np.array([5, 9])
        want_lg, want_cache = ref_dense.decode_step(
            ref_params, ref_cfg, jnp.asarray(cache), jnp.asarray(token),
            jnp.asarray(pos, jnp.int32))
        got_lg, got_cache = dense.decode_step(params, cfg, _t(cache.copy()),
                                              _t(token), _t(pos))
        _close(got_lg.numpy(), want_lg, f"decode_step {arch} logits")
        _close(got_cache.numpy(), want_cache, f"decode_step {arch} cache")

    def test_init_cache_matches_reference(self):
        cfg = get_smoke_config("llama3-1-8b")
        want = ref_dense.init_cache(ref_get_smoke("llama3-1-8b"), 2, 12)
        got = dense.init_cache(cfg, 2, 12, "cpu")
        assert tuple(got.shape) == want.shape
        assert got.dtype == torch.float32 and not bool(got.any())

    def test_init_shapes_match_reference(self):
        cfg = get_smoke_config("llama3-1-8b")
        ref_params, _ = _bridged("llama3-1-8b")
        ours = build_model(cfg, device="cpu").init_params(
            torch.Generator().manual_seed(0))
        ref_shapes = jax.tree.map(lambda a: tuple(a.shape), ref_params)

        def shapes(tree):
            if isinstance(tree, dict):
                return {k: shapes(v) for k, v in tree.items()}
            return tuple(tree.shape)
        assert shapes(ours) == ref_shapes
        # the reference's standard deviations: d_in ** -0.5 for wq
        w = ours["layers"]["attn"]["wq"]["w"]
        assert abs(float(w.std()) - cfg.d_model ** -0.5) < 0.1 * \
            cfg.d_model ** -0.5

    def test_cuda_without_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            build_model(get_smoke_config("qwen3-0.6b"), device="cuda")

    @pytest.mark.parametrize("arch", ref_list_archs(include_extra=True))
    def test_every_family_builds(self, arch):
        """`build_model` builds every arch of the registry, and its random
        parameters have the reference's tree, shapes and dtypes."""
        model = build_model(get_smoke_config(arch), device="cpu")
        ours = model.init_params(torch.Generator().manual_seed(0))
        ref_model = ref_build_model(ref_get_smoke(arch))
        want = jax.eval_shape(ref_model.init_params, jax.random.PRNGKey(0))

        def layout(tree):
            if isinstance(tree, dict):
                return {k: layout(v) for k, v in tree.items()}
            return tuple(tree.shape), str(tree.dtype).split(".")[-1]
        assert layout(ours) == layout(want)


class TestConfigs:
    @pytest.mark.parametrize("arch", [m.ARCH_ID for m in REF_ARCH_MODULES])
    @pytest.mark.parametrize("smoke", [False, True])
    def test_same_fields_and_values(self, arch, smoke):
        ref = (ref_get_smoke if smoke else ref_get_config)(arch)
        ours = (get_smoke_config if smoke else get_config)(arch)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert ours.padded_vocab == ref.padded_vocab
        assert ours.attn_layers == ref.attn_layers
        assert ours.param_count() == ref.param_count()
        assert dataclasses.asdict(ours.kv_spec(16, codec="int8")) \
            == dataclasses.asdict(ref.kv_spec(16, codec="int8"))

    def test_arch_lists_match(self):
        """The reference's archs in its order; then the port's own
        (latent attention, which the reference has not)."""
        assert list_archs() == ref_list_archs()
        assert list_archs(True) == ref_list_archs(True) + \
            ["deepseek-v2-lite"]


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", list_archs(True))
def test_param_spec_is_init_params_on_meta(arch):
    """`Model.param_spec` (no draw on the meta device) has the keys, shapes
    and dtypes of a CPU `init_params`, and leaves the generator it is given,
    and torch's default one, as they were."""
    model = build_model(get_smoke_config(arch), device="cpu")
    default = torch.default_generator.get_state()
    spec = {k: (tuple(v.shape), v.dtype, v.device.type)
            for k, v in _leaves(model.param_spec())}
    assert torch.equal(torch.default_generator.get_state(), default)
    params = model.init_params(torch.Generator().manual_seed(0))
    assert spec == {k: (tuple(v.shape), v.dtype, "meta")
                    for k, v in _leaves(params)}
    g = torch.Generator().manual_seed(3)
    before = g.get_state()
    model._mod.init_params(model.cfg, g, torch.device("meta"))
    assert torch.equal(g.get_state(), before)
