"""The port's state-space (Mamba2), hybrid (Zamba2) and encoder-decoder
(Whisper) families against the JAX reference, and every family's cache
layout.

Models: the fp32 smoke configs of ``mamba2-2.7b`` (SSD chunk 8),
``zamba2-1.2b`` (8 Mamba layers, the shared block every 3: lead 2, two
groups) and ``whisper-large-v3`` (2 + 2 layers, 12 stub frames),
reference-initialised and bridged.  Inputs from numpy seeds.  Tolerance:
TOL = 1e-4 on activations, logits and caches (the reference's own cache-hit
bound: two fp32 implementations sum in other orders).
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as ref_get_smoke  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import encdec as ref_encdec  # noqa: E402
from repro.models import layers as ref_nn  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro_torch.bridge import params_from_reference  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import build_model, dense, encdec, ssm  # noqa: E402
from repro_torch.models import layers as nn  # noqa: E402

TOL = 1e-4
MAMBA, ZAMBA, WHISPER = "mamba2-2.7b", "zamba2-1.2b", "whisper-large-v3"
B = 2


def _close(got, want, what):
    """Every leaf of ``got`` (tensors, nested in dicts) within TOL of the
    same leaf of ``want``; prints the largest difference."""
    if isinstance(want, dict):
        assert set(got) == set(want), (what, set(got), set(want))
        for k in want:
            _close(got[k], want[k], f"{what}[{k}]")
        return
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    diff = float(np.abs(got - want).max()) if got.size else 0.0
    print(f"max_abs_diff {what}: {diff:.3g}")
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@functools.lru_cache(maxsize=None)
def _bridged(arch):
    """(reference model, reference params, port model, port params)."""
    ref_model = ref_build_model(ref_get_smoke(arch))
    ref_params = jax.jit(ref_model.init_params)(jax.random.PRNGKey(0))
    params = params_from_reference(jax.tree.map(np.asarray, ref_params),
                                   device="cpu")
    return (ref_model, ref_params,
            build_model(get_smoke_config(arch), device="cpu"), params)


def _t(tree):
    """numpy / jax arrays (nested in dicts) -> torch tensors (copies)."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _tokens(seed, S):
    return np.random.default_rng(seed).integers(0, 256, size=(B, S))


def _batch(tokens, embeds=None):
    ref = {"tokens": jnp.asarray(tokens)}
    port = {"tokens": _t(tokens)}
    if embeds is not None:
        ref["embeds"], port["embeds"] = jnp.asarray(embeds), _t(embeds)
    return ref, port


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------
class TestBlocks:
    def test_layernorm(self):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
        p = {"scale": rng.standard_normal(64).astype(np.float32),
             "bias": rng.standard_normal(64).astype(np.float32)}
        want = ref_nn.layernorm(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
        _close(nn.layernorm(_t(p), _t(x)), want, "layernorm")

    @pytest.mark.parametrize("with_h0", [False, True])
    def test_ssd_chunked(self, with_h0):
        rng = np.random.default_rng(1)
        b, s, h, p, n = 2, 24, 3, 4, 5
        x = rng.standard_normal((b, s, h, p)).astype(np.float32)
        dt = rng.uniform(0.01, 0.2, (b, s, h)).astype(np.float32)
        A = -rng.uniform(1.0, 4.0, (h,)).astype(np.float32)
        Bm = rng.standard_normal((b, s, n)).astype(np.float32)
        Cm = rng.standard_normal((b, s, n)).astype(np.float32)
        h0 = rng.standard_normal((b, h, n, p)).astype(np.float32) \
            if with_h0 else None
        args = (x, dt, A, Bm, Cm)
        wy, ws = ref_ssm.ssd_chunked(*map(jnp.asarray, args), 8,
                                     None if h0 is None else jnp.asarray(h0))
        gy, gs = ssm.ssd_chunked(*map(_t, args), 8,
                                 None if h0 is None else _t(h0))
        _close(gy, wy, f"ssd_chunked y h0={with_h0}")
        _close(gs, ws, f"ssd_chunked state h0={with_h0}")

    def test_chunked_equals_recurrent(self):
        """The chunked scan and the one-token recurrence give the same
        outputs and final state (the port against itself)."""
        rng = np.random.default_rng(2)
        b, s, h, p, n = 1, 16, 2, 4, 3
        x = _t(rng.standard_normal((b, s, h, p)).astype(np.float32))
        dt = _t(rng.uniform(0.01, 0.2, (b, s, h)).astype(np.float32))
        A = _t(-rng.uniform(1.0, 4.0, (h,)).astype(np.float32))
        Bm = _t(rng.standard_normal((b, s, n)).astype(np.float32))
        Cm = _t(rng.standard_normal((b, s, n)).astype(np.float32))
        y, final = ssm.ssd_chunked(x, dt, A, Bm, Cm, 8)
        state = torch.zeros((b, h, n, p))
        for t in range(s):
            yt, state = ssm.ssd_recurrent_step(x[:, t], dt[:, t], A,
                                               Bm[:, t], Cm[:, t], state)
            _close(yt, y[:, t].numpy(), f"recurrent y t={t}")
        _close(state, final.numpy(), "recurrent final state")

    def test_causal_conv_with_state(self):
        rng = np.random.default_rng(3)
        xBC = rng.standard_normal((B, 6, 10)).astype(np.float32)
        w = rng.standard_normal((4, 10)).astype(np.float32)
        b = rng.standard_normal(10).astype(np.float32)
        st = rng.standard_normal((B, 3, 10)).astype(np.float32)
        wo, ws = ref_ssm._causal_conv(*map(jnp.asarray, (xBC, w, b, st)))
        go, gs = ssm._causal_conv(*map(_t, (xBC, w, b, st)))
        _close(go, wo, "causal_conv out")
        _close(gs, ws, "causal_conv state")

    def test_sinusoids(self):
        _close(encdec.sinusoids(64, 64), ref_encdec.sinusoids(64, 64),
               "sinusoids")

    def test_sinusoids_at_whisper_frames(self):
        """At 1500 positions the fp32 angles reach 1499, whose rounding step
        is 2**-13: one step of ``inv`` or of the product moves sin/cos by up
        to that.  Bound: two such steps."""
        got = encdec.sinusoids(1500, 64).numpy()
        want = np.asarray(ref_encdec.sinusoids(1500, 64))
        diff = float(np.abs(got - want).max())
        print(f"max_abs_diff sinusoids(1500): {diff:.3g}")
        assert diff <= 2 * 2.0 ** -13, diff


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------
class TestMamba2:
    def test_prefill(self):
        ref_model, ref_params, model, params = _bridged(MAMBA)
        rb, pb = _batch(_tokens(4, 16))
        wl, wc = ref_model.prefill(ref_params, rb)
        gl, gc = model.prefill(params, pb)
        _close(gl, wl, "mamba2 prefill logits")
        _close(gc, wc, "mamba2 prefill state")

    def test_prefill_with_prefix_state(self):
        ref_model, ref_params, model, params = _bridged(MAMBA)
        tokens = _tokens(5, 24)
        rb, pb = _batch(tokens[:, :8])
        _, ref_state = ref_model.prefill(ref_params, rb)
        _, state = model.prefill(params, pb)
        rb, pb = _batch(tokens[:, 8:])
        wl, wc = ref_model.prefill(ref_params, rb, ref_state, 8)
        gl, gc = model.prefill(params, pb, state, 8)
        _close(gl, wl, "mamba2 prefill(prefix_state) logits")
        _close(gc, wc, "mamba2 prefill(prefix_state) state")
        # the continuation is the full prefill (the port against itself)
        full, _ = model.prefill(params, _batch(tokens)[1])
        _close(gl, full.numpy(), "mamba2 8 + 16 vs 24 tokens")

    def test_decode_step(self):
        ref_model, ref_params, model, params = _bridged(MAMBA)
        cfg = model.cfg
        rng = np.random.default_rng(6)
        cache = jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32),
            ref_model.init_cache(B, 0))
        token = rng.integers(0, cfg.vocab_size, size=(B, 1))
        pos = np.array([5, 9])
        wl, wc = ref_model.decode_step(
            ref_params, jax.tree.map(jnp.asarray, cache), jnp.asarray(token),
            jnp.asarray(pos, jnp.int32))
        gl, gc = model.decode_step(params, _t(cache), _t(token), _t(pos))
        _close(gl, wl, "mamba2 decode logits")
        _close(gc, wc, "mamba2 decode state")


class TestZamba2:
    def test_prefill(self):
        ref_model, ref_params, model, params = _bridged(ZAMBA)
        rb, pb = _batch(_tokens(7, 16))
        wl, wc = ref_model.prefill(ref_params, rb)
        gl, gc = model.prefill(params, pb)
        _close(gl, wl, "zamba2 prefill logits")
        _close(gc, wc, "zamba2 prefill cache")

    def test_prefill_with_prefix_cache(self):
        ref_model, ref_params, model, params = _bridged(ZAMBA)
        tokens = _tokens(8, 24)
        rb, pb = _batch(tokens[:, :8])
        _, ref_cache = ref_model.prefill(ref_params, rb)
        _, cache = model.prefill(params, pb)
        rb, pb = _batch(tokens[:, 8:])
        wl, wc = ref_model.prefill(ref_params, rb, ref_cache, 8)
        gl, gc = model.prefill(params, pb, cache, 8)
        _close(gl, wl, "zamba2 prefill(prefix_cache) logits")
        _close(gc, wc, "zamba2 prefill(prefix_cache) cache")
        full, _ = model.prefill(params, _batch(tokens)[1])
        _close(gl, full.numpy(), "zamba2 8 + 16 vs 24 tokens")

    def test_decode_step(self):
        ref_model, ref_params, model, params = _bridged(ZAMBA)
        cfg = model.cfg
        rng = np.random.default_rng(9)
        cache = jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32),
            ref_model.init_cache(B, 12))
        token = rng.integers(0, cfg.vocab_size, size=(B, 1))
        pos = np.array([5, 9])
        wl, wc = ref_model.decode_step(
            ref_params, jax.tree.map(jnp.asarray, cache), jnp.asarray(token),
            jnp.asarray(pos, jnp.int32))
        gl, gc = model.decode_step(params, _t(cache), _t(token), _t(pos))
        _close(gl, wl, "zamba2 decode logits")
        _close(gc, wc, "zamba2 decode cache")

    def test_each_application_keeps_its_own_kv(self):
        _, _, model, params = _bridged(ZAMBA)
        _, cache = model.prefill(params, _batch(_tokens(10, 8))[1])
        kv = cache["attn"]  # [G, 2, B, S, KV, dh]
        assert kv.shape[0] == 2 and not torch.equal(kv[0], kv[1])


class TestWhisper:
    def _embeds(self, seed):
        cfg = get_smoke_config(WHISPER)
        return np.random.default_rng(seed).standard_normal(
            (B, cfg.cross_kv_len, cfg.d_model)).astype(np.float32)

    def test_encode(self):
        ref_model, ref_params, model, params = _bridged(WHISPER)
        e = self._embeds(11)
        want = ref_encdec.encode(ref_params, ref_model.cfg, jnp.asarray(e))
        _close(encdec.encode(params, model.cfg, _t(e)), want, "encode")

    @pytest.mark.parametrize("P", [0, 8])
    def test_prefill(self, P):
        ref_model, ref_params, model, params = _bridged(WHISPER)
        cfg = model.cfg
        rng = np.random.default_rng(12)
        rb, pb = _batch(_tokens(13, 7), self._embeds(14))
        prefix = None
        if P:
            prefix = rng.standard_normal(
                (cfg.num_layers, 2, B, P, cfg.num_kv_heads, cfg.head_dim)
            ).astype(np.float32)
        wl, wc = ref_model.prefill(
            ref_params, rb, None if prefix is None else jnp.asarray(prefix), P)
        gl, gc = model.prefill(params, pb,
                               None if prefix is None else _t(prefix), P)
        _close(gl, wl, f"whisper prefill P={P} logits")
        _close(gc, wc, f"whisper prefill P={P} cache")

    def test_decode_step(self):
        ref_model, ref_params, model, params = _bridged(WHISPER)
        cfg = model.cfg
        rng = np.random.default_rng(15)
        cache = jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32),
            ref_model.init_cache(B, 12))
        token = rng.integers(0, cfg.vocab_size, size=(B, 1))
        pos = np.array([5, 9])
        wl, wc = ref_model.decode_step(
            ref_params, jax.tree.map(jnp.asarray, cache), jnp.asarray(token),
            jnp.asarray(pos, jnp.int32))
        gl, gc = model.decode_step(params, _t(cache), _t(token), _t(pos))
        _close(gl, wl, "whisper decode logits")
        _close(gc, wc, "whisper decode cache")

    def test_prefill_then_decode_equals_longer_prefill(self):
        """prefill(S-1) + decode_step(last token) == prefill(S) (the port
        against itself: the self-attention decode over the grown cache)."""
        _, _, model, params = _bridged(WHISPER)
        tokens, e = _tokens(16, 9), self._embeds(17)
        full, _ = model.prefill(params, _batch(tokens, e)[1])
        _, cache = model.prefill(params, _batch(tokens[:, :-1], e)[1])
        cache["self"] = torch.nn.functional.pad(cache["self"],
                                                (0, 0, 0, 0, 0, 1))
        lg, _ = model.decode_step(params, cache, _t(tokens[:, -1:]),
                                  torch.full((B,), 8))
        _close(lg, full.numpy(), "whisper prefill(8) + decode vs prefill(9)")


# one arch of each family
FAMILY_ARCHS = {"dense": "qwen3-0.6b", "vlm": "internvl2-26b",
                "moe": "qwen3-moe-30b-a3b", "ssm": MAMBA, "hybrid": ZAMBA,
                "encdec": WHISPER}


@pytest.mark.parametrize("family", list(FAMILY_ARCHS))
def test_init_cache_matches_reference(family):
    arch = FAMILY_ARCHS[family]
    assert get_smoke_config(arch).family == family
    want = ref_build_model(ref_get_smoke(arch)).init_cache(B, 12)
    got = build_model(get_smoke_config(arch), device="cpu").init_cache(B, 12)

    def layout(tree):
        if isinstance(tree, dict):
            return {k: layout(v) for k, v in tree.items()}
        return tuple(tree.shape), str(tree.dtype).split(".")[-1]
    assert layout(got) == layout(want)
    leaves = [got] if isinstance(got, torch.Tensor) else \
        [t for v in got.values() for t in
         (v.values() if isinstance(v, dict) else [v])]
    assert not any(bool(t.any()) for t in leaves)


def test_layer_slices_share_storage():
    """`dense.take` of a stacked tree is a view: no copy per layer."""
    _, _, _, params = _bridged(ZAMBA)
    p0 = dense.take(params["groups"], 0)
    assert p0["in_proj"]["w"].data_ptr() \
        == params["groups"]["in_proj"]["w"].data_ptr()
