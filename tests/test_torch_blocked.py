"""The blocked attention variants of the port (``attn_impl="blocked"``,
``attn_seq_shard``, ``decode_impl="blocked"``) against the reference's
(``tests/test_perf_variants.py``'s counterpart) and against the port's
naive path, in fp32 on the same inputs.

Tolerances: 2e-5 on attention outputs and 2e-4 on gradients (the
reference's own bounds for blocked vs naive); model logits 2e-3 between
variants and 1e-4 between the port and the reference (the port's model
tests' bound); losses 2e-4 between variants.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as ref_get_smoke  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import layers as ref_nn  # noqa: E402
from repro_torch.bridge import params_from_reference  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as nn  # noqa: E402

ATTN_TOL = 2e-5
GRAD_TOL = 2e-4
VARIANT_TOL = 2e-3
REF_TOL = 1e-4
LOSS_TOL = 2e-4


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _qkv(seed, B, Sq, Sk, H, dh):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, dh), (B, Sk, H, dh), (B, Sk, H, dh))]


def _causal_mask(Sq, Sk, q_offset):
    iq = torch.arange(Sq)[:, None] + q_offset
    return (torch.arange(Sk)[None, :] <= iq)[None, None]


class TestBlockedAttention:
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("q_offset", [0, 8])
    def test_matches_reference_and_naive(self, causal, q_offset):
        B, Sq, H, dh = 2, 16, 4, 8
        q, k, v = _qkv(0, B, Sq, Sq + q_offset, H, dh)
        got = nn.attention_scores_blocked(_t(q), _t(k), _t(v), causal=causal,
                                          q_offset=q_offset, block_k=4)
        ref = ref_nn.attention_scores_blocked(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            q_offset=q_offset, block_k=4)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=ATTN_TOL, atol=ATTN_TOL)
        mask = _causal_mask(Sq, Sq + q_offset, q_offset) if causal else \
            torch.ones((1, 1, Sq, Sq + q_offset), dtype=torch.bool)
        naive = nn.attention_scores(_t(q), _t(k), _t(v), mask)
        np.testing.assert_allclose(got.numpy(), naive.numpy(),
                                   rtol=ATTN_TOL, atol=ATTN_TOL)

    @pytest.mark.parametrize("bk", [2, 4, 8, 16])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_block_size_invariance(self, bk, seed):
        q, k, v = (_t(a) for a in _qkv(seed, 1, 16, 16, 2, 8))
        a = nn.attention_scores_blocked(q, k, v, causal=True, q_offset=0,
                                        block_k=bk)
        b = nn.attention_scores_blocked(q, k, v, causal=True, q_offset=0,
                                        block_k=16)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=ATTN_TOL,
                                   atol=ATTN_TOL)

    def test_softcap_matches_reference(self):
        q, k, v = _qkv(2, 1, 16, 16, 2, 8)
        got = nn.attention_scores_blocked(_t(q) * 8, _t(k), _t(v),
                                          causal=True, q_offset=0,
                                          block_k=4, softcap=5.0)
        ref = ref_nn.attention_scores_blocked(
            jnp.asarray(q) * 8, jnp.asarray(k), jnp.asarray(v), causal=True,
            q_offset=0, block_k=4, softcap=5.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=ATTN_TOL, atol=ATTN_TOL)

    def test_gradients_match_naive_and_reference(self):
        """The rematerialised blocked backward == the naive backward."""
        qn, kn, vn = _qkv(3, 1, 8, 8, 2, 4)
        mask = _causal_mask(8, 8, 0)
        q1 = _t(qn).requires_grad_(True)
        nn.attention_scores(q1, _t(kn), _t(vn), mask).sum().backward()
        q2 = _t(qn).requires_grad_(True)
        nn.attention_scores_blocked(q2, _t(kn), _t(vn), causal=True,
                                    q_offset=0, block_k=4).sum().backward()
        np.testing.assert_allclose(q2.grad.numpy(), q1.grad.numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)
        g_ref = jax.grad(lambda q: ref_nn.attention_scores_blocked(
            q, jnp.asarray(kn), jnp.asarray(vn), causal=True, q_offset=0,
            block_k=4).sum())(jnp.asarray(qn))
        np.testing.assert_allclose(q2.grad.numpy(), np.asarray(g_ref),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)

    def test_ragged_key_length_raises(self):
        q, k, v = (_t(a) for a in _qkv(0, 1, 8, 10, 2, 4))
        with pytest.raises(ValueError):
            nn.attention_scores_blocked(q, k, v, causal=True, q_offset=2,
                                        block_k=4)


class TestBlockedDecode:
    @pytest.mark.parametrize("nb", [2, 4, 8])
    def test_matches_reference_and_naive(self, nb):
        B, H, KV, S, dh = 3, 4, 2, 32, 8
        rng = np.random.default_rng(1)
        q = rng.standard_normal((B, H, dh)).astype(np.float32)
        kc = rng.standard_normal((B, S, KV, dh)).astype(np.float32)
        vc = rng.standard_normal((B, S, KV, dh)).astype(np.float32)
        pos = np.array([5, 31, 16], np.int32)
        got = nn._decode_scores_blocked(_t(q), _t(kc), _t(vc),
                                        torch.from_numpy(pos).long(), nb)
        ref = ref_nn._decode_scores_blocked(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
            jnp.asarray(pos), nb)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=ATTN_TOL, atol=ATTN_TOL)
        mask = (torch.arange(S)[None, :] <= torch.from_numpy(pos)[:, None]
                .long())[:, None, None, :]
        naive = nn.attention_scores(
            _t(q)[:, None], nn._repeat_kv(_t(kc), H // KV),
            nn._repeat_kv(_t(vc), H // KV), mask)[:, 0]
        np.testing.assert_allclose(got.numpy(), naive.numpy(),
                                   rtol=ATTN_TOL, atol=ATTN_TOL)


def _opt(cfg, seq_shard=False):
    return dataclasses.replace(cfg, attn_impl="blocked", attn_block_k=8,
                               decode_impl="blocked", decode_blocks=4,
                               attn_seq_shard=seq_shard)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = ref_get_smoke(arch)
    p = jax.jit(ref_build_model(cfg).init_params)(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, p)


def _batch(cfg, B=2, S=16):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.family == "encdec":
        batch["embeds"] = rng.standard_normal(
            (B, 12, cfg.d_model)).astype(np.float32)
        batch["tokens"] = tokens[:, :8]
        batch["labels"] = tokens[:, :8]
    return batch


def _grow(cache, family, plen, n=4):
    """Pad every [.., .., B, plen, ...] fp KV cache by n positions (dim 3),
    as the reference's test does."""
    def g(a):
        if a.ndim >= 4 and a.shape[3] == plen and a.dtype.is_floating_point:
            pad = torch.zeros(a.shape[:3] + (n,) + a.shape[4:], dtype=a.dtype)
            return torch.cat([a, pad], dim=3)
        return a.clone()
    if family in ("dense", "vlm", "moe"):
        return g(cache)
    key = {"hybrid": "attn", "encdec": "self"}[family]
    out = {k: (v.clone() if isinstance(v, torch.Tensor) else
               {kk: vv.clone() for kk, vv in v.items()})
           for k, v in cache.items()}
    out[key] = g(cache[key])
    return out


def _ref_grow(cache, family, plen, n=4):
    def g(a):
        if a.ndim >= 4 and a.shape[3] == plen and \
                jnp.issubdtype(a.dtype, jnp.floating):
            pad = [(0, 0)] * a.ndim
            pad[3] = (0, n)
            return jnp.pad(a, pad)
        return a
    if family in ("dense", "vlm", "moe"):
        return g(cache)
    key = {"hybrid": "attn", "encdec": "self"}[family]
    return {**cache, key: g(cache[key])}


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen3-moe-30b-a3b",
                                  "zamba2-1.2b", "whisper-large-v3"])
class TestEndToEndVariants:
    def test_loss_prefill_decode(self, arch):
        """opt == base within the variant bounds, and the port's opt ==
        the reference's opt within REF_TOL."""
        base_cfg = get_smoke_config(arch)
        np_params = _ref_params(arch)
        params = params_from_reference(np_params, device="cpu")
        base = build_model(base_cfg, "cpu")
        opt = build_model(_opt(base_cfg), "cpu")
        ref_opt = ref_build_model(_opt(ref_get_smoke(arch)))
        nb = _batch(base_cfg)
        batch = {k: torch.from_numpy(v) for k, v in nb.items()}
        jb = {k: jnp.asarray(v) for k, v in nb.items()}

        l1 = float(base.loss(params, batch))
        l2 = float(opt.loss(params, batch))
        l_ref = float(ref_opt.loss(np_params, jb))
        assert abs(l1 - l2) < LOSS_TOL, (arch, l1, l2)
        assert abs(l2 - l_ref) < REF_TOL, (arch, l2, l_ref)

        pb = {k: v for k, v in batch.items() if k != "labels"}
        lg1, c1 = base.prefill(params, pb)
        lg2, c2 = opt.prefill(params, pb)
        lg_ref, c_ref = ref_opt.prefill(
            np_params, {k: v for k, v in jb.items() if k != "labels"})
        np.testing.assert_allclose(lg2.numpy(), lg1.numpy(),
                                   rtol=VARIANT_TOL, atol=VARIANT_TOL)
        np.testing.assert_allclose(lg2.numpy(), np.asarray(lg_ref),
                                   rtol=0, atol=REF_TOL)

        B, plen = nb["tokens"].shape
        tok = batch["tokens"][:, -1:]
        pos = torch.full((B,), plen, dtype=torch.int32)
        fam = base_cfg.family
        d1, _ = base.decode_step(params, _grow(c1, fam, plen), tok, pos)
        d2, _ = opt.decode_step(params, _grow(c2, fam, plen), tok, pos)
        d_ref, _ = ref_opt.decode_step(
            np_params, _ref_grow(c_ref, fam, plen), jnp.asarray(tok.numpy()),
            jnp.asarray(pos.numpy()))
        np.testing.assert_allclose(d2.numpy(), d1.numpy(),
                                   rtol=VARIANT_TOL, atol=VARIANT_TOL)
        np.testing.assert_allclose(d2.numpy(), np.asarray(d_ref),
                                   rtol=0, atol=REF_TOL)

    def test_seq_shard_is_a_no_op_without_a_mesh(self, arch):
        """O2 on plain tensors changes nothing, as a sharding constraint
        does nothing outside a mesh."""
        cfg = get_smoke_config(arch)
        params = params_from_reference(_ref_params(arch), device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
        a = build_model(_opt(cfg), "cpu").loss(params, batch)
        b = build_model(_opt(cfg, seq_shard=True), "cpu").loss(params, batch)
        assert torch.equal(a, b)
