"""The port's training forward against the JAX reference: the loss of every
family and every gradient leaf, the cross-entropy, remat, and the MoE
capacity dispatch.

Models: the fp32 smoke configs of the ten assigned archs and llama3-1-8b,
reference-initialised and bridged.  The reference's gradients come from
``jax.value_and_grad(model.loss)``, the port's from ``torch.autograd``.
Tolerances: loss within LOSS_RTOL = 1e-5 relative; each gradient leaf
within GRAD_TOL = 1e-4 of its largest |value| (two fp32 implementations
that sum in other orders; measured at most a few 1e-6, printed per arch).
The port's ``remat=True`` is held bit-equal to ``remat=False``.
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
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch.bridge import params_from_reference  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.models import build_model, dense, moe  # noqa: E402
from repro_torch.models import layers as nn  # noqa: E402
from repro_torch.training.tree import (tree_leaves,  # noqa: E402
                                       tree_unflatten)
from repro_torch.training.train_step import value_and_grad  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
ALL_ARCHS = ARCH_IDS + ["llama3-1-8b"]
QWEN, LLAMA4 = "qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b"


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _bridged(arch):
    """(reference model, reference params, port model, port params)."""
    ref_model = ref_build_model(ref_get_smoke(arch))
    ref_params = jax.jit(ref_model.init_params)(jax.random.PRNGKey(0))
    params = params_from_reference(jax.tree.map(np.asarray, ref_params),
                                   device="cpu")
    return (ref_model, ref_params,
            build_model(get_smoke_config(arch), device="cpu"), params)


def _batch(cfg, seed, B=2, S=16, mask=False):
    """(reference batch, port batch) of the same numpy arrays: tokens and
    next-token labels; audio frames for encdec (8 tokens over 12 frames) and
    patches for vlm, as the reference's arch smoke test builds them."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        S = 8
    seq = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    b = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    if cfg.family == "encdec":
        b["embeds"] = rng.standard_normal((B, 12, cfg.d_model), np.float32)
    elif cfg.family == "vlm":
        b["embeds"] = rng.standard_normal((B, cfg.num_patches, cfg.d_model),
                                          np.float32)
    if mask:
        b["loss_mask"] = (rng.random((B, S)) < 0.6).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: _t(v) for k, v in b.items()})


def _ref_value_and_grad(ref_model, ref_params, batch, **kw):
    loss_fn = lambda p: ref_model.loss(p, batch, **kw)  # noqa: E731
    return jax.jit(jax.value_and_grad(loss_fn))(ref_params)


def _assert_grads(got, want, what):
    """Each leaf within GRAD_TOL of its largest |value|; prints the largest
    difference relative to that."""
    want = jax.tree.leaves(want)
    got = tree_leaves(got)
    assert len(got) == len(want)
    worst = 0.0
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        g = g.numpy()
        assert g.shape == w.shape
        scale = max(float(np.abs(w).max()), 1e-30)
        diff = float(np.abs(g - w).max())
        worst = max(worst, diff / scale)
        assert diff <= GRAD_TOL * scale, (what, diff, scale)
    print(f"{what}: {len(got)} leaves, max |dgrad| / max|grad| {worst:.3g}")


class TestCrossEntropy:
    @pytest.mark.parametrize("mask", [False, True])
    def test_against_reference(self, mask):
        rng = np.random.default_rng(0)
        lg = rng.standard_normal((2, 7, 33)).astype(np.float32) * 3
        labels = rng.integers(0, 33, size=(2, 7)).astype(np.int32)
        m = (rng.random((2, 7)) < 0.5).astype(np.float32) if mask else None
        want = ref_layers.cross_entropy(
            jnp.asarray(lg), jnp.asarray(labels),
            None if m is None else jnp.asarray(m))
        got = nn.cross_entropy(_t(lg), _t(labels),
                               None if m is None else _t(m))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)

    def test_empty_mask_divides_by_one(self):
        lg = torch.zeros((1, 3, 5))
        got = nn.cross_entropy(lg, torch.zeros((1, 3), dtype=torch.int32),
                               torch.zeros((1, 3)))
        assert float(got) == 0.0

    def test_padded_vocab_gets_zero_gradient(self):
        """`logits` masks the padded vocab in place after the product:
        autograd takes it, and those columns pass no gradient back."""
        cfg = get_smoke_config("smollm-135m")
        cfg = dataclasses.replace(cfg, vocab_size=cfg.vocab_size - 5)
        assert cfg.padded_vocab > cfg.vocab_size
        table = torch.randn((cfg.padded_vocab, cfg.d_model),
                            requires_grad=True)
        x = torch.randn((2, 3, cfg.d_model))
        lg = nn.logits({"table": table}, cfg, x)
        loss = nn.cross_entropy(lg, torch.zeros((2, 3), dtype=torch.long))
        (g,) = torch.autograd.grad(loss, table)
        assert torch.all(g[cfg.vocab_size:] == 0)
        assert torch.any(g[:cfg.vocab_size] != 0)


class TestUnstack:
    def test_views_of_each_layer(self):
        tree = {"a": torch.arange(6.).reshape(3, 2),
                "b": {"c": torch.arange(3.)}}
        parts = dense.unstack(tree)
        assert len(parts) == 3
        assert torch.equal(parts[1]["a"], tree["a"][1])
        assert float(parts[2]["b"]["c"]) == 2.0
        assert dense.unstack({"a": torch.zeros((0, 4))}) == []

    def test_backward_is_one_stack(self):
        """The gradient of a stacked leaf through its per-layer slices is the
        same as through indexing, and comes from one unbind node."""
        w = torch.randn((4, 3, 3), requires_grad=True)
        x = torch.randn(3)
        y = x
        for p in dense.unstack({"w": w}):
            y = y @ p["w"]
        (g,) = torch.autograd.grad(y.sum(), w)
        w2 = w.detach().clone().requires_grad_(True)
        y = x
        for i in range(4):
            y = y @ w2[i]
        (g2,) = torch.autograd.grad(y.sum(), w2)
        torch.testing.assert_close(g, g2, rtol=0, atol=0)


class TestLossAndGrads:
    @pytest.mark.parametrize("arch", ALL_ARCHS)
    def test_against_reference(self, arch):
        ref_model, ref_params, model, params = _bridged(arch)
        rb, pb = _batch(model.cfg, 1)
        want_l, want_g = _ref_value_and_grad(ref_model, ref_params, rb)
        got_l, got_g = value_and_grad(model, params, pb)
        print(f"{arch}: loss {float(got_l):.7f} reference "
              f"{float(want_l):.7f}")
        np.testing.assert_allclose(float(got_l), float(want_l),
                                   rtol=LOSS_RTOL)
        _assert_grads(got_g, want_g, arch)

    @pytest.mark.parametrize("arch", ALL_ARCHS)
    def test_remat_is_bit_equal(self, arch):
        _, _, model, params = _bridged(arch)
        _, pb = _batch(model.cfg, 2)
        l0, g0 = value_and_grad(model, params, pb, remat=False)
        l1, g1 = value_and_grad(model, params, pb, remat=True)
        assert torch.equal(l0, l1)
        for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("arch", ["smollm-135m", "internvl2-26b"])
    def test_loss_mask(self, arch):
        """A loss mask over the text positions (vlm: after the patches)."""
        ref_model, ref_params, model, params = _bridged(arch)
        rb, pb = _batch(model.cfg, 3, mask=True)
        want_l, want_g = _ref_value_and_grad(ref_model, ref_params, rb)
        got_l, got_g = value_and_grad(model, params, pb)
        np.testing.assert_allclose(float(got_l), float(want_l),
                                   rtol=LOSS_RTOL)
        _assert_grads(got_g, want_g, f"{arch} masked")

    def test_grad_is_zero_for_unrouted_experts(self):
        """An expert no token routes to gets an exact zero gradient (its
        slice of the unbind's stack), as the reference's does."""
        _, _, model, params = _bridged(QWEN)
        _, pb = _batch(model.cfg, 4, B=1, S=1)  # 1 token: k of E experts
        _, g = value_and_grad(model, params, pb)
        per_expert = g["layers"]["moe"]["wi_gate"].abs().sum(dim=(2, 3))
        used = (per_expert != 0).sum(dim=1)
        assert torch.all(used == model.cfg.experts_per_token), used


_NO_CYCLE = r"""
import gc, sys, weakref
import torch
from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model
from repro_torch.training.train_step import value_and_grad
gc.disable()
model = build_model(get_smoke_config("llama3-1-8b"), device="cpu")
params = model.init_params(torch.Generator().manual_seed(0))
tokens = torch.randint(0, 500, (2, 16))
loss, grads = value_and_grad(model, params, {"tokens": tokens,
                                             "labels": tokens}, remat=True)
alive = weakref.ref(params["layers"]["mlp"]["wo"]["w"])
del params, loss, grads
sys.exit(1 if alive() is not None else 0)
"""


def test_first_remat_call_keeps_no_tensor_alive():
    """In a fresh process with the garbage collector off, the first remat
    call's parameters are freed once the caller drops them (``checkpoint``'s
    first call would otherwise import ``torch._dynamo`` and leave a
    reference cycle through the calling frames)."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", _NO_CYCLE], timeout=300,
                       env=dict(os.environ,
                                PYTHONPATH=os.path.join(root, "src")),
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


# the same through a model's own loss, with no training module imported
_NO_CYCLE_LOSS = r"""
import gc, sys, weakref
import torch
from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model
gc.disable()
model = build_model(get_smoke_config("llama3-1-8b"), device="cpu")
params = model.init_params(torch.Generator().manual_seed(0))
tokens = torch.randint(0, 500, (2, 16))
for leaf in (params["layers"]["mlp"]["wo"]["w"], params["embed"]["table"]):
    leaf.requires_grad_(True)
loss = model.loss(params, {"tokens": tokens, "labels": tokens}, remat=True)
loss.backward()
assert "repro_torch.training" not in sys.modules
assert params["layers"]["mlp"]["wo"]["w"].grad is not None
alive = weakref.ref(params["layers"]["mlp"]["wo"]["w"])
del params, loss
sys.exit(1 if alive() is not None else 0)
"""


def test_first_remat_loss_keeps_no_tensor_alive():
    """`test_first_remat_call_keeps_no_tensor_alive` through `Model.loss`
    with ``remat=True`` called directly, ``repro_torch.training`` never
    imported."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", _NO_CYCLE_LOSS], timeout=300,
                       env=dict(os.environ,
                                PYTHONPATH=os.path.join(root, "src")),
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


def _layer0_moe(arch):
    _, ref_params, model, params = _bridged(arch)
    if model.cfg.moe_every == 1:
        return (jax.tree.map(lambda a: a[0], ref_params["layers"]["moe"]),
                dense.take(params["layers"]["moe"], 0))
    return (jax.tree.map(lambda a: a[0], ref_params["layers"]["moe"]["moe"]),
            dense.take(params["layers"]["moe"]["moe"], 0))


def _reference_kept(topi, E, C):
    """The reference's keep rule, in numpy: stable sort by expert, rank
    within the expert's segment, kept below C; per flat (token, rank)."""
    flat = np.asarray(topi).reshape(-1)
    order = np.argsort(flat, kind="stable")
    rank = np.empty_like(flat)
    for e in range(E):
        idx = order[flat[order] == e]
        rank[idx] = np.arange(len(idx))
    return rank < C


class TestCapacityDispatch:
    """`moe_mlp(..., "capacity")` against the reference's at capacity
    factors where tokens drop (0.5, 1.0) and where none can (E: C = T*k).
    Tolerance 1e-5 absolute (outputs of size ~1; measured ~1e-7)."""

    @pytest.mark.parametrize("arch", [QWEN, LLAMA4])
    @pytest.mark.parametrize("factor", [0.5, 1.0])
    def test_same_drops_and_output(self, arch, factor):
        ref_p, p = _layer0_moe(arch)
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  capacity_factor=factor)
        ref_cfg = dataclasses.replace(ref_get_smoke(arch),
                                      capacity_factor=factor)
        x = np.random.default_rng(5).standard_normal(
            (2, 24, cfg.d_model)).astype(np.float32)
        want, want_aux = ref_moe.moe_mlp(ref_p, ref_cfg, jnp.asarray(x),
                                         "capacity")
        got, aux = moe.moe_mlp(p, cfg, _t(x), "capacity")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
        # the dropped (token, rank) pairs are the reference's
        E, k, T = cfg.num_experts, cfg.experts_per_token, 48
        C = max(1, int(T * k / E * factor))
        _, topi, _ = moe._route(p, cfg, _t(x).reshape(T, -1))
        order, slot = moe.capacity_slots(topi, E, C)
        kept = np.empty(T * k, bool)
        kept[order.numpy()] = (slot < E * C).numpy()
        want_kept = _reference_kept(topi.numpy(), E, C)
        np.testing.assert_array_equal(kept, want_kept)
        print(f"{arch} factor {factor}: C={C}, "
              f"{int((~kept).sum())} of {T * k} pairs dropped")
        if factor == 0.5:
            assert (~kept).sum() > 0

    @pytest.mark.parametrize("arch", [QWEN, LLAMA4])
    def test_no_drops_equals_ragged(self, arch):
        _, p = _layer0_moe(arch)
        cfg = get_smoke_config(arch)
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
        x = _t(np.random.default_rng(6).standard_normal(
            (2, 24, cfg.d_model)).astype(np.float32))
        cap, _ = moe.moe_mlp(p, cfg, x, "capacity")
        rag, _ = moe.moe_mlp(p, cfg, x, "ragged")
        torch.testing.assert_close(cap, rag, rtol=0, atol=1e-6)

    @pytest.mark.parametrize("arch", [QWEN, LLAMA4])
    def test_grads_against_reference(self, arch):
        """d(sum of outputs * r)/d(x, every expert weight) with drops."""
        ref_p, p = _layer0_moe(arch)
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  capacity_factor=0.5)
        ref_cfg = dataclasses.replace(ref_get_smoke(arch),
                                      capacity_factor=0.5)
        rng = np.random.default_rng(7)
        x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
        r = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)

        def ref_f(pp, xx):
            y, aux = ref_moe.moe_mlp(pp, ref_cfg, xx, "capacity")
            return jnp.sum(y * r) + aux
        want_gp, want_gx = jax.grad(ref_f, argnums=(0, 1))(
            ref_p, jnp.asarray(x))
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in tree_leaves(p)]
        pp = tree_unflatten(p, leaves)
        xx = _t(x).requires_grad_(True)
        y, aux = moe.moe_mlp(pp, cfg, xx, "capacity")
        gs = torch.autograd.grad(torch.sum(y * _t(r)) + aux, leaves + [xx])
        _assert_grads(tree_unflatten(p, gs[:-1]), want_gp,
                      f"{arch} capacity params")
        np.testing.assert_allclose(gs[-1].numpy(), np.asarray(want_gx),
                                   rtol=0, atol=GRAD_TOL * float(
                                       np.abs(np.asarray(want_gx)).max()))

    def test_same_bits_on_every_call(self):
        _, p = _layer0_moe(QWEN)
        cfg = dataclasses.replace(get_smoke_config(QWEN), capacity_factor=0.5)
        x = _t(np.random.default_rng(8).standard_normal(
            (1, 40, cfg.d_model)).astype(np.float32))
        a, _ = moe.moe_mlp(p, cfg, x, "capacity")
        b, _ = moe.moe_mlp(p, cfg, x, "capacity")
        assert torch.equal(a, b)

    @pytest.mark.parametrize("arch", [QWEN, LLAMA4])
    def test_loss_with_capacity_dispatch(self, arch):
        """`moe.loss(..., dispatch="capacity")` (the reference's training
        dispatch) and its gradients against the reference's."""
        ref_model, ref_params, model, params = _bridged(arch)
        rb, pb = _batch(model.cfg, 9)
        want_l, want_g = jax.jit(jax.value_and_grad(
            lambda pp: ref_moe.loss(pp, ref_model.cfg, rb,
                                    dispatch="capacity")))(ref_params)
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        loss = moe.loss(tree_unflatten(params, leaves), model.cfg, pb,
                        dispatch="capacity")
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True,
                                    allow_unused=True)
        np.testing.assert_allclose(float(loss.detach()), float(want_l),
                                   rtol=LOSS_RTOL)
        _assert_grads(tree_unflatten(params, grads), want_g,
                      f"{arch} capacity loss")
