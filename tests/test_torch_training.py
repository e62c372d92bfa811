"""The port's training substrate against the JAX reference: AdamW and its
schedule, the train step (remat, microbatches), the data pipeline,
checkpoints in both directions, the fault-tolerant supervisor, pod gradient
compression over 4 gloo ranks, and the launcher.

Tolerances (each test states its own beside the measured difference):
AdamW fp32 results within 1e-6 of each leaf's largest |value|, bf16 results
within one bf16 rounding step; five train steps within LOSS_RTOL of the
reference's loss and each parameter within STEP_TOL x lr x steps (Adam's
normalised step m/(sqrt(v)+eps) of an element whose gradient is near eps
differs between two fp32 gradient computations; measured 0.1% of lr x
steps); compression within the reference test's 2% x max|mean| + 1e-4 of
the fp32 mean, and int8 equal to the exact integer emulation.
"""
import functools
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.training as ref_training  # noqa: E402
import repro.training.checkpoint as ref_checkpoint  # noqa: E402
import repro.training.compression as ref_compression  # noqa: E402
import repro.training.optimizer as ref_optimizer  # noqa: E402
from repro.configs import get_smoke_config as ref_get_smoke  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro_torch.bridge import (params_from_reference,  # noqa: E402
                                tree_to_numpy)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import (AdamWConfig, SimulatedFailure,  # noqa
                                  SyntheticLM, TrainSupervisor, adamw_init,
                                  adamw_update, latest_step, make_train_step,
                                  restore_checkpoint, save_checkpoint)
from repro_torch.training import checkpoint, compression  # noqa: E402
from repro_torch.training import optimizer  # noqa: E402
from repro_torch.training.tree import (tree_leaves, tree_map,  # noqa: E402
                                       tree_unflatten, treedef_str)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
STEP_TOL = 0.01
ARCH = "smollm-135m"


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_np(words):
    """uint16 words -> the reference's bf16 array."""
    return np.asarray(words).view(jnp.bfloat16)


def _as_f32(leaf):
    """A port leaf (tensor) or a reference leaf -> float32 numpy."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().float().numpy()
    return np.asarray(leaf, np.float32)


def _close_leaves(got, want, what, fp32_tol=1e-6):
    """fp32 leaves within fp32_tol of the largest |value|; bf16 leaves
    within one bf16 step at each element's magnitude."""
    worst = 0.0
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        gf, wf = _as_f32(g), _as_f32(w)
        assert gf.shape == wf.shape
        diff = np.abs(gf - wf)
        if g.dtype == torch.bfloat16:
            mag = np.maximum(np.abs(gf), np.abs(wf))
            step = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126)))
                           - 7)
            assert np.all(diff <= step), (what, float((diff / step).max()))
        else:
            scale = max(float(np.abs(wf).max()), 1e-30)
            worst = max(worst, float(diff.max()) / scale)
            assert float(diff.max()) <= fp32_tol * scale, (what, diff.max())
    print(f"{what}: fp32 max |diff| / max|value| {worst:.3g}")


# ---------------------------------------------------------------------------
# trees and the bridge
# ---------------------------------------------------------------------------
class TestTree:
    TREE = {"b": {"z": np.zeros(2), "a": np.ones(3)}, "a": np.arange(4.0),
            "s": np.int32(7)}

    def test_leaf_order_is_jax_flatten_order(self):
        want = jax.tree.leaves(self.TREE)
        got = tree_leaves(self.TREE)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    def test_treedef_string(self):
        assert treedef_str(self.TREE) == str(jax.tree.flatten(self.TREE)[1])

    def test_unflatten_round_trip(self):
        back = tree_unflatten(self.TREE, tree_leaves(self.TREE))
        assert back.keys() == self.TREE.keys()
        np.testing.assert_array_equal(back["b"]["a"], self.TREE["b"]["a"])
        with pytest.raises(ValueError):
            tree_unflatten(self.TREE, tree_leaves(self.TREE) + [1])

    def test_map_over_several_trees(self):
        got = tree_map(lambda a, b: a + b, {"x": 1, "y": {"z": 2}},
                       {"x": 10, "y": {"z": 20}})
        assert got == {"x": 11, "y": {"z": 22}}


class TestBridge:
    def test_opt_state_crosses(self):
        ref_p = {"w": jnp.ones((2, 3), jnp.bfloat16), "n": jnp.ones(3)}
        ref_o = ref_training.adamw_init(
            ref_p, ref_training.AdamWConfig(moment_dtype="bfloat16"))
        o = params_from_reference(jax.tree.map(np.asarray, ref_o), "cpu")
        assert o["step"].shape == () and o["step"].dtype == torch.int32
        assert o["m"]["w"].dtype == torch.bfloat16

    def test_tree_to_numpy_round_trip(self):
        x = np.random.default_rng(0).standard_normal((4, 5)).astype(
            jnp.bfloat16)
        tree = {"a": x, "b": {"c": np.float32(2.5)},
                "s": np.zeros((), np.int32)}
        back = tree_to_numpy(params_from_reference(tree, "cpu"))
        assert back["a"].dtype == np.uint16
        np.testing.assert_array_equal(_bf16_np(back["a"]).view(np.uint16),
                                      x.view(np.uint16))
        assert back["b"]["c"] == 2.5 and back["s"].dtype == np.int32


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def _opt_trees(seed):
    """Reference params/grads: a bf16 matrix, an fp32 matrix, a stacked
    [L, d] bf16 norm scale (decayed: ndim 2) and a [d] fp32 norm (not)."""
    rng = np.random.default_rng(seed)
    params = {
        "w_bf16": rng.standard_normal((6, 8)).astype(jnp.bfloat16),
        "w_f32": rng.standard_normal((5, 4)).astype(np.float32),
        "layers": {"ln": {"scale": (1 + 0.1 * rng.standard_normal((3, 8)))
                          .astype(jnp.bfloat16)}},
        "final_norm": {"scale": (1 + 0.1 * rng.standard_normal(8))
                       .astype(np.float32)},
    }
    grads = jax.tree.map(
        lambda p: (rng.standard_normal(p.shape) * 0.3).astype(p.dtype),
        params)
    return params, grads


class TestOptimizer:
    def test_lr_schedule_against_reference(self):
        cfg = AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100)
        ref_cfg = ref_training.AdamWConfig(lr=3e-4, warmup_steps=10,
                                           total_steps=100)
        got = [float(optimizer.lr_schedule(cfg, s)) for s in range(121)]
        want = [float(ref_optimizer.lr_schedule(ref_cfg, s))
                for s in range(121)]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)

    @pytest.mark.parametrize("moments", ["float32", "bfloat16"])
    def test_adamw_update_against_reference(self, moments):
        """Three chained updates; the [L, d] norm decays, the [d] one not."""
        kw = dict(lr=0.05, warmup_steps=1, total_steps=10, clip_norm=1.0,
                  weight_decay=0.1, moment_dtype=moments)
        cfg, ref_cfg = AdamWConfig(**kw), ref_training.AdamWConfig(**kw)
        ref_p, _ = _opt_trees(0)
        p = params_from_reference(ref_p, "cpu")
        ref_s = ref_training.adamw_init(jax.tree.map(jnp.asarray, ref_p),
                                        ref_cfg)
        s = adamw_init(p, cfg)
        ref_p = jax.tree.map(jnp.asarray, ref_p)
        for i in range(3):
            _, ref_g = _opt_trees(i + 1)
            g = params_from_reference(ref_g, "cpu")
            ref_p, ref_s, ref_m = ref_training.adamw_update(
                jax.tree.map(jnp.asarray, ref_g), ref_s, ref_p, ref_cfg)
            p, s, m = adamw_update(g, s, p, cfg)
            np.testing.assert_allclose(float(m["grad_norm"]),
                                       float(ref_m["grad_norm"]), rtol=1e-6)
            np.testing.assert_allclose(float(m["lr"]), float(ref_m["lr"]),
                                       rtol=1e-6)
            assert int(s["step"]) == int(ref_s["step"]) == i + 1
            _close_leaves(p, ref_p, f"params after update {i + 1}")
            _close_leaves(s["m"], ref_s["m"], f"m after update {i + 1}")
            _close_leaves(s["v"], ref_s["v"], f"v after update {i + 1}")
        assert s["m"]["w_f32"].dtype == optimizer._DTYPES[moments]

    def test_decay_rule_is_ndim_at_least_2(self):
        """With zero gradients only weight decay moves a parameter: the
        stacked [L, d] norm scale decays, the [d] one and a scalar do not."""
        cfg = AdamWConfig(lr=0.1, warmup_steps=0, weight_decay=0.5)
        p = {"stacked": torch.ones((2, 4)), "final": torch.ones(4),
             "scalar": torch.ones(())}
        new, _, _ = adamw_update(tree_map(torch.zeros_like, p),
                                 adamw_init(p, cfg), p, cfg)
        assert torch.all(new["stacked"] < 1)
        assert torch.equal(new["final"], p["final"])
        assert torch.equal(new["scalar"], p["scalar"])

    def test_global_norm_against_reference(self):
        ref_p, _ = _opt_trees(4)
        got = float(optimizer.global_norm(params_from_reference(ref_p, "cpu")))
        want = float(ref_optimizer.global_norm(
            jax.tree.map(jnp.asarray, ref_p)))
        np.testing.assert_allclose(got, want, rtol=1e-6)

    def test_arguments_untouched_and_blocks_change_no_bit(self, monkeypatch):
        """Functional: the inputs keep their values.  A leaf updated in
        blocks of rows gives the bits of one block."""
        cfg = AdamWConfig(lr=0.05, warmup_steps=0)
        ref_p, ref_g = _opt_trees(5)
        p = params_from_reference(ref_p, "cpu")
        g = params_from_reference(ref_g, "cpu")
        s = adamw_init(p, cfg)
        s["m"] = tree_map(lambda t: t + 0.01, s["m"])
        keep = [t.clone() for t in tree_leaves(p) + tree_leaves(g)
                + tree_leaves(s)]
        whole = adamw_update(g, s, p, cfg)
        monkeypatch.setattr(optimizer, "_BLOCK", 8)
        blocked = adamw_update(g, s, p, cfg)
        for a, b in zip(keep, tree_leaves(p) + tree_leaves(g)
                        + tree_leaves(s)):
            assert torch.equal(a, b)
        for a, b in zip(tree_leaves(whole[0]) + tree_leaves(whole[1]),
                        tree_leaves(blocked[0]) + tree_leaves(blocked[1])):
            assert torch.equal(a, b)

    # the reference's own optimizer tests, ported
    def test_adamw_converges_quadratic(self):
        cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                          total_steps=200)
        params = {"w": torch.tensor([5.0, -3.0])}
        state = adamw_init(params, cfg)
        for _ in range(200):
            grads = {"w": 2 * params["w"]}  # d/dw of w^2
            params, state, _ = adamw_update(grads, state, params, cfg)
        assert params["w"].abs().max() < 0.05

    def test_clip_bounds_update(self):
        cfg = AdamWConfig(lr=1.0, clip_norm=1.0, warmup_steps=0)
        params = {"w": torch.zeros(4)}
        state = adamw_init(params, cfg)
        _, _, metrics = adamw_update({"w": torch.full((4,), 1e6)}, state,
                                     params, cfg)
        assert metrics["grad_norm"] > 1e6  # raw norm reported

    def test_bf16_moments(self):
        cfg = AdamWConfig(moment_dtype="bfloat16")
        state = adamw_init({"w": torch.zeros((8, 8))}, cfg)
        assert state["m"]["w"].dtype == torch.bfloat16

    def test_lr_schedule_shape(self):
        cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
        lrs = [float(optimizer.lr_schedule(cfg, s)) for s in range(0, 100, 5)]
        assert lrs[0] < lrs[1]  # warmup
        assert lrs[-1] < cfg.lr  # decayed
        assert min(lrs[2:]) >= cfg.lr * cfg.lr_min_ratio * 0.99


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _bridged():
    """(reference model, reference params, port model, port params) of the
    smollm smoke config; shared, since every step leaves its inputs as
    they are."""
    ref_model = ref_build_model(ref_get_smoke(ARCH))
    ref_params = jax.jit(ref_model.init_params)(jax.random.PRNGKey(0))
    params = params_from_reference(jax.tree.map(np.asarray, ref_params),
                                   "cpu")
    return ref_model, ref_params, build_model(get_smoke_config(ARCH),
                                              "cpu"), params


def _tiny_setup(steps=300, lr=1e-2):
    """The reference test's setup, port side (weights from the reference's
    init, bridged)."""
    _, _, model, params = _bridged()
    ocfg = AdamWConfig(lr=lr, warmup_steps=10, total_steps=steps,
                       weight_decay=0.01)
    opt = adamw_init(params, ocfg)
    step = make_train_step(model, ocfg, remat=False)
    data = SyntheticLM(model.cfg.vocab_size, 32, 8, seed=0)
    return model, params, opt, step, data


class TestTrainStep:
    @pytest.mark.parametrize("microbatches", [1, 4])
    def test_five_steps_against_reference(self, microbatches):
        """Loss within LOSS_RTOL (measured 2.6e-7); parameters within
        STEP_TOL x lr x 5 (measured 4.7e-5 at lr 1e-2, 0.09%)."""
        ref_model, ref_params, model, params = _bridged()
        kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.01)
        ref_cfg, cfg = ref_training.AdamWConfig(**kw), AdamWConfig(**kw)
        ref_step = jax.jit(ref_training.make_train_step(
            ref_model, ref_cfg, remat=False, microbatches=microbatches))
        step = make_train_step(model, cfg, remat=False,
                               microbatches=microbatches)
        ref_o, o = ref_training.adamw_init(ref_params, ref_cfg), \
            adamw_init(params, cfg)
        data = SyntheticLM(model.cfg.vocab_size, 32, 8, seed=0)
        worst = 0.0
        for i in range(5):
            b = data.batch_at(i)
            ref_params, ref_o, ref_m = ref_step(ref_params, ref_o, b)
            params, o, m = step(params, o, b)
            np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                                       rtol=LOSS_RTOL)
            for a, w in zip(tree_leaves(params), jax.tree.leaves(ref_params)):
                d = float(np.abs(a.numpy() - np.asarray(w)).max())
                worst = max(worst, d)
                assert d <= STEP_TOL * kw["lr"] * (i + 1), (i, d)
        print(f"microbatches {microbatches}: max |dparam| {worst:.3g}")

    def test_microbatching_matches_full_batch_loss(self):
        _, _, model, params = _bridged()
        ocfg = AdamWConfig(lr=1e-3, warmup_steps=0)
        opt = adamw_init(params, ocfg)
        data = SyntheticLM(model.cfg.vocab_size, 16, 8, seed=0).batch_at(0)
        s1 = make_train_step(model, ocfg, remat=False, microbatches=1)
        s4 = make_train_step(model, ocfg, remat=False, microbatches=4)
        p1, _, m1 = s1(params, opt, data)
        p4, _, m4 = s4(params, opt, data)
        assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-3
        for a, b in zip(tree_leaves(p1), tree_leaves(p4)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                       atol=1e-4)

    def test_microbatches_must_split_the_batch(self):
        _, _, model, params = _bridged()
        ocfg = AdamWConfig()
        step = make_train_step(model, ocfg, microbatches=3)
        with pytest.raises(ValueError, match="microbatches"):
            step(params, adamw_init(params, ocfg),
                 SyntheticLM(256, 8, 8).batch_at(0))

    def test_remat_step_is_bit_equal(self):
        _, _, model, params = _bridged()
        ocfg = AdamWConfig(lr=1e-2, warmup_steps=0)
        opt = adamw_init(params, ocfg)
        b = SyntheticLM(model.cfg.vocab_size, 16, 4, seed=1).batch_at(0)
        pa, _, ma = make_train_step(model, ocfg, remat=True)(params, opt, b)
        pb, _, mb = make_train_step(model, ocfg, remat=False)(params, opt, b)
        assert torch.equal(ma["loss"], mb["loss"])
        for a, c in zip(tree_leaves(pa), tree_leaves(pb)):
            assert torch.equal(a, c)

    def test_loss_decreases(self):
        model, params, opt, step, data = _tiny_setup()
        losses = []
        for s in range(100):
            params, opt, m = step(params, opt, data.batch_at(s))
            losses.append(float(m["loss"]))
        assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.4, losses[::10]


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
class TestData:
    def test_copied_line_for_line(self):
        with open(os.path.join(ROOT, "src/repro/training/data.py")) as f:
            want = f.read().replace("repro.", "repro_torch.")
        with open(os.path.join(ROOT, "src/repro_torch/training/data.py")) as f:
            assert f.read() == want

    @pytest.mark.parametrize("seed,host,hosts", [(0, 0, 1), (3, 1, 2),
                                                 (7, 3, 4)])
    def test_batches_equal_reference(self, seed, host, hosts):
        a = SyntheticLM(1000, 24, 8, seed=seed, host_id=host, num_hosts=hosts)
        b = ref_training.SyntheticLM(1000, 24, 8, seed=seed, host_id=host,
                                     num_hosts=hosts)
        for step in (0, 1, 17):
            x, y = a.batch_at(step), b.batch_at(step)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(x[k], y[k])

    # the reference's own data tests, ported
    def test_deterministic_and_restart_safe(self):
        d = SyntheticLM(1000, 32, 8, seed=3)
        a, b = d.batch_at(7), d.batch_at(7)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])

    def test_host_sharding_partitions_batch(self):
        parts = [SyntheticLM(1000, 16, 8, seed=1, host_id=h, num_hosts=2
                             ).batch_at(0) for h in range(2)]
        assert all(p["tokens"].shape == (4, 16) for p in parts)
        assert not np.array_equal(parts[0]["tokens"], parts[1]["tokens"])

    def test_labels_shift(self):
        b = SyntheticLM(1000, 16, 2, seed=0).batch_at(0)
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])

    def test_prefetch_iterator(self):
        d = SyntheticLM(1000, 8, 2, seed=0)
        it = d.iterate(5)
        first = next(it)
        np.testing.assert_array_equal(first["tokens"], d.batch_at(5)["tokens"])
        d.close()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _state_trees():
    """A reference {params, opt} tree with bf16 and fp32 leaves and its
    port twin."""
    ref_p, _ = _opt_trees(6)
    ref_p = jax.tree.map(jnp.asarray, ref_p)
    ref_tree = {"params": ref_p, "opt": ref_training.adamw_init(
        ref_p, ref_training.AdamWConfig(moment_dtype="bfloat16"))}
    ref_tree["opt"]["m"] = jax.tree.map(lambda x: x + 0.5, ref_tree["opt"]["m"])
    ref_tree["opt"]["step"] = jnp.int32(3)
    return ref_tree, params_from_reference(
        jax.tree.map(np.asarray, ref_tree), "cpu")


def _assert_same(port_tree, ref_tree):
    for g, w in zip(tree_leaves(port_tree), jax.tree.leaves(ref_tree)):
        w = np.asarray(w)
        if g.dtype == torch.bfloat16:
            assert w.dtype == jnp.bfloat16
            np.testing.assert_array_equal(
                g.view(torch.int16).numpy().view(np.uint16), w.view(np.uint16))
        else:
            assert str(g.numpy().dtype) == str(w.dtype)
            np.testing.assert_array_equal(g.numpy(), w)


class TestCheckpoint:
    def test_roundtrip_bf16(self, tmp_path):
        tree = {"a": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
                "b": {"c": torch.tensor(3.5)}}
        save_checkpoint(str(tmp_path), 3, tree)
        assert latest_step(str(tmp_path)) == 3
        got, _ = restore_checkpoint(str(tmp_path), 3, tree)
        assert got["a"].dtype == torch.bfloat16
        assert torch.equal(got["a"], tree["a"])
        assert float(got["b"]["c"]) == 3.5

    def test_reference_checkpoint_restored_by_port(self, tmp_path):
        ref_tree, like = _state_trees()
        ref_checkpoint.save_checkpoint(str(tmp_path), 5, ref_tree,
                                       extra={"step": 5})
        got, extra = restore_checkpoint(str(tmp_path), 5, like)
        assert extra == {"step": 5}
        _assert_same(got, ref_tree)

    def test_port_checkpoint_restored_by_reference(self, tmp_path):
        ref_tree, tree = _state_trees()
        save_checkpoint(str(tmp_path), 6, tree, extra={"step": 6})
        got, extra = ref_checkpoint.restore_checkpoint(str(tmp_path), 6,
                                                       ref_tree)
        assert extra == {"step": 6}
        _assert_same(tree, got)

    def test_manifest_equals_reference(self, tmp_path):
        ref_tree, tree = _state_trees()
        save_checkpoint(str(tmp_path / "port"), 1, tree)
        ref_checkpoint.save_checkpoint(str(tmp_path / "ref"), 1, ref_tree)
        man = [json.load(open(tmp_path / d / "step_00000001" /
                              "manifest.json")) for d in ("port", "ref")]
        assert man[0] == man[1]
        for name in sorted(os.listdir(tmp_path / "ref" / "step_00000001")):
            if name.endswith(".npy"):
                a = np.load(tmp_path / "port" / "step_00000001" / name)
                b = np.load(tmp_path / "ref" / "step_00000001" / name)
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)

    def test_leaf_count_mismatch_raises(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(2)})
        with pytest.raises(ValueError, match="leaves"):
            restore_checkpoint(str(tmp_path), 1,
                               {"w": torch.zeros(2), "x": torch.zeros(1)})

    def test_restore_onto_device(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, {"w": torch.ones(2)})
        got, _ = restore_checkpoint(str(tmp_path), 1, {"w": np.zeros(2)},
                                    device="cpu")
        assert got["w"].device.type == "cpu" and float(got["w"][0]) == 1.0

    def test_atomic_commit_no_partial(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, {"w": torch.zeros((4,))})
        assert os.listdir(tmp_path) == ["step_00000001"]  # no .tmp residue

    def test_async_save(self, tmp_path):
        t = save_checkpoint(str(tmp_path), 2, {"w": torch.ones(3)},
                            async_save=True)
        t.join(timeout=60)
        assert not t.is_alive()
        assert latest_step(str(tmp_path)) == 2

    def test_async_save_is_a_copy(self, tmp_path):
        """The leaves go to the host before the thread starts: a later
        in-place change is not saved."""
        w = torch.ones(3)
        t = save_checkpoint(str(tmp_path), 2, {"w": w}, async_save=True)
        w.fill_(7.0)
        t.join(timeout=60)
        got, _ = restore_checkpoint(str(tmp_path), 2, {"w": w})
        assert torch.equal(got["w"], torch.ones(3))

    def test_prune_keeps_newest(self, tmp_path):
        for s in (1, 2, 3, 4):
            save_checkpoint(str(tmp_path), s, {"w": torch.zeros(1)})
        os.makedirs(tmp_path / "step_00000009.tmp")  # a torn save: ignored
        checkpoint.prune_checkpoints(str(tmp_path), keep=2)
        assert sorted(os.listdir(tmp_path)) == [
            "step_00000003", "step_00000004", "step_00000009.tmp"]
        assert latest_step(str(tmp_path)) == 4


# ---------------------------------------------------------------------------
# supervisor
# ---------------------------------------------------------------------------
class TestSupervisor:
    def test_failure_restart_resumes(self, tmp_path):
        model, params, opt, step, data = _tiny_setup()
        sup = TrainSupervisor(step, params, opt, ckpt_dir=str(tmp_path),
                              ckpt_every=5)
        fired = {"done": False}

        def inject(s):
            if s == 12 and not fired["done"]:
                fired["done"] = True
                raise SimulatedFailure("node lost")

        stats = sup.run(data.batch_at, 20, failure_injector=inject)
        assert stats.restarts == 1
        # resumed from step 10 ckpt -> replayed steps 10..19 plus 0..11
        assert stats.steps_done == 20 + 2

    def test_nan_rollback(self, tmp_path):
        model, params, opt, step, data = _tiny_setup()
        calls = {"n": 0}

        def poisoned_step(p, o, b):
            calls["n"] += 1
            if calls["n"] == 7:
                p2, o2, m = step(p, o, b)
                return p2, o2, {**m, "loss": torch.tensor(float("nan"))}
            return step(p, o, b)

        sup = TrainSupervisor(poisoned_step, params, opt,
                              ckpt_dir=str(tmp_path), ckpt_every=3)
        stats = sup.run(data.batch_at, 10)
        assert stats.rollbacks == 1
        assert all(np.isfinite(l) for l in stats.losses)

    def test_checkpoints_pruned(self, tmp_path):
        model, params, opt, step, data = _tiny_setup()
        sup = TrainSupervisor(step, params, opt, ckpt_dir=str(tmp_path),
                              ckpt_every=2, keep=2)
        sup.run(data.batch_at, 8)
        dirs = [d for d in os.listdir(tmp_path) if d.startswith("step_")]
        assert len(dirs) <= 2

    def test_losses_after_restart_bit_equal(self, tmp_path):
        """The replayed steps give the uninterrupted run's losses bit for
        bit, and the final state is the same."""
        model, params, opt, step, data = _tiny_setup()
        a = TrainSupervisor(step, params, opt, ckpt_dir=str(tmp_path / "a"),
                            ckpt_every=5)
        clean = list(a.run(data.batch_at, 16).losses)

        def inject(s, fired=[]):
            if s == 12 and not fired:
                fired.append(s)
                raise SimulatedFailure("node lost")

        b = TrainSupervisor(step, params, opt, ckpt_dir=str(tmp_path / "b"),
                            ckpt_every=5)
        stats = b.run(data.batch_at, 16, failure_injector=inject)
        assert stats.restarts == 1
        # steps 0..11, then 10..15 again from the step-10 checkpoint
        assert stats.losses == clean[:12] + clean[10:]
        for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------
_RANK_SCRIPT = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.training import compression

rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
dist.init_process_group("gloo", init_method=init, rank=rank,
                        world_size=world)
x = np.random.default_rng(rank).standard_normal((64, 33)).astype(np.float32)
x *= 0.1 * (rank + 1)
grads = {"a": torch.from_numpy(x), "b": {"c": torch.from_numpy(x[:3])}}
res = {}
for kind in ("fp32", "bf16", "int8"):
    r = compression.make_pod_reducer(kind)(grads)
    res[kind] = r["a"].numpy()
    res[kind + "_c"] = r["b"]["c"].numpy()
np.savez(out, **res)
dist.destroy_process_group()
"""


class TestCompression:
    def test_quantize_against_reference(self):
        x = np.random.default_rng(0).standard_normal((17, 9)).astype(
            np.float32) * 3
        scale = np.float32(np.abs(x).max() / 127.0)
        q = compression.quantize_int8(_t(x), torch.tensor(scale))
        want = ref_compression.quantize_int8(jnp.asarray(x), scale)
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            compression.dequantize_int8(q, torch.tensor(scale)).numpy(),
            np.asarray(ref_compression.dequantize_int8(want, scale)))

    def test_error_feedback_against_reference(self):
        """200 rounds of quantise-with-feedback: the port's residuals equal
        the reference's (within 1e-6), and the mean transmitted gradient
        converges to the true one (the reference test's 0.01)."""
        true_g = np.random.default_rng(1).standard_normal(256).astype(
            np.float32)
        res, ref_res = {"g": torch.zeros(256)}, {"g": jnp.zeros(256)}
        acc = torch.zeros(256)
        for _ in range(200):
            pre = compression.apply_error_feedback({"g": _t(true_g)}, res)
            ref_pre = ref_compression.apply_error_feedback(
                {"g": jnp.asarray(true_g)}, ref_res)
            scale = pre["g"].abs().max() / 127.0
            post = {"g": compression.dequantize_int8(
                compression.quantize_int8(pre["g"], scale), scale)}
            ref_scale = jnp.max(jnp.abs(ref_pre["g"])) / 127.0
            ref_post = {"g": ref_compression.dequantize_int8(
                ref_compression.quantize_int8(ref_pre["g"], ref_scale),
                ref_scale)}
            res = compression.update_residual(pre, post)
            ref_res = ref_compression.update_residual(ref_pre, ref_post)
            acc += post["g"]
        np.testing.assert_allclose(res["g"].numpy(), np.asarray(ref_res["g"]),
                                   rtol=0, atol=1e-6)
        assert float((acc / 200 - _t(true_g)).abs().max()) < 0.01
        assert compression.apply_error_feedback({"g": 1}, None) == {"g": 1}

    def test_reducers_over_four_gloo_ranks(self, tmp_path):
        """fp32, bf16 and int8 means over 4 ranks (one process each): every
        rank gets the same result, within the reference test's bound of the
        fp32 mean; int8 equals sum(q_r) x scale / 4 computed in numpy."""
        world = 4
        script = tmp_path / "rank.py"
        script.write_text(_RANK_SCRIPT)
        init = f"file://{tmp_path / 'pg'}"
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, str(script), str(r), str(world), init,
             str(tmp_path / f"out{r}.npz")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(world)]
        try:
            outs = [p.communicate(timeout=120)[0].decode() for p in procs]
        finally:
            for p in procs:
                p.kill()
        assert all(p.returncode == 0 for p in procs), outs
        xs = [np.random.default_rng(r).standard_normal((64, 33)).astype(
            np.float32) * np.float32(0.1 * (r + 1)) for r in range(world)]
        mean = np.mean(xs, axis=0)
        res = [np.load(tmp_path / f"out{r}.npz") for r in range(world)]
        for kind in ("fp32", "bf16", "int8"):
            for r in range(1, world):
                np.testing.assert_array_equal(res[r][kind], res[0][kind])
            err = float(np.abs(res[0][kind] - mean).max())
            bound = 0.02 * float(np.abs(mean).max()) + 1e-4
            print(f"{kind}: max |err| {err:.3g} (bound {bound:.3g})")
            assert err < bound, (kind, err, bound)
        scale = np.float32(max(float(np.abs(np.stack(xs)).max()), 1e-12)
                           / 127.0)
        q = sum(np.clip(np.round(x / scale), -127, 127).astype(np.int32)
                for x in xs)
        np.testing.assert_allclose(res[0]["int8"],
                                   q.astype(np.float32) * scale / world,
                                   rtol=1e-6, atol=0)

    @pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
    def test_reducer_without_process_group_raises(self, kind):
        assert not torch.distributed.is_initialized()
        with pytest.raises(RuntimeError, match="process group"):
            compression.make_pod_reducer(kind)
        _, _, model, _ = _bridged()
        with pytest.raises(RuntimeError, match="process group"):
            make_train_step(model, AdamWConfig(), pod_reduce=kind)

    def test_none_and_unknown_kinds(self):
        g = {"a": torch.ones(2)}
        assert compression.make_pod_reducer("none")(g) is g
        with pytest.raises(ValueError):
            compression.make_pod_reducer("fp8")


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------
class TestLaunch:
    def test_cpu_smoke_run_prints_closing_line(self, tmp_path, capsys):
        launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--steps", "12", "--batch", "4", "--seq", "16",
                           "--ckpt-every", "5", "--ckpt-dir",
                           str(tmp_path)])
        out = capsys.readouterr().out
        assert "device=cpu" in out
        last = out.strip().splitlines()[-1]
        assert last.startswith("done: steps=12 loss ") and \
            "rollbacks=0 restarts=0" in last, out
        assert latest_step(str(tmp_path)) == 12

    def test_default_device_raises_without_card(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            launch_train.main(["--arch", ARCH, "--smoke", "--ckpt-dir",
                               str(tmp_path)])
