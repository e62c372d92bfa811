"""The port's products with an fp32 result (`models.layers.matmul_f32` and
the grouped attention products built on it) against the reference's
``preferred_element_type=jnp.float32`` products, and every site that uses
them.

* CPU, the plain version of the product: bf16 operands widened exactly and
  multiplied in fp32, against ``jnp.einsum(...,
  preferred_element_type=jnp.float32)`` on the same numpy-seeded inputs.
  Every product of two bf16 values is exact in fp32, so the two differ only
  in the order of their fp32 sums: bound ``2 * K * 2**-24 * (|a| @ |b|)``
  element by element (K the contraction length; each sum is within
  (K-1) * 2**-24 * sum |terms| of the exact one).
* CPU, the sites: the model's prefill, decode, blocked and O3 variants,
  packed suffix and gradients on the grouped products, against the same
  model with its scores and values taken over K/V repeated to the query
  heads (``_repeat_kv`` and an einsum, the reference's layout), within
  1e-5 in fp32.  `_ProductF32`'s backward runs on the CPU with the
  out_dtype product (which has no CPU kernel) stood in for by the widened
  one: in bf16 it rounds the cotangent to bf16 (a relative 2**-9), so its
  gradients are held to the widened product's by cosine.
* meta: a bf16 model issues ``aten::mm.dtype`` / ``aten::bmm.dtype`` and
  makes no fp32 or repeated copy of a decode cache; the dry run counts the
  one-device FLOPs of a bf16 model as the closed form.
* gloo ranks: the sharded steps (the vocab product shard by shard, its
  gradients' placements, the grouped products) against one process.
* ``cuda`` (skipped without a card): the out_dtype products against the
  plain version with the bound above, and `_ProductF32`'s gradients against
  the float64 product: each gradient rounds the cotangent to bf16 (2**-9 of
  it), sums in fp32 and rounds once to bf16 (2**-9 of the result), so
  ``|got - exact| <= (2**-8 + K * 2**-23) * (|g| @ |b|)`` element by element.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.models import layers as nn  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
U32 = 2.0 ** -24


def _bf16(rng, *shape):
    """numpy-seeded values rounded to bf16, as a CPU torch tensor."""
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)


def _sum_bound(a, b, eq, K):
    """2 K 2**-24 (|a| . |b|) for ``einsum(eq)`` over K terms, in float64."""
    return 2 * K * U32 * torch.einsum(eq, a.double().abs(), b.double().abs())


def _assert_within(got, want, bound, what):
    diff = (got.double() - want.double()).abs()
    worst = float((diff / bound.clamp_min(1e-300)).max())
    print(f"{what}: max |diff| {float(diff.max()):.3g}, worst diff / bound "
          f"{worst:.3g}")
    assert worst <= 1.0, (what, float(diff.max()), worst)


# --------------------------------------------------------------------------
# the plain version against the reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [((37, 64), (64, 29)),
                                   ((3, 17, 128), (3, 128, 40)),
                                   ((1, 256), (256, 512))])
def test_matmul_f32_plain_equals_reference(shape):
    jnp = pytest.importorskip("jax.numpy")
    rng = np.random.default_rng(0)
    a, b = _bf16(rng, *shape[0]), _bf16(rng, *shape[1])
    got = nn.matmul_f32(a, b)
    assert got.dtype == torch.float32 and got.shape == shape[0][:-1] + \
        shape[1][-1:]
    eq = "mk,kn->mn" if a.ndim == 2 else "bmk,bkn->bmn"
    want = jnp.einsum(eq, jnp.asarray(a.float().numpy(), jnp.bfloat16),
                      jnp.asarray(b.float().numpy(), jnp.bfloat16),
                      preferred_element_type=jnp.float32)
    _assert_within(got, torch.from_numpy(np.array(want)),
                   _sum_bound(a, b, eq, a.shape[-1]), "matmul_f32")


@pytest.mark.parametrize("B,Sq,H,KV", [(1, 1, 8, 2), (3, 1, 8, 8),
                                        (2, 5, 8, 2), (2, 7, 4, 1)])
def test_grouped_products_equal_reference(B, Sq, H, KV):
    """Query heads grouped per KV head, against the reference's products
    over the repeated heads (``jnp.repeat``, as its decode repeats them)."""
    jnp = pytest.importorskip("jax.numpy")
    rng = np.random.default_rng(1)
    Sk, dh = 19, 16
    q, k, v = _bf16(rng, B, Sq, H, dh), _bf16(rng, B, Sk, KV, dh), \
        _bf16(rng, B, Sk, KV, dh)
    p = torch.softmax(_bf16(rng, B, H, Sq, Sk).float(), -1).to(torch.bfloat16)

    def j(t):
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    kr, vr = (jnp.repeat(j(t), H // KV, axis=2) for t in (k, v))
    got = nn.grouped_scores(q, k)
    want = jnp.einsum("bqhd,bkhd->bhqk", j(q), kr,
                      preferred_element_type=jnp.float32)
    krt = nn._repeat_kv(k, H // KV)
    _assert_within(got, torch.from_numpy(np.array(want)),
                   _sum_bound(q, krt, "bqhd,bkhd->bhqk", dh), "grouped_scores")
    got = nn.grouped_values(p, v, f32=True)
    want = jnp.einsum("bhqk,bkhd->bhqd", j(p), vr,
                      preferred_element_type=jnp.float32)
    _assert_within(got, torch.from_numpy(np.array(want)),
                   _sum_bound(p, nn._repeat_kv(v, H // KV),
                              "bhqk,bkhd->bhqd", Sk), "grouped_values")


# --------------------------------------------------------------------------
# the sites, on the CPU
# --------------------------------------------------------------------------
def _repeated_heads(monkeypatch):
    """The oracle of the grouped products: K/V repeated to the query heads
    and contracted with one einsum over the widened operands."""
    def scores(q, k):
        k = nn._repeat_kv(k, q.shape[2] // k.shape[2])
        return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())

    def values(p, v, f32):
        v = nn._repeat_kv(v, p.shape[1] // v.shape[2])
        if f32:
            return torch.einsum("bhqk,bkhd->bhqd", p.float(), v.float())
        return torch.einsum("bhqk,bkhd->bhqd", p, v)
    monkeypatch.setattr(nn, "grouped_scores", scores)
    monkeypatch.setattr(nn, "grouped_values", values)


@pytest.fixture
def card_product(monkeypatch):
    """`matmul_f32` through `_ProductF32`, as on the card, with the out_dtype
    product (no CPU kernel) stood in for by the widened one."""
    monkeypatch.setattr(nn, "_mm",
                        lambda a, b: torch.matmul(a.float(), b.float()))
    monkeypatch.setattr(nn, "matmul_f32", nn._ProductF32.apply)


def _cfg(dtype, **kw):
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config("llama3-1-8b"),
                               compute_dtype=dtype, param_dtype=dtype, **kw)


def _model_outputs(cfg, seed=0):
    """prefill with a prefix, two decode steps, loss and gradients."""
    from repro_torch.models import build_model
    from repro_torch.training.train_step import value_and_grad
    model = build_model(cfg, "cpu")
    params = model.init_params(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24)))
    lg0, prefix = model.prefill(params, {"tokens": toks[:, :16]})
    lg1, _ = model.prefill(params, {"tokens": toks[:, 16:]}, prefix, 16)
    dc = model.init_cache(2, 32)
    dc[:, :, :, :16] = prefix
    outs = [lg0, lg1]
    for i in range(2):
        lg, dc = model.decode_step(params, dc, toks[:, 16 + i:17 + i],
                                   torch.tensor([16 + i, 16 + i]))
        outs.append(lg)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss, grads = value_and_grad(model, params, batch, remat=False)
    return outs, loss, grads


def _leaves(tree):
    from repro_torch.training.tree import tree_leaves
    return tree_leaves(tree)


@pytest.mark.parametrize("variant", [{}, {"attn_impl": "blocked",
                                          "attn_block_k": 8,
                                          "decode_impl": "blocked",
                                          "decode_blocks": 4}])
def test_grouped_equals_repeated_fp32(monkeypatch, variant):
    """fp32: the model on the grouped products against the same model over
    repeated heads, within 1e-5."""
    cfg = _cfg("float32", **variant)
    got = _model_outputs(cfg)
    _repeated_heads(monkeypatch)
    want = _model_outputs(cfg)
    d_logits = max(float((g - w).abs().max())
                   for g, w in zip(got[0], want[0]))
    d_grads = max(float((g - w).abs().max())
                  for g, w in zip(_leaves(got[2]), _leaves(want[2])))
    print(f"fp32 grouped vs repeated: logits {d_logits:.3g}, gradients "
          f"{d_grads:.3g}")
    for g, w in zip(got[0], want[0]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)
    for g, w in zip(_leaves(got[2]), _leaves(want[2])):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


def test_product_f32_bf16_gradients(card_product, monkeypatch):
    """bf16, `_ProductF32` against the widened product at every site: the
    forward products are the same exact products summed in fp32 (logits
    within 1e-3, a few fp32 orders of sums through bf16 activations); the
    backward rounds each fp32 cotangent to bf16, so every gradient leaf
    keeps a cosine of at least 0.999 with the widened product's."""
    cfg = _cfg("bfloat16")
    got = _model_outputs(cfg)
    monkeypatch.undo()
    want = _model_outputs(cfg)
    rel = max(float((g - w).abs().max() / w.abs().max())
              for g, w in zip(got[0], want[0]))
    cos = min(float(g.double().flatten() @ w.double().flatten()
                    / (g.double().norm() * w.double().norm())
                    .clamp_min(1e-300))
              for g, w in zip(_leaves(got[2]), _leaves(want[2])))
    print(f"bf16 _ProductF32 vs widened: logits {rel:.3g} of the largest, "
          f"smallest gradient cosine {cos:.6f}")
    assert rel <= 1e-3
    assert abs(float(got[1]) - float(want[1])) <= 1e-3 * float(want[1])
    assert cos >= 0.999


def test_grouped_packed_prefix(monkeypatch):
    """The packed-resident attention's fp suffix (prefill and decode) on
    the grouped products: its cache is neither repeated nor widened for the
    scores.  Against repeated heads within 1e-5 (fp32)."""
    cfg = _cfg("float32")
    from repro_torch.models import build_model
    from repro_torch.models.dense import layer_params
    model = build_model(cfg, "cpu")
    params = model.init_params(torch.Generator().manual_seed(2))
    lp = layer_params(params, 0)["attn"]
    rng = np.random.default_rng(2)
    KV, dh, G, N = cfg.num_kv_heads, cfg.head_dim, 8, 2
    P = N * G
    kq = torch.from_numpy(rng.integers(-127, 128, (1, P, KV, dh),
                                       dtype=np.int8))
    vq = torch.from_numpy(rng.integers(-127, 128, (1, P, KV, dh),
                                       dtype=np.int8))
    sc = [torch.from_numpy(((0.5 + rng.random((1, N, KV * dh))) / 127)
                           .astype(np.float16)) for _ in range(2)]
    packed = (kq, vq, sc[0], sc[1])
    x = torch.from_numpy(rng.standard_normal((1, 5, cfg.d_model))
                         .astype(np.float32))
    args = dict(bits=8, group=1, chunk_tokens=G)

    def run():
        out, (k, v) = nn.attention_packed_prefix(
            lp, cfg, x, packed, positions=torch.arange(P, P + 5)[None],
            **args)
        sk = torch.zeros((1, 8, KV, dh))
        sv = torch.zeros((1, 8, KV, dh))
        sk[:, :5], sv[:, :5] = k, v
        dec, _ = nn.decode_attention_packed_prefix(
            lp, cfg, x[:, :1], packed, sk, sv, torch.tensor([P + 5]), **args)
        return out, dec
    got = run()
    _repeated_heads(monkeypatch)
    want = run()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# meta: the ops a bf16 model issues, and the dry run's count
# --------------------------------------------------------------------------
class _Ops(TorchDispatchMode):
    """Records (op, output numel) of every op that makes a new tensor: no
    view and no in-place write."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and not func._schema.is_mutable:
            self.made += [(func.name(), o.numel()) for o in (
                out if isinstance(out, (tuple, list)) else (out,))
                if isinstance(o, torch.Tensor)]
        return out


def test_meta_decode_reads_the_cache_as_it_is():
    """A bf16 decode step on meta tensors: the scores and the value sum are
    out_dtype / bf16 products straight off the [B, S, KV, dh] cache; no op
    writes a tensor of the cache's size or larger (no repeated or widened
    copy), and the logits come from ``aten::mm.dtype``."""
    cfg = dataclasses.replace(_cfg("bfloat16"), num_layers=1)
    from repro_torch.models import build_model
    model = build_model(cfg, "meta")
    params = model.param_spec()
    B, S = 2, 64
    cache = model.cache_spec(B, S)
    mode = _Ops()
    with mode:
        lg, _ = model.decode_step(params, cache, torch.zeros(
            (B, 1), dtype=torch.int64, device="meta"),
            torch.full((B,), 5, device="meta"))
    assert lg.dtype == torch.float32
    names = {name for name, _ in mode.made}
    assert {"aten::mm.dtype", "aten::bmm.dtype"} <= names, names
    one_layer = B * S * cfg.num_kv_heads * cfg.head_dim
    assert [m for m in mode.made if m[1] >= one_layer] == []


_ONE = r"""
import dataclasses, json
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun
cfg = dataclasses.replace(get_smoke_config("llama3-1-8b"),
                          compute_dtype="bfloat16", param_dtype="bfloat16")
one = dryrun._mesh("one")
print(json.dumps({s: dryrun.count_step(cfg, s, one)["flops"]
                  for s in ("prefill_32k", "decode_32k", "train_4k")}))
"""


def _closed_form(cfg, shape_name):
    """`tests/test_torch_dryrun.py`'s closed form of the one-device FLOPs."""
    from repro_torch.configs import SHAPES as S
    sh = S[shape_name]
    B, T = sh.global_batch, sh.seq_len
    d, H, KV, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ff, L, V = cfg.d_ff, cfg.num_layers, cfg.padded_vocab
    per_token = L * (d * H * dh + 2 * d * KV * dh + H * dh * d + 3 * d * ff)
    if sh.kind == "decode":
        return 2 * per_token * B + 4 * B * H * T * dh * L + 2 * B * d * V
    attention = 4 * B * H * T * T * dh * L
    if sh.kind == "prefill":
        return 2 * per_token * B * T + attention + 2 * B * d * V
    forward = 2 * per_token * B * T + attention
    not_recomputed = 2 * B * T * ff * d * L
    return 4 * forward - not_recomputed + 3 * 2 * B * T * d * V


def test_dry_run_one_device_flops_bf16():
    """The dry run on meta tensors of a bf16 model, whose products take the
    out_dtype overloads: the one-device FLOPs equal the closed form."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _ONE], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    cfg = _cfg("bfloat16")
    for shape, flops in got.items():
        assert flops == _closed_form(cfg, shape), shape


# --------------------------------------------------------------------------
# DTensors on four gloo ranks: the sharded steps against one process
# --------------------------------------------------------------------------
_RANKS = r"""
import json, sys
import torch
import torch.distributed as dist
rank, world, init = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=init, rank=rank,
                        world_size=world)
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.sharding import distribute, param_shardings
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.steps import _batch_shardings, make_step
from repro_torch.models import build_model
from repro_torch.models import layers as nn
from repro_torch.training.train_step import value_and_grad
from repro_torch.training.tree import tree_leaves

mesh = make_debug_mesh(2, 2, device_type="cpu")
cfg = get_smoke_config("llama3-1-8b")
model = build_model(cfg, "cpu")
params = model.init_params(torch.Generator().manual_seed(0))
g = torch.Generator().manual_seed(1)
toks = torch.randint(0, cfg.vocab_size, (4, 17), generator=g)
psh = param_shardings(params, mesh)


def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def run(sharded):
    put = distribute if sharded else (lambda tree, shardings: tree)
    ps = put(params, psh)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with implicit_replication():
        loss, grads = value_and_grad(
            model, ps, put(batch, _batch_shardings(batch, mesh)))
    step, _, (_, bsh), _ = make_step(cfg, "prefill_32k", mesh,
                                     batch_override=4, seq_override=16)
    pre = step(ps, put({"tokens": toks[:, :16]}, bsh))[0]
    step, _, (_, csh, tsh, qsh), _ = make_step(
        cfg, "decode_32k", mesh, batch_override=4, seq_override=32)
    cache = model.init_cache(4, 32)
    pos = torch.full((4,), 16, dtype=torch.int32)
    dec = step(ps, put(cache, csh), put(toks[:, 16:], tsh),
               put(pos, qsh))[0]
    return [full(loss)] + [full(t) for t in tree_leaves(grads)] + \
        [full(pre), full(dec)]


sharded = run(True)
one = run(False)
diff = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
           for a, b in zip(sharded, one))
if rank == 0:
    print(json.dumps({"max_rel_diff": diff, "n": len(sharded)}))
dist.destroy_process_group()
"""


def test_sharded_steps_equal_one_process():
    """The sharded train step's loss and gradients, a sharded prefill and a
    sharded decode step (its cache heads split over 'model', so the decode
    repeats them) on a 2x2 mesh of gloo ranks, fp32: the vocab product
    shard by shard, its gradients' placements and the grouped products
    against the same steps on plain tensors, each within 1e-5 of the
    largest value."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANKS, str(r), "4",
         f"tcp://localhost:{port}"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(4)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    got = json.loads(outs[0][0].strip().splitlines()[-1])
    print(got)
    assert got["n"] > 10 and got["max_rel_diff"] <= 1e-5, got


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the out_dtype products have no "
                    "CPU kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [((37, 64), (64, 29)),
                                   ((3, 17, 128), (3, 128, 40)),
                                   ((4096, 4096), (4096, 1000))])
def test_cuda_product_equals_plain(shape):
    _card()
    rng = np.random.default_rng(3)
    a, b = _bf16(rng, *shape[0]), _bf16(rng, *shape[1])
    got = nn.matmul_f32(a.cuda(), b.cuda()).cpu()
    assert got.dtype == torch.float32
    eq = "mk,kn->mn" if a.ndim == 2 else "bmk,bkn->bmn"
    _assert_within(got, nn.matmul_f32(a, b),
                   _sum_bound(a, b, eq, a.shape[-1]),
                   "out_dtype product vs plain")


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,H,KV", [(1, 1, 32, 8), (8, 1, 32, 8),
                                        (2, 33, 32, 8)])
def test_cuda_grouped_equals_plain(B, Sq, H, KV):
    _card()
    rng = np.random.default_rng(4)
    Sk, dh = 300, 128
    q, k, v = _bf16(rng, B, Sq, H, dh), _bf16(rng, B, Sk, KV, dh), \
        _bf16(rng, B, Sk, KV, dh)
    p = torch.softmax(_bf16(rng, B, H, Sq, Sk).float(), -1).to(torch.bfloat16)
    c = [t.cuda() for t in (q, k, v, p)]
    krt, vrt = nn._repeat_kv(k, H // KV), nn._repeat_kv(v, H // KV)
    _assert_within(nn.grouped_scores(c[0], c[1]).cpu(),
                   nn.grouped_scores(q, k),
                   _sum_bound(q, krt, "bqhd,bkhd->bhqk", dh), "scores")
    _assert_within(nn.grouped_values(c[3], c[2], f32=True).cpu(),
                   nn.grouped_values(p, v, f32=True),
                   _sum_bound(p, vrt, "bhqk,bkhd->bhqd", Sk), "values")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [((64, 256), (256, 48)),
                                   ((2, 128, 1024), (2, 1024, 96)),
                                   ((512, 4096), (4096, 8192))])
def test_cuda_product_gradients_against_float64(shape):
    _card()
    rng = np.random.default_rng(5)
    a, b = _bf16(rng, *shape[0]), _bf16(rng, *shape[1])
    g = torch.from_numpy(rng.standard_normal(
        shape[0][:-1] + shape[1][-1:]).astype(np.float32))
    ac, bc = (t.cuda().requires_grad_() for t in (a, b))
    out = nn.matmul_f32(ac, bc)
    out.backward(g.cuda())
    assert ac.grad.dtype == torch.bfloat16 and bc.grad.dtype == torch.bfloat16
    K = shape[1][-1]
    ga = g.double() @ b.double().mT
    gb = a.double().mT @ g.double()
    bound_a = (2 ** -8 + K * 2 ** -23) * (g.double().abs() @
                                          b.double().abs().mT)
    Ka = shape[0][-2]
    bound_b = (2 ** -8 + Ka * 2 ** -23) * (a.double().abs().mT @
                                           g.double().abs())
    _assert_within(ac.grad.cpu(), ga, bound_a, "grad of a")
    _assert_within(bc.grad.cpu(), gb, bound_b, "grad of b")
