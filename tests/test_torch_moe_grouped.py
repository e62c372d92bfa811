"""The MoE ragged dispatch's grouped products (`moe._expert_grouped`)
against its plain version, the per-expert chain (`moe._expert_loop`).

* Grouped == chain on the CPU in bf16 (``torch._grouped_mm`` has a CPU
  kernel there): outputs, the zero rows of pairs routed to other ranks'
  experts (`moe._moe_sharded`'s key E_l), and the gradients of the input
  and of the three weight stacks, for counts with empty experts, one
  expert taking every row, and other ranks' keys.  Both sides run the same
  bf16 product per group, so the outputs must agree bit for bit; the
  gradients (sums over a group's rows, in other kernels) within
  GRAD_BF16_STEPS bf16 steps of each tensor's largest magnitude.
* The group offsets handed to the product are the cumulative counts.
* The dispatch makes no host read: on meta tensors (which have no values
  to read) the grouped path runs with no counts given, and the chain's
  `.tolist()` is reached only for CPU tensors.
* `roofline.CostMode` counts a grouped product's FLOPs as the chain's,
  forward and backward, on meta under balanced routing and on the CPU
  with real offsets.
* The grouped path's `moe_mlp` against the reference's ``ragged_dot``
  (bf16, JAX imported inside the test), within REF_BF16_STEPS bf16 steps.
* On the card (`cuda` marker): the grouped path against the chain.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import moe  # noqa: E402
from repro_torch.roofline.analysis import CostMode  # noqa: E402

GRAD_BF16_STEPS = 2
REF_BF16_STEPS = 4
E_L, D, F = 6, 32, 48


def _needs_grouped_mm():
    if not hasattr(torch, "_grouped_mm"):
        pytest.skip("this torch has no torch._grouped_mm")


def _step(t) -> float:
    """One bf16 rounding step at the largest |t|."""
    top = float(t.float().abs().max())
    return 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


# (name, count per expert among E_L, pairs of other ranks' experts)
CASES = [("empty experts", [3, 0, 17, 1, 0, 9], 0),
         ("one expert takes every row", [0, 0, 40, 0, 0, 0], 0),
         ("other ranks' keys", [2, 5, 0, 0, 11, 4], 13),
         ("only other ranks' keys", [0] * E_L, 8)]


def _inputs(counts, others, seed=0, device="cpu"):
    """xs [M, D] bf16 sorted by key, key [M] (E_L = held elsewhere) and the
    three weight stacks, from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    key = torch.tensor(sum(([e] * n for e, n in enumerate(counts)), [])
                       + [E_L] * others, dtype=torch.long, device=device)
    M = key.numel()

    def bf16(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) * scale).to(device=device, dtype=torch.bfloat16)

    xs = bf16(M, D)
    ws = [bf16(E_L, D, F, scale=D ** -0.5), bf16(E_L, D, F, scale=D ** -0.5),
          bf16(E_L, F, D, scale=F ** -0.5)]
    return xs, key, ws


def _run(fn, xs, key, ws, seed=1):
    xs = xs.clone().requires_grad_()
    ws = [w.clone().requires_grad_() for w in ws]
    out = fn(xs, key, ws)
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        tuple(out.shape)).astype(np.float32)).to(out.device, out.dtype)
    if out.requires_grad:  # the chain with no pairs in a group has none
        out.backward(g)
    return out.detach(), [torch.zeros_like(t) if t.grad is None else t.grad
                          for t in [xs] + ws]


@pytest.mark.parametrize("name,counts,others", CASES,
                         ids=[c[0] for c in CASES])
def test_grouped_equals_chain(name, counts, others):
    _needs_grouped_mm()
    xs, key, ws = _inputs(counts, others)
    out_g, grads_g = _run(moe._expert_grouped, xs, key, ws)
    out_c, grads_c = _run(moe._expert_loop, xs, key, ws)
    n = sum(counts)
    print(f"{name}: rows in groups {n} of {key.numel()}; outputs bit-equal "
          f"{torch.equal(out_g, out_c)}")
    assert torch.equal(out_g, out_c)
    assert not out_g[n:].any(), "other ranks' pairs must give zero rows"
    for what, a, b in zip(("xs", "gate", "up", "out"), grads_g, grads_c):
        diff = float((a.float() - b.float()).abs().max())
        bound = GRAD_BF16_STEPS * _step(b)
        print(f"  grad {what}: max_abs_diff {diff:.3g} (bound {bound:.3g})")
        assert diff <= bound, what
    assert not grads_g[0][n:].any(), "other ranks' pairs get zero gradient"


@pytest.mark.parametrize("name,counts,others", CASES,
                         ids=[c[0] for c in CASES])
def test_offsets_are_cumulative_counts(monkeypatch, name, counts, others):
    _needs_grouped_mm()
    xs, key, ws = _inputs(counts, others)
    seen, real = [], torch._grouped_mm

    def spy(a, b, offs=None, **kw):
        seen.append(offs.clone())
        return real(a, b, offs=offs, **kw)

    monkeypatch.setattr(torch, "_grouped_mm", spy)
    moe._expert_grouped(xs, key, ws)
    want = torch.tensor(np.cumsum(counts), dtype=torch.int32)
    assert len(seen) == 3
    for offs in seen:
        assert offs.dtype == torch.int32 and torch.equal(offs, want)


@pytest.mark.parametrize("name,counts,others", CASES,
                         ids=[c[0] for c in CASES])
def test_chain_combined_grouped_equals_chain(monkeypatch, name, counts,
                                             others):
    """`_expert_chain` (sort, products, combine back to tokens) with the
    grouped products against the same with the chain, tokens in random
    order and k = 2 pairs each."""
    _needs_grouped_mm()
    xs, key, ws = _inputs(counts, others, seed=3)
    M, k = key.numel(), 2
    T = (M + k - 1) // k
    key = torch.cat([key, key[:T * k - M]])  # T tokens x k pairs
    key = key[torch.from_numpy(np.random.default_rng(4).permutation(T * k))]
    xf = xs[:T]
    topw = torch.softmax(torch.from_numpy(np.random.default_rng(5)
                         .standard_normal((T, k)).astype(np.float32)), -1)
    monkeypatch.setattr(moe, "grouped_dispatch", lambda x: True)
    got = moe._expert_chain(xf, topw, key, ws)
    monkeypatch.setattr(moe, "grouped_dispatch", lambda x: False)
    want = moe._expert_chain(xf, topw, key, ws)
    assert torch.equal(got, want)


def test_dispatch_by_device_and_dtype():
    x = torch.empty(2, 2)
    assert not moe.grouped_dispatch(x)
    assert not moe.grouped_dispatch(x.bfloat16())
    meta = torch.empty(2, 2, device="meta")
    assert not moe.grouped_dispatch(meta)  # no fp32 meta kernel
    assert moe.grouped_dispatch(meta.bfloat16())


def test_no_host_read_off_the_cpu(monkeypatch):
    """On meta tensors any host read (`.tolist()`, `.item()`, a bincount's
    size) raises: the grouped dispatch runs there with no counts given, and
    the chain is never reached; on the CPU the chain is."""
    _needs_grouped_mm()
    calls = []
    real = moe._expert_loop

    def loop(*args):
        calls.append(args[0].device.type)
        return real(*args)

    monkeypatch.setattr(moe, "_expert_loop", loop)
    T, k, E = 16, 2, E_L
    ws = [torch.empty(E, D, F, dtype=torch.bfloat16, device="meta"),
          torch.empty(E, D, F, dtype=torch.bfloat16, device="meta"),
          torch.empty(E, F, D, dtype=torch.bfloat16, device="meta")]
    xf = torch.empty(T, D, dtype=torch.bfloat16, device="meta")
    topw = torch.empty(T, k, device="meta")
    key = torch.empty(T * k, dtype=torch.long, device="meta")
    y = moe._expert_chain(xf, topw, key, ws)
    assert y.shape == (T, D) and calls == []
    # the router's expert counts, too, without a host read
    assert moe._expert_counts(key.view(T, k), E).shape == (E,)
    xs, key, ws = _inputs([3, 0, 5, 0, 0, 2], 0)
    moe._expert_chain(xs[:5], torch.ones(5, 2), key, ws)
    assert calls == ["cpu"]


def _flops(fn, xs, key, ws, counts=None):
    xs = xs.detach().requires_grad_()
    ws = [w.detach().requires_grad_() for w in ws]
    with CostMode() as m:
        out = fn(xs, key, ws, counts)
        out.backward(torch.ones_like(out))
    return m.flops


def test_costmode_counts_grouped_as_chain():
    _needs_grouped_mm()
    # meta, balanced routing (`_moe_sharded`'s counts): 4 of 6 experts here
    # take 5 pairs each, 7 pairs are other ranks'
    counts = [5] * E_L
    M = sum(counts) + 7
    xs = torch.empty(M, D, dtype=torch.bfloat16, device="meta")
    key = torch.empty(M, dtype=torch.long, device="meta")
    ws = [torch.empty(E_L, D, F, dtype=torch.bfloat16, device="meta"),
          torch.empty(E_L, D, F, dtype=torch.bfloat16, device="meta"),
          torch.empty(E_L, F, D, dtype=torch.bfloat16, device="meta")]
    want = 3 * 3 * 2 * sum(counts) * D * F  # 3 products x (fwd + 2 bwd)
    assert _flops(moe._expert_grouped, xs, key, ws, counts) == want
    assert _flops(moe._expert_loop, xs, key, ws, counts) == want
    # the CPU with real offsets: rows past the last group cost nothing
    xs, key, ws = _inputs([3, 0, 17, 1, 0, 9], 13)
    got = _flops(moe._expert_grouped, xs, key, ws)
    assert got == _flops(moe._expert_loop, xs, key, ws) \
        == 3 * 3 * 2 * 30 * D * F


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b",
                                  "llama4-maverick-400b-a17b"])
def test_grouped_moe_mlp_matches_reference(monkeypatch, arch):
    """The grouped dispatch of a bf16 copy of the smoke config's first MoE
    layer against the reference's ``ragged_dot`` in bf16."""
    _needs_grouped_mm()
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import build_model as ref_build
    from repro.models import moe as ref_moe
    from repro_torch.bridge import params_from_reference
    from repro_torch.configs import get_smoke_config

    bf = dict(compute_dtype="bfloat16", param_dtype="bfloat16")
    ref_cfg = dataclasses.replace(ref_smoke(arch), **bf)
    cfg = dataclasses.replace(get_smoke_config(arch), **bf)
    ref_params = jax.jit(ref_build(ref_cfg).init_params)(
        jax.random.PRNGKey(0))
    layers = ref_params["layers"]["moe"]
    if cfg.moe_every != 1:
        layers = layers["moe"]
    ref_p = jax.tree.map(lambda a: a[0], layers)
    p = params_from_reference(jax.tree.map(np.asarray, ref_p), device="cpu")
    x = np.random.default_rng(1).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32)
    want, _ = ref_moe.moe_mlp(ref_p, ref_cfg,
                              jnp.asarray(x, dtype=jnp.bfloat16))
    want = np.asarray(want.astype(jnp.float32))
    monkeypatch.setattr(moe, "grouped_dispatch", lambda t: True)
    got, _ = moe.moe_mlp(p, cfg, torch.from_numpy(x).bfloat16())
    got = got.float().numpy()
    step = _step(torch.from_numpy(want.copy()))
    diff = float(np.abs(got - want).max())
    print(f"{arch}: grouped moe_mlp vs reference ragged_dot max_abs_diff "
          f"{diff:.3g} (bound {REF_BF16_STEPS * step:.3g})")
    assert diff <= REF_BF16_STEPS * step


@pytest.mark.cuda
@pytest.mark.parametrize("name,counts,others", CASES,
                         ids=[c[0] for c in CASES])
def test_cuda_grouped_equals_chain(name, counts, others):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    xs, key, ws = _inputs(counts, others, device="cuda")
    out_g, grads_g = _run(moe._expert_grouped, xs, key, ws)
    out_c, grads_c = _run(moe._expert_loop, xs, key, ws)
    n = sum(counts)
    assert torch.equal(out_g, out_c)
    assert not out_g[n:].any() and not grads_g[0][n:].any()
    for a, b in zip(grads_g, grads_c):
        assert float((a.float() - b.float()).abs().max()) \
            <= GRAD_BF16_STEPS * _step(b)
