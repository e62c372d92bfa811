"""The port's sharded steps over 8 gloo ranks (one process each, on the
CPU), the counterparts of ``tests/test_distributed.py``:

* the sharded train step on a 2x4 mesh against one device: loss within
  1e-4, every leaf within the reference test's rtol=5e-3, atol=5e-4 (the
  reference skips its own case on the CPU; the port holds it);
* decode with a sequence-sharded cache against unsharded decode (naive and
  blocked), logits within the reference test's rtol=atol=2e-3, and the
  cache written in place on its shards;
* the blocked prefill with q sequence-sharded (O2) against one device;
* the expert-parallel MoE (qwen3-moe, llama4) sharded against one device:
  prefill and decode logits within 2e-3, the loss within 1e-4;
* elastic restore: a checkpoint of parameters sharded on a 2x4 mesh (one
  directory, written by the mesh's first rank) restored onto a 4x2 one by
  every rank, bit-equal, every leaf on the new mesh;
* ``TrainSupervisor(..., shardings=)`` over one shared checkpoint
  directory: a node failure restarts from the last checkpoint onto the
  mesh, and the losses equal an uninterrupted run's bit for bit;
* the dry run's per-device counts: `CostMode` on real gloo ranks equals
  the same step counted on meta tensors over a fake group of 8 (the dry
  run's way, on the busier of its first and last rank; bytes within 1e-5,
  see the test); every rank counts the same, except under O2, where the
  last 'model' coordinate counts the most and is the rank reported.

All cases run in one launch of 8 ranks (a module fixture); each test reads
its case's result.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
CUT = {"train_4k": (8, 16), "prefill_32k": (4, 64), "decode_32k": (4, 64)}
# O2's blocked prefill at the prefill cut, with key tiles that divide it
OPT = ("prefill_32k", 8)

_RANK_SCRIPT = r"""
import dataclasses, json, os, sys, traceback
import numpy as np
import torch
import torch.distributed as dist

rank, world, init, out_dir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                              sys.argv[4])
dist.init_process_group("gloo", init_method=init, rank=rank,
                        world_size=world)
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.sharding import distribute, param_shardings
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.steps import _batch_shardings, make_step
from repro_torch.models import build_model
from repro_torch.training import (AdamWConfig, SimulatedFailure, SyntheticLM,
                                  TrainSupervisor, adamw_init,
                                  make_train_step, restore_checkpoint,
                                  save_checkpoint)
from repro_torch.training.tree import tree_leaves

CUT = json.loads(sys.argv[5])
OPT_SHAPE, OPT_BLOCK = json.loads(sys.argv[6])
mesh = make_debug_mesh(2, 4, device_type="cpu")


def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def gen(seed):
    return torch.Generator().manual_seed(seed)


def init(arch):
    cfg = get_smoke_config(arch)
    model = build_model(cfg, "cpu")
    return cfg, model, model.init_params(gen(0))


def lm_batch(cfg, step, seq=16, batch=8):
    b = SyntheticLM(cfg.vocab_size, seq, batch, seed=0).batch_at(step)
    return {k: torch.as_tensor(v) for k, v in b.items()}


def case_train():
    cfg, model, params = init("qwen3-0.6b")
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=0)
    opt = adamw_init(params, ocfg)
    batch = lm_batch(cfg, 0)
    p1, o1, m1 = make_train_step(model, ocfg, remat=False)(params, opt, batch)
    step, _, (psh, osh, _), _ = make_step(
        cfg, "train_4k", mesh, remat=False, opt_cfg=ocfg, batch_override=8,
        seq_override=16)
    p2, o2, m2 = step(distribute(params, psh), distribute(opt, osh),
                      distribute(batch, _batch_shardings(batch, mesh)))
    diffs, ok, kept = [], True, True
    for a, b, s in zip(tree_leaves(p1), tree_leaves(p2), tree_leaves(psh)):
        fb = full(b).float()
        diffs.append(float((a.float() - fb).abs().max()))
        ok &= bool(torch.allclose(fb, a.float(), rtol=5e-3, atol=5e-4))
        kept &= tuple(b.placements) == tuple(s.placements)
    return {"loss_1": float(m1["loss"]), "loss_mesh": float(m2["loss"]),
            "max_leaf_diff": max(diffs), "leaves_close": ok,
            "placements_kept": kept}


def case_decode():
    out = {}
    for impl in ("naive", "blocked"):
        cfg, model, params = init("qwen3-0.6b")
        cfg = dataclasses.replace(cfg, decode_impl=impl, decode_blocks=4)
        model = build_model(cfg, "cpu")
        B, S = 4, 32
        tokens = torch.randint(0, 200, (B, 8), generator=gen(1))
        _, cache = model.prefill(params, {"tokens": tokens})
        cache_full = model.init_cache(B, S)
        cache_full[:, :, :, :8] = cache
        tok, pos = tokens[:, -1:], torch.full((B,), 8, dtype=torch.int32)
        d1, c1 = model.decode_step(params, cache_full.clone(), tok, pos)
        step, _, (psh, csh, tsh, qsh), _ = make_step(
            cfg, "decode_32k", mesh, batch_override=B, seq_override=S)
        d2, c2 = step(distribute(params, psh), distribute(cache_full, csh),
                      distribute(tok, tsh), distribute(pos, qsh))
        out[impl] = {
            "logit_diff": float((d1 - full(d2)).abs().max()),
            "logits_close": bool(torch.allclose(full(d2), d1, rtol=2e-3,
                                                atol=2e-3)),
            "cache_diff": float((c1 - full(c2)).abs().max()),
            "cache_placements": [str(p) for p in c2.placements],
            "want_placements": [str(p) for p in csh.placements]}
    return out


def case_seq_shard():
    # O2: the blocked prefill with q sequence-sharded over 'model', against
    # one device's naive prefill
    cfg, model, params = init("qwen3-0.6b")
    opt = dataclasses.replace(cfg, attn_impl="blocked", attn_block_k=8,
                              attn_seq_shard=True)
    tokens = torch.randint(0, cfg.vocab_size, (4, 32), generator=gen(4))
    lg1, c1 = model.prefill(params, {"tokens": tokens})
    step, _, (psh, bsh), _ = make_step(opt, "prefill_32k", mesh,
                                       batch_override=4, seq_override=32)
    lg2, c2 = step(distribute(params, psh),
                   distribute({"tokens": tokens}, bsh))
    return {"logit_diff": float((lg1 - full(lg2)).abs().max()),
            "cache_diff": float((c1 - full(c2)).abs().max())}


def case_moe():
    # the expert-parallel ragged dispatch: sharded prefill, decode and loss
    # against one device
    out = {}
    for arch in ("qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b"):
        cfg, model, params = init(arch)
        B, S = 4, 16
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen(3))
        lg1, c1 = model.prefill(params, {"tokens": tokens})
        step, _, (psh, bsh), _ = make_step(cfg, "prefill_32k", mesh,
                                           batch_override=B, seq_override=S)
        p = distribute(params, psh)
        lg2, c2 = step(p, distribute({"tokens": tokens}, bsh))
        cache = model.init_cache(B, S + 4)
        cache[:, :, :, :S] = c1
        tok, pos = tokens[:, -1:], torch.full((B,), S, dtype=torch.int32)
        d1, _ = model.decode_step(params, cache.clone(), tok, pos)
        dstep, _, (_, csh, tsh, qsh), _ = make_step(
            cfg, "decode_32k", mesh, batch_override=B, seq_override=S + 4)
        d2, _ = dstep(p, distribute(cache, csh), distribute(tok, tsh),
                      distribute(pos, qsh))
        batch = {"tokens": tokens, "labels": torch.roll(tokens, 1, 1)}
        l1 = float(model.loss(params, batch))
        tstep, _, (_, osh, _), _ = make_step(
            cfg, "train_4k", mesh, remat=False, batch_override=B,
            seq_override=S)
        opt = adamw_init(params, AdamWConfig())
        _, _, m2 = tstep(p, distribute(opt, osh),
                         distribute(batch, _batch_shardings(batch, mesh)))
        out[arch] = {"prefill_diff": float((lg1 - full(lg2)).abs().max()),
                     "decode_diff": float((d1 - full(d2)).abs().max()),
                     "loss_diff": abs(l1 - float(m2["loss"]))}
    return out


def case_elastic():
    cfg, model, params = init("qwen3-0.6b")
    mesh_a = make_debug_mesh(2, 4, device_type="cpu")
    pa = distribute(params, param_shardings(params, mesh_a))
    d = f"{out_dir}/elastic"  # one checkpoint, written by rank 0
    save_checkpoint(d, 5, pa)
    written = sorted(os.listdir(d))
    mesh_b = make_debug_mesh(4, 2, device_type="cpu")
    pb, _ = restore_checkpoint(d, 5, params,
                               shardings=param_shardings(params, mesh_b))
    leaves = tree_leaves(pb)
    return {"bit_equal": all(torch.equal(a, full(b)) for a, b in
                             zip(tree_leaves(params), leaves)),
            "on_new_mesh": all(isinstance(b, DTensor) and
                               b.device_mesh.shape == (4, 2) and
                               b.device_mesh.mesh_dim_names ==
                               ("data", "model") for b in leaves),
            "sharded_somewhere": any(not p.is_replicate() for b in leaves
                                     for p in b.placements),
            "one_checkpoint": written == ["step_00000005"]}


def case_supervisor():
    cfg, model, params = init("smollm-135m")
    ocfg = AdamWConfig(lr=5e-3, warmup_steps=0)
    step, _, (psh, osh, _), _ = make_step(
        cfg, "train_4k", mesh, remat=False, opt_cfg=ocfg, batch_override=8,
        seq_override=16)
    bsh = _batch_shardings(lm_batch(cfg, 0), mesh)

    def run(tag, fail_at):
        sup = TrainSupervisor(
            step, distribute(params, psh),
            distribute(adamw_init(params, ocfg), osh),
            ckpt_dir=f"{out_dir}/sup_{tag}", ckpt_every=2,
            shardings=(psh, osh))
        fired = []

        def inject(s):
            if s == fail_at and not fired:
                fired.append(s)
                raise SimulatedFailure("node lost")
        stats = sup.run(lambda s: distribute(lm_batch(cfg, s), bsh), 6,
                        failure_injector=inject)
        return stats, sup
    clean, _ = run("clean", -1)
    failed, sup = run("failed", 3)
    leaves = tree_leaves(sup.params)
    return {"restarts": failed.restarts,
            # steps 0-2, the failure at 3, a restart from the checkpoint of
            # step 2, then steps 2-5 again: the replay is bit-equal
            "losses_equal": failed.losses[:3] == clean.losses[:3]
            and failed.losses[3:] == clean.losses[2:],
            "losses": failed.losses,
            "on_mesh": all(isinstance(b, DTensor) and b.device_mesh == mesh
                           for b in leaves)}


def case_counts():
    out = {}
    base = get_smoke_config("llama3-1-8b")
    params = build_model(base, "cpu").init_params(gen(0))
    opt = dataclasses.replace(
        dryrun.apply_variant(base, OPT_SHAPE, "opt"), attn_block_k=OPT_BLOCK)
    for name, (shape, cfg) in {**{k: (k, base) for k in CUT},
                               "opt": (OPT_SHAPE, opt)}.items():
        b, s = CUT[shape]
        specs = make_step(cfg, shape, mesh, batch_override=b,
                          seq_override=s)[1]
        args = list(specs)
        args[0] = params
        if shape == "train_4k":
            from repro_torch.training.optimizer import AdamWConfig as A
            args[1] = adamw_init(params, A())
            args[2] = dryrun.realize(specs[2], cfg, gen(2), "cpu", s)
        elif shape == "prefill_32k":
            args[1] = dryrun.realize(specs[1], cfg, gen(2), "cpu", s)
        else:
            r = dryrun.realize({"cache": specs[1], "token": specs[2],
                                "pos": specs[3]}, cfg, gen(2), "cpu", s)
            args[1:] = [r["cache"], r["token"], r["pos"]]
        c = dryrun.count_step(cfg, shape, mesh, args=args, batch_override=b,
                              seq_override=s)
        c.pop("run_s")
        every = [None] * world
        dist.all_gather_object(every, c)
        out[name] = every
    return out


results = {}
for name in ("train", "decode", "seq_shard", "moe", "elastic", "supervisor",
             "counts"):
    try:
        results[name] = globals()["case_" + name]()
    except Exception:
        results[name] = {"error": traceback.format_exc()}
    dist.barrier()
if rank == 0:
    with open(f"{out_dir}/results.json", "w") as f:
        json.dump(results, f)
dist.destroy_process_group()
"""

_FAKE_COUNTS = r"""
import dataclasses, json, sys
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun
cut = json.loads(sys.argv[1])
opt_shape, opt_block = json.loads(sys.argv[2])
base = get_smoke_config("llama3-1-8b")
opt = dataclasses.replace(dryrun.apply_variant(base, opt_shape, "opt"),
                          attn_block_k=opt_block)
out = {}
for name, (shape, cfg) in {**{k: (k, base) for k in cut},
                           "opt": (opt_shape, opt)}.items():
    b, s = cut[shape]
    c = dryrun.count_busiest(cfg, shape, "debug", device_type="cpu",
                             batch_override=b, seq_override=s)
    c.pop("run_s")
    out[name] = c
print(json.dumps(out))
"""


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo8")
    script = tmp / "rank.py"
    script.write_text(_RANK_SCRIPT)
    init = f"file://{tmp / 'pg'}"
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(WORLD), init, str(tmp),
         json.dumps(CUT), json.dumps(OPT)], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(WORLD)]
    try:
        outs = [p.communicate(timeout=400)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), outs[0][-4000:]
    with open(tmp / "results.json") as f:
        return json.load(f)


def _case(results, name):
    r = results[name]
    assert "error" not in r, r.get("error")
    return r


def test_sharded_train_step_matches_one_device(results):
    r = _case(results, "train")
    print(r)
    assert abs(r["loss_1"] - r["loss_mesh"]) < 1e-4, r
    assert r["leaves_close"], r
    assert r["placements_kept"], r


@pytest.mark.parametrize("impl", ["naive", "blocked"])
def test_sequence_sharded_decode_matches_unsharded(results, impl):
    r = _case(results, "decode")[impl]
    print(r)
    assert r["logits_close"], r
    assert r["cache_diff"] < 2e-3, r
    assert r["cache_placements"] == r["want_placements"], r
    assert "S(3)" in r["cache_placements"], r


def test_sequence_sharded_blocked_prefill_matches_one_device(results):
    """O2 (q sharded on its sequence over 'model', blocked attention on
    each rank's rows) against one device's naive prefill: logits and
    cache within the reference's 2e-3."""
    r = _case(results, "seq_shard")
    print(r)
    assert r["logit_diff"] <= 2e-3 and r["cache_diff"] <= 2e-3, r


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b",
                                  "llama4-maverick-400b-a17b"])
def test_expert_parallel_moe_matches_one_device(results, arch):
    """Prefill and decode logits within the reference test's 2e-3, the
    loss (with the load-balance term) within 1e-4."""
    r = _case(results, "moe")[arch]
    print(r)
    assert r["prefill_diff"] <= 2e-3 and r["decode_diff"] <= 2e-3, r
    assert r["loss_diff"] < 1e-4, r


def test_elastic_restore_2x4_to_4x2_bit_equal(results):
    r = _case(results, "elastic")
    assert r["bit_equal"] and r["on_new_mesh"] and r["sharded_somewhere"], r
    assert r["one_checkpoint"], r


def test_supervisor_restores_onto_its_mesh(results):
    r = _case(results, "supervisor")
    assert r["restarts"] == 1, r
    assert r["losses_equal"], r
    assert r["on_mesh"], r


@pytest.fixture(scope="module")
def fake_counts():
    out = subprocess.run([sys.executable, "-c", _FAKE_COUNTS, json.dumps(CUT),
                          json.dumps(OPT)],
                         env=_env(), capture_output=True, text=True,
                         timeout=400)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _same_counts(real, fake):
    """A real rank's counts == the dry run's, bytes within 1e-5."""
    for key in ("flops", "collective_bytes", "collectives", "moved_bytes"):
        assert real[key] == fake[key], (key, real, fake)
    # on meta tensors a few scalar constants are copied onto the device,
    # which the CPU run does not need (12 bytes of 8e6 measured)
    assert real["bytes_accessed"] == pytest.approx(fake["bytes_accessed"],
                                                   rel=1e-5)
    assert real["flops"] > 0
    mem_r, mem_f = real["memory_analysis"], fake["memory_analysis"]
    assert mem_r["argument_size_in_bytes"] == mem_f["argument_size_in_bytes"]
    assert mem_r["output_size_in_bytes"] == mem_f["output_size_in_bytes"]


@pytest.mark.parametrize("shape", list(CUT))
def test_dry_run_counts_equal_real_ranks(results, fake_counts, shape):
    """Counted on meta tensors over a fake group == counted by the same
    rank of eight gloo ranks running the same step on real tensors, and
    every rank counts the same."""
    every = _case(results, "counts")[shape]
    assert all(e == every[0] for e in every), every
    fake = fake_counts[shape]
    assert fake["counted_rank"] in (0, WORLD - 1)
    _same_counts(every[fake["counted_rank"]], fake)


def test_dry_run_counts_the_busiest_rank(results, fake_counts):
    """Under O2 the ranks' work differs (query rows at a higher 'model'
    coordinate attend to more keys): the dry run reports the last rank,
    whose counts equal the busiest real rank's."""
    every = _case(results, "counts")["opt"]
    flops = [e["flops"] for e in every]
    assert len(set(flops)) > 1, flops
    fake = fake_counts["opt"]
    assert fake["counted_rank"] == WORLD - 1, fake["per_rank"]
    assert fake["flops"] == max(flops) > fake["per_rank"]["0"]["flops"]
    assert fake["per_rank"]["0"]["flops"] == min(flops)
    _same_counts(every[WORLD - 1], fake)
