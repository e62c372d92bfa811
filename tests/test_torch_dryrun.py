"""The port's dry run (`launch.dryrun`) on smoke configs over a fake 2x4
process group, in subprocesses (a process holds one process group):

* `run_cell` for every family (dense, vlm, moe homogeneous and alternating,
  ssm, hybrid, encdec) and every shape: "ok" with the reference's record
  keys, or "skipped" for long_500k on a full-attention arch;
* on one device, the counted FLOPs equal the closed form exactly:
  2·(matmul parameters)·tokens + 4·B·H·Sq·Sk·dh per layer (the naive
  attention computes every score) + the logits' product; a train step is
  three forwards (forward, backward's two products per product) plus
  remat's recomputation, which stops before each layer's last product
  (non-reentrant checkpointing recomputes only what the backward needs);
* `two_point_counts` equals the full pass on a homogeneous stack;
* the "opt" variant runs, and its causal tiles skip work on one device;
* the CLI, and the report and sections rendered from the cells.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILY_ARCHS = {"qwen3-0.6b": "dense", "internvl2-26b": "vlm",
                "qwen3-moe-30b-a3b": "moe",
                "llama4-maverick-400b-a17b": "moe",
                "whisper-large-v3": "encdec", "mamba2-2.7b": "ssm",
                "zamba2-1.2b": "hybrid"}
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
# the slow SSD chunk loops (smoke chunk 8 over 32768 tokens) get their own
# processes, run side by side
GROUPS = (("qwen3-0.6b", "internvl2-26b", "qwen3-moe-30b-a3b",
           "llama4-maverick-400b-a17b", "whisper-large-v3"),
          ("mamba2-2.7b",), ("zamba2-1.2b",))

_CELLS = r"""
import json, sys
from repro_torch.launch import dryrun
dryrun.OUT_DIR = sys.argv[1]
out = {}
for arch in sys.argv[2].split(","):
    for shape in %r:
        r = dryrun.run_cell(arch, shape, "debug", force=True, smoke=True)
        r.pop("traceback", None)
        out[f"{arch}/{shape}"] = r
print(json.dumps(out))
""" % (SHAPES,)

_CHECKS = r"""
import dataclasses, json, sys
from repro_torch.configs import SHAPES, get_smoke_config
from repro_torch.launch import dryrun
dryrun.OUT_DIR = sys.argv[1]
out = {}
one = dryrun._mesh("one")
for arch in ("llama3-1-8b", "qwen3-0.6b"):
    for shape in ("prefill_32k", "decode_32k", "train_4k"):
        for variant in ("base", "opt"):
            cfg = dryrun.apply_variant(get_smoke_config(arch), shape, variant)
            out[f"one/{arch}/{shape}/{variant}"] = dryrun.count_step(
                cfg, shape, one)["flops"]
debug = dryrun._mesh("debug")
cfg6 = dataclasses.replace(get_smoke_config("llama3-1-8b"), num_layers=6)
for shape in ("prefill_32k", "decode_32k", "train_4k"):
    full = dryrun.count_step(cfg6, shape, debug)
    two = dryrun.two_point_counts(cfg6, shape, debug)
    out[f"two_point/{shape}"] = {
        "full": [full["flops"], full["bytes_accessed"],
                 full["collective_bytes"]], "two_point": list(two[:3])}
for shape in ("prefill_32k", "decode_32k", "train_4k"):
    r = dryrun.run_cell("llama3-1-8b", shape, "debug", force=True,
                        variant="opt", smoke=True)
    out[f"opt/{shape}"] = r["status"]
print(json.dumps(out))
"""


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                OMP_NUM_THREADS="1")


def _json_of(proc):
    out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every family's cells and the one-device / two-point / opt checks,
    in processes run side by side."""
    d = str(tmp_path_factory.mktemp("dryrun"))
    procs = [subprocess.Popen([sys.executable, "-c", _CELLS, d, ",".join(g)],
                              env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for g in GROUPS]
    procs.append(subprocess.Popen([sys.executable, "-c", _CHECKS, d],
                                  env=_env(), stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True))
    cells = {}
    for p in procs[:-1]:
        cells.update(_json_of(p))
    return {"cells": cells, "checks": _json_of(procs[-1]), "dir": d}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", list(FAMILY_ARCHS))
def test_run_cell_every_family_and_shape(runs, arch, shape):
    from repro_torch.configs import get_smoke_config
    r = runs["cells"][f"{arch}/{shape}"]
    if shape == "long_500k" and not get_smoke_config(arch).subquadratic:
        assert r["status"] == "skipped" and "sub-quadratic" in r["reason"]
        return
    assert r["status"] == "ok", r.get("error")
    assert r["num_devices"] == 8
    for key in ("flops", "bytes_accessed", "collective_bytes"):
        assert r[key] > 0, (key, r)
    mem = r["memory_analysis"]
    assert mem["argument_size_in_bytes"] > 0
    assert mem["temp_size_in_bytes"] > 0
    terms = r["roofline"]
    assert terms["bottleneck"] in ("compute", "memory", "collective")
    assert terms["step_time_bound_s"] == max(
        terms["compute_s"], terms["memory_s"], terms["collective_s"])
    # counted on the busier of the first and the last rank; the floor from
    # the bytes the step must move and its useful FLOPs
    assert r["counted_rank"] in (0, 7) and set(r["per_rank"]) == {"0", "7"}
    assert r["flops"] == max(v["flops"] for v in r["per_rank"].values())
    floor = r["floor"]
    assert r["moved_bytes"] >= mem["argument_size_in_bytes"]
    assert floor["floor_memory_s"] == r["moved_bytes"] / 3.35e12
    assert floor["step_time_floor_s"] == max(floor["floor_compute_s"],
                                             floor["floor_memory_s"]) > 0
    with open(os.path.join(runs["dir"],
                           f"{arch}__{shape}__debug__smoke.json")) as f:
        assert json.load(f)["flops"] == r["flops"]


def closed_form(cfg, shape_name):
    """The step's matmul FLOPs on one device (see the module docstring)."""
    from repro_torch.configs import SHAPES as S
    sh = S[shape_name]
    B, T = sh.global_batch, sh.seq_len
    d, H, KV, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ff, L, V = cfg.d_ff, cfg.num_layers, cfg.padded_vocab
    per_token = L * (d * H * dh + 2 * d * KV * dh + H * dh * d + 3 * d * ff)
    if sh.kind == "decode":
        return 2 * per_token * B + 4 * B * H * T * dh * L + 2 * B * d * V
    attention = 4 * B * H * T * T * dh * L
    if sh.kind == "prefill":  # logits of the last token only
        return 2 * per_token * B * T + attention + 2 * B * d * V
    forward = 2 * per_token * B * T + attention
    not_recomputed = 2 * B * T * ff * d * L  # each layer's MLP output product
    return 4 * forward - not_recomputed + 3 * 2 * B * T * d * V


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "train_4k"])
@pytest.mark.parametrize("arch", ["llama3-1-8b", "qwen3-0.6b"])
def test_one_device_flops_equal_closed_form(runs, arch, shape):
    from repro_torch.configs import get_smoke_config
    got = runs["checks"][f"one/{arch}/{shape}/base"]
    assert got == closed_form(get_smoke_config(arch), shape)


@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k"])
def test_blocked_causal_tiles_skip_work(runs, shape):
    """The opt variant's query tiles attend only to their causal horizon
    (decode_32k's blocked decode does the same products as the naive)."""
    c = runs["checks"]
    for arch in ("llama3-1-8b", "qwen3-0.6b"):
        assert c[f"one/{arch}/{shape}/opt"] < c[f"one/{arch}/{shape}/base"]
        assert c[f"one/{arch}/decode_32k/opt"] == \
            c[f"one/{arch}/decode_32k/base"]


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "train_4k"])
def test_two_point_equals_full_pass(runs, shape):
    r = runs["checks"][f"two_point/{shape}"]
    assert r["two_point"] == pytest.approx(r["full"], rel=1e-9), r


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "train_4k"])
def test_opt_variant_runs(runs, shape):
    assert runs["checks"][f"opt/{shape}"] == "ok"


def test_cli_and_report(runs, tmp_path, monkeypatch):
    script = ("import sys\nfrom repro_torch.launch import dryrun\n"
              f"dryrun.OUT_DIR = {str(tmp_path)!r}\n"
              "sys.argv = ['dryrun', '--arch', 'qwen3-0.6b', '--smoke', "
              "'--shape', 'decode_32k', '--mesh', 'debug']\n"
              "sys.exit(dryrun.main())\n")
    out = subprocess.run([sys.executable, "-c", script], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = out.stdout.strip().splitlines()[-1]
    assert "qwen3-0.6b" in line and " ok " in line and "bottleneck=" in line
    assert os.path.exists(tmp_path / "qwen3-0.6b__decode_32k__debug__smoke.json")

    from repro_torch.roofline import experiments_md, report
    monkeypatch.setattr(report, "DRYRUN_DIR", runs["dir"])
    cells = report.load_cells("debug__smoke")
    assert len(cells) == len(FAMILY_ARCHS) * len(SHAPES)
    table = report.table(cells)
    assert table.count("\n") == len(cells) + 1
    assert "skip" in table
    cand = report.candidates(cells)
    assert set(cand) == {"worst_fraction", "most_collective"}
    assert "989 TFLOP/s" in experiments_md.HW_NOTE
    assert "TPU" not in experiments_md.HW_NOTE


def test_moved_bytes_counts_an_in_place_output_once():
    """The floor's bytes: arguments read once, outputs written once, and an
    output that is an argument updated in place (the decode cache) once."""
    from repro_torch.launch import dryrun
    cache, w = torch.zeros(4, 8), torch.ones(8, 2)
    args = dryrun.local_storages([{"cache": cache, "w": w}, cache[:1]])
    out = (torch.ones(2), cache)
    assert dryrun.moved_bytes(args, dryrun.local_storages(out)) == \
        (32 + 16 + 2) * 4
