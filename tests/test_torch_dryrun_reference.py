"""The port's dry-run counts beside the reference's, on the CPU.

Both packages' dry runs count one step of the same cell on the 16x16 'pod'
mesh, each in a subprocess of its own (a process holds one fake device
set or process group): the reference's `repro.launch.dryrun.run_cell`
(XLA's compiled counts, its ``OUT_DIR`` pointed at a temporary directory
inside the subprocess, and its collective bytes split by kind with the
reference's own HLO rule) and the port's `repro_torch.launch.dryrun.run_cell`
(`roofline.CostMode`).  The reference's roofline uses TPU v5e constants,
so counts are compared, never bounds.

The tests' cells are qwen3-0.6b's decode_32k, base and "opt": the
smallest architecture whose decode weights outweigh its activations, so
that the reference keeps the FSDP-sharded weights in place and moves the
tokens.  Checked:

* the port's decode moves no weight all-gather (`layers.gather_fsdp`,
  ZeRO-3's gather at use, wrapped in the subprocess to count the weights
  it gathers, gathers none), and its collective bytes per device stay
  within REF_COLLECTIVE_FACTOR of the reference's;
* llama3-1-8b's train_4k on this torch: per-device FLOPs within
  TRAIN_FLOPS_RTOL of the closed form / 256 and the peak below the
  57.75 GB it reached before the loss's gradient was pinned.

Run as a script it prints the full table for llama3-1-8b (train_4k,
prefill_32k, prefill_32k opt, decode_32k, decode_32k opt):

    PYTHONPATH=src python tests/test_torch_dryrun_reference.py
"""
import json
import os
import subprocess
import sys
import tempfile

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_COLLECTIVE_FACTOR = 2.0
TRAIN_FLOPS_RTOL = 0.01
LLAMA_TRAIN_FLOPS = 6.691848e16 / 256  # the closed form, one device / 256
LLAMA_TRAIN_PEAK_BEFORE = 57.75e9  # torch 2.13, before the pin
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

_REFERENCE = r"""
import json, sys
import repro.launch.dryrun as dr
from repro.roofline import analysis as ra
dr.OUT_DIR = sys.argv[1]
kinds = {}


def per_kind(hlo):
    # `collective_bytes_from_hlo`'s rule, summed per kind
    out = {}
    for line in hlo.splitlines():
        m = ra._OP_RE.search(line)
        if not m or "-done(" in line:
            continue
        types = ra._TYPE_RE.findall(line[:m.start()])
        if not types:
            continue
        payload = max(ra._type_bytes(dt, dims) for dt, dims in types)
        if m.group(1) == "reduce-scatter":
            g = ra._GROUPS_RE.search(line)
            if g:
                payload *= int(g.group(2))
        out[m.group(1)] = out.get(m.group(1), 0) + payload
    return out


def counted(hlo):  # the last call is the unrolled module's
    kinds.clear()
    kinds.update(per_kind(hlo))
    return total(hlo)


total = dr.collective_bytes_from_hlo
dr.collective_bytes_from_hlo = counted
out = {}
for arch, shape, variant in json.loads(sys.argv[2]):
    r = dr.run_cell(arch, shape, "pod", force=True, variant=variant)
    r.pop("traceback", None)
    r["collective_bytes_by_kind"] = dict(kinds)
    out[f"{arch}/{shape}/{variant}"] = r
print(json.dumps(out))
"""

_PORT = r"""
import json, sys
from repro_torch.launch import dryrun
from repro_torch.models import layers
dryrun.OUT_DIR = sys.argv[1]
gathers = []
gather = layers.gather_fsdp


def counted(w):  # ZeRO-3's weight gathers, as they happen
    g = gather(w)
    if g is not w:
        gathers.append(g.to_local().numel() * g.element_size())
    return g


layers.gather_fsdp = counted
out = {}
for arch, shape, variant in json.loads(sys.argv[2]):
    gathers.clear()
    r = dryrun.run_cell(arch, shape, "pod", force=True, variant=variant)
    r.pop("traceback", None)
    r["weight_gathers"] = [len(gathers), sum(gathers)]
    out[f"{arch}/{shape}/{variant}"] = r
print(json.dumps(out))
"""


def _start(script, cells, out_dir, jax: bool):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    if jax:
        env["JAX_PLATFORMS"] = "cpu"
    else:
        env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.Popen(
        [sys.executable, "-c", script, str(out_dir), json.dumps(cells)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def run_both(ref_cells, port_cells, tmp, timeout=1500):
    """Both packages' records of their cells, the two runs side by side."""
    os.makedirs(os.path.join(tmp, "ref"), exist_ok=True)
    os.makedirs(os.path.join(tmp, "port"), exist_ok=True)
    procs = [_start(_REFERENCE, ref_cells, os.path.join(tmp, "ref"), True),
             _start(_PORT, port_cells, os.path.join(tmp, "port"), False)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]


def table(ref: dict, port: dict) -> str:
    """Per device, each cell's two records: FLOPs, bytes, collective bytes
    by kind and the temp (reference) / peak (port) memory."""
    lines = []
    for cell in port:
        for side, rec in (("reference", ref.get(cell)), ("port", port[cell])):
            if rec is None:
                continue
            if rec["status"] != "ok":
                lines.append(f"{cell:36s} {side:9s} {rec['status']}: "
                             f"{rec.get('error', rec.get('reason', ''))[:90]}")
                continue
            kinds = rec.get("collective_bytes_by_kind", {})
            mem = rec["memory_analysis"]["temp_size_in_bytes"]
            lines.append(
                f"{cell:36s} {side:9s} flops {rec['flops']:.4e} bytes "
                f"{rec['bytes_accessed']:.4e} collective "
                f"{rec['collective_bytes']:.4e} ("
                + ", ".join(f"{k} {kinds[k]:.4e}" for k in KINDS
                            if kinds.get(k))
                + f") temp/peak {mem / 1e9:.3f} GB")
    return "\n".join(lines)


DECODE = [("qwen3-0.6b", "decode_32k", "base"),
          ("qwen3-0.6b", "decode_32k", "opt")]
TRAIN = [("llama3-1-8b", "train_4k", "base")]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    pytest.importorskip("torch")
    pytest.importorskip("jax")
    ref, port = run_both(DECODE, DECODE + TRAIN,
                         str(tmp_path_factory.mktemp("dryrun_ref")))
    print(table(ref, port))
    return ref, port


@pytest.mark.parametrize("cell", DECODE, ids=lambda c: f"{c[1]}-{c[2]}")
def test_decode_moves_no_weight_gather(records, cell):
    ref, port = records
    key = "/".join(cell)
    r, p = ref[key], port[key]
    assert r["status"] == "ok" and p["status"] == "ok", (r, p)
    print(f"{key}: port weight gathers (count, bytes) {p['weight_gathers']}; "
          f"collective port {p['collective_bytes']:.4e} B "
          f"{p['collective_bytes_by_kind']}, reference "
          f"{r['collective_bytes']:.4e} B {r['collective_bytes_by_kind']}")
    assert p["weight_gathers"] == [0, 0]
    assert p["collective_bytes"] <= REF_COLLECTIVE_FACTOR \
        * r["collective_bytes"]


def test_train_flops_and_peak_do_not_rise(records):
    _, port = records
    p = port["/".join(TRAIN[0])]
    assert p["status"] == "ok", p
    peak = p["memory_analysis"]["temp_size_in_bytes"]
    rel = abs(p["flops"] - LLAMA_TRAIN_FLOPS) / LLAMA_TRAIN_FLOPS
    print(f"train_4k: flops {p['flops']:.6e} (closed form / 256 "
          f"{LLAMA_TRAIN_FLOPS:.6e}, rel {rel:.3g}); peak {peak / 1e9:.3f} "
          f"GB; at the peak {p['memory_analysis']['peak_by_op']}")
    assert rel <= TRAIN_FLOPS_RTOL
    assert peak < LLAMA_TRAIN_PEAK_BEFORE


if __name__ == "__main__":
    cells = [("llama3-1-8b", s, v) for s, v in (
        ("train_4k", "base"), ("prefill_32k", "base"), ("prefill_32k", "opt"),
        ("decode_32k", "base"), ("decode_32k", "opt"))]
    with tempfile.TemporaryDirectory() as tmp:
        ref, port = run_both(cells, cells, tmp, timeout=3600)
    print(table(ref, port))
