"""Assemble the data-driven dry-run sections from
experiments/dryrun_torch/*.json.  Usage:

    PYTHONPATH=src python -m repro_torch.roofline.experiments_md > experiments/dryrun_torch/sections.md

Port of the reference's ``roofline/experiments_md.py``: the same sections,
for the port's dry run (`launch.dryrun`) and the H100's constants.
"""
from __future__ import annotations

import glob
import json
import os

from . import report
from .analysis import HW

HW_NOTE = (f"NVIDIA H100 SXM constants: {HW.peak_flops / 1e12:.0f} TFLOP/s "
           f"bf16 dense, {HW.hbm_bw / 1e12:.2f} TB/s HBM, "
           f"{HW.link_bw / 1e9:.0f} GB/s per GPU on the network (400 Gb/s "
           f"NDR).  All counts are per device: the local ops the busiest "
           f"rank (the first or the last) runs under the DTensor step over "
           f"a fake process group (`roofline.CostMode`); bytes are eager op "
           f"traffic (this program's, not a lower bound), FLOPs the "
           f"products' and attentions'; the floor is the bytes the step "
           f"must move and its useful FLOPs.")


def load(variant: str = "base") -> dict:
    cells = {}
    for f in glob.glob(os.path.join(report.DRYRUN_DIR, "*.json")):
        with open(f) as fh:
            r = json.load(fh)
        v = r.get("variant", "base")
        cells[(r["arch"], r["shape"], r["mesh"], v)] = r
    return cells


def dryrun_section(cells) -> str:
    out = ["## §Dry-run — cells x {16x16, 2x16x16} meshes", ""]
    out.append("Every (arch x shape) step run once on meta tensors placed "
               "with `distributed.distribute` on the production mesh over "
               "a fake process group; per-device memory and counts "
               "recorded per cell in `experiments/dryrun_torch/`.  "
               "`serve_step` for decode shapes, `prefill_step` for prefill, "
               "the full `train_step` (loss + AdamW) for train_4k.")
    out.append("")
    out.append("| arch | shape | pod (256) | multipod (512) | per-dev args+temp (pod) |")
    out.append("|---|---|---|---|---|")
    archs = sorted({k[0] for k in cells if k[3] == "base"})
    shapes = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
    n_ok = n_skip = 0
    for a in archs:
        for s in shapes:
            pod = cells.get((a, s, "pod", "base"))
            mp = cells.get((a, s, "multipod", "base"))
            if pod is None:
                continue
            if pod["status"] == "skipped":
                out.append(f"| {a} | {s} | skipped | skipped | "
                           f"sub-quadratic-only shape |")
                n_skip += 1
                continue
            if pod["status"] != "ok":
                out.append(f"| {a} | {s} | {pod['status']} | | |")
                continue
            n_ok += 1
            mem = pod.get("memory_analysis", {})
            gb = (mem.get("argument_size_in_bytes", 0) +
                  mem.get("temp_size_in_bytes", 0)) / 2**30
            mp_txt = "not run" if mp is None else \
                f"{mp['status']} ({mp.get('run_s', 0):.0f}s)"
            out.append(
                f"| {a} | {s} | ok ({pod['run_s']:.0f}s) | {mp_txt} | "
                f"{gb:.2f} GiB |")
    out.append("")
    out.append(f"**{n_ok} cells run + {n_skip} documented skips "
               f"(long_500k on pure full-attention archs).**")
    return "\n".join(out)


def roofline_section(cells) -> str:
    out = ["## §Roofline — single-pod (16x16, 256 GPUs), baseline", "",
           HW_NOTE, ""]
    out.append("| arch | shape | compute | memory | collective | bound | "
               "floor | MODEL_FLOPS/counted | perf_frac |")
    out.append("|---|---|---|---|---|---|---|---|---|")
    archs = sorted({k[0] for k in cells if k[3] == "base"})
    shapes = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
    for a in archs:
        for s in shapes:
            c = cells.get((a, s, "pod", "base"))
            if c is None or c["status"] != "ok":
                continue
            r = c["roofline"]
            out.append(
                f"| {a} | {s} | {r['compute_s']*1e3:.1f} ms | "
                f"{r['memory_s']*1e3:.1f} ms | {r['collective_s']*1e3:.1f} ms | "
                f"{r['bottleneck']} | "
                f"{c['floor']['step_time_floor_s']*1e3:.1f} ms | "
                f"{r['useful_flops_ratio']:.3f} | "
                f"{r['perf_fraction']:.4f} |")
    return "\n".join(out)


def perf_compare_section(cells) -> str:
    pairs = [(a, s) for (a, s, m, v) in cells if v == "opt" and m == "pod"]
    if not pairs:
        return ""
    out = ["## §Perf — baseline vs optimized (opt variant)", ""]
    out.append("| arch | shape | term | baseline | optimized | delta |")
    out.append("|---|---|---|---|---|---|")
    for a, s in sorted(set(pairs)):
        b = cells.get((a, s, "pod", "base"))
        o = cells.get((a, s, "pod", "opt"))
        if not b or not o or b["status"] != "ok" or o["status"] != "ok":
            continue
        rb, ro = b["roofline"], o["roofline"]
        for term in ("compute_s", "memory_s", "collective_s",
                     "perf_fraction"):
            tb, to = rb[term], ro[term]
            if term == "perf_fraction":
                d = f"{to/max(tb,1e-12):.2f}x"
                out.append(f"| {a} | {s} | {term} | {tb:.4f} | {to:.4f} | {d} |")
            else:
                d = f"{tb/max(to,1e-12):.2f}x better" if to < tb else \
                    f"{to/max(tb,1e-12):.2f}x worse"
                out.append(f"| {a} | {s} | {term} | {tb*1e3:.1f} ms | "
                           f"{to*1e3:.1f} ms | {d} |")
    return "\n".join(out)


def main() -> None:
    cells = load()
    print(dryrun_section(cells))
    print()
    print(roofline_section(cells))
    print()
    print(perf_compare_section(cells))


if __name__ == "__main__":
    main()
