"""Roofline report: render the per-cell table from
experiments/dryrun_torch/*.json and rank hillclimb candidates (worst perf
fraction / most collective-bound).

Usage: PYTHONPATH=src python -m repro_torch.roofline.report [--mesh pod]

Port of the reference's ``roofline/report.py``, reading the port's own
dry-run directory.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

DRYRUN_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "experiments", "dryrun_torch")


def load_cells(mesh: str = "pod") -> list[dict]:
    cells = []
    for f in sorted(glob.glob(os.path.join(DRYRUN_DIR, f"*__{mesh}.json"))):
        with open(f) as fh:
            cells.append(json.load(fh))
    return cells


def table(cells: list[dict]) -> str:
    hdr = (f"| {'arch':27s} | {'shape':11s} | {'compute':>9s} | {'memory':>9s} |"
           f" {'collective':>10s} | {'bound':>10s} | {'floor':>9s} |"
           f" {'useful':>6s} | {'frac':>6s} |")
    sep = "|" + "|".join("-" * (len(c) - 1) for c in hdr.split("|")[1:-1]) + "|"
    rows = [hdr, sep]
    for c in cells:
        if c["status"] != "ok":
            rows.append(f"| {c['arch']:27s} | {c['shape']:11s} | {'skip':>9s} |"
                        f" {'':>9s} | {'':>10s} | {'':>10s} | {'':>9s} |"
                        f" {'':>6s} | {'':>6s} |")
            continue
        r = c["roofline"]
        rows.append(
            f"| {c['arch']:27s} | {c['shape']:11s} |"
            f" {r['compute_s']*1e3:8.2f}ms | {r['memory_s']*1e3:8.2f}ms |"
            f" {r['collective_s']*1e3:9.2f}ms | {r['bottleneck']:>10s} |"
            f" {c['floor']['step_time_floor_s']*1e3:7.2f}ms |"
            f" {r['useful_flops_ratio']:6.3f} | {r['perf_fraction']:6.4f} |")
    return "\n".join(rows)


def candidates(cells: list[dict]) -> dict:
    ok = [c for c in cells if c["status"] == "ok"]
    worst = min(ok, key=lambda c: c["roofline"]["perf_fraction"])
    coll = max(ok, key=lambda c: (c["roofline"]["collective_s"] /
                                  max(c["roofline"]["step_time_bound_s"], 1e-30)))
    return {"worst_fraction": (worst["arch"], worst["shape"]),
            "most_collective": (coll["arch"], coll["shape"])}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod")
    args = ap.parse_args()
    cells = load_cells(args.mesh)
    print(table(cells))
    print()
    print("hillclimb candidates:", json.dumps(candidates(cells), indent=1))


if __name__ == "__main__":
    main()
