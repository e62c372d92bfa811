"""Perf-trajectory regression gate over versioned BENCH_<name>.json files.

The benchmarks print ``name,us_per_call,derived`` CSV that nobody tracks
across PRs — the perf trajectory is empty.  This module closes the loop:

* **Schema** — every bench (via ``benchmarks/run.py --json`` or a bench's
  own ``--json`` flag) emits a versioned result document::

      {"schema": "repro-bench-result/v1",
       "bench": "bench_async",
       "rows": [{"name": "...", "us_per_call": 12.3,
                 "metrics": {"ttft_p95_ms": 4.56, "policy": "hybrid"}}]}

  ``metrics`` is the bench's semicolon-separated ``k=v`` derived column
  parsed into floats where possible (non-numeric values ride along as
  strings and are compared for equality).  `rows_from_csv` builds the
  document from the CSV every bench already prints, so benches need no
  rewrite to join the trajectory.

* **Comparator** — `compare` diffs a current document against the
  committed baseline (``benchmarks/trajectory/BENCH_<name>.json``),
  classifying each metric by its name into lower-is-better (``*_ms``,
  ``*_s``, ``*_bytes``, ``us_per_call``, …), higher-is-better (``*_rate``,
  ``goodput*``, ``*_x``, …) or direction-unknown (flagged as ``drift``,
  never as regression).  A change flags only beyond the relative noise
  band (default 10 %) *and* an absolute floor (so a 1e-12 s jitter in a
  conformance diff metric never pages anyone).  Timings (``us_per_call``)
  are noise across CI machines and are ignored unless ``--timings`` asks
  for them; the *derived* metrics are virtual-clock deterministic, which
  is what makes the gate sharp: an unmodified re-run compares clean, and
  a 20 % TTFT regression flags (both pinned by tests).

* **CLI** — ``python -m repro.obs.regress --baseline DIR BENCH_*.json``
  prints a pass/flag table; ``--gate`` exits nonzero on regressions (the
  CI step stays non-gating by omitting it).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
from typing import Optional

SCHEMA = "repro-bench-result/v1"

#: metric-name suffix/substring → direction. First match wins; checked in
#: order so e.g. ``hot_rate`` (higher-better) is matched before ``_s``.
_HIGHER_BETTER = ("goodput", "_rps", "hit_rate", "hot_rate", "rate",
                  "speedup", "_x")
_LOWER_BETTER = ("us_per_call", "_ms", "_us", "_ns", "_s", "_bytes", "_gb",
                 "_mb", "egress", "bytes", "diff", "err", "stall", "shed",
                 "_pct_overhead")


def metric_direction(name: str) -> int:
    """-1 lower-is-better, +1 higher-is-better, 0 unknown."""
    low = name.lower()
    for pat in _HIGHER_BETTER:
        if pat in low:
            return +1
    for pat in _LOWER_BETTER:
        if low.endswith(pat) or pat in low:
            return -1
    return 0


# -- document construction ----------------------------------------------------

def parse_derived(derived: str) -> dict:
    """Parse the bench CSV's ``k=v;k=v`` derived column; numeric values
    become floats, the rest stay strings."""
    out: dict = {}
    for part in derived.split(";"):
        part = part.strip()
        if not part or "=" not in part:
            continue
        k, v = part.split("=", 1)
        try:
            out[k.strip()] = float(v)
        except ValueError:
            out[k.strip()] = v.strip()
    return out


def rows_from_csv(lines) -> list[dict]:
    """Structured rows from ``name,us_per_call,derived`` CSV lines."""
    rows = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        parts = line.split(",", 2)
        if len(parts) < 2:
            continue
        name, us = parts[0], parts[1]
        derived = parts[2] if len(parts) > 2 else ""
        try:
            us_val = float(us)
        except ValueError:
            continue  # header or stray output line
        rows.append({"name": name, "us_per_call": us_val,
                     "metrics": parse_derived(derived)})
    return rows


def bench_result(bench: str, rows: list[dict]) -> dict:
    return {"schema": SCHEMA, "bench": bench, "rows": rows}


def bench_result_from_csv(bench: str, lines) -> dict:
    return bench_result(bench, rows_from_csv(lines))


def validate_bench_result(doc: dict) -> list[str]:
    """Schema check; returns a list of violations (empty = valid)."""
    v: list[str] = []
    if not isinstance(doc, dict):
        return ["document is not an object"]
    if doc.get("schema") != SCHEMA:
        v.append(f"schema must be {SCHEMA!r}, got {doc.get('schema')!r}")
    if not isinstance(doc.get("bench"), str) or not doc.get("bench"):
        v.append("bench must be a non-empty string")
    rows = doc.get("rows")
    if not isinstance(rows, list):
        v.append("rows must be a list")
        return v
    for i, r in enumerate(rows):
        if not isinstance(r, dict):
            v.append(f"rows[{i}] is not an object")
            continue
        if not isinstance(r.get("name"), str) or not r.get("name"):
            v.append(f"rows[{i}].name must be a non-empty string")
        if not isinstance(r.get("us_per_call"), (int, float)):
            v.append(f"rows[{i}].us_per_call must be a number")
        m = r.get("metrics")
        if not isinstance(m, dict):
            v.append(f"rows[{i}].metrics must be an object")
            continue
        for k, val in m.items():
            if not isinstance(val, (int, float, str)):
                v.append(f"rows[{i}].metrics[{k!r}] must be number or "
                         f"string")
    return v


def assert_valid_bench_result(doc: dict) -> None:
    violations = validate_bench_result(doc)
    if violations:
        raise ValueError("invalid bench result:\n  "
                         + "\n  ".join(violations))


def write_bench_result(path: str, doc: dict) -> None:
    assert_valid_bench_result(doc)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")


# -- comparison ---------------------------------------------------------------

PASS = "pass"
REGRESSION = "regression"
IMPROVEMENT = "improvement"
DRIFT = "drift"          # direction-unknown metric changed, or string diff
NEW = "new"              # row/metric absent from the baseline
MISSING = "missing"      # baseline row/metric absent from the current run


@dataclasses.dataclass(frozen=True)
class Delta:
    row: str
    metric: str
    baseline: object
    current: object
    status: str
    rel_change: float = math.nan  # (current - baseline) / |baseline|

    def __str__(self) -> str:
        if isinstance(self.baseline, (int, float)) \
                and isinstance(self.current, (int, float)) \
                and not math.isnan(self.rel_change):
            chg = f"{self.rel_change * 100:+.1f}%"
            return (f"[{self.status:<11s}] {self.row} :: {self.metric}: "
                    f"{self.baseline:.6g} -> {self.current:.6g} ({chg})")
        return (f"[{self.status:<11s}] {self.row} :: {self.metric}: "
                f"{self.baseline!r} -> {self.current!r}")


def _compare_metric(row: str, metric: str, base, cur, *, band: float,
                    abs_floor: float) -> Delta:
    if isinstance(base, str) or isinstance(cur, str):
        status = PASS if base == cur else DRIFT
        return Delta(row, metric, base, cur, status)
    diff = cur - base
    rel = diff / abs(base) if base != 0 else (0.0 if diff == 0 else math.inf)
    if abs(diff) <= abs_floor or abs(rel) <= band:
        return Delta(row, metric, base, cur, PASS, rel)
    direction = metric_direction(metric)
    if direction == 0:
        return Delta(row, metric, base, cur, DRIFT, rel)
    worse = (diff > 0) if direction < 0 else (diff < 0)
    return Delta(row, metric, base, cur,
                 REGRESSION if worse else IMPROVEMENT, rel)


def compare(baseline: dict, current: dict, *, band: float = 0.10,
            abs_floor: float = 1e-9, timings: bool = False) -> list[Delta]:
    """Diff two bench-result documents row-by-row, metric-by-metric.

    ``band`` is the relative noise band (changes within it pass);
    ``abs_floor`` suppresses flags on absolutely-tiny changes regardless
    of relative size; ``timings=False`` skips ``us_per_call`` (wall-clock,
    machine-dependent) and compares only the deterministic derived
    metrics.
    """
    assert_valid_bench_result(baseline)
    assert_valid_bench_result(current)
    base_rows = {r["name"]: r for r in baseline["rows"]}
    cur_rows = {r["name"]: r for r in current["rows"]}
    deltas: list[Delta] = []
    for name in sorted(set(base_rows) | set(cur_rows)):
        b, c = base_rows.get(name), cur_rows.get(name)
        if b is None:
            deltas.append(Delta(name, "<row>", None, None, NEW))
            continue
        if c is None:
            deltas.append(Delta(name, "<row>", None, None, MISSING))
            continue
        if timings:
            deltas.append(_compare_metric(
                name, "us_per_call", b["us_per_call"], c["us_per_call"],
                band=band, abs_floor=abs_floor))
        bm, cm = b["metrics"], c["metrics"]
        for metric in sorted(set(bm) | set(cm)):
            if metric not in bm:
                deltas.append(Delta(name, metric, None, cm[metric], NEW))
            elif metric not in cm:
                deltas.append(Delta(name, metric, bm[metric], None,
                                    MISSING))
            else:
                deltas.append(_compare_metric(
                    name, metric, bm[metric], cm[metric],
                    band=band, abs_floor=abs_floor))
    return deltas


def summarize(deltas: list[Delta]) -> dict:
    counts: dict[str, int] = {}
    for d in deltas:
        counts[d.status] = counts.get(d.status, 0) + 1
    return counts


def format_report(bench: str, deltas: list[Delta],
                  verbose: bool = False) -> str:
    counts = summarize(deltas)
    flagged = [d for d in deltas if d.status not in (PASS,)]
    head = (f"{bench}: {counts.get(PASS, 0)} pass"
            + "".join(f", {n} {s}" for s, n in sorted(counts.items())
                      if s != PASS))
    lines = [head]
    shown = deltas if verbose else flagged
    lines.extend(f"  {d}" for d in shown)
    return "\n".join(lines)


# -- CLI ----------------------------------------------------------------------

def main(argv: Optional[list[str]] = None) -> int:
    """``python -m repro.obs.regress --baseline DIR BENCH_*.json``

    Compares each current BENCH_<name>.json against the file of the same
    name under the baseline directory and prints the pass/flag table.
    Exit status is 0 unless ``--gate`` is given and a regression (or a
    missing row/metric) was flagged.
    """
    argv = list(sys.argv[1:] if argv is None else argv)
    baseline_dir = None
    band, gate, timings, verbose = 0.10, False, False, False
    files: list[str] = []
    it = iter(argv)
    for arg in it:
        if arg == "--baseline":
            baseline_dir = next(it, None)
        elif arg == "--band":
            band = float(next(it))
        elif arg == "--gate":
            gate = True
        elif arg == "--timings":
            timings = True
        elif arg == "--verbose":
            verbose = True
        else:
            files.append(arg)
    if baseline_dir is None or not files:
        print("usage: python -m repro.obs.regress --baseline DIR "
              "[--band F] [--gate] [--timings] [--verbose] "
              "BENCH_<name>.json ...", file=sys.stderr)
        return 2

    bad = False
    for path in files:
        with open(path) as f:
            current = json.load(f)
        base_path = os.path.join(baseline_dir, os.path.basename(path))
        if not os.path.exists(base_path):
            print(f"{os.path.basename(path)}: no baseline at {base_path} "
                  f"— trajectory starts here")
            continue
        with open(base_path) as f:
            baseline = json.load(f)
        deltas = compare(baseline, current, band=band, timings=timings)
        print(format_report(current.get("bench", path), deltas,
                            verbose=verbose))
        if any(d.status in (REGRESSION, MISSING) for d in deltas):
            bad = True
    return 1 if (gate and bad) else 0


if __name__ == "__main__":
    raise SystemExit(main())
