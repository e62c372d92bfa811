"""Run one cell of the benchmark on this machine's card and print its result.

    python3 ocbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``; with
``--trace 1`` also ``breakdown``; ``checks`` last); the last lines of
standard error are the numbers compared, each beside its limit.  Exits
non-zero, printing no result, without a CUDA device, without the program's
package, or if JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def loaded_forbidden() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0]
                  in FORBIDDEN)


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _number(v):
    """A number JSON can hold: a non-finite one as its name."""
    return v if math.isfinite(v) else str(v)


def result_line(out: dict, device: dict) -> dict:
    """The contract's last line; ``checks`` comes last.  A metric that is
    not finite (a tail over requests that failed) is left out: the run is
    not correct then."""
    metrics = {k: m for k, m in out["metrics"].items()
               if math.isfinite(m["value"])}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if out.get("breakdown"):
        line["breakdown"] = out["breakdown"]
    line["checks"] = {k: {"value": _number(v), "limit": lim}
                      for k, (v, lim) in out["checks"].items()}
    return line


def main(argv=None) -> int:
    args = _args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no program to measure: {ROOT / 'src' / 'repro_torch'} is "
              f"missing", file=sys.stderr)
        return 2
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    from ocbench.host import keep_freed_memory
    keep_freed_memory()  # before numpy and torch allocate anything
    import torch
    from ocbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this "
              f"machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_START)
    found = loaded_forbidden()
    if found:
        print(f"JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": out["memory_peak_bytes"],
              **out["device"]}
    sys.stdout.flush()
    for k, (v, lim) in out["checks"].items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result_line(out, device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
