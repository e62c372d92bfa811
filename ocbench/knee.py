"""Sweep of arrival rates for one cell, to find its knee once: the highest
rate whose backlog does not grow over the window.  A mix below the knee
takes 0.8 of it as ``rate_rps``; a mix above it a rate over the knee of
every host seen.

    python3 ocbench/knee.py --workload <cell> --seed <n> --seconds <s> \\
        --rates <r> [<r> ...]

One set-up, then one window per rate on the same stack; one JSON line per
rate: requests, the median service time, the mean queue wait of the first
and the last third of the window, and the requests shed at its close.
"""
import argparse
import json
import statistics
import time
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    for path in (ROOT, ROOT / "src"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    from ocbench.host import keep_freed_memory
    keep_freed_memory()  # as run.py: the same process the cells measure
    import torch
    from ocbench import harness
    from ocbench.traffic import schedule
    if not torch.cuda.is_available():
        print("the sweep runs on a CUDA device", file=sys.stderr)
        return 1
    cell = harness.load_cell(args.workload)
    t0 = time.perf_counter()
    stack = harness.set_up(cell, args.seed, "cuda", trace=False)
    print(json.dumps({"set_up_s": time.perf_counter() - t0}), flush=True)
    for rate in args.rates:
        reqs = schedule(cell.mix, args.seconds, rate)
        stack.tokens.draw(reqs)
        t0, served = harness.serve(stack, reqs, args.seconds)
        done = [s for s in served if s.ok]
        waits = [s.start - s.due for s in served if s.start is not None]
        third = max(1, len(waits) // 3)
        print(json.dumps({
            "rate_rps": rate, "requests": len(served), "failed":
            len(waits) - len(done),
            "service_s_median": statistics.median(s.end - s.start
                                                  for s in done),
            "service_s_mean": statistics.fmean(s.end - s.start
                                               for s in done),
            "wait_s_first_third": statistics.fmean(waits[:third]),
            "wait_s_last_third": statistics.fmean(waits[-third:]),
            "shed_at_close": len(served) - len(waits)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
