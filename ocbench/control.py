"""The control of a cell's ``correct``: the reference put in the program's
place and computed in float8 e4m3, the precision below the configuration's
bf16.  Its last-token logits of the requests the cell's check would sample
are judged by the check's own comparison (``check.compare``); the readings
have to exceed the cell's limits.

    python3 ocbench/control.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...]

Needs no program run: weights and prompts come from each seed as in a run
of the cell, the sample is drawn, with the check's own rule, from the
requests the window's schedule holds.  Prints one JSON line per seed.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_reading(cell, seed: int, seconds: float, device) -> dict:
    """The fp8 reference's readings of every number ``check.compare``
    gives, for one seed."""
    import torch
    from ocbench import archs, check, weights
    from ocbench.traffic import Tokens, schedule

    cfg = cell.config
    params = weights.make(cfg, seed, device)
    reqs = schedule(cell.mix, seconds)
    tokens = Tokens(cell.mix, seed, cfg["vocab_size"])
    tokens.draw(reqs)
    picked = check.sample(reqs, seed, cell.mix["check_tokens"])
    grp, order = check.groups(picked, tokens)
    model = archs.reference(cfg)
    with torch.no_grad():
        h8 = model.forward(params, cfg, grp, fp8=True)
        last = torch.cat([h for _, sufs in h8 for h in sufs])
        lg = model.Logits(params, cfg, fp8=True)(last).cpu().numpy()
    answers = {r.index: row for r, row in zip(order, lg)}
    out = check.compare(params, cfg, tokens, picked, answers)
    return {"seed": seed, "requests": len(picked), **out}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    for path in (ROOT, ROOT / "src"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    import torch
    from ocbench import harness
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 1
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = control_reading(cell, seed, args.seconds, "cuda")
        out["limits"] = cell.limits
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
