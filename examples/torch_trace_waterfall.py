"""Per-request span timelines + added-TTFT attribution (DESIGN.md
§Observability).

Replays a small Poisson trace through the discrete-event cluster simulator
with a `Tracer` attached, then:

  1. renders the TTFT waterfall (queue / wire / stall / compute spans, nested
     by containment) for the slowest request,
  2. decomposes every request's added TTFT into queue + bandwidth-stall +
     gate-stall + dequant components and checks the telescoping identity
     ``sum(components) == ttft - baseline`` to 1e-6,
  3. exports the full timeline as Perfetto-loadable Chrome trace JSON
     (chrome://tracing or https://ui.perfetto.dev) and validates the schema,
  4. re-runs the identical trace *without* the tracer and asserts bit-equal
     records — attaching observability never moves a simulated timestamp.

Run:  PYTHONPATH=src python examples/torch_trace_waterfall.py

The port of `trace_waterfall.py`: the same simulation on the port's copies
of `core/`, `cluster/` and `obs/` (`repro_torch` in place of `repro`); it
touches no tensor and prints the same numbers.
"""
import dataclasses
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.cluster import ClusterSim, poisson_trace
from repro_torch.core.scheduler import Policy
from repro_torch.core.simulator import PAPER_MARGIN_BPS
from repro_torch.obs import (Tracer, attribute_trace, check_identity,
                       format_attribution, render_waterfall,
                       validate_chrome_trace, write_chrome_trace)

GBPS = 1e9 / 8
trace = poisson_trace(12, rate_rps=1.5, seed=3)


def run(tracer=None):
    sim = ClusterSim(cap_bps=50 * GBPS, policy=Policy.CAL_STALL_OPT,
                     margin_bps=PAPER_MARGIN_BPS, tracer=tracer)
    return sim.run(trace)


tracer = Tracer()
res = run(tracer)

# -- 1. waterfall for the slowest request ------------------------------------
slowest = max((r for r in res.records if r.done), key=lambda r: r.ttft_s)
print(render_waterfall(tracer, slowest.req_id))

# -- 2. added-TTFT attribution, identity-checked -----------------------------
attrs = attribute_trace(tracer)
print()
print(format_attribution(attrs))
residual = check_identity(attrs, tol=1e-6)
print(f"\nOK: attribution telescopes exactly "
      f"(max identity residual {residual:.2e} <= 1e-6)")

# -- 3. Perfetto export ------------------------------------------------------
with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "trace.json")
    doc = write_chrome_trace(tracer, path)
    with open(path) as f:
        errors = validate_chrome_trace(json.load(f))
    assert errors == [], errors
    print(f"OK: exported {len(doc['traceEvents'])} Chrome trace events "
          f"(load in chrome://tracing or ui.perfetto.dev)")

# -- 4. zero-perturbation contract -------------------------------------------
bare = run()
assert ([dataclasses.asdict(r) for r in bare.records]
        == [dataclasses.asdict(r) for r in res.records])
print("OK: tracer attached changed no simulated timestamp")
