"""Trace-driven cluster simulation (DESIGN.md §Cluster-sim).

Generates a seeded Poisson arrival trace over the paper's §5.7 request mix,
replays it through the discrete-event cluster simulator under EQUAL and
Calibrated Stall-opt, and prints TTFT percentiles + total added TTFT for
each.  Also demonstrates the committed-JSON replay format: the trace is
saved, reloaded, and re-run — metrics must be bit-identical (the
determinism contract regression tests rely on).

Run:  PYTHONPATH=src python examples/torch_cluster_trace.py

The port of `cluster_trace.py`: the same simulation on the port's copies
of `core/`, `cluster/` and `obs/` (`repro_torch` in place of `repro`); it
touches no tensor and prints the same numbers.
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.cluster import (ClusterSim, load_trace, poisson_trace,
                                 save_trace, summarize)
from repro_torch.core.scheduler import Policy
from repro_torch.core.simulator import (PAPER_MARGIN_BPS, ServingSimulator,
                                        WorkloadRequest)

GBPS = 1e9 / 8
CAP = 80 * GBPS

trace = poisson_trace(24, rate_rps=1.0, seed=0)
sim0 = ServingSimulator()
baseline = {t.req_id: sim0.ttft_layerwise(
    WorkloadRequest(t.req_id, t.context, t.hit_rate)).ttft_s for t in trace}

print(f"Poisson trace: {len(trace)} requests over "
      f"{trace[-1].arrival_s:.1f}s, cap 80 Gbps\n")
print(f"{'policy':16s} {'p50':>8s} {'p95':>8s} {'p99':>8s} "
      f"{'added TTFT':>11s} {'reallocs':>8s}")
results = {}
for pol, margin in ((Policy.EQUAL, 0.0),
                    (Policy.CAL_STALL_OPT, PAPER_MARGIN_BPS)):
    res = ClusterSim(cap_bps=CAP, policy=pol, margin_bps=margin).run(trace)
    m = summarize(res.records, baseline)
    results[pol] = m
    print(f"{pol.value:16s} {m.ttft_p50_s*1e3:7.0f}m {m.ttft_p95_s*1e3:7.0f}m "
          f"{m.ttft_p99_s*1e3:7.0f}m {m.added_ttft_total_s*1e3:10.0f}m "
          f"{res.reallocs:8d}")
ratio = (results[Policy.EQUAL].added_ttft_total_s
         / results[Policy.CAL_STALL_OPT].added_ttft_total_s)
print(f"\ncal-stall-opt reduces added TTFT {ratio:.2f}x vs equal "
      f"(paper static window: 1.2-1.8x)")

# --- replay round-trip: save -> load -> identical metrics -------------------
with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "trace.json")
    save_trace(path, trace)
    replayed = load_trace(path)
    m2 = summarize(ClusterSim(cap_bps=CAP, policy=Policy.CAL_STALL_OPT,
                              margin_bps=PAPER_MARGIN_BPS).run(replayed).records,
                   baseline)
assert m2 == results[Policy.CAL_STALL_OPT]
print("OK: JSON replay reproduces bit-identical metrics")
