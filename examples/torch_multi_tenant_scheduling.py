"""Multi-tenant bandwidth scheduling (paper §3.6 / §5.7, Fig. 16).

Replays the paper's Workloads A, B, C under their bandwidth caps with all
five policies and reports per-request allocations (reproducing Appendix
Table A9 to rounding precision) and total added TTFT vs the unthrottled
baseline.

Run:  PYTHONPATH=src python examples/torch_multi_tenant_scheduling.py

The port of `multi_tenant_scheduling.py`: the same simulation on the
port's copies of `core/`, `cluster/` and `obs/` (`repro_torch` in place of
`repro`); it touches no tensor and prints the same numbers.
"""
import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core.scheduler import Policy, allocate
from repro_torch.core.simulator import (PAPER_MARGIN_BPS, WORKLOAD_A,
                                        WORKLOAD_B, WORKLOAD_C,
                                        ServingSimulator)

GBPS = 1e9 / 8
sim = ServingSimulator()

for name, (reqs, cap) in (("A (80 Gbps)", WORKLOAD_A),
                          ("B (50 Gbps)", WORKLOAD_B),
                          ("C (50 Gbps, 6 tenants)", WORKLOAD_C)):
    print(f"\n=== Workload {name} ===")
    flows = [sim.flow_request(w) for w in reqs]
    base = sim.unthrottled_total_ttft(reqs)
    print(f"{'policy':16s} " +
          " ".join(f"{w.req_id:>10s}" for w in reqs) + "   added TTFT")
    for pol in (Policy.EQUAL, Policy.KV_PROP, Policy.BW_PROP,
                Policy.STALL_OPT, Policy.CAL_STALL_OPT):
        margin = PAPER_MARGIN_BPS if pol is Policy.CAL_STALL_OPT else 0.0
        alloc = allocate(flows, cap, pol, margin)
        total = sim.workload_total_ttft(reqs, cap, pol, margin)
        cells = " ".join(f"{alloc[w.req_id]/GBPS:9.2f}G" for w in reqs)
        print(f"{pol.value:16s} {cells}   +{(total-base)*1e3:7.0f} ms")
    print("(compare per-request Gbps with paper Appendix Table A9)")
