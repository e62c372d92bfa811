"""Layerwise transfer/compute overlap study (paper §3.5 Eq. 3, Fig. 7/12/13).

Sweeps context length and hit rate for Llama 3.1 8B and shows, per config:
  * the required overlap bandwidth B_req = D^(l)/t^(l)  (Table A8),
  * chunkwise vs layerwise TTFT (Fig. 7 semantics),
  * the counter-intuitive §5.4 effect: LONGER contexts need LESS bandwidth.

Run:  PYTHONPATH=src python examples/torch_layerwise_overlap.py

The port of `layerwise_overlap.py`: the same simulation on the port's copies
of `core/`, `cluster/` and `obs/` (`repro_torch` in place of `repro`); it
touches no tensor and prints the same numbers.
"""
import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core.compute_model import PaperComputeModel
from repro_torch.core.simulator import ServingSimulator, WorkloadRequest

sim = ServingSimulator()
m = PaperComputeModel()

print(f"{'ctx':>6s} {'hit':>6s} {'B_req GB/s':>11s} {'chunkwise':>11s} "
      f"{'layerwise':>11s} {'opt-local':>11s} {'LW overhead':>12s}")
for ctx in (4096, 16384, 32768, 65536):
    for hit in (0.5, 0.875):
        w = WorkloadRequest("w", ctx, hit, 64)
        cw = sim.ttft_chunkwise(w).ttft_s
        lw = sim.ttft_layerwise(w).ttft_s
        opt = sim.ttft_opt_local(w)
        print(f"{ctx:6d} {hit:6.3f} {m.required_bw(ctx, hit)/1e9:11.2f} "
              f"{cw*1e3:9.1f}ms {lw*1e3:9.1f}ms {opt*1e3:9.1f}ms "
              f"{100*(lw/opt-1):11.1f}%")

print("\nNote how B_req FALLS as context grows at fixed hit rate (§5.4): "
      "more cached bytes, but a quadratically larger compute window.")
