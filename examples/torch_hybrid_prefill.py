"""Compute-or-load hybrid prefill on PyTorch (DESIGN.md §Compute-or-load;
after Cake, arXiv:2410.03065).

Run:  PYTHONPATH=src python examples/torch_hybrid_prefill.py [--device cpu]

The port of `hybrid_prefill.py` (`repro_torch` in place of `repro`).

Part 1 — paper-scale planner: sweeps the shared-bandwidth cap for one grid
request and prints pure-fetch / pure-recompute / hybrid TTFT with the chosen
split, showing the crossover: fetch-everything at high bandwidth,
recompute-everything near zero, hybrid on the lower envelope in between.

Part 2 — real engine: a bandwidth-capped smollm-135m smoke engine serves the
same prompt twice on the CUDA card (or the CPU with ``--device cpu``); the
warm request is split by the planner (some chunks fetched through the object
store, the rest recomputed with the suffix) and its logits must equal the
cold no-cache prefill's bit for bit, as in the reference: they do on the CPU
and on the H100.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.core.simulator import WorkloadRequest
from repro_torch.hybrid import crossover_sweep

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()

GBPS = 1e9 / 8

w = WorkloadRequest("16K,87.5%", 16384, 0.875, 64)
print(f"Compute-or-load sweep for ctx={w.context} hit={w.hit_rate} "
      f"({w.cached_tokens // w.chunk_tokens} matched chunks):")
print(f"{'rate':>8s} {'pure-fetch':>12s} {'recompute':>12s} {'hybrid':>12s} "
      f"{'split m/n':>10s}")
for r in crossover_sweep(w, [g * GBPS for g in
                             (0.25, 0.5, 1, 2, 4, 8, 16, 32, 100)]):
    assert r["hybrid_s"] <= min(r["fetch_s"], r["recompute_s"]) + 1e-9
    print(f"{r['rate']/GBPS:6.2f}G {r['fetch_s']*1e3:10.1f}ms "
          f"{r['recompute_s']*1e3:10.1f}ms {r['hybrid_s']*1e3:10.1f}ms "
          f"{r['fetch_chunks']:5d}/{r['total_chunks']}")
print("OK: hybrid <= min(pure-fetch, pure-recompute) at every rate\n")

# --------------------------------------------------------------------------
# Part 2: the real PyTorch path.
from repro_torch.configs import get_smoke_config
from repro_torch.core import (Gateway, InMemoryStore, MeasuredCompute,
                              RadixIndex)
from repro_torch.core.transport import LOCAL_DRAM
from repro_torch.hybrid import HybridPlanner
from repro_torch.models import build_model
from repro_torch.models.layers import dt
from repro_torch.serving import Orchestrator, ServingEngine

G = 8
cfg = get_smoke_config("smollm-135m")
model = build_model(cfg, args.device)
params = model.init_params(torch.Generator(device=model.device).manual_seed(0))
spec = cfg.kv_spec(G, dtype_bytes=dt(cfg).itemsize)
compute = MeasuredCompute(
    num_layers=spec.num_layers, base_s=0.0, per_token_s=1e-4,
    bytes_per_token_per_layer=spec.bytes_per_token_per_layer)
orch = Orchestrator(RadixIndex(G), Gateway(InMemoryStore()), spec,
                    theta_bytes=0, bandwidth_cap=1.28e6,
                    hybrid=HybridPlanner(compute, LOCAL_DRAM,
                                         session_setup=False))
engine = ServingEngine(model, params, orch)
prompt = np.random.default_rng(0).integers(0, 200, size=48)
cold = engine.submit(prompt, "cold")
warm = engine.submit(prompt, "warm")
print(f"device={model.device}")
print(f"warm request: delivery={warm.delivery.value}, "
      f"{warm.matched_tokens} tokens fetched + "
      f"{len(prompt) - warm.matched_tokens} recomputed")
assert np.array_equal(cold.logits, warm.logits)
print("OK: hybrid-prefill logits == no-cache logits (bit-for-bit)")
