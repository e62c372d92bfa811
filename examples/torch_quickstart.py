"""Quickstart on PyTorch: serve an LLM with ObjectCache prefix reuse.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The port of `quickstart.py` (`repro_torch` in place of `repro`).  Two
requests share a 64-token system prompt.  The first request computes
everything and commits its KV chunks (rolling-hash keys) to the object
store; the second matches the prefix in the radix index, fetches it back via
server-side LAYERWISE aggregation (Table A3 of the paper), and only computes
the 32-token suffix — its logits equal a fresh engine's within 1e-4.  The
model runs on the CUDA card unless ``--device cpu`` is given; without a card
building the model raises.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import Gateway, InMemoryStore, RadixIndex
from repro_torch.models import build_model
from repro_torch.models.layers import dt
from repro_torch.serving import Orchestrator, ServingEngine

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()

CHUNK_TOKENS = 16  # G — fine granularity preserves branch points (Fig. 3)

cfg = get_smoke_config("llama3-1-8b")  # the paper's model family, smoke size
model = build_model(cfg, args.device)
params = model.init_params(torch.Generator(device=model.device).manual_seed(0))

spec = cfg.kv_spec(CHUNK_TOKENS, dtype_bytes=dt(cfg).itemsize)
orch = Orchestrator(index=RadixIndex(CHUNK_TOKENS),
                    gateway=Gateway(InMemoryStore()),
                    spec=spec, theta_bytes=0)  # theta=0 -> always layerwise
engine = ServingEngine(model, params, orch)

rng = np.random.default_rng(0)
system_prompt = rng.integers(0, cfg.vocab_size, size=64)
req_a = np.concatenate([system_prompt, rng.integers(0, cfg.vocab_size, 32)])
req_b = np.concatenate([system_prompt, rng.integers(0, cfg.vocab_size, 32)])

ra = engine.submit(req_a, "A", max_new_tokens=8)
rb = engine.submit(req_b, "B", max_new_tokens=8)

print(f"device={model.device}")
print(f"A: hit={ra.matched_tokens:3d} tokens  mode={ra.delivery}  "
      f"generated={ra.new_tokens}")
print(f"B: hit={rb.matched_tokens:3d} tokens  mode={rb.delivery.value}  "
      f"generated={rb.new_tokens}")
assert rb.matched_tokens == 64, "B must reuse the shared system prompt"

# correctness: a fresh engine that never saw A produces the same logits
fresh = ServingEngine(model, params,
                      Orchestrator(RadixIndex(CHUNK_TOKENS),
                                   Gateway(InMemoryStore()), spec))
rf = fresh.submit(req_b, "B-fresh")
np.testing.assert_allclose(rb.logits, rf.logits, rtol=1e-4, atol=1e-4)
print(f"max |dlogit| warm vs fresh: "
      f"{float(np.abs(np.asarray(rb.logits) - np.asarray(rf.logits)).max())}")
print("OK: cached-prefix logits == from-scratch logits")
print("store:", orch.gateway.store.stats.snapshot())
