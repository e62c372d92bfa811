"""Serving launcher: an ObjectCache-backed engine serving batched requests,
on PyTorch.

Runs the full paper pipeline on real bytes: radix prefix match -> Eq. 2 mode
selection -> bandwidth-scheduled transfer (calibrated 100 Gbps model) ->
layerwise prefill overlapping per-layer compute -> greedy decode -> chunk
write-back.  Prints per-request TTFT breakdowns and engine statistics.
Weights are random, from a generator seeded with 0.

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-1-8b \
      --requests 8 --shared-prefix 64 --chunk-tokens 16 --device cuda
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import Gateway, InMemoryStore, Policy, RadixIndex
from repro_torch.models import build_model
from repro_torch.models.layers import dt
from repro_torch.serving import Orchestrator, ServingEngine
from repro_torch.serving.orchestrator import StragglerModel


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-1-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=96)
    ap.add_argument("--shared-prefix", type=int, default=64)
    ap.add_argument("--chunk-tokens", type=int, default=16)
    ap.add_argument("--decode-tokens", type=int, default=8)
    ap.add_argument("--theta-bytes", type=int, default=0,
                    help="Eq. 2 threshold (0 => always layerwise)")
    ap.add_argument("--bandwidth-gbps", type=float, default=0.0,
                    help="shared cap; 0 => unthrottled")
    ap.add_argument("--hedge", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda, or cpu)")
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device=args.device)
    params = model.init_params(
        torch.Generator(device=model.device).manual_seed(0))
    spec = cfg.kv_spec(args.chunk_tokens, dtype_bytes=dt(cfg).itemsize)
    orch = Orchestrator(
        RadixIndex(args.chunk_tokens), Gateway(InMemoryStore()), spec,
        theta_bytes=args.theta_bytes,
        bandwidth_cap=(args.bandwidth_gbps * 1e9 / 8) or None,
        policy=Policy.CAL_STALL_OPT, margin=5e9 / 8,
        straggler=StragglerModel(sigma=0.3, seed=0), hedge=args.hedge)
    engine = ServingEngine(model, params, orch)

    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, size=args.shared_prefix)
    print(f"arch={cfg.name} device={model.device} chunk_G={args.chunk_tokens} "
          f"S_layer_chunk={spec.per_layer_chunk_bytes}B")
    for i in range(args.requests):
        tail = rng.integers(0, cfg.vocab_size,
                            size=args.prompt_len - args.shared_prefix)
        prompt = np.concatenate([shared, tail])
        r = engine.submit(prompt, f"req{i}", max_new_tokens=args.decode_tokens)
        print(f"req{i}: hit={r.matched_tokens:4d}/{args.prompt_len} "
              f"mode={r.delivery.value if r.delivery else 'recompute':9s} "
              f"ttft={r.ttft_model_s*1e3:8.2f}ms "
              f"(compute {r.compute_s*1e3:7.2f}ms, "
              f"xfer-done {r.transfer_completion_s*1e3:7.2f}ms) "
              f"out={r.new_tokens[:6]}")
    print("engine:", engine.stats.snapshot())
    print("orchestrator:", orch.stats.snapshot())
    print("store:", orch.gateway.store.stats.snapshot())


if __name__ == "__main__":
    main()
