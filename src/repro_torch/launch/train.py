"""Training launcher, on PyTorch.

Runs real steps on one device (the card unless ``--device cpu``), with the
fault-tolerance stack: async checkpoints, NaN rollback, failure restart,
step-indexed data replay, optional compressed pod gradient reduction over
an initialised ``torch.distributed`` process group.  Weights are random,
from a generator seeded with 0.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --smoke --steps 200 --batch 8 --seq 64 --device cpu --ckpt-dir ckpt
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import build_model
from repro_torch.training import (AdamWConfig, SyntheticLM, TrainSupervisor,
                                  adamw_init, make_train_step)
from repro_torch.training.tree import tree_leaves


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--pod-reduce", default="none",
                    choices=["none", "fp32", "bf16", "int8"])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda, or cpu)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device=args.device)
    params = model.init_params(
        torch.Generator(device=model.device).manual_seed(0))
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.2f}M device={model.device}")

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 10),
                          total_steps=args.steps)
    opt_state = adamw_init(params, opt_cfg)
    step_fn = make_train_step(model, opt_cfg, remat=args.remat,
                              microbatches=args.microbatches,
                              pod_reduce=args.pod_reduce)
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=0)
    sup = TrainSupervisor(step_fn, params, opt_state, ckpt_dir=args.ckpt_dir,
                          ckpt_every=args.ckpt_every)

    t0 = time.time()
    stats = sup.run(data.batch_at, args.steps)
    dt = time.time() - t0
    tokens = args.steps * args.batch * args.seq
    print(f"done: steps={stats.steps_done} loss {stats.losses[0]:.3f} -> "
          f"{np.mean(stats.losses[-5:]):.3f} | {tokens/dt:.0f} tok/s | "
          f"rollbacks={stats.rollbacks} restarts={stats.restarts} "
          f"stragglers={stats.stragglers}")


if __name__ == "__main__":
    main()
