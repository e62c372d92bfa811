"""Fault-tolerant training end to end, on PyTorch.

Run:  PYTHONPATH=src python examples/torch_train_ft.py [--device cpu]

The port of `train_ft.py` (`repro_torch` in place of `repro`).  Trains a
SmolLM-family smoke model on the synthetic LM stream for 200 steps with the
full production loop: async checkpoints, a SIMULATED NODE FAILURE at step 60
(restart from the last checkpoint), NaN rollback armed.  Loss must keep
descending through the restart.  Runs on the CUDA card unless ``--device
cpu`` is given; without a card building the model raises.  The step is
eager (the reference jits it).
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model
from repro_torch.training import (AdamWConfig, SimulatedFailure, SyntheticLM,
                                  TrainSupervisor, adamw_init, make_train_step)
from repro_torch.training.tree import tree_leaves

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()

STEPS = 200

cfg = get_smoke_config("smollm-135m")
model = build_model(cfg, args.device)
params = model.init_params(torch.Generator(device=model.device).manual_seed(0))
n = sum(x.numel() for x in tree_leaves(params))
print(f"model={cfg.name} params={n/1e6:.2f}M device={model.device}")

opt_cfg = AdamWConfig(lr=1e-2, warmup_steps=20, total_steps=STEPS)
opt = adamw_init(params, opt_cfg)
step_fn = make_train_step(model, opt_cfg, remat=False)
data = SyntheticLM(cfg.vocab_size, 32, 8, seed=0)

fired = set()


def chaos(step):
    if step == 60 and 60 not in fired:
        fired.add(60)
        print(">>> injecting node failure at step 60")
        raise SimulatedFailure("rack power loss")


with tempfile.TemporaryDirectory() as ckpt:
    sup = TrainSupervisor(step_fn, params, opt, ckpt_dir=ckpt, ckpt_every=25)
    stats = sup.run(data.batch_at, STEPS, failure_injector=chaos)

l = stats.losses
print(f"steps={stats.steps_done} restarts={stats.restarts} "
      f"rollbacks={stats.rollbacks}")
print("loss:", " ".join(f"{x:.2f}" for x in l[::20]))
assert stats.restarts == 1
assert np.mean(l[-10:]) < np.mean(l[:10]) - 0.3
print("OK: training survived failure and converged "
      f"({np.mean(l[:10]):.2f} -> {np.mean(l[-10:]):.2f})")
