"""Fault-tolerant training supervisor.

Port of the reference's ``training/supervisor.py``.  Production behaviours,
exercised by tests via injection hooks:
  * periodic async checkpoints with pruning;
  * NaN/inf loss -> rollback to the last checkpoint and skip the batch;
  * simulated node failure -> restart from the last checkpoint, onto the
    devices the state is on, or with ``shardings`` (param shardings, opt
    shardings) onto their mesh (state on a mesh: every rank runs a
    supervisor over one shared ``ckpt_dir``, which the mesh's first rank
    writes, `training.checkpoint`);
  * straggler detection: steps slower than ``straggler_factor`` x the running
    median are counted and surfaced (on real fleets this feeds the scheduler).
Data order is step-indexed (SyntheticLM.batch_at), so a restart replays the
exact stream — loss curves are bitwise reproducible across failures where
the step itself is (on the CPU; on the card as far as its kernels sum in a
fixed order).  Each step's clock ends when its loss reaches the host
(``.item()``), so it includes the device's work.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from .checkpoint import (latest_step, mesh_barrier, mesh_of,
                         prune_checkpoints, restore_checkpoint,
                         save_checkpoint)


class SimulatedFailure(RuntimeError):
    """Raised by an injector to emulate a node loss mid-run."""


@dataclasses.dataclass
class SupervisorStats:
    steps_done: int = 0
    rollbacks: int = 0
    restarts: int = 0
    stragglers: int = 0
    losses: list = dataclasses.field(default_factory=list)


class TrainSupervisor:
    def __init__(self, train_step: Callable, params, opt_state, *,
                 ckpt_dir: str, ckpt_every: int = 50, keep: int = 3,
                 straggler_factor: float = 3.0,
                 shardings: Optional[tuple] = None) -> None:
        self.train_step = train_step
        self.params = params
        self.opt_state = opt_state
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.keep = keep
        self.straggler_factor = straggler_factor
        self.shardings = shardings  # (param_shardings, opt_shardings) or None
        self.stats = SupervisorStats()
        self._step_times: list[float] = []
        self._pending_save = None

    # ------------------------------------------------------------------
    def _save(self, step: int) -> None:
        self._join_save()
        self._pending_save = save_checkpoint(
            self.ckpt_dir, step, {"params": self.params, "opt": self.opt_state},
            extra={"step": step}, async_save=True)

    def _join_save(self) -> None:
        """Wait for the save in flight, then prune to the newest ``keep``.
        (Pruning while a save is still being written would count without
        it and leave ``keep`` + 1 once it commits.)  On a mesh only the
        first rank writes, and every rank then waits for its commit."""
        if self._pending_save is not None:
            self._pending_save.join()
            self._pending_save = None
            prune_checkpoints(self.ckpt_dir, self.keep)
        mesh = mesh_of(self.params)
        if mesh is not None:
            mesh_barrier(mesh)

    def _restore(self) -> int:
        self._join_save()
        step = latest_step(self.ckpt_dir)
        if step is None:
            return 0
        sh = None
        if self.shardings is not None:
            sh = {"params": self.shardings[0], "opt": self.shardings[1]}
        tree, extra = restore_checkpoint(
            self.ckpt_dir, step, {"params": self.params, "opt": self.opt_state},
            shardings=sh)
        self.params, self.opt_state = tree["params"], tree["opt"]
        return extra.get("step", step)

    # ------------------------------------------------------------------
    def run(self, batch_at: Callable[[int], dict], num_steps: int,
            start_step: int = 0,
            failure_injector: Optional[Callable[[int], None]] = None) -> SupervisorStats:
        step = start_step
        self._save(step)
        while step < num_steps:
            batch = batch_at(step)
            t0 = time.perf_counter()
            try:
                if failure_injector is not None:
                    failure_injector(step)
                params, opt_state, metrics = self.train_step(
                    self.params, self.opt_state, batch)
                loss = metrics["loss"].item()
            except SimulatedFailure:
                # node lost: restart from the last durable checkpoint
                self.stats.restarts += 1
                step = self._restore()
                continue
            dt = time.perf_counter() - t0
            if not np.isfinite(loss):
                # divergence: roll back and skip this batch
                self.stats.rollbacks += 1
                step = self._restore() + 1
                continue
            self.params, self.opt_state = params, opt_state
            self.stats.losses.append(loss)
            self.stats.steps_done += 1
            self._step_times.append(dt)
            med = float(np.median(self._step_times[-20:]))
            if len(self._step_times) > 5 and dt > self.straggler_factor * med:
                self.stats.stragglers += 1
            step += 1
            if step % self.ckpt_every == 0:
                self._save(step)
        self._save(num_steps)
        self._join_save()
        return self.stats
