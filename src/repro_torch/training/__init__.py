"""Training in PyTorch (port of the reference's ``training/``): AdamW, the
train step with remat and microbatches, the synthetic data pipeline,
checkpoints in the reference's layout, the fault-tolerant supervisor and
pod gradient compression over ``torch.distributed``."""
from .checkpoint import (latest_step, restore_checkpoint, save_checkpoint)
from .data import SyntheticLM
from .optimizer import AdamWConfig, adamw_init, adamw_update
from .train_step import make_train_step
from .supervisor import SimulatedFailure, TrainSupervisor

__all__ = ["AdamWConfig", "SimulatedFailure", "SyntheticLM", "TrainSupervisor",
           "adamw_init", "adamw_update", "latest_step", "make_train_step",
           "restore_checkpoint", "save_checkpoint"]
