"""Train step factory: loss -> grads -> AdamW, with microbatch gradient
accumulation, remat, and an optional compressed pod gradient reduction over
a ``torch.distributed`` process group.

Port of the reference's ``training/train_step.py``.  Eager: there is no
``jax.jit`` counterpart (and no ``torch.compile``), and the microbatches run
as a Python loop where the reference scans.  Gradients come from
``torch.autograd`` on fresh leaves that share the parameters' storage.
"""
from __future__ import annotations

import torch

from repro_torch.models import Model

from .compression import make_pod_reducer
from .optimizer import AdamWConfig, adamw_update
from .tree import tree_leaves, tree_map, tree_unflatten


def value_and_grad(model: Model, params, batch, *, remat: bool = False,
                   loss_fn=None):
    """(loss, grads) of ``model.loss`` (or ``loss_fn(params, batch,
    remat=)``) at ``params``: the loss detached, the grads a tree like
    ``params`` in the parameters' dtypes (zeros for a leaf the loss does
    not reach)."""
    loss_fn = loss_fn or model.loss
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = loss_fn(tree_unflatten(params, leaves), batch, remat=remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(model: Model, opt_cfg: AdamWConfig, *,
                    remat: bool = True, microbatches: int = 1,
                    pod_reduce: str = "none", group=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).  ``batch``: dict of [B, ...] arrays or tensors (the global
    batch), moved to the model's device.

    ``pod_reduce`` in {none, fp32, bf16, int8}: when not 'none', gradients
    are averaged over the ranks of ``group`` (the default process group if
    None) with the chosen wire format (int8 = 4x less traffic); making the
    step raises if no process group is initialised.
    """
    reducer = make_pod_reducer(pod_reduce, group) \
        if pod_reduce != "none" else None

    def grads_of(params, batch):
        if microbatches == 1:
            return value_and_grad(model, params, batch, remat=remat)
        B = batch["tokens"].shape[0]
        if B % microbatches:
            raise ValueError(f"batch {B} does not split into {microbatches} "
                             f"microbatches")
        n = B // microbatches
        loss = torch.zeros((), dtype=torch.float32, device=model.device)
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        for i in range(microbatches):
            mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            l, g = value_and_grad(model, params, mb, remat=remat)
            loss = loss + l
            tree_map(lambda a, x: a.add_(x), acc, g)  # fp32 accumulation
        inv = 1.0 / microbatches
        return loss * inv, tree_map(lambda a: a.mul_(inv), acc)

    def train_step(params, opt_state, batch):
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        loss, grads = grads_of(params, batch)
        if reducer is not None:
            grads = reducer(grads)
        params, opt_state, metrics = adamw_update(grads, opt_state, params,
                                                  opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step
