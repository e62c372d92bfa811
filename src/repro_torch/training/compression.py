"""Gradient compression for cross-pod reduction (the slow link between pods,
not the fast one inside a pod, is the constraint).

Port of the reference's ``training/compression.py`` over
``torch.distributed``: a process group takes the place of the mesh's 'pod'
axis, and each all-reduce is a collective over its ranks (gloo on the CPU,
NCCL on the card).

int8 scheme: per-tensor max-abs scale agreed via a scalar MAX all-reduce,
stochastic-free symmetric quantisation, integer all-reduce, dequantise, plus
an error-feedback residual carried in the optimizer loop so quantisation
noise does not bias the descent direction (Seide et al. / EF-SGD style).

Wire cost per gradient element: 1 byte (vs 2 bf16 / 4 fp32) -> 4x less
traffic for the pod all-reduce (the int8 codes travel as int32 sums here;
the scheme, not this transport, sets the wire format).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .tree import tree_map


def quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8-quantised mean over the ranks of ``group``.

    The scale is the global max-abs (one scalar MAX all-reduce), so every
    rank quantises on the same grid and the integer sum is exact up to
    clipping.  int32 accumulation avoids wrap-around for any rank count
    <= 2^23."""
    absmax = torch.max(torch.abs(x.float()))
    dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp_min(absmax, 1e-12) / 127.0
    total = quantize_int8(x, scale).to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    n = dist.get_world_size(group)
    return (total.float() * scale / n).to(x.dtype)


def bf16_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """bf16-cast mean: 2x less wire traffic than fp32, no residual."""
    total = x.to(torch.bfloat16, copy=True)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    n = dist.get_world_size(group)
    return (total.float() / n).to(x.dtype)


def fp32_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The plain mean (the reference's ``pmean``)."""
    total = x.clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total / dist.get_world_size(group)


_REDUCERS = {"fp32": fp32_all_reduce, "bf16": bf16_all_reduce,
             "int8": compressed_all_reduce}


def make_pod_reducer(kind: str, group=None):
    """Returns reduce(grads_tree) -> grads_tree averaging each leaf over the
    ranks of ``group`` (the default group if None); ``kind`` in {none, fp32,
    bf16, int8}.  Any kind but 'none' needs an initialised process group,
    and raises without one."""
    if kind == "none":
        return lambda g: g
    if kind not in _REDUCERS:
        raise ValueError(kind)
    if not dist.is_initialized():
        raise RuntimeError(f"pod_reduce={kind!r} needs an initialised "
                           f"torch.distributed process group")
    fn = _REDUCERS[kind]
    return lambda g: tree_map(lambda x: fn(x, group), g)


def apply_error_feedback(grads, residual):
    """g' = g + residual (pre-compression); call :func:`update_residual` with
    the decompressed result to carry the quantisation error forward."""
    if residual is None:
        return grads
    return tree_map(lambda g, r: g + r.to(g.dtype), grads, residual)


def update_residual(grads_pre, grads_post):
    """residual = pre-compression grads - post-compression grads."""
    return tree_map(lambda a, b: a.float() - b.float(), grads_pre,
                    grads_post)
