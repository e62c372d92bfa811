"""Logical sharding rules with divisibility fallback.

One rule set must serve ten architectures whose head counts (1..48) and odd
vocabularies do not all divide a fixed 16-way 'model' axis, so every rule is
applied *only if the dim divides the axis product* — otherwise that dim stays
replicated (the MaxText convention).  The dims that carry the big bytes
(d_ff, fused H*dh projections, vocab-padded embeddings, expert count 128) are
all divisible by 16 for every assigned arch, so fallbacks only ever hit small
tensors.

Scheme:
  *  TP  over 'model' : projection output fused dims, expert axis (EP), vocab;
  * FSDP over 'data'  : the opposite matrix dim of every large param
                        (ZeRO-3 — parameters and optimizer state sharded);
  *  DP  over ('pod','data') for batch dims — the pod axis only ever sees
                        data parallelism + gradient all-reduce;
  *  decode KV caches : batch over DP, sequence over 'model'
                        (falls back to sequence over DP x model for B=1).

Port of the reference's ``distributed/sharding.py`` onto
``torch.distributed``'s ``DeviceMesh`` and ``DTensor``.  A spec is a tuple
with one entry per tensor dim: ``None``, a mesh axis name, or a tuple of
names (the port's stand-in for ``PartitionSpec``).  A mesh is anything with
``mesh_dim_names`` and ``shape``, as a ``DeviceMesh`` has.  The rules
(`data_axes` .. `_cache_rule`) are the reference's, line for line; a
`Sharding` is a (mesh, placements) pair, and `distribute` places a tree.
Where the reference's GSPMD propagates every other sharding, DTensor
propagates them op by op, with its own rules.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.training.tree import tree_map


def data_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes present in this mesh ('pod' first if any)."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def _sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return int(np.prod([_sizes(mesh)[a] for a in axis]))
    return _sizes(mesh)[axis]


def _fallback(shape, spec, mesh) -> tuple:
    """Drop any rule a dim cannot honour (non-divisible -> replicated)."""
    fixed = []
    for dim, axis in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if axis is not None and dim % _axis_size(mesh, axis) == 0 and dim > 0:
            fixed.append(axis)
        else:
            fixed.append(None)
    return tuple(fixed)


def logical_pspec(shape, logical: tuple, mesh) -> tuple:
    """Right-align ``logical`` axes onto ``shape`` (leading stack dims get
    None) and apply divisibility fallback."""
    pad = len(shape) - len(logical)
    return _fallback(shape, (None,) * pad + tuple(logical), mesh)


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------
_TP, _FSDP = "model", "data"

def _param_rule(path: tuple[str, ...], ndim_tail: int) -> tuple:
    """Logical spec for the TRAILING dims of a param, keyed by its path."""
    name = path[-1]
    parent = path[-2] if len(path) > 1 else ""
    col = (_FSDP, _TP)       # column-parallel: [d_in, d_out] out over model
    row = (_TP, _FSDP)       # row-parallel:    [d_in, d_out] in  over model
    if name == "w":
        if parent in ("wq", "wk", "wv", "wi_gate", "wi_up", "wi", "in_proj",
                      "frontend"):
            return col
        if parent in ("wo", "out_proj"):
            return row
        return (None, None)
    if name in ("wi_gate", "wi_up"):   # raw expert stacks [E, d, f]
        return (_TP, _FSDP, None)
    if name == "wo":                   # expert stack [E, f, d]
        return (_TP, None, _FSDP)
    if name in ("table", "unembed"):   # [V_pad, d]
        return (_TP, _FSDP)
    if name == "router":               # [d, E] — small, fp32
        return (None, None)
    if name == "conv_w":               # [k, C]
        return (None, _TP)
    return tuple([None] * ndim_tail)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested-dict tree, path = the dict keys."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_pspecs(params: Any, mesh) -> Any:
    """Spec tree matching ``params`` (works on meta tensors)."""
    return _map_with_path(
        lambda path, leaf: logical_pspec(
            leaf.shape, _param_rule(path, leaf.ndim), mesh), params)


def param_shardings(params: Any, mesh) -> Any:
    """`Sharding` tree matching ``params``."""
    return pspec_to_sharding(param_pspecs(params, mesh), mesh)


# ---------------------------------------------------------------------------
# batch / cache rules
# ---------------------------------------------------------------------------
def batch_pspec(shape, mesh) -> tuple:
    """Leading dim over DP axes, rest replicated (token/label/embeds)."""
    dp = data_axes(mesh)
    return _fallback(shape, (dp,), mesh)


def _cache_rule(path: tuple[str, ...], shape, mesh) -> tuple:
    """KV caches [L, 2, B, S, KV, dh]: B over DP, S over 'model'; if B cannot
    shard (long_500k B=1), S takes DP x model.  SSM states: B over DP, the
    head/state dim over 'model'."""
    dp = data_axes(mesh)
    name = path[-1] if path else ""
    if name == "conv":  # [..., B, k-1, C] (right-aligned: stack dims vary)
        return logical_pspec(shape, (dp, None, _TP), mesh)
    if name == "ssm":  # [..., B, nh, ds, hd]
        return logical_pspec(shape, (dp, _TP, None, None), mesh)
    if len(shape) == 6:  # attention cache [L, 2, B, S, KV, dh]
        B, S = shape[2], shape[3]
        if B % _axis_size(mesh, dp) == 0 and B > 1:
            return _fallback(shape, (None, None, dp, _TP, None, None), mesh)
        seq_axes = dp + (_TP,)
        return _fallback(shape, (None, None, None, seq_axes, None, None), mesh)
    return ()


def cache_pspecs(cache: Any, mesh) -> Any:
    return _map_with_path(
        lambda path, leaf: _cache_rule(path, leaf.shape, mesh), cache)


def cache_shardings(cache: Any, mesh) -> Any:
    return pspec_to_sharding(cache_pspecs(cache, mesh), mesh)


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------
class Sharding(NamedTuple):
    """Where a tensor lives: the mesh, and one placement per mesh dim."""
    mesh: Any
    placements: tuple


def spec_placements(spec: tuple, mesh) -> tuple:
    """One placement per mesh dim: ``Shard(d)`` on each mesh dim that tensor
    dim ``d`` is spread over, ``Replicate()`` on the rest and on every mesh
    dim of size 1 (one piece: the same thing, and a placement no DTensor
    rule has to reshape).  A dim spread over several axes must name them in
    mesh order (JAX's order: the first named axis is the major one, as
    DTensor shards mesh dim by mesh dim)."""
    names = list(mesh.mesh_dim_names)
    placements = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"order {tuple(names)}")
        for i in idx:
            if mesh.shape[i] > 1:
                placements[i] = Shard(d)
    return tuple(placements)


def pspec_to_sharding(tree_of_pspecs: Any, mesh) -> Any:
    return tree_map(lambda s: Sharding(mesh, spec_placements(s, mesh)),
                    tree_of_pspecs)


def distribute(tree: Any, shardings: Any) -> Any:
    """DTensors of ``tree``'s leaves placed by ``shardings`` (a tree of the
    same structure).  Every rank holds the whole tree, with the same values
    (or on ``meta``), and keeps its own shard of it: nothing is sent."""

    def place(t, s: Sharding):
        return distribute_tensor(t, s.mesh, s.placements, src_data_rank=None)
    return tree_map(place, tree, shardings)
