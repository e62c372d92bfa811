"""Atomic checkpointing, in the reference's on-disk layout.

Layout:  <dir>/step_<N>/manifest.json + one .npy per tree leaf, leaves in
JAX's flatten order for nested dicts (sorted keys); bf16 stored as uint16
words, dtype recorded in the manifest.  Each package restores the other's
checkpoints.  Writes go to a tmp dir and are committed with an atomic
rename, so a torn save is never visible.  ``async_save`` runs serialization
on a background thread (the train loop keeps stepping) after the leaves
were copied to the host.  A tree with DTensor leaves is one checkpoint of
its mesh: every rank of the mesh calls `save_checkpoint` (each leaf is
gathered whole, a collective), only the mesh's first rank writes, and
every rank restores from that one directory, so ``ckpt_dir`` must be one
that every rank reads.  A synchronous save returns once the checkpoint is
committed on every rank (`mesh_barrier`); after an asynchronous one the
caller joins the writer's thread and then calls `mesh_barrier` before any
rank reads it (`TrainSupervisor` does).  Restore places each leaf on a
``device`` or, given ``shardings`` (a tree of
`distributed.sharding.Sharding`), on a mesh: the mesh at save time does
not matter, so elastic restore re-shards here.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from .tree import tree_leaves, tree_map, tree_unflatten, treedef_str

_WIRE = {"bfloat16": np.uint16}
_TORCH_DTYPES = {"bfloat16": torch.bfloat16}


def _leaf_path(i: int) -> str:
    return f"leaf_{i:05d}.npy"


def _to_host(x) -> tuple[np.ndarray, str]:
    """A leaf -> (a numpy copy on the host, its dtype's name); bf16 as its
    uint16 words."""
    if isinstance(x, torch.Tensor):
        if isinstance(x, DTensor):  # gather its shards
            x = x.full_tensor()
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return x.numpy(), str(x.numpy().dtype)
    arr = np.array(x, copy=True)
    dt = arr.dtype.name
    return (arr.view(_WIRE[dt]) if dt in _WIRE else arr), dt


def mesh_of(tree: Any):
    """The device mesh of ``tree``'s first DTensor leaf, or None."""
    return next((x.device_mesh for x in tree_leaves(tree)
                 if isinstance(x, DTensor)), None)


def mesh_barrier(mesh) -> None:
    """Every rank of ``mesh`` waits for every other: a barrier over each
    mesh dim's group in turn (after dims 0..i, a rank has met every rank
    that differs from it only there), so the writer's commit precedes
    every rank's return."""
    import torch.distributed as dist
    for i in range(mesh.ndim):
        dist.barrier(group=mesh.get_group(i))


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    extra: Optional[dict] = None,
                    async_save: bool = False) -> threading.Thread | None:
    """Serialize ``tree`` (params/opt_state/anything) for ``step``.  On a
    mesh, only its first rank writes (the module docstring); the others
    return None."""
    leaves = tree_leaves(tree)
    host = [_to_host(x) for x in leaves]
    mesh = mesh_of(tree)
    if mesh is not None:
        import torch.distributed as dist
        if dist.get_rank() != int(mesh.mesh.min()):
            if not async_save:
                mesh_barrier(mesh)
            return None

    def _write():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp, exist_ok=True)
        for i, (arr, _) in enumerate(host):
            np.save(os.path.join(tmp, _leaf_path(i)), arr)
        manifest = {
            "step": step,
            "num_leaves": len(host),
            "dtypes": [dt for _, dt in host],
            "treedef": treedef_str(tree),
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)  # atomic commit

    if async_save:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    if mesh is not None:
        mesh_barrier(mesh)
    return None


def _steps(ckpt_dir: str) -> list[int]:
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, like: Any,
                       device=None, shardings: Any = None
                       ) -> tuple[Any, dict]:
    """Restore into the structure of ``like`` as tensors on ``device`` (None:
    each on the device of its leaf in ``like``, the CPU for a leaf that is
    not a tensor); dtypes come from the checkpoint.  With ``shardings`` (a
    tree like ``like``), each leaf becomes a DTensor on its sharding's mesh
    (loaded whole onto the mesh's device type, each rank keeping its
    shard).  Returns (tree, extra)."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    like_leaves = tree_leaves(like)
    if manifest["num_leaves"] != len(like_leaves):
        raise ValueError(f"checkpoint {d} holds {manifest['num_leaves']} "
                         f"leaves, the tree {len(like_leaves)}")
    leaves = []
    for i, ref in enumerate(like_leaves):
        arr = np.load(os.path.join(d, _leaf_path(i)))
        dt = manifest["dtypes"][i]
        if dt in _TORCH_DTYPES:  # uint16 words
            t = torch.from_numpy(arr.view(np.int16)).view(_TORCH_DTYPES[dt])
        else:
            t = torch.from_numpy(arr)
        dev = device if device is not None else (
            ref.device if isinstance(ref, torch.Tensor) else "cpu")
        leaves.append(t.to(dev))
    tree = tree_unflatten(like, leaves)
    if shardings is not None:
        from repro_torch.distributed.sharding import distribute
        tree = distribute(tree_map(lambda t, s: t.to(s.mesh.device_type),
                                   tree, shardings), shardings)
    return tree, manifest["extra"]


def prune_checkpoints(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the ``keep`` newest committed checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return
    for s in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
