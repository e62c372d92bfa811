"""Atomic checkpointing, in the reference's on-disk layout.

Layout:  <dir>/step_<N>/manifest.json + one .npy per tree leaf, leaves in
JAX's flatten order for nested dicts (sorted keys); bf16 stored as uint16
words, dtype recorded in the manifest.  Each package restores the other's
checkpoints.  Writes go to a tmp dir and are committed with an atomic
rename, so a torn save is never visible.  ``async_save`` runs serialization
on a background thread (the train loop keeps stepping) after the leaves
were copied to the host.  Restore takes a *device* where the reference
takes target shardings: a checkpoint restores onto the card or the CPU,
whichever device wrote it.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from .tree import tree_leaves, tree_unflatten, treedef_str

_WIRE = {"bfloat16": np.uint16}
_TORCH_DTYPES = {"bfloat16": torch.bfloat16}


def _leaf_path(i: int) -> str:
    return f"leaf_{i:05d}.npy"


def _to_host(x) -> tuple[np.ndarray, str]:
    """A leaf -> (a numpy copy on the host, its dtype's name); bf16 as its
    uint16 words."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return x.numpy(), str(x.numpy().dtype)
    arr = np.array(x, copy=True)
    dt = arr.dtype.name
    return (arr.view(_WIRE[dt]) if dt in _WIRE else arr), dt


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    extra: Optional[dict] = None,
                    async_save: bool = False) -> threading.Thread | None:
    """Serialize ``tree`` (params/opt_state/anything) for ``step``."""
    host = [_to_host(x) for x in tree_leaves(tree)]

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
                       device=None) -> tuple[Any, dict]:
    """Restore into the structure of ``like`` as tensors on ``device`` (None:
    each on the device of its leaf in ``like``, the CPU for a leaf that is
    not a tensor); dtypes come from the checkpoint.  Returns (tree,
    extra)."""
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
    return tree_unflatten(like, leaves), manifest["extra"]


def prune_checkpoints(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the ``keep`` newest committed checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return
    for s in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
