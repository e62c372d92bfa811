"""Random weights for a configuration, made on the device from the run's
seed: one ``normal_`` call per stacked leaf, in the type they are served in.

The tree has the program's parameter layout (layers stacked on a leading
[L]); the same tensors go to the program and to the reference.
"""
from __future__ import annotations

import torch

from ocbench import archs

VOCAB_PAD = 256  # the program pads its tables to a multiple of 256 rows

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype(cfg: dict) -> torch.dtype:
    return _DTYPES[cfg["torch_dtype"]]


def padded_vocab(cfg: dict) -> int:
    return -(-cfg["vocab_size"] // VOCAB_PAD) * VOCAB_PAD


def shapes(cfg: dict) -> dict:
    """The tree of (shape, dtype, mean, std) the weights are drawn from: the
    architecture's (``archs/<module>.py`` ``weight_shapes``)."""
    return archs.of(cfg).weight_shapes(cfg)


def make(cfg: dict, seed: int, device) -> dict:
    """The weights of ``cfg`` from ``seed``, drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        shape, dt, mean, std = node
        return torch.empty(shape, dtype=dt, device=device).normal_(
            mean, std, generator=gen)
    return fill(shapes(cfg))


def same_layout(tree, spec) -> list[str]:
    """Where ``tree`` differs from ``spec`` (the program's own parameter
    tree on the meta device) in keys, shapes or dtypes."""
    if isinstance(spec, dict):
        if not isinstance(tree, dict) or set(tree) != set(spec):
            return [f"keys {sorted(tree) if isinstance(tree, dict) else tree}"
                    f" != {sorted(spec)}"]
        return [f"{k}/{e}" for k in spec for e in same_layout(tree[k], spec[k])]
    if tree.shape != spec.shape or tree.dtype != spec.dtype:
        return [f"{tuple(tree.shape)} {tree.dtype} != "
                f"{tuple(spec.shape)} {spec.dtype}"]
    return []
