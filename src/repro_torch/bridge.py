"""Reference parameters -> port parameters.

The reference initialises with a JAX ``PRNGKey``, which torch cannot
reproduce, so every parity test initialises with the reference and hands its
parameter tree to :func:`params_from_reference` as nested dicts of numpy
arrays (``jax.tree.map(np.asarray, params)``).  The layout is unchanged:
``x @ w`` weights [d_in, d_out], layers stacked on a leading [L] axis.
"""
from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(arr, device="cuda") -> torch.Tensor:
    """One numpy array -> a tensor on ``device`` with the same values.

    bfloat16 arrays (numpy has no native bf16; the reference hands over its
    own bf16 dtype) cross as their uint16 bit patterns, so no value is
    rounded on the way."""
    arr = np.array(arr, copy=True)  # writable, contiguous, owned
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_reference(tree, device="cuda"):
    """Nested dicts of numpy arrays -> the same nesting of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)
