"""Public kernel ops: one dispatch rule for every op.

A tensor on the CPU goes to the kernel's plain PyTorch version; a CUDA
tensor goes to the CUDA kernel, which launches or raises.  There is no
capability probe and no fallback: a card that cannot run the kernel fails
loudly at the first call.
"""
from __future__ import annotations

import torch

from .kv_dequant import (kv_dequant, kv_dequant_packed4,
                         kv_dequant_packed4_ref, kv_dequant_ref)


def kv_dequant_op(q: torch.Tensor, scales: torch.Tensor, *, group: int = 1,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """q [N, R, W] int8 x scales [N, W/group] fp16 -> [N, R, W]."""
    if q.device.type == "cpu":
        return kv_dequant_ref(q, scales, group=group, out_dtype=out_dtype)
    return kv_dequant(q, scales, group=group, out_dtype=out_dtype)


def kv_dequant_packed4_op(q_packed: torch.Tensor, scales: torch.Tensor, *,
                          group: int = 1,
                          out_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """q_packed [N, R, W/2] uint8 x scales [N, W/group] fp16 -> [N, R, W]."""
    if q_packed.device.type == "cpu":
        return kv_dequant_packed4_ref(q_packed, scales, group=group,
                                      out_dtype=out_dtype)
    return kv_dequant_packed4(q_packed, scales, group=group,
                              out_dtype=out_dtype)
