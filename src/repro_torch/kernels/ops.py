"""Public kernel ops: one dispatch rule for every op.

A tensor on the CPU goes to the kernel's plain PyTorch version; a CUDA
tensor goes to the CUDA kernel, which launches or raises.  There is no
capability probe and no fallback: a card that cannot run the kernel fails
loudly at the first call.

The attention ops keep the reference's keyword arguments.  Their
block-size arguments (``block_s``, ``block_q``, ``block_k``) were the TPU
kernels' tiling; they are accepted and do not change the result: the plain
versions have no blocks and the CUDA kernels choose their own.
"""
from __future__ import annotations

import torch

from .decode_attention import (decode_attention, decode_attention_quant,
                               decode_attention_quant_ref,
                               decode_attention_ref)
from .flash_attention import (flash_attention, flash_attention_quant,
                              flash_attention_quant_ref, flash_attention_ref)
from .kv_dequant import (kv_dequant, kv_dequant_packed4,
                         kv_dequant_packed4_ref, kv_dequant_ref)
from .kv_gather import kv_gather, kv_gather_ref


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, block_q: int = 128,
                       block_k: int = 128) -> torch.Tensor:
    """Flash attention (K4): q [B, H, Sq, dh]; k/v [B, KV, Sk, dh] -> out
    [B, H, Sq, dh]; the causal mask is top-left aligned.  ``block_q`` and
    ``block_k`` do not change the result."""
    del block_q, block_k
    fn = flash_attention_ref if q.device.type == "cpu" else flash_attention
    return fn(q, k, v, causal=causal)


def decode_attention_op(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, lengths: torch.Tensor, *,
                        block_s: int = 512) -> torch.Tensor:
    """Decode attention (K5): q [B, H, dh]; caches [B, S, KV, dh]; lengths
    [B] int32 -> out [B, H, dh].  ``block_s`` does not change the result."""
    del block_s
    fn = decode_attention_ref if q.device.type == "cpu" else decode_attention
    return fn(q, k_cache, v_cache, lengths)


def kv_gather_op(pool: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Chunk-tile gather (K8): pool [P, G, W]; indices [N] int32 or int64 ->
    [N, G, W] = pool[indices]."""
    fn = kv_gather_ref if pool.device.type == "cpu" else kv_gather
    return fn(pool, indices)


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


def decode_attention_quant_op(q, k_q, v_q, k_scales, v_scales, lengths, *,
                              bits: int, group: int, chunk_tokens: int,
                              block_s: int = 512,
                              return_residuals: bool = False):
    """Decode attention over a packed cache (K6): q [B, H, dh]; k_q/v_q
    [B, S, KV, dh']; scales [B, S/G, KV*dh/group] fp16; lengths [B] int32
    -> out [B, H, dh], or (out, m [B, H], l [B, H]) with
    ``return_residuals``.  ``block_s`` does not change the result."""
    del block_s
    fn = (decode_attention_quant_ref if q.device.type == "cpu"
          else decode_attention_quant)
    out, m, l = fn(q, k_q, v_q, k_scales, v_scales, lengths, bits=bits,
                   group=group, chunk_tokens=chunk_tokens)
    return (out, m, l) if return_residuals else out


def flash_attention_quant_op(q, k_q, v_q, k_scales, v_scales, *, bits: int,
                             group: int, chunk_tokens: int,
                             causal: bool = True, q_offset: int = 0,
                             block_q: int = 128, block_k: int = 128,
                             return_residuals: bool = False):
    """Flash attention over a packed prefix (K7): q [B, Sq, H, dh]; k_q/v_q
    [B, Sk, KV, dh']; scales [B, Sk/G, KV*dh/group] fp16 -> out
    [B, Sq, H, dh], or (out, m, l [B, Sq, H]) with ``return_residuals``.
    ``block_q`` and ``block_k`` do not change the result."""
    del block_q, block_k
    fn = (flash_attention_quant_ref if q.device.type == "cpu"
          else flash_attention_quant)
    out, m, l = fn(q, k_q, v_q, k_scales, v_scales, bits=bits, group=group,
                   chunk_tokens=chunk_tokens, causal=causal,
                   q_offset=q_offset)
    return (out, m, l) if return_residuals else out
