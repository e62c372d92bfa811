"""Flash attention: many query rows against a key/value sequence.

K4 (``flash_attention``, CUDA kernel of ``csrc/flash_attention.cu``) takes
head-major queries [B, H, Sq, dh] against fp32 or bf16 K/V [B, KV, Sk, dh]
and returns ``out`` [B, H, Sq, dh]; bf16 runs on the tensor cores
(``csrc/flash_wgmma.cuh``), fp32 on the CUDA cores.  With ``causal``, row i sees key j iff
``i >= j``: the mask is top-left aligned, as the reference's kernel's (its
jnp oracle ``ref_flash_attention`` is bottom-right aligned; the two agree
only when Sq == Sk).

K7 (``flash_attention_quant``, ``csrc/flash_attention_quant.cu``) takes
queries in the engines' native layout [B, Sq, H, dh] against a prefix kept
at wire width (packed int8 or int4 words plus one fp16 scale row per chunk
of G tokens), expanded inside the kernel (K3, ``csrc/dequant_tile.cuh``):
bf16 q runs K4's tensor-core loop with a loader that writes the values as
bf16 pieces, fp32 q K4's CUDA-core loop with a loader of fp32 tiles; a CTA
takes rows of the H/KV heads of one KV head (`flash_quant_grid`).  It
returns ``(out, m, l)``: ``out``
[B, Sq, H, dh] and the fp32 softmax residuals m, l [B, Sq, H].  With
``causal``, query row i sits at absolute position ``q_offset + i`` and sees
key j iff ``q_offset + i >= j``; a row that sees no key gives out = 0,
m = -inf, l = 0.

Both compute in fp32 and round ``out`` once to q's dtype.  Each ``*_ref``
function is its kernel's plain PyTorch version (the CPU path and the oracle
the kernel is held to).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build, launches
from .decode_attention import (H100_SMS, Q_KINDS, _counters, check_fp_kv,
                               check_kernel_inputs, check_query,
                               softmax_values)
from .kv_dequant import check_packed_cache, dequant_cache_ref


def check_fp_flash_args(q, k, v) -> tuple[int, int, int, int, int, int]:
    """Validate the inputs both versions of K4 take; returns
    (B, Sq, Sk, H, KV, dh)."""
    check_fp_kv(k, v, q, ("k", "v"), "[B, KV, Sk, dh]")
    B, KV, Sk, dh = k.shape
    if Sk < 1 or KV < 1:
        raise ValueError("k and v hold no key or no KV head")
    if q.ndim != 4 or q.shape[0] != B or q.shape[3] != dh:
        raise ValueError(f"want q [B, H, Sq, dh] = [{B}, H, Sq, {dh}], got "
                         f"{tuple(q.shape)}")
    H, Sq = q.shape[1], q.shape[2]
    if Sq < 1:
        raise ValueError("q holds no query row")
    if H < 1 or H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} KV "
                         f"heads")
    if q.device != k.device:
        raise ValueError(f"q on {q.device}, k and v on {k.device}")
    return B, Sq, Sk, H, KV, dh


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """Plain version of `flash_attention` (K4): q [B, H, Sq, dh]; k/v
    [B, KV, Sk, dh] in q's dtype -> out [B, H, Sq, dh] in q's dtype.  The
    causal mask is top-left aligned: row i sees key j iff i >= j."""
    B, Sq, Sk, H, KV, dh = check_fp_flash_args(q, k, v)
    qg = q.float().reshape(B, KV, H // KV, Sq, dh)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) \
        * (1.0 / math.sqrt(dh))
    if causal:
        rows = torch.arange(Sq, device=q.device)[:, None]
        cols = torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(rows >= cols, s, float("-inf"))
    o, _, _ = softmax_values(s, v.float(), "bkgqs,bksd->bkgqd")
    return o.reshape(B, H, Sq, dh).to(q.dtype)


def check_flash_args(q, k_q, v_q, k_scales, v_scales, *, bits, group,
                     chunk_tokens, q_offset) -> tuple[int, int, int, int,
                                                      int, int]:
    """Validate the inputs both versions take; returns
    (B, Sq, Sk, H, KV, dh)."""
    B, Sk, KV, dh = check_packed_cache(k_q, v_q, k_scales, v_scales,
                                       bits=bits, group=group,
                                       chunk_tokens=chunk_tokens)
    if Sk < 1:
        raise ValueError("the cache holds no token")
    if q.ndim != 4:
        raise ValueError(f"want q [B, Sq, H, dh], got {tuple(q.shape)}")
    Sq = q.shape[1]
    H = check_query(q, (B, Sq), KV, dh, k_q.device)
    if Sq < 1:
        raise ValueError("q holds no query row")
    if not isinstance(q_offset, int) or q_offset < 0:
        raise ValueError(f"q_offset must be a non-negative int, "
                         f"got {q_offset!r}")
    return B, Sq, Sk, H, KV, dh


def flash_attention_quant_ref(q, k_q, v_q, k_scales, v_scales, *, bits: int,
                              group: int, chunk_tokens: int,
                              causal: bool = True, q_offset: int = 0):
    """Plain version of `flash_attention_quant`: q [B, Sq, H, dh]; k_q/v_q
    [B, Sk, KV, dh']; scales [B, Sk/G, KV*dh/group] fp16 -> (out
    [B, Sq, H, dh] q.dtype, m [B, Sq, H], l [B, Sq, H] fp32)."""
    B, Sq, Sk, H, KV, dh = check_flash_args(
        q, k_q, v_q, k_scales, v_scales, bits=bits, group=group,
        chunk_tokens=chunk_tokens, q_offset=q_offset)
    k = dequant_cache_ref(k_q, k_scales, bits=bits, group=group,
                          chunk_tokens=chunk_tokens)  # [B, Sk, KV, dh]
    v = dequant_cache_ref(v_q, v_scales, bits=bits, group=group,
                          chunk_tokens=chunk_tokens)
    qg = q.float().reshape(B, Sq, KV, H // KV, dh)
    s = torch.einsum("bqkgd,bskd->bqkgs", qg, k) * (1.0 / math.sqrt(dh))
    if causal:
        rows = q_offset + torch.arange(Sq, device=q.device)[:, None]
        cols = torch.arange(Sk, device=q.device)[None, :]
        s = torch.where((rows >= cols)[None, :, None, None, :], s,
                        float("-inf"))
    o, m, l = softmax_values(s, v, "bqkgs,bskd->bqkgd")
    return (o.reshape(B, Sq, H, dh).to(q.dtype), m.reshape(B, Sq, H),
            l.reshape(B, Sq, H))


# query rows a CTA of K7 takes: 128 on the tensor-core loop (bf16 q), 64 on
# the CUDA-core loop (fp32 q)
QUANT_ROWS = {torch.bfloat16: 128, torch.float32: 64}


def flash_quant_grid(B: int, Sq: int, H: int, KV: int,
                     dtype: torch.dtype) -> tuple[int, int, int]:
    """The row blocks of the grid K7's entry point launches for q
    [B, Sq, H, dh] of ``dtype`` over KV heads.  A CTA's rows are query
    vectors of one KV head:
    vector v of KV head kh is (position v // (H/KV), head kh * H/KV +
    v % (H/KV)) (`flash_quant_row`), so the Sq * H/KV vectors of a KV head
    fill ceil(Sq * H/KV / rows) row blocks.  bf16: (KV, row blocks x
    `flash_quant_splits`, B), the splits of a row block adjacent along y;
    fp32: (row blocks, KV, B)."""
    blocks = -(-Sq * (H // KV) // QUANT_ROWS[dtype])
    return (KV, blocks, B) if dtype == torch.bfloat16 else (blocks, KV, B)


# K7's key splits on the tensor-core loop: at least this many keys a CTA,
# at most this many CTAs a row block
MIN_SPLIT_KEYS = 512
MAX_SPLITS = 8


def flash_quant_splits(B: int, Sq: int, H: int, KV: int, Sk: int,
                       dtype: torch.dtype) -> int:
    """CTAs per row block of K7 (bf16 q): as many as the card's SMs hold
    beside the row blocks of one launch, each with at least MIN_SPLIT_KEYS
    keys; 1 where the row blocks fill the card or q is fp32 (the CUDA-core
    loop takes no split).  The last CTA of a row block merges the others'
    partials."""
    if dtype != torch.bfloat16:
        return 1
    blocks = math.prod(flash_quant_grid(B, Sq, H, KV, dtype))
    return max(1, min(H100_SMS // blocks, Sk // MIN_SPLIT_KEYS, MAX_SPLITS))


def flash_quant_row(kh: int, v: int, H: int, KV: int) -> tuple[int, int]:
    """(query position, head) of vector v of KV head kh in K7's packing:
    the H/KV heads of a position are adjacent rows of q [B, Sq, H, dh]."""
    gs = H // KV
    return v // gs, kh * gs + v % gs


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention_quant")
    fn = lib.flash_attention_quant
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 8
                       + [ctypes.c_int] * 3
                       + [ctypes.c_longlong, ctypes.c_float, ctypes.c_int]
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
    return lib


def flash_attention_quant(q, k_q, v_q, k_scales, v_scales, *, bits: int,
                          group: int, chunk_tokens: int, causal: bool = True,
                          q_offset: int = 0):
    """CUDA kernel: the same function as `flash_attention_quant_ref` on CUDA
    tensors."""
    B, Sq, Sk, H, KV, dh = check_flash_args(
        q, k_q, v_q, k_scales, v_scales, bits=bits, group=group,
        chunk_tokens=chunk_tokens, q_offset=q_offset)
    out = torch.empty_like(q)
    check_kernel_inputs("flash_attention_quant", {
        "q": q, "k_q": k_q, "v_q": v_q, "k_scales": k_scales,
        "v_scales": v_scales}, dh, H, KV)
    # the tensor-core loop reads q rows and writes out rows 16 bytes a step
    check_kernel_inputs("flash_attention_quant", {"q": q, "out": out}, dh,
                        H, KV, aligned=("q", "out"), alignment=16)
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.empty((B, Sq, H), **f32)
    l = torch.empty((B, Sq, H), **f32)
    nsplit = flash_quant_splits(B, Sq, H, KV, Sk, q.dtype)
    blocks = math.prod(flash_quant_grid(B, Sq, H, KV, q.dtype))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        scratch = (0, 0, 0)
        if nsplit > 1:  # the splits' partials (o, then m and l) per row
            pacc = torch.empty(blocks * nsplit * 128 * dh, **f32)
            pml = torch.empty(blocks * nsplit * 128 * 2, **f32)
            scratch = (pacc.data_ptr(), pml.data_ptr(),
                       _counters(q.device, stream, blocks).data_ptr())
        err = _lib().flash_attention_quant(
            q.data_ptr(), k_q.data_ptr(), v_q.data_ptr(), k_scales.data_ptr(),
            v_scales.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(),
            B, Sq, Sk, H, KV, dh, chunk_tokens, group, bits,
            Q_KINDS[q.dtype], int(bool(causal)), q_offset,
            1.0 / math.sqrt(dh), nsplit, *scratch, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_quant launch failed: CUDA error "
                           f"{err}")
    launches.count("flash_attention_quant")
    return out, m, l


def _fp_lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.flash_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 6
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def flash_attention(q, k, v, *, causal: bool = True):
    """CUDA kernel (K4): the same function as `flash_attention_ref` on CUDA
    tensors."""
    B, Sq, Sk, H, KV, dh = check_fp_flash_args(q, k, v)
    out = torch.empty_like(q)
    # TMA (bf16) and 16-byte vector loads (fp32) take 16-byte aligned bases
    check_kernel_inputs("flash_attention", {"q": q, "k": k, "v": v,
                                            "out": out}, dh, H, KV,
                        aligned=("q", "k", "v", "out"), alignment=16)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fp_lib().flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Sk, H, KV, dh, Q_KINDS[q.dtype], int(bool(causal)),
            1.0 / math.sqrt(dh), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    launches.count("flash_attention")
    return out
