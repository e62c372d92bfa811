"""Decode attention: one query token per sequence against a cache.

K5 (``decode_attention``, CUDA kernel of ``csrc/decode_attention.cu``)
attends over an fp32 or bf16 cache [B, S, KV, dh]; K6
(``decode_attention_quant``, ``csrc/decode_attention_quant.cu``) over a
cache kept at wire width: packed int8 or int4 words plus one fp16 scale row
per chunk of G tokens, expanded to fp32 inside the kernel (K3,
``csrc/dequant_tile.cuh``) so the cache is read once, at wire width.  Both
are one launch of the split decode of ``csrc/decode_split.cuh`` with their
own row loader, planned by `decode_plan`.  Each
``*_ref`` function is its kernel's plain PyTorch version (the CPU path and
the oracle the kernel is held to).

Both compute in fp32 and round ``out`` [B, H, dh] once to q's dtype; cache
rows at or past a row's length never affect it, and a row with
``length == 0`` gives out = 0 (as the reference's kernels, not its jnp
oracle, which gives NaN).  K6 also returns the fp32 softmax residuals m (row
max of the scaled logits) and l (sum of exp(logit - m)) [B, H], so a caller
can merge the result with attention over a disjoint key set
(`models.layers.merge_attention_partials`); an empty row has m = -inf,
l = 0.

The helpers here that check queries and launch preconditions are shared with
`flash_attention` (K4, K7).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build, launches
from .kv_dequant import H100_SMS, check_packed_cache, dequant_cache_ref

Q_KINDS = {torch.float32: 0, torch.bfloat16: 1}
# head widths the CUDA kernels are built for (those of the dense configs:
# smollm 64; llama, qwen3, internvl 128; gemma 256), and the most query heads
# that may share one KV head
KERNEL_HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 16
# the split decode (K5, K6): the waves of CTAs that keep enough bytes in
# flight on each of the card's SMs, and the fewest tokens worth a CTA
DECODE_WAVES = 2
MIN_SPLIT_TOKENS = 128
# query heads of one KV head a CTA of the split decode serves (more take
# several CTAs)
DECODE_HEAD_BLOCK = 8


def decode_split_tokens(S: int, B: int, KV: int) -> int:
    """Cache tokens per CTA of the split decode over a cache of S tokens
    for B rows of KV heads: at least MIN_SPLIT_TOKENS, and otherwise small
    enough that the B * KV * ceil(S / split) CTAs fill DECODE_WAVES waves of
    the card's SMs.  The splits cover S; those at or past a row's length
    exit at once."""
    want = -(-DECODE_WAVES * H100_SMS // (B * KV))  # splits per (b, kh)
    return max(MIN_SPLIT_TOKENS, -(-S // want))


def decode_plan(S: int, B: int, H: int, KV: int) -> tuple[int, int, int]:
    """The launch plan of K5 and K6 over a cache of S tokens for B rows of H
    query heads on KV heads: (split, nsplit, head_blocks).  The grid is
    nsplit x (KV * head_blocks) x B CTAs, the partials take
    [B, KV, nsplit, H/KV, dh] floats and the stream's counters
    B * KV * head_blocks ints."""
    split = decode_split_tokens(S, B, KV)
    return split, -(-S // split), -(-(H // KV) // DECODE_HEAD_BLOCK)


def quant_block_s(S: int, chunk_tokens: int, block_s: int) -> int:
    """Largest usable cache block <= ``block_s`` for the TPU kernel: the
    per-chunk scale rows pin the block to either a whole number of chunks or
    a divisor of one chunk.  Kept for parity with the reference; the CUDA
    kernel finds each token's scale row as ``t // G`` and is not shaped by
    it."""
    G = chunk_tokens
    block_s = min(block_s, S)
    if block_s % G == 0 or G % block_s == 0:
        return block_s
    return max(G, (block_s // G) * G)


def check_query(q: torch.Tensor, lead: tuple, KV: int, dh: int,
                device: torch.device) -> int:
    """q [*lead, H, dh] in fp32 or bf16 with H a multiple of KV; returns
    H."""
    if q.dtype not in Q_KINDS:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    want = len(lead) + 2
    if q.ndim != want or tuple(q.shape[:len(lead)]) != lead \
            or q.shape[-1] != dh:
        raise ValueError(f"q shape {tuple(q.shape)} does not fit a cache of "
                         f"head_dim {dh}: want {lead + ('H', dh)}")
    H = q.shape[-2]
    if H < 1 or H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} KV "
                         f"heads")
    if q.device != device:
        raise ValueError(f"q on {q.device}, the cache on {device}")
    return H


def check_kernel_inputs(name: str, tensors: dict[str, torch.Tensor],
                        dh: int, H: int, KV: int, *,
                        aligned: tuple[str, ...] = ("k_q", "v_q"),
                        alignment: int = 8) -> None:
    """What the CUDA kernels take beyond the shared checks: CUDA tensors,
    contiguous, a head width they were built for, at most MAX_GROUP query
    heads per KV head, and the ``aligned`` tensors' rows aligned to
    ``alignment`` bytes for their vector loads."""
    for tname, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name} runs on CUDA tensors, got {tname} on "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous inputs; {tname} is "
                             f"not")
    if dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name} is built for head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {dh}")
    if H // KV > MAX_GROUP:
        raise ValueError(f"{name} serves at most {MAX_GROUP} query heads per "
                         f"KV head, got {H // KV}")
    for tname in aligned:
        if tensors[tname].data_ptr() % alignment:
            raise ValueError(f"{name} needs {tname} {alignment}-byte "
                             f"aligned")


def check_decode_args(q, k_q, v_q, k_scales, v_scales, lengths, *, bits,
                      group, chunk_tokens) -> tuple[int, int, int, int, int]:
    """Validate the inputs both versions take; returns (B, S, H, KV, dh)."""
    B, S, KV, dh = check_packed_cache(k_q, v_q, k_scales, v_scales,
                                      bits=bits, group=group,
                                      chunk_tokens=chunk_tokens)
    if S < 1:
        raise ValueError("the cache holds no token")
    H = check_query(q, (B,), KV, dh, k_q.device)
    check_lengths(lengths, B, k_q.device)
    return B, S, H, KV, dh


def check_lengths(lengths: torch.Tensor, B: int,
                  device: torch.device) -> None:
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be int32 [{B}], got {lengths.dtype} "
                         f"{tuple(lengths.shape)}")
    if lengths.device != device:
        raise ValueError(f"lengths on {lengths.device}, the cache on "
                         f"{device}")


def check_fp_kv(k: torch.Tensor, v: torch.Tensor, q: torch.Tensor,
                names: tuple[str, str], layout: str) -> None:
    """k and v of one 4-d shape, in q's dtype (fp32 or bf16)."""
    if k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"want {names[0]} and {names[1]} {layout} of one "
                         f"shape, got {tuple(k.shape)} and {tuple(v.shape)}")
    if k.dtype not in Q_KINDS or v.dtype != k.dtype or q.dtype != k.dtype:
        raise TypeError(f"q, {names[0]} and {names[1]} must share one dtype, "
                        f"float32 or bfloat16; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if v.device != k.device:
        raise ValueError(f"{names[1]} on {v.device}, {names[0]} on "
                         f"{k.device}")


def check_fp_decode_args(q, k_cache, v_cache, lengths
                         ) -> tuple[int, int, int, int, int]:
    """Validate the inputs both versions of K5 take; returns
    (B, S, H, KV, dh)."""
    check_fp_kv(k_cache, v_cache, q, ("k_cache", "v_cache"),
                "[B, S, KV, dh]")
    B, S, KV, dh = k_cache.shape
    if S < 1 or KV < 1:
        raise ValueError("the cache holds no token or no KV head")
    H = check_query(q, (B,), KV, dh, k_cache.device)
    check_lengths(lengths, B, k_cache.device)
    return B, S, H, KV, dh


def softmax_values(s: torch.Tensor, v: torch.Tensor, equation: str):
    """fp32 softmax of the masked logits ``s`` (-inf where masked) over their
    last axis, applied to ``v`` by ``equation``: (out, m, l), out =
    sum p v / max(l, 1e-30).  A row that sees no key gives out = 0,
    m = -inf, l = 0; masked entries weigh exactly 0."""
    m = s.amax(dim=-1)
    safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(torch.isfinite(s), torch.exp(s - safe[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum(equation, p, v) / l.clamp_min(1e-30)[..., None]
    return o, m, l


def decode_attention_ref(q, k_cache, v_cache, lengths):
    """Plain version of `decode_attention` (K5): q [B, H, dh]; caches
    [B, S, KV, dh] in q's dtype; lengths [B] int32 -> out [B, H, dh] in q's
    dtype.  Rows at or past a row's length are selected away (not multiplied
    by a zero weight), so stale values there, NaN included, do not
    matter."""
    B, S, H, KV, dh = check_fp_decode_args(q, k_cache, v_cache, lengths)
    cols = torch.arange(S, device=q.device)
    seen = cols[None, :] < lengths.long()[:, None]  # [B, S]
    v = torch.where(seen[:, :, None, None], v_cache.float(), 0.0)
    qg = q.float().reshape(B, KV, H // KV, dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) \
        * (1.0 / math.sqrt(dh))
    s = torch.where(seen[:, None, None, :], s, float("-inf"))
    o, _, _ = softmax_values(s, v, "bkgs,bskd->bkgd")
    return o.reshape(B, H, dh).to(q.dtype)


def decode_attention_quant_ref(q, k_q, v_q, k_scales, v_scales, lengths, *,
                               bits: int, group: int, chunk_tokens: int):
    """Plain version of `decode_attention_quant`: q [B, H, dh]; k_q/v_q
    [B, S, KV, dh']; scales [B, S/G, KV*dh/group] fp16; lengths [B] int32
    -> (out [B, H, dh] q.dtype, m [B, H], l [B, H] fp32)."""
    B, S, H, KV, dh = check_decode_args(q, k_q, v_q, k_scales, v_scales,
                                        lengths, bits=bits, group=group,
                                        chunk_tokens=chunk_tokens)
    k = dequant_cache_ref(k_q, k_scales, bits=bits, group=group,
                          chunk_tokens=chunk_tokens)  # [B, S, KV, dh]
    v = dequant_cache_ref(v_q, v_scales, bits=bits, group=group,
                          chunk_tokens=chunk_tokens)
    qg = q.float().reshape(B, KV, H // KV, dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k) * (1.0 / math.sqrt(dh))
    cols = torch.arange(S, device=q.device)
    seen = (cols[None, :] < lengths.long()[:, None])[:, None, None, :]
    s = torch.where(seen, s, float("-inf"))
    o, m, l = softmax_values(s, v, "bkgs,bskd->bkgd")
    return (o.reshape(B, H, dh).to(q.dtype), m.reshape(B, H),
            l.reshape(B, H))


def _lib() -> ctypes.CDLL:
    lib = build.load("decode_attention_quant")
    fn = lib.decode_attention_quant
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_longlong] * 7
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def decode_attention_quant(q, k_q, v_q, k_scales, v_scales, lengths, *,
                           bits: int, group: int, chunk_tokens: int):
    """CUDA kernel: the same function as `decode_attention_quant_ref` on
    CUDA tensors.  One launch, as K5's: the split pass over the cache,
    whose last CTA per KV head merges the splits' partials."""
    B, S, H, KV, dh = check_decode_args(q, k_q, v_q, k_scales, v_scales,
                                        lengths, bits=bits, group=group,
                                        chunk_tokens=chunk_tokens)
    check_kernel_inputs("decode_attention_quant", {
        "q": q, "k_q": k_q, "v_q": v_q, "k_scales": k_scales,
        "v_scales": v_scales, "lengths": lengths}, dh, H, KV)
    gs = H // KV
    split, nsplit, head_blocks = decode_plan(S, B, H, KV)
    f32 = dict(dtype=torch.float32, device=q.device)
    out = torch.empty((B, H, dh), dtype=q.dtype, device=q.device)
    m = torch.empty((B, H), **f32)
    l = torch.empty((B, H), **f32)
    pacc = torch.empty((B, KV, nsplit, gs, dh), **f32)
    pm = torch.empty((B, KV, nsplit, gs), **f32)
    pl = torch.empty((B, KV, nsplit, gs), **f32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        counters = _counters(q.device, stream, B * KV * head_blocks)
        err = _lib().decode_attention_quant(
            q.data_ptr(), k_q.data_ptr(), v_q.data_ptr(), k_scales.data_ptr(),
            v_scales.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            m.data_ptr(), l.data_ptr(), pacc.data_ptr(), pm.data_ptr(),
            pl.data_ptr(), counters.data_ptr(), B, S, H, KV, dh,
            chunk_tokens, group, bits, Q_KINDS[q.dtype], split,
            1.0 / math.sqrt(dh), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention_quant launch failed: CUDA "
                           f"error {err}")
    launches.count("decode_attention_quant")
    return out, m, l


def _fp_lib() -> ctypes.CDLL:
    lib = build.load("decode_attention")
    fn = lib.decode_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 5
                       + [ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


# The split decode's counters (K5 and K6), one zeroed int32 buffer per
# (device, stream): the kernel's last CTA of each KV head resets its counter
# to 0, so a buffer is zero between the calls of its stream, and calls on
# two streams never share one.
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[key] = torch.zeros(n, dtype=torch.int32,
                                           device=device)
    return buf


def decode_attention(q, k_cache, v_cache, lengths):
    """CUDA kernel (K5): the same function as `decode_attention_ref` on CUDA
    tensors.  One launch: the split pass over the cache, whose last CTA per
    KV head merges the splits' partials."""
    B, S, H, KV, dh = check_fp_decode_args(q, k_cache, v_cache, lengths)
    check_kernel_inputs("decode_attention", {
        "q": q, "k_cache": k_cache, "v_cache": v_cache, "lengths": lengths},
        dh, H, KV, aligned=("k_cache", "v_cache"), alignment=16)
    gs = H // KV
    split, nsplit, head_blocks = decode_plan(S, B, H, KV)
    f32 = dict(dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    pacc = torch.empty((B, KV, nsplit, gs, dh), **f32)
    pm = torch.empty((B, KV, nsplit, gs), **f32)
    pl = torch.empty((B, KV, nsplit, gs), **f32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        counters = _counters(q.device, stream, B * KV * head_blocks)
        err = _fp_lib().decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), pacc.data_ptr(),
            pm.data_ptr(), pl.data_ptr(), counters.data_ptr(), B, S, H, KV,
            dh, Q_KINDS[q.dtype], split, 1.0 / math.sqrt(dh), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error "
                           f"{err}")
    launches.count("decode_attention")
    return out
