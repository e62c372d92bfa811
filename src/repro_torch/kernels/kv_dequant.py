"""KV dequantization: the client-side decode hop of the quantized wire codecs.

An aggregated layer payload lands as N per-chunk quantized tiles plus one
fp16 scale row per matrix per chunk.  ``kv_dequant`` (int8) and
``kv_dequant_packed4`` (two biased nibbles per byte) expand them to
``out_dtype`` on the card with the CUDA kernels of ``csrc/kv_dequant.cu``;
``kv_dequant_ref`` and ``kv_dequant_packed4_ref`` are their plain PyTorch
versions (the CPU path and the oracle the kernels are held to).

Both compute ``f32(q) * f32(scale[n, c // group])`` with one rounding to
``out_dtype``, so kernel and plain version are bit-equal.

Each kernel wrapper counts its launches in `launches.LAUNCHES` so a run can
show that the serving path went through the kernel.  `dequant_plan` chooses
the kernels' launch geometry: a thread owns a strip of channels of one chunk
and walks rows of it.

`dequant_cache_ref` expands a packed-resident cache ([B, S, KV, dh'] plus one
scale row per chunk) the same way; it is the dequant half of the plain
versions of the fused attention kernels, and `check_packed_cache` validates
the packed cache those kernels take.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import build, launches

OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1}
# the card's SMs (H100 SXM)
H100_SMS = 132
# K1/K2's geometry (csrc/kv_dequant.cu): threads a CTA (kThreads), CTAs an
# SM holds at once (kMinBlocks of its launch bounds), channels a thread owns
# (two units of 8: 16 bytes of int8 codes or 8 of nibbles a row), and the
# rows a thread walks: at least MIN_ROWS, at most MAX_ROWS before the grid
# takes several waves
DEQUANT_THREADS = 256
DEQUANT_CTAS_PER_SM = 4
DEQUANT_STRIP = 16
DEQUANT_UNIT = 8  # channels of one load of codes (K3's unit)
MIN_ROWS = 2
MAX_ROWS = 16
MAX_GRID_YZ = 65535  # CUDA's limit on gridDim.y and gridDim.z
# word type of a packed cache of each width: int8, or two biased nibbles
PACKED_DTYPES = {8: torch.int8, 4: torch.uint8}


def check_dequant_args(q: torch.Tensor, scales: torch.Tensor, group: int,
                       out_dtype: torch.dtype, *, packed: bool
                       ) -> tuple[int, int, int]:
    """Validate the inputs both versions take; returns (N, R, W) with W the
    unpacked width.  Raises on anything the kernel does not take."""
    want = torch.uint8 if packed else torch.int8
    if q.dtype != want:
        raise TypeError(f"q must be {want}, got {q.dtype}")
    if scales.dtype != torch.float16:
        raise TypeError(f"scales must be float16, got {scales.dtype}")
    if out_dtype not in OUT_KINDS:
        raise TypeError(f"out_dtype must be float32 or bfloat16, "
                        f"got {out_dtype}")
    if q.ndim != 3 or scales.ndim != 2:
        raise ValueError(f"want q [N, R, W'] and scales [N, W/group], got "
                         f"{tuple(q.shape)} and {tuple(scales.shape)}")
    N, R, Wq = q.shape
    W = 2 * Wq if packed else Wq
    if not isinstance(group, int) or group < 1 or W % group:
        raise ValueError(f"group {group!r} must be a positive divisor of "
                         f"the width {W}")
    if tuple(scales.shape) != (N, W // group):
        raise ValueError(f"scales shape {tuple(scales.shape)} != "
                         f"{(N, W // group)} for q {tuple(q.shape)}, "
                         f"group {group}")
    if q.device != scales.device:
        raise ValueError(f"q on {q.device}, scales on {scales.device}")
    return N, R, W


def _expand_scales(scales: torch.Tensor, group: int) -> torch.Tensor:
    """[..., W/group] fp16 -> [..., W] fp32."""
    s = scales.float()
    return s if group == 1 else s.repeat_interleave(group, dim=-1)


def unpack_int4(q_packed: torch.Tensor) -> torch.Tensor:
    """[..., W/2] uint8 biased nibbles -> [..., W] int32 values in [-8, 7]
    (low nibble = even channel)."""
    lo = (q_packed & 0xF).to(torch.int32) - 8
    hi = (q_packed >> 4).to(torch.int32) - 8
    return torch.stack([lo, hi], dim=-1).reshape(
        *q_packed.shape[:-1], 2 * q_packed.shape[-1])


def kv_dequant_ref(q: torch.Tensor, scales: torch.Tensor, *, group: int = 1,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of `kv_dequant`: q [N, R, W] int8, scales [N, W/group]
    fp16 -> [N, R, W] ``out_dtype``."""
    check_dequant_args(q, scales, group, out_dtype, packed=False)
    return (q.float() * _expand_scales(scales, group)[:, None, :]).to(out_dtype)


def kv_dequant_packed4_ref(q_packed: torch.Tensor, scales: torch.Tensor, *,
                           group: int = 1,
                           out_dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """Plain version of `kv_dequant_packed4`: q_packed [N, R, W/2] uint8,
    scales [N, W/group] fp16 -> [N, R, W] ``out_dtype``."""
    check_dequant_args(q_packed, scales, group, out_dtype, packed=True)
    q = unpack_int4(q_packed).float()
    return (q * _expand_scales(scales, group)[:, None, :]).to(out_dtype)


def check_packed_cache(k_q: torch.Tensor, v_q: torch.Tensor,
                       k_scales: torch.Tensor, v_scales: torch.Tensor, *,
                       bits: int, group: int, chunk_tokens: int
                       ) -> tuple[int, int, int, int]:
    """Validate a packed-resident cache: k_q/v_q [B, S, KV, dh'] (int8, or
    uint8 nibble pairs with dh' = dh/2 when ``bits == 4``) and
    k_scales/v_scales [B, S/G, KV*dh/group] fp16 scale rows, one per chunk
    of ``chunk_tokens`` tokens.  Returns (B, S, KV, dh)."""
    if bits not in PACKED_DTYPES:
        raise ValueError(f"bits must be one of {sorted(PACKED_DTYPES)}, "
                         f"got {bits!r}")
    want = PACKED_DTYPES[bits]
    for name, a in (("k_q", k_q), ("v_q", v_q)):
        if a.dtype != want:
            raise TypeError(f"{name} must be {want} for {bits}-bit, "
                            f"got {a.dtype}")
    for name, a in (("k_scales", k_scales), ("v_scales", v_scales)):
        if a.dtype != torch.float16:
            raise TypeError(f"{name} must be float16, got {a.dtype}")
    if k_q.ndim != 4 or k_q.shape != v_q.shape:
        raise ValueError(f"want k_q and v_q [B, S, KV, dh'] of one shape, "
                         f"got {tuple(k_q.shape)} and {tuple(v_q.shape)}")
    B, S, KV, dhp = k_q.shape
    dh = 2 * dhp if bits == 4 else dhp
    G = chunk_tokens
    if not isinstance(G, int) or G < 1 or S % G:
        raise ValueError(f"chunk_tokens {G!r} must be a positive divisor of "
                         f"the cache length {S}")
    W = KV * dh
    if not isinstance(group, int) or group < 1 or W % group:
        raise ValueError(f"group {group!r} must be a positive divisor of "
                         f"the width {W}")
    want_s = (B, S // G, W // group)
    for name, a in (("k_scales", k_scales), ("v_scales", v_scales)):
        if tuple(a.shape) != want_s:
            raise ValueError(f"{name} shape {tuple(a.shape)} != {want_s} "
                             f"for a cache {tuple(k_q.shape)}, chunk_tokens "
                             f"{G}, group {group}")
    if len({a.device for a in (k_q, v_q, k_scales, v_scales)}) != 1:
        raise ValueError("k_q, v_q and the scales must be on one device")
    return B, S, KV, dh


def dequant_cache_ref(q: torch.Tensor, scales: torch.Tensor, *, bits: int,
                      group: int, chunk_tokens: int) -> torch.Tensor:
    """Expand a packed-resident cache to fp32: q [B, S, KV, dh'] against
    per-chunk scale rows [B, S/G, W/group] fp16 -> [B, S, KV, dh].

    Token t uses scale row t // G.  Each value is ``f32(q) * f32(scale)``,
    one rounding, so it equals `kv_dequant_ref` / `kv_dequant_packed4_ref`
    of the same chunk at fp32."""
    B, S, KV, dh = check_packed_cache(q, q, scales, scales, bits=bits,
                                      group=group, chunk_tokens=chunk_tokens)
    vals = unpack_int4(q) if bits == 4 else q
    W = KV * dh
    NC = S // chunk_tokens
    out = (vals.float().reshape(B, NC, chunk_tokens, W)
           * _expand_scales(scales, group)[:, :, None, :])
    return out.reshape(B, S, KV, dh)


@dataclass(frozen=True)
class DequantPlan:
    """The launch of K1/K2 for one call.  CTA (threads_x, threads_y) of grid
    (N, slabs, strip_blocks): chunk n = blockIdx.x; thread (tx, ty) of CTA
    (n, slab, sb) owns the strip of ``strip`` channels `channels(sb, tx)`,
    units of 8 channels threads_x units apart, and walks rows
    `rows_of(slab, ty)` of chunk n.  ``vec``: whole units take the vector
    path (one load of codes, 16-byte stores); a unit the width cuts, and
    every unit when ``vec`` is False, takes the per-element path."""
    strip: int
    threads_x: int
    threads_y: int
    rows: int
    slabs: int
    strip_blocks: int
    vec: bool

    def grid(self, N: int) -> tuple[int, int, int]:
        return (N, self.slabs, self.strip_blocks)

    def rows_of(self, slab: int, ty: int, R: int) -> list[int]:
        """The rows (below R) thread row ``ty`` of slab ``slab`` walks."""
        r0 = slab * self.threads_y * self.rows + ty
        return [r for r in range(r0, r0 + self.rows * self.threads_y,
                                 self.threads_y) if r < R]

    def channels(self, sb: int, tx: int, W: int) -> list[tuple[range, bool]]:
        """(channels, vector path) of each unit below the width of thread
        ``tx`` of strip block ``sb``."""
        units = self.strip // DEQUANT_UNIT
        u0 = sb * self.threads_x * units + tx
        out = []
        for k in range(units):
            c0 = (u0 + k * self.threads_x) * DEQUANT_UNIT
            c1 = min(c0 + DEQUANT_UNIT, W)
            if c0 < W:
                out.append((range(c0, c1),
                            self.vec and c1 - c0 == DEQUANT_UNIT))
        return out


def dequant_plan(N: int, R: int, W: int, q_ptr: int, s_ptr: int,
                 out_ptr: int) -> DequantPlan:
    """K1's or K2's launch for q [N, R, W] (W unpacked; both kernels take
    the same geometry).

    A CTA's threads_x threads span the strips of a row (up to
    DEQUANT_THREADS; wider rows take several strip blocks) and its
    threads_y rows of them fill the rest of the CTA.  Rows a thread: the
    fewest from MIN_ROWS up, doubling, that put the grid in one wave of
    DEQUANT_CTAS_PER_SM CTAs on each of H100_SMS SMs, up to MAX_ROWS (and
    more where R would need more slabs than a grid dimension holds).  The
    vector path needs whole units on aligned boundaries: W a multiple of 8
    and q, scales and out 16-byte aligned (every row then starts on one,
    whatever the group and the output type)."""
    strip = DEQUANT_STRIP
    units = -(-W // DEQUANT_UNIT)
    per = strip // DEQUANT_UNIT  # units a thread
    tx = min(-(-units // per), DEQUANT_THREADS)
    ty = max(1, min(DEQUANT_THREADS // tx, R))
    strip_blocks = -(-units // (tx * per))

    def slabs(rows: int) -> int:
        return -(-R // (ty * rows))

    wave = H100_SMS * DEQUANT_CTAS_PER_SM
    rows = MIN_ROWS
    while rows < MAX_ROWS and N * slabs(rows) * strip_blocks > wave:
        rows *= 2
    while slabs(rows) > MAX_GRID_YZ:
        rows *= 2
    if strip_blocks > MAX_GRID_YZ:
        raise ValueError(f"width {W} needs {strip_blocks} strip blocks, more "
                         f"than a grid dimension holds")
    vec = W % DEQUANT_UNIT == 0 and all(p % 16 == 0 for p in (q_ptr, s_ptr,
                                                                out_ptr))
    return DequantPlan(strip, tx, ty, rows, slabs(rows), strip_blocks, vec)


def _lib() -> ctypes.CDLL:
    lib = build.load("kv_dequant")
    if lib.kv_dequant_i8.argtypes is None:
        args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        for fn in (lib.kv_dequant_i8, lib.kv_dequant_p4):
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def _launch(fn_name: str, count_name: str, q: torch.Tensor,
            scales: torch.Tensor, N: int, R: int, W: int, group: int,
            out_dtype: torch.dtype) -> torch.Tensor:
    if q.device.type != "cuda":
        raise ValueError(f"{count_name} runs on a CUDA tensor, got one on "
                         f"{q.device}")
    if not (q.is_contiguous() and scales.is_contiguous()):
        raise ValueError(f"{count_name} needs contiguous q and scales")
    if N * R * W == 0:
        raise ValueError(f"{count_name} got an empty tensor {tuple(q.shape)}")
    out = torch.empty((N, R, W), dtype=out_dtype, device=q.device)
    p = dequant_plan(N, R, W, q.data_ptr(), scales.data_ptr(),
                     out.data_ptr())
    fn = getattr(_lib(), fn_name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), scales.data_ptr(), out.data_ptr(), N, R, W,
                 group, OUT_KINDS[out_dtype], int(p.vec), p.strip,
                 p.threads_x, p.threads_y, p.rows, p.slabs, p.strip_blocks,
                 stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")
    launches.count(count_name)
    return out


def kv_dequant(q: torch.Tensor, scales: torch.Tensor, *, group: int = 1,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """CUDA kernel: q [N, R, W] int8, scales [N, W/group] fp16 ->
    [N, R, W] ``out_dtype`` (fp32 or bf16)."""
    N, R, W = check_dequant_args(q, scales, group, out_dtype, packed=False)
    return _launch("kv_dequant_i8", "kv_dequant", q, scales, N, R, W, group,
                   out_dtype)


def kv_dequant_packed4(q_packed: torch.Tensor, scales: torch.Tensor, *,
                       group: int = 1,
                       out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """CUDA kernel: q_packed [N, R, W/2] uint8 (pairwise biased int4),
    scales [N, W/group] fp16 -> [N, R, W] ``out_dtype``."""
    N, R, W = check_dequant_args(q_packed, scales, group, out_dtype,
                                 packed=True)
    return _launch("kv_dequant_p4", "kv_dequant_packed4", q_packed, scales,
                   N, R, W, group, out_dtype)
