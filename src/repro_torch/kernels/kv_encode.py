"""KV encode: the commit's hop into the quantized wire codecs, on the card.

`kv_quant_encode` (K9, ``csrc/kv_quant_encode.cu``) turns N chunks of a
model's cache into their wire images where the KV already lives, so the
serving engine copies only the images to the host; `kv_quant_encode_ref` is
its plain PyTorch version (the CPU path and the oracle the kernel is held
to).  Both write the bytes of the numpy codec's ``encode_chunk``
(`codec/quant.py`): per (chunk, layer, K|V) matrix and group of ``group``
channels, an fp16 scale ``min(absmax / qmax, 65504)`` and codes
``clamp(rint(x / scale), -qmax, qmax)``, int4 codes packed two a byte.  The
maximum is exact in any order and every other step is one IEEE fp32
operation, so kernel, plain version and codec agree bit for bit.

Input: x [L, 2, N*G, KV, dh] (bf16 or fp32), any view of the engine's
[L, 2, B, S, KV, dh] cache whose token rows are contiguous; ``bits`` and
``groups`` give each layer's width (8 or 4) and scale group, as the codec's
``layer_bits`` / ``layer_group`` read them, so one call takes int8, int4,
the group-wise and the mixed-bit codecs alike.  Output: [N, chunk_bytes]
uint8, layer l of chunk n at ``wire_offsets(...)[l]``.

The kernel wrapper counts its launches in `launches.LAUNCHES`.
`encode_plan` chooses the kernel's launch geometry.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Sequence

import torch

from . import build, launches

IN_KINDS = {torch.float32: 0, torch.bfloat16: 1}
FP16_MAX = 65504.0
# K9's geometry (csrc/kv_quant_encode.cu): channels a thread owns (one
# 16-byte load of bf16 a row), rows a thread holds in a pass, threads a
# block, the narrowest strip a block takes when the width allows, the
# widest strip, and the most layers one launch takes
ENCODE_UNIT = 8
ENCODE_ROWS = 8
ENCODE_MAX_THREADS = 512
ENCODE_MIN_STRIP = 64
ENCODE_MAX_STRIP = 2048
ENCODE_MAX_LAYERS = 128
MAX_GRID_YZ = 65535  # CUDA's limit on gridDim.y and gridDim.z


def layer_wire_bytes(G: int, W: int, bits: int, group: int) -> int:
    """Bytes of one layer's slice of a chunk: K and V scales (fp16, one a
    group), then K and V codes of G x W values at ``bits``."""
    return 2 * (W // group) * 2 + 2 * ((G * W * bits + 7) // 8)


def wire_offsets(G: int, W: int, bits: Sequence[int],
                 groups: Sequence[int]) -> list[int]:
    """Prefix sums of the layers' slice sizes: layer l of a chunk's image
    occupies bytes [offsets[l], offsets[l + 1])."""
    off = [0]
    for b, g in zip(bits, groups):
        off.append(off[-1] + layer_wire_bytes(G, W, b, g))
    return off


def check_encode_args(x: torch.Tensor, chunk_tokens: int,
                      bits: Sequence[int], groups: Sequence[int]
                      ) -> tuple[int, int, int, int]:
    """Validate the inputs both versions take; returns (L, N, G, W).
    Raises on anything they do not take."""
    if x.dtype not in IN_KINDS:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.ndim != 5 or x.shape[1] != 2:
        raise ValueError(f"want x [L, 2, N*G, KV, dh], got {tuple(x.shape)}")
    L, _, T, KV, dh = x.shape
    G = chunk_tokens
    if not isinstance(G, int) or G < 1 or T % G or T == 0:
        raise ValueError(f"chunk_tokens {G!r} must divide the {T} tokens "
                         f"of x into one or more chunks")
    W = KV * dh
    if len(bits) != L or len(groups) != L:
        raise ValueError(f"want one bits and one group entry a layer ({L}), "
                         f"got {len(bits)} and {len(groups)}")
    for l, (b, g) in enumerate(zip(bits, groups)):
        if b not in (8, 4):
            raise ValueError(f"layer {l}: bits must be 8 or 4, got {b!r}")
        if not isinstance(g, int) or g < 1 or W % g:
            raise ValueError(f"layer {l}: group {g!r} must be a positive "
                             f"divisor of the width {W}")
        if b == 4 and W % 2:
            raise ValueError(f"layer {l}: int4 needs an even width, got {W}")
    return L, T // G, G, W


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 codes in [-8, 7], [..., W] -> [..., W/2] uint8 biased nibbles
    (n = q + 8; even channel in the low nibble): `codec.ref.pack_int4`."""
    b = (q.to(torch.int16) + 8).to(torch.uint8)
    return b[..., 0::2] | (b[..., 1::2] << 4)


def kv_quant_encode_ref(x: torch.Tensor, *, chunk_tokens: int,
                        bits: Sequence[int], groups: Sequence[int]
                        ) -> torch.Tensor:
    """Plain version of `kv_quant_encode`: x [L, 2, N*G, KV, dh] ->
    [N, chunk_bytes] uint8, the wire images of the N chunks."""
    L, N, G, W = check_encode_args(x, chunk_tokens, bits, groups)
    off = wire_offsets(G, W, bits, groups)
    out = torch.empty((N, off[-1]), dtype=torch.uint8, device=x.device)
    xs = x.reshape(L, 2, N, G, W)
    for l, (b, g) in enumerate(zip(bits, groups)):
        qmax = (1 << (b - 1)) - 1
        xl = xs[l].float().reshape(2, N, G, W // g, g)
        absmax = xl.abs().amax(dim=(2, 4))  # [2, N, W/g]
        # qmax as a tensor: on the card, division by a Python number is a
        # multiply by its reciprocal, which rounds differently
        scales = torch.clamp_max(absmax / absmax.new_tensor(float(qmax)),
                                 FP16_MAX).to(torch.float16)
        s = scales.float()
        safe = torch.where(s > 0, s, torch.ones_like(s))
        q = torch.clamp(torch.round(xl / safe[:, :, None, :, None]),
                        -qmax, qmax).to(torch.int8).reshape(2, N, G, W)
        codes = pack_int4(q) if b == 4 else q.view(torch.uint8)
        sb = 4 * (W // g)
        dst = out[:, off[l]:off[l + 1]]
        dst[:, :sb] = scales.transpose(0, 1).contiguous() \
            .view(torch.uint8).reshape(N, sb)
        dst[:, sb:] = codes.transpose(0, 1).reshape(N, -1)
    return out


@dataclass(frozen=True)
class EncodePlan:
    """The launch of K9 for one call.  Block (b, 2 l + m, n) of grid
    (strips, 2 L, N) encodes channels [b * strip, (b + 1) * strip) below W of
    matrix m (K, V) of layer l of chunk n; its ``threads`` threads are
    ``strip / 8`` units of 8 channels by ``row_groups`` rows, each holding
    ENCODE_ROWS rows a pass, ``row_groups`` rows apart."""
    strip: int
    row_groups: int

    @property
    def threads(self) -> int:
        return self.strip // ENCODE_UNIT * self.row_groups

    def passes(self, G: int) -> int:
        """Passes over the block's rows (1: every row stays in registers)."""
        return -(-G // (self.row_groups * ENCODE_ROWS))

    def grid(self, W: int, L: int, N: int) -> tuple[int, int, int]:
        return (-(-W // self.strip), 2 * L, N)

    def rows_of(self, ry: int, G: int) -> list[int]:
        """The rows below G that thread row ``ry`` holds, over all passes."""
        per = self.row_groups * ENCODE_ROWS
        return [r for p in range(self.passes(G))
                for r in range(p * per + ry, (p + 1) * per, self.row_groups)
                if r < G]


def encode_plan(G: int, W: int, groups: Sequence[int]) -> EncodePlan:
    """K9's launch for chunks of G tokens of width W with these layers'
    scale groups.  The strip is the smallest multiple of lcm(8, every
    group) from ENCODE_MIN_STRIP channels up, and at most the width, so
    every group lies inside one block; the rows fill the block up to
    ENCODE_MAX_THREADS threads.  Raises where the kernel takes no such
    shape."""
    if W % ENCODE_UNIT:
        raise ValueError(f"the kernel takes widths that are a multiple of "
                         f"{ENCODE_UNIT}, got {W}")
    unit = math.lcm(ENCODE_UNIT, *groups)
    strip = unit * -(-min(ENCODE_MIN_STRIP, W) // unit)
    if strip > ENCODE_MAX_STRIP:
        raise ValueError(f"scale groups {sorted(set(groups))} need strips of "
                         f"{strip} channels; the kernel takes at most "
                         f"{ENCODE_MAX_STRIP}")
    units = strip // ENCODE_UNIT
    row_groups = min(-(-G // ENCODE_ROWS), ENCODE_MAX_THREADS // units)
    return EncodePlan(strip, row_groups)


def _lib() -> ctypes.CDLL:
    lib = build.load("kv_quant_encode")
    fn = lib.kv_quant_encode
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_longlong),
                       ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def kv_quant_encode(x: torch.Tensor, *, chunk_tokens: int,
                    bits: Sequence[int], groups: Sequence[int]
                    ) -> torch.Tensor:
    """CUDA kernel: x [L, 2, N*G, KV, dh] (bf16 or fp32, token rows
    contiguous, 16-byte aligned) -> [N, chunk_bytes] uint8 wire images."""
    L, N, G, W = check_encode_args(x, chunk_tokens, bits, groups)
    if x.device.type != "cuda":
        raise ValueError(f"kv_quant_encode runs on a CUDA tensor, got one "
                         f"on {x.device}")
    _, _, _, KV, dh = x.shape
    if x.stride(4) != 1 or (KV > 1 and x.stride(3) != dh):
        raise ValueError(f"kv_quant_encode needs each token's [KV, dh] "
                         f"contiguous, got strides {x.stride()}")
    esize = x.element_size()
    if x.data_ptr() % 16 or any(s * esize % 16 for s in x.stride()[:3]):
        raise ValueError(f"kv_quant_encode needs x and its layer, matrix and "
                         f"token strides 16-byte aligned, got pointer "
                         f"{x.data_ptr()} and strides {x.stride()}")
    if L > ENCODE_MAX_LAYERS or N > MAX_GRID_YZ:
        raise ValueError(f"kv_quant_encode takes at most {ENCODE_MAX_LAYERS} "
                         f"layers and {MAX_GRID_YZ} chunks, got {L} and {N}")
    plan = encode_plan(G, W, groups)
    off = wire_offsets(G, W, bits, groups)
    out = torch.empty((N, off[-1]), dtype=torch.uint8, device=x.device)
    offsets = (ctypes.c_longlong * L)(*off[:L])
    c_bits = (ctypes.c_int * L)(*bits)
    c_groups = (ctypes.c_int * L)(*groups)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().kv_quant_encode(
            x.data_ptr(), IN_KINDS[x.dtype], x.stride(0), x.stride(1),
            x.stride(2), out.data_ptr(), off[-1], L, N, G, W, offsets,
            c_bits, c_groups, plan.strip, plan.row_groups, stream)
    if err != 0:
        raise RuntimeError(f"kv_quant_encode launch failed: CUDA error {err}")
    launches.count("kv_quant_encode")
    return out
