"""Quantized KV wire codecs (DESIGN.md §Codec; CacheGen / LMCache-style).

Per-layer slice wire layout (stride = ``spec.wire_layer_bytes(l)``)::

    [ k_scales: width/group fp16 | v_scales: width/group fp16 |
      K_q: G x width @ bits | V_q: G x width @ bits ]

Scales are symmetric over the token axis of each matrix and over ``group``
consecutive channels (group=1 — one scale per channel — for the classic
``int8``/``int4`` codecs; `codec/groupwise.py` registers the >1 variants),
recomputed per chunk per layer (a chunk is immutable, so its scales are
content-addressed along with it).  int4 packs two values per byte pairwise
along the channel axis (`ref.pack_int4`).  `codec/mixedbit.py` reuses all of
this with per-layer bits.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.types import CODEC_INT4, CODEC_INT8, KVSpec, parse_codec

from .base import KVCodec, register, register_family
from .ref import dequantize_grouped, pack_int4, quantize_grouped, unpack_int4


class _QuantCodec(KVCodec):
    """Shared machinery for the symmetric integer codecs (any scale group,
    uniform or per-layer bits)."""

    group: int = 1  # channels sharing one fp16 scale

    def _to_float(self, arr: np.ndarray, spec: KVSpec) -> np.ndarray:
        arr = np.asarray(arr)
        if arr.dtype.kind == "u":  # wire words: bf16 arrives as uint16
            if spec.dtype_bytes != 2:
                raise ValueError(
                    f"cannot quantize {arr.dtype} wire words of a "
                    f"{spec.dtype_bytes}-byte dtype; pass typed arrays")
            # a bf16 word is the top half of the fp32 with the same value,
            # so widening by a 16-bit shift is exact (no ml_dtypes needed)
            return (arr.astype(np.uint32) << 16).view(np.float32)
        return arr.astype(np.float32)

    def _check_spec(self, spec: KVSpec) -> None:
        fmt = parse_codec(spec.codec)
        if fmt != parse_codec(self.name):
            raise ValueError(
                f"spec codec {spec.codec!r} does not match codec {self.name!r}")

    def encode_chunk(self, k, v, spec):
        self._check_spec(spec)
        L, G, W = spec.num_layers, spec.chunk_tokens, spec.width
        kv = np.stack([self._to_float(k, spec), self._to_float(v, spec)],
                      axis=1)  # [L, 2, G, W]
        if kv.shape != (L, 2, G, W):
            raise ValueError(f"bad chunk shape {kv.shape}, want {(L, 2, G, W)}")
        parts = []
        for l in range(L):
            bits = self.layer_bits(spec, l)
            if bits == 4 and W % 2:
                raise ValueError(f"int4 codec needs an even width, got {W}")
            q, scales = quantize_grouped(kv[l], bits,
                                         self.layer_group(spec, l))
            parts.append(scales.tobytes())  # K scales then V scales
            parts.append(self._pack(q.reshape(2 * G, W), bits))
        buf = b"".join(parts)
        assert len(buf) == spec.wire_chunk_bytes, (len(buf), spec.wire_chunk_bytes)
        return buf

    def parse_layer_payload(self, payload: bytes, num_chunks: int, spec: KVSpec,
                            layer: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """Split an aggregated layer payload into its quantized parts:
        (q [N, 2G, W] int8 — or [N, 2G, W/2] uint8 when packed —,
        scales [N, 2, W/group] fp16).  Rows [:G] are K, rows [G:] are V;
        scale row 0 is K, row 1 is V.  This is the input of the fused
        dequant kernel."""
        G, W = spec.chunk_tokens, spec.width
        S = spec.wire_layer_bytes(layer)
        bits = self.layer_bits(spec, layer)
        group = self.layer_group(spec, layer)
        arr = np.frombuffer(payload, dtype=np.uint8).reshape(num_chunks, S)
        sb = spec.layer_scale_bytes(layer)
        scales = np.ascontiguousarray(arr[:, :sb]).view(np.float16)
        scales = scales.reshape(num_chunks, 2, W // group)
        body = np.ascontiguousarray(arr[:, sb:])
        if bits == 4:
            q = body.reshape(num_chunks, 2 * G, W // 2)
        else:
            q = body.view(np.int8).reshape(num_chunks, 2 * G, W)
        return q, scales

    def decode_layer_payload(self, payload, num_chunks, spec, dtype, layer=0):
        G, W = spec.chunk_tokens, spec.width
        q, scales = self.parse_layer_payload(payload, num_chunks, spec, layer)
        group = self.layer_group(spec, layer)
        if self.layer_bits(spec, layer) == 4:
            q = unpack_int4(q)
        k = dequantize_grouped(q[:, :G, :], scales[:, 0, :], group,
                               np.dtype(dtype))
        v = dequantize_grouped(q[:, G:, :], scales[:, 1, :], group,
                               np.dtype(dtype))
        return (np.ascontiguousarray(k.reshape(num_chunks * G, W)),
                np.ascontiguousarray(v.reshape(num_chunks * G, W)))

    @staticmethod
    def _pack(q: np.ndarray, bits: int) -> bytes:
        return pack_int4(q).tobytes() if bits == 4 else q.tobytes()


class Int8Codec(_QuantCodec):
    name = CODEC_INT8
    bits = 8


class Int4Codec(_QuantCodec):
    name = CODEC_INT4
    bits = 4


register(Int8Codec())
register(Int4Codec())
register_family(CODEC_INT8, lambda name, fmt: Int8Codec())
register_family(CODEC_INT4, lambda name, fmt: Int4Codec())
