"""Bridging model KV caches <-> wire-encoded chunk objects.

The model side speaks [L, 2, B, S, KV, dh] tensors; the storage side speaks
immutable per-chunk byte objects (layer-major, encoded by ``spec.codec`` —
DESIGN.md §Codec).  These converters are the only place the two layouts meet.

bf16 note: numpy has no bfloat16, so bf16 tensors cross the identity codec as
uint16 words (``tensor.view(torch.int16)``, then numpy ``uint16``, and back),
which is bit-exact.  The quantized codecs receive fp32 arrays: widening bf16
to fp32 is exact, so they see the same values, and write the same bytes, as
the reference's.

Decode paths: the identity codec is a bit view (never a value cast).  On the
host, the quantized codecs dequantize with the numpy codec to fp32 and torch
casts to the model dtype.  On the device, `layer_payload_to_device_kv`
uploads the wire image (int8 / packed int4 + fp16 scales) and runs the
dequant kernel (`kernels.ops`): on a CUDA device that is the CUDA kernel.
`layer_payload_to_packed_kv` uploads the wire image and keeps it so
(`PackedLayerKV`, the quantized-resident prefix of one layer); the fused
dequant-attention kernels read it, and `packed_layer_to_fp` expands it with
the dequant kernel where a model-width copy is needed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.codec import get_codec
from repro_torch.core import KVSpec
from repro_torch.kernels import ops as kernel_ops

# Explicit quantized-width -> standalone dequant kernel dispatch.  A lookup
# (rather than `4 -> packed4, anything else -> int8`) means a future 2/6-bit
# layer raises here instead of silently dequantizing garbage through the
# int8 kernel.
_DEQUANT_OPS = {
    8: kernel_ops.kv_dequant_op,
    4: kernel_ops.kv_dequant_packed4_op,
}


def _dequant_op_for(bits: int):
    try:
        return _DEQUANT_OPS[bits]
    except KeyError:
        raise ValueError(
            f"no dequant kernel for {bits}-bit payloads; known widths: "
            f"{sorted(_DEQUANT_OPS)}") from None


def _host_words(t: torch.Tensor) -> np.ndarray:
    """A tensor as host numpy: bf16 as its uint16 words, else native."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _widen(words: np.ndarray) -> np.ndarray:
    """Host words -> fp32 values (exact for bf16 words, fp16 and fp32)."""
    if words.dtype == np.uint16:
        return (words.astype(np.uint32) << 16).view(np.float32)
    return words.astype(np.float32)


def _wire_word(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype the identity codec decodes ``dtype`` into."""
    if dtype == torch.bfloat16:
        return np.dtype(np.uint16)
    return torch.empty((), dtype=dtype).numpy().dtype


def _host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor sharing ``arr``'s memory (copied first when ``arr`` is
    a read-only view of a payload's bytes)."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr)


def _from_words(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of `_host_words` (a bit view, never a value cast)."""
    if dtype == torch.bfloat16:
        return _host_tensor(arr.view(np.int16)).view(torch.bfloat16)
    return _host_tensor(arr)


def cache_to_host_words(cache, start_token: int, n_tokens: int,
                        batch_row: int = 0) -> np.ndarray:
    """Tokens [start_token, start_token + n_tokens) of one sequence's KV,
    copied to the host: [L, 2, n_tokens, KV, dh] words (`_host_words`).

    ``cache``: [L, 2, B, S, KV, dh] tensor.  Returns after the copy has
    finished (a device tensor's ``.cpu()`` waits for it)."""
    return _host_words(cache[:, :, batch_row,
                             start_token:start_token + n_tokens])


def encode_chunks(words: np.ndarray, keys: list[bytes], spec: KVSpec
                  ) -> dict[bytes, bytes]:
    """Encode ``len(keys)`` G-token chunks of host words [L, 2, T, KV, dh]
    (`cache_to_host_words`) into objects (``spec.codec``): chunk i covers
    tokens [i*G, (i+1)*G) of ``words``."""
    G = spec.chunk_tokens
    L = spec.num_layers
    width = spec.width
    codec = get_codec(spec.codec)
    out: dict[bytes, bytes] = {}
    for i, key in enumerate(keys):
        sl = words[:, :, i * G:(i + 1) * G]  # [L, 2, G, KV, dh]
        k = np.ascontiguousarray(sl[:, 0].reshape(L, G, width))
        v = np.ascontiguousarray(sl[:, 1].reshape(L, G, width))
        if not codec.lossless:
            k, v = _widen(k), _widen(v)
        out[key] = codec.encode_chunk(k, v, spec)
    return out


def cache_to_chunks(cache, keys: list[bytes], spec: KVSpec, batch_row: int = 0,
                    start_token: int = 0) -> dict[bytes, bytes]:
    """Pack ``len(keys)`` G-token chunks of one sequence's KV into encoded
    objects (``spec.codec``).

    ``cache``: [L, 2, B, S, KV, dh] tensor (prefix+suffix as produced by
    prefill).  Chunk i covers tokens [start_token + i*G, start_token + (i+1)*G).
    """
    words = cache_to_host_words(cache, start_token,
                                len(keys) * spec.chunk_tokens, batch_row)
    return encode_chunks(words, keys, spec)


def layer_payload_to_kv(payload: bytes, num_chunks: int, spec: KVSpec,
                        dtype: torch.dtype, layer: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """One aggregated layer payload -> (k, v) [P, KV, dh] CPU tensors of
    ``dtype`` (P = N*G).

    Host-side decode: identity is a bit view; quantized codecs dequantize with
    the numpy codec to fp32, cast to ``dtype`` in torch.  ``layer`` selects
    the per-layer parameters of a variable-rate codec (mixed-bit)."""
    codec = get_codec(spec.codec)
    P = num_chunks * spec.chunk_tokens
    shape = (P, spec.num_kv_heads, spec.head_dim)
    if codec.lossless:
        k, v = codec.decode_layer_payload(payload, num_chunks, spec,
                                          _wire_word(dtype), layer=layer)
        return (_from_words(k, dtype).reshape(shape),
                _from_words(v, dtype).reshape(shape))
    k, v = codec.decode_layer_payload(payload, num_chunks, spec, np.float32,
                                      layer=layer)
    return (_host_tensor(k).to(dtype).reshape(shape),
            _host_tensor(v).to(dtype).reshape(shape))


def layer_payload_to_device_kv(payload: bytes, num_chunks: int, spec: KVSpec,
                               dtype: torch.dtype, layer: int = 0,
                               device="cuda"
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Device-side decode of one aggregated layer payload -> (k, v)
    [P, KV, dh] on ``device``.

    Identity payloads are a bit view, uploaded as is.  Quantized payloads
    upload the *compressed* tensors (int8 / packed int4 + fp16 scales,
    possibly group-wise) and dequantize with the kernel op, so the copy to
    the device moves wire bytes, not decoded bytes."""
    codec = get_codec(spec.codec)
    G = spec.chunk_tokens
    P = num_chunks * G
    shape = (P, spec.num_kv_heads, spec.head_dim)
    if codec.lossless:
        k, v = layer_payload_to_kv(payload, num_chunks, spec, dtype, layer)
        return k.to(device), v.to(device)
    op = _dequant_op_for(codec.layer_bits(spec, layer))
    q, scales = codec.parse_layer_payload(payload, num_chunks, spec, layer)
    group = codec.layer_group(spec, layer)

    def up(a):
        return _host_tensor(a).to(device)

    k = op(up(q[:, :G]), up(scales[:, 0, :]), group=group, out_dtype=dtype)
    v = op(up(q[:, G:]), up(scales[:, 1, :]), group=group, out_dtype=dtype)
    return k.reshape(shape), v.reshape(shape)


@dataclasses.dataclass
class PackedLayerKV:
    """One layer's prefix KV kept *quantized-resident* on the device.

    The wire image of an aggregated layer payload, uploaded as is: packed
    integer tensors plus the per-chunk fp16 scale rows, never expanded to
    model width in device memory.  The fused attention kernels
    (`decode_attention_quant` / `flash_attention_quant`) read exactly these
    tensors.  Leading batch dim is 1 (one sequence's prefix)."""

    k_q: torch.Tensor       # [1, P, KV, dh'] int8 (or uint8 nibbles, dh'=dh/2)
    v_q: torch.Tensor       # [1, P, KV, dh']
    k_scales: torch.Tensor  # [1, NC, W/group] fp16
    v_scales: torch.Tensor  # [1, NC, W/group]
    bits: int
    group: int
    chunk_tokens: int

    @property
    def tokens(self) -> int:
        return self.k_q.shape[1]

    @property
    def resident_bytes(self) -> int:
        """Device bytes this prefix pins (the wire-resident footprint)."""
        return sum(a.numel() * a.element_size()
                   for a in (self.k_q, self.v_q, self.k_scales, self.v_scales))

    def as_tuple(self):
        """The tensor 4-tuple the fused kernel ops take."""
        return (self.k_q, self.v_q, self.k_scales, self.v_scales)


def layer_payload_to_packed_kv(payload: bytes, num_chunks: int, spec: KVSpec,
                               layer: int = 0, device="cuda") -> PackedLayerKV:
    """One aggregated layer payload -> quantized-resident tensors on
    ``device``.

    The quantized-resident counterpart of `layer_payload_to_device_kv`: the
    host-to-device copy moves wire bytes and *stays* wire-sized; no dequant
    kernel runs, the fused attention kernels dequantize at read time.
    Raises for lossless codecs (identity has no packed form) and for bit
    widths without a kernel."""
    codec = get_codec(spec.codec)
    if codec.lossless:
        raise ValueError(
            f"codec {spec.codec!r} is lossless; quantized-resident caching "
            f"needs a quantized codec")
    bits = codec.layer_bits(spec, layer)
    _dequant_op_for(bits)  # unknown widths raise before any upload
    group = codec.layer_group(spec, layer)
    G = spec.chunk_tokens
    q, scales = codec.parse_layer_payload(payload, num_chunks, spec, layer)
    dhp = spec.head_dim // 2 if bits == 4 else spec.head_dim
    shape = (1, num_chunks * G, spec.num_kv_heads, dhp)

    def up(a):
        return _host_tensor(a).to(device)

    return PackedLayerKV(up(q[:, :G]).reshape(shape),
                         up(q[:, G:]).reshape(shape),
                         up(scales[:, 0, :])[None], up(scales[:, 1, :])[None],
                         bits=bits, group=group, chunk_tokens=G)


def packed_layer_to_fp(pkv: PackedLayerKV, dtype: torch.dtype
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Expand a packed-resident layer to model-width (k, v) [1, P, KV, dh]
    of ``dtype`` (fp32 or bf16) with the dequant kernel op (K1/K2 on a CUDA
    tensor): each chunk's [G, KV*dh'] tile against its scale row, which is
    `kernels.kv_dequant.dequant_cache_ref` rounded once to ``dtype``.

    The materialization boundary: a decode pool that batches several
    sequences into one fp cache expands a packed prefix exactly once
    here."""
    op = _dequant_op_for(pkv.bits)
    G = pkv.chunk_tokens
    _, P, KV, dhp = pkv.k_q.shape
    dh = 2 * dhp if pkv.bits == 4 else dhp

    def expand(q, s):
        out = op(q.reshape(P // G, G, KV * dhp), s[0], group=pkv.group,
                 out_dtype=dtype)
        return out.reshape(1, P, KV, dh)

    return expand(pkv.k_q, pkv.k_scales), expand(pkv.v_q, pkv.v_scales)


def prefix_kv_from_payloads(payloads: list[bytes], num_chunks: int,
                            spec: KVSpec, dtype: torch.dtype, device="cuda"
                            ) -> torch.Tensor:
    """All layers -> [L, 2, 1, P, KV, dh] prefix-KV (batch dim of 1), decoded
    on the host."""
    ks, vs = [], []
    for layer, payload in enumerate(payloads):
        k, v = layer_payload_to_kv(payload, num_chunks, spec, dtype, layer)
        ks.append(k)
        vs.append(v)
    k = torch.stack(ks)[:, None]  # [L, 1, P, KV, dh]
    v = torch.stack(vs)[:, None]
    return torch.stack([k, v], dim=1).to(device)  # [L, 2, 1, P, KV, dh]


def chunks_from_store(store, keys: list[bytes]) -> list[bytes]:
    return [store.get(k) for k in keys]
