"""Bridging model KV caches <-> wire-encoded chunk objects.

The model side speaks [L, 2, B, S, KV, dh] tensors, or [L, B, S, W] latents
for a `LatentKVSpec` (multi-head latent attention: one tensor a layer, the
identity codec only); the storage side speaks immutable per-chunk byte
objects (layer-major, encoded by ``spec.codec`` — DESIGN.md §Codec).  These
converters are the only place the two layouts meet.

Encode (the commit): `cache_to_wire_images` builds the N chunks' wire
images where the cache lives, and `wire_images_to_objects` copies them to
the host and cuts them into one ``bytes`` object a chunk.  The quantized
codecs encode through the kernel op `kernels.ops.kv_quant_encode_op`: on a
CUDA cache that is the CUDA kernel K9, so only the int8 / int4 codes and
fp16 scales cross to the host; on a CPU cache its plain PyTorch version.
Both write the numpy codec's ``encode_chunk`` bytes, which stays as the
codec API and the oracle.  The identity codec's image is the cache's own
words in the KV_L2TD order, made by one copy on the cache's device (bf16
crosses as its 16-bit words: bit-exact).

bf16 note: numpy has no bfloat16, so an identity payload decodes bf16 as
numpy ``uint16`` words viewed back as ``torch.bfloat16``, which is
bit-exact.

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
    """Host words (bf16 as uint16) -> a CPU tensor of ``dtype`` (a bit
    view, never a value cast)."""
    if dtype == torch.bfloat16:
        return _host_tensor(arr.view(np.int16)).view(torch.bfloat16)
    return _host_tensor(arr)


def cache_to_wire_images(cache, n_chunks: int, spec: KVSpec,
                         batch_row: int = 0, start_token: int = 0
                         ) -> torch.Tensor:
    """The wire images (``spec.codec``) of ``n_chunks`` G-token chunks of
    one sequence's KV: [N, spec.wire_chunk_bytes] uint8 on ``cache``'s
    device.  Chunk i covers tokens [start_token + i*G, start_token +
    (i+1)*G) of batch row ``batch_row`` of ``cache`` [L, 2, B, S, KV, dh]
    (a `LatentKVSpec`'s [L, B, S, W]).

    Quantized codecs encode through `kernels.ops.kv_quant_encode_op` with
    each layer's bits and group; identity copies the cache's words into the
    KV_L2TD order.  Returns after the images are complete on the device."""
    G = spec.chunk_tokens
    latent = spec.kv_tensors == 1
    if latent:
        L, _, S, width = cache.shape
    else:
        L, _, _, S, KV, dh = cache.shape
        width = KV * dh
    if L != spec.num_layers or width != spec.width:
        raise ValueError(f"cache {tuple(cache.shape)} does not hold "
                         f"{spec.num_layers} layers of width {spec.width}")
    if start_token + n_chunks * G > S:
        raise ValueError(f"{n_chunks} chunks of {G} tokens from token "
                         f"{start_token} run past the cache's {S}")
    tokens = slice(start_token, start_token + n_chunks * G)
    x = cache[:, batch_row, tokens] if latent else \
        cache[:, :, batch_row, tokens]
    codec = get_codec(spec.codec)
    if n_chunks == 0:
        return torch.empty((0, spec.wire_chunk_bytes), dtype=torch.uint8,
                           device=cache.device)
    if codec.lossless:
        if x.element_size() != spec.dtype_bytes:
            raise ValueError(f"dtype width {x.element_size()} != spec "
                             f"{spec.dtype_bytes}")
        # [L, (2,) N, G, ...] -> [N, L, (2,) G, ...]: layer-major, K rows
        # then V rows (or the latent's), one copy
        seq = 1 if latent else 2
        images = x.unflatten(seq, (n_chunks, G)).movedim(seq, 0) \
            .contiguous().view(torch.uint8).reshape(n_chunks, -1)
    else:
        layers = range(spec.num_layers)
        images = kernel_ops.kv_quant_encode_op(
            x, chunk_tokens=G, bits=[codec.layer_bits(spec, l) for l in layers],
            groups=[codec.layer_group(spec, l) for l in layers])
    if images.shape[1] != spec.wire_chunk_bytes:
        raise ValueError(f"images of {images.shape[1]} bytes a chunk, spec "
                         f"says {spec.wire_chunk_bytes}")
    if images.device.type == "cuda":
        torch.cuda.current_stream(images.device).synchronize()
    return images


def wire_images_to_objects(images: torch.Tensor, keys: list[bytes]
                           ) -> dict[bytes, bytes]:
    """Copy [N, wire_chunk_bytes] images to the host (one copy) and cut them
    into one object a chunk: ``keys[i]`` -> row i's bytes."""
    host = images.cpu().numpy()
    return {key: host[i].tobytes() for i, key in enumerate(keys)}


def cache_to_chunks(cache, keys: list[bytes], spec: KVSpec, batch_row: int = 0,
                    start_token: int = 0) -> dict[bytes, bytes]:
    """Pack ``len(keys)`` G-token chunks of one sequence's KV into encoded
    objects (``spec.codec``): `cache_to_wire_images`, then
    `wire_images_to_objects`.

    ``cache``: [L, 2, B, S, KV, dh] tensor (prefix+suffix as produced by
    prefill).  Chunk i covers tokens [start_token + i*G, start_token + (i+1)*G).
    """
    images = cache_to_wire_images(cache, len(keys), spec, batch_row,
                                  start_token)
    return wire_images_to_objects(images, keys)


def layer_payload_to_kv(payload: bytes, num_chunks: int, spec: KVSpec,
                        dtype: torch.dtype, layer: int = 0
                        ) -> tuple[torch.Tensor, ...]:
    """One aggregated layer payload -> (k, v) [P, KV, dh] CPU tensors of
    ``dtype`` (P = N*G), or the one latent [P, W] of a `LatentKVSpec`.

    Host-side decode: identity is a bit view; quantized codecs dequantize with
    the numpy codec to fp32, cast to ``dtype`` in torch.  ``layer`` selects
    the per-layer parameters of a variable-rate codec (mixed-bit)."""
    codec = get_codec(spec.codec)
    P = num_chunks * spec.chunk_tokens
    shape = (P, spec.width) if spec.kv_tensors == 1 else \
        (P, spec.num_kv_heads, spec.head_dim)
    if codec.lossless:
        parts = codec.decode_layer_payload(payload, num_chunks, spec,
                                           _wire_word(dtype), layer=layer)
        return tuple(_from_words(a, dtype).reshape(shape) for a in parts)
    k, v = codec.decode_layer_payload(payload, num_chunks, spec, np.float32,
                                      layer=layer)
    return (_host_tensor(k).to(dtype).reshape(shape),
            _host_tensor(v).to(dtype).reshape(shape))


def layer_payload_to_device_kv(payload: bytes, num_chunks: int, spec: KVSpec,
                               dtype: torch.dtype, layer: int = 0,
                               device="cuda"
                               ) -> tuple[torch.Tensor, ...]:
    """Device-side decode of one aggregated layer payload -> (k, v)
    [P, KV, dh] on ``device``, or the one latent [P, W] of a
    `LatentKVSpec`.

    Identity payloads are a bit view, uploaded as is.  Quantized payloads
    upload the *compressed* tensors (int8 / packed int4 + fp16 scales,
    possibly group-wise) and dequantize with the kernel op, so the copy to
    the device moves wire bytes, not decoded bytes."""
    codec = get_codec(spec.codec)
    G = spec.chunk_tokens
    P = num_chunks * G
    shape = (P, spec.num_kv_heads, spec.head_dim)
    if codec.lossless:
        return tuple(t.to(device) for t in layer_payload_to_kv(
            payload, num_chunks, spec, dtype, layer))
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
    """All layers -> [L, 2, 1, P, KV, dh] prefix-KV (batch dim of 1), or a
    `LatentKVSpec`'s [L, 1, P, W], decoded on the host."""
    if spec.kv_tensors == 1:
        return torch.stack([
            layer_payload_to_kv(payload, num_chunks, spec, dtype, layer)[0]
            for layer, payload in enumerate(payloads)])[:, None].to(device)
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
