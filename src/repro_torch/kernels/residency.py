"""HBM residency & traffic byte model for quantized-resident KV caches, kept
equal to the JAX package's ``repro.kernels.residency`` (the parity tests
compare them on a grid of shapes).

In the port, ``chip_smoke.py`` holds the bytes the CUDA decode kernel
(``csrc/decode_attention_quant.cu``) reads to ``cache_bytes(...)``; the other
functions are kept for that parity.  ``fused_decode_hbm_reads`` models the
TPU kernel's ``quant_block_s`` grid, not the CUDA kernel's splits (at least
128 tokens each, ``decode_split_tokens`` in ``decode_attention.py``).

The two closed-form accountings:

* **Residency** — how many bytes one cached context pins in HBM.  A
  packed-resident context holds the wire image (packed ints + per-chunk fp16
  scale rows); an fp-resident context holds model-width fp16.  The *composed*
  pipeline (standalone dequant, then plain attention) transiently holds both
  at once, so its **peak** residency is wire + fp — that peak is what bounds
  concurrent contexts per device, and it's the basis of the ≥2× (int8) /
  ≥3.5× (int4) contexts-per-byte acceptance ratios.  Steady-state fp-only vs
  wire-only is reported alongside (int8 lands at ~1.98×: the scale rows keep
  it a hair under the pure 2× width ratio).

* **Traffic** — bytes the decode hot path moves per attention call.  The
  fused kernel's grid reads each packed cache byte and scale row exactly
  once (`fused_decode_hbm_reads` derives this from the same block-spec
  arithmetic the kernel uses and asserts it equals the wire image — the
  single-HBM-pass claim).  The composed path reads the wire image, writes
  the fp expansion, then reads it back: wire + 2×fp.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class CacheBytes:
    """Byte footprint of one cached context's K+V for one layer stack."""

    packed_cache: int  # packed int tensors, K and V
    scale_bytes: int   # per-chunk fp16 scale rows, K and V
    fp_cache: int      # the model-width fp expansion, K and V

    @property
    def wire_resident(self) -> int:
        """Bytes pinned by a packed-resident context."""
        return self.packed_cache + self.scale_bytes

    @property
    def composed_peak(self) -> int:
        """Peak bytes while the composed pipeline materializes fp KV: the
        wire image and the expansion coexist until the former is dropped."""
        return self.wire_resident + self.fp_cache


def cache_bytes(tokens: int, num_kv_heads: int, head_dim: int, *, bits: int,
                group: int, chunk_tokens: int, num_layers: int = 1,
                fp_bytes: int = 2) -> CacheBytes:
    """Byte model for ``tokens`` cached positions of K+V.

    Mirrors `core.types.KVSpec.wire_layer_bytes`: W = KV*dh channels per
    token per matrix, one fp16 scale per ``group`` channels per chunk of
    ``chunk_tokens`` tokens, packed ints at ``bits`` per channel."""
    W = num_kv_heads * head_dim
    assert tokens % chunk_tokens == 0, (tokens, chunk_tokens)
    assert (W * bits) % 8 == 0 and W % group == 0
    chunks = tokens // chunk_tokens
    packed = 2 * tokens * (W * bits // 8) * num_layers
    scales = 2 * chunks * (W // group) * 2 * num_layers
    fp = 2 * tokens * W * fp_bytes * num_layers
    return CacheBytes(packed_cache=packed, scale_bytes=scales, fp_cache=fp)


def residency_ratio(cb: CacheBytes, *, peak: bool = True) -> float:
    """Contexts-per-byte advantage of packed-resident over fp-resident.

    ``peak=True`` (the acceptance basis) compares against the composed
    pipeline's transient wire+fp peak; ``peak=False`` is the steady-state
    fp-only vs wire-only ratio."""
    num = cb.composed_peak if peak else cb.fp_cache
    return num / cb.wire_resident


def fused_decode_hbm_reads(cb: CacheBytes, tokens: int, *, chunk_tokens: int,
                           block_s: int) -> int:
    """Cache bytes the fused decode kernel reads for one [B=1] attention
    call, from its own grid arithmetic: ceil(S/bs) sequential steps, each
    streaming one packed K and V tile plus the scale rows riding it.  Block
    specs revisit nothing (the cache-scan axis is the innermost grid axis
    and every index map is injective in it), so when S is block-aligned this
    is exactly ``cb.wire_resident`` — the single-HBM-pass assertion."""
    from .decode_attention import quant_block_s  # avoid cycle at import

    bs = quant_block_s(tokens, chunk_tokens, block_s)
    num_s = -(-tokens // bs)
    # bytes per cache row (K+V packed) and per chunk (K+V scale rows)
    packed_per_tok = cb.packed_cache // tokens
    scale_per_chunk = cb.scale_bytes // (tokens // chunk_tokens)
    packed_read = num_s * bs * packed_per_tok
    if bs >= chunk_tokens:
        chunks_read = num_s * (bs // chunk_tokens)
    else:  # several cache blocks share one chunk's scale row
        chunks_read = -(-num_s * bs // chunk_tokens)
    scale_read = chunks_read * scale_per_chunk
    return packed_read + scale_read


def composed_decode_hbm_traffic(cb: CacheBytes) -> int:
    """Cache bytes the composed path moves: read the wire image (dequant
    kernel in), write the fp expansion (dequant out), read it back
    (attention in)."""
    return cb.wire_resident + 2 * cb.fp_cache
