// K3: the dequant of a packed-resident cache inside the fused
// dequant-attention kernels K6 (decode_attention_quant.cu) and K7
// (flash_attention_quant.cu), hand-written for Hopper (sm_90a).
// __device__ functions, not a launch of their own.
//
// Replaces src/repro/kernels/kv_dequant.py:41 `dequant_tile`, which runs
// inside the reference's decode/flash `pallas_call`s.
//
// A packed-resident cache is [B, S, KV, dh'] words (int8, or uint8 holding two
// biased nibbles with dh' = dh/2; low nibble = even channel, value = nibble -
// 8) plus one fp16 scale row [KV*dh/group] per chunk of G tokens.  Token t of
// head h, channel c, dequantizes to f32(q) * f32(scale[t / G][(h*dh + c) /
// group]) with one rounding (__fmul_rn, no fused add): for equal inputs these
// are exactly the fp32 values of K1/K2 (kv_dequant.cu) and of the plain
// version `kernels.kv_dequant.dequant_cache_ref`.
//
// The unit is `dequant8`, 8 consecutive channels of one token, and its
// parts: `codes8` (one 8-byte or 4-byte load, `unpack8`), `scales8` and
// `widen8` (the products).  Where they run:
//   - K7's bf16 loader (the wgmma loop) calls `codes8`, `scales8` and
//     `widen8`, keeping a unit's scales while its rows stay in one chunk;
//   - K7's fp32 loader (the CUDA-core loop) calls `dequant_tile`, a loop of
//     `dequant8` over a tile;
//   - K6's row loader (the split decode) calls `unpack8`, `scales8` and
//     `widen8` on codes it has already loaded to registers.
// The TPU kernel snapped its blocks to the chunk grid so that each tile came
// with whole scale rows (`quant_block_s`); here a token finds its scale row
// as t / G directly, so tiles of any size and offset work.  dh must be a
// multiple of 8.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace k3 {

constexpr int kUnit = 8;  // channels one call to `dequant8` expands

// The 8 codes of one unit as exact floats: `raw` holds them little-endian,
// 8 bytes of int8 (uint2) or 4 bytes of biased nibbles (unsigned int).  A
// code u in [0, 255] (an int8 code + 128, or a nibble) placed in the
// mantissa of 2^23 is the float 2^23 + u; one subtraction then gives the
// code exactly, with full-rate integer and float instructions instead of
// int-to-float conversions.
__device__ __forceinline__ float code_from(uint32_t word, int byte,
                                           float bias) {
  // bytes [word.byte, 0, 0, 0x4B] = 2^23 + u
  return __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7540 + byte)) -
         bias;
}
__device__ __forceinline__ void unpack8(const uint2& raw,
                                        float (&vals)[kUnit]) {
  const uint32_t w[2] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < kUnit; ++i)
    vals[i] = code_from(w[i / 4], i % 4, 8388736.f);  // 2^23 + 128
}
__device__ __forceinline__ void unpack8(unsigned int raw,
                                        float (&vals)[kUnit]) {
  const uint32_t lo = raw & 0x0F0F0F0Fu;         // even channels
  const uint32_t hi = (raw >> 4) & 0x0F0F0F0Fu;  // odd channels
#pragma unroll
  for (int j = 0; j < kUnit / 2; ++j) {
    vals[2 * j] = code_from(lo, j, 8388616.f);  // 2^23 + 8
    vals[2 * j + 1] = code_from(hi, j, 8388616.f);
  }
}

// the raw word of 8 channels of a unit: 8 bytes (int8) or 4 (int4)
template <int kBits>
using Raw8 = typename std::conditional<kBits == 8, uint2, unsigned int>::type;

// Channels [c, c + 8) of a token's packed row (dh' words) as floats.
template <int kBits>
__device__ __forceinline__ void codes8(const uint8_t* __restrict__ row, int c,
                                       float (&vals)[kUnit]) {
  static_assert(kBits == 8 || kBits == 4, "packed caches are 8- or 4-bit");
  unpack8(__ldg(reinterpret_cast<const Raw8<kBits>*>(row + c * kBits / 8)),
          vals);
}

// The scales of channels [cglob, cglob + 8) of the full KV*dh width from
// their chunk's scale row `srow`: one division for the first, then a
// counter (as kv_dequant.cu).
__device__ __forceinline__ void scales8(const __half* __restrict__ srow,
                                        int cglob, int group,
                                        float (&s)[kUnit]) {
  int gi = cglob / group;
  int r = cglob - gi * group;
#pragma unroll
  for (int i = 0; i < kUnit; ++i) {
    s[i] = __half2float(srow[gi]);
    if (++r == group) {
      r = 0;
      ++gi;
    }
  }
}

// code x scale, one rounding each (no fused add)
__device__ __forceinline__ void widen8(const float (&vals)[kUnit],
                                       const float (&s)[kUnit],
                                       float (&out)[kUnit]) {
#pragma unroll
  for (int i = 0; i < kUnit; ++i) out[i] = __fmul_rn(vals[i], s[i]);
}

// Channels [c, c + 8) of one token of one head.  `row` is the token's packed
// row for that head (dh' words), `srow` its chunk's scale row, `cglob` the
// channel's index in the full KV*dh width (h*dh + c).
template <int kBits>
__device__ __forceinline__ void dequant8(const uint8_t* __restrict__ row,
                                         int c,
                                         const __half* __restrict__ srow,
                                         int cglob, int group,
                                         float (&out)[kUnit]) {
  float vals[kUnit];
  float s[kUnit];
  codes8<kBits>(row, c, vals);
  scales8(srow, cglob, group, s);
  widen8(vals, s, out);
}

// Expand tokens [t0, t0 + kRows) of KV head `kh` into fp32 shared memory,
// dst[r * ld + c] (dst 16-byte aligned, ld a multiple of 4); rows at or past
// `t_end` are written as zeros.  `cache` and `scales` point at one batch
// row: [S, KV, dh'] words and [S/G, ng] fp16.  All kThreads threads of the
// block call it; the caller synchronises before reading dst.
template <int kBits, int kDH, int kRows, int kThreads>
__device__ __forceinline__ void dequant_tile(
    const uint8_t* __restrict__ cache, const __half* __restrict__ scales,
    int KV, int kh, int G, int ng, int group, long long t0, long long t_end,
    float* dst, int ld) {
  static_assert(kDH % kUnit == 0, "head_dim must be a multiple of 8");
  constexpr int kUnitsPerRow = kDH / kUnit;
  constexpr long long kRowWords = kBits == 8 ? kDH : kDH / 2;
  for (int u = threadIdx.x; u < kRows * kUnitsPerRow; u += kThreads) {
    const int r = u / kUnitsPerRow;
    const int c = (u - r * kUnitsPerRow) * kUnit;
    const long long t = t0 + r;
    float v[kUnit];
    if (t < t_end) {
      const uint8_t* row = cache + (t * KV + kh) * kRowWords;
      const __half* srow = scales + (t / G) * ng;
      dequant8<kBits>(row, c, srow, kh * kDH + c, group, v);
    } else {
#pragma unroll
      for (int i = 0; i < kUnit; ++i) v[i] = 0.f;
    }
    float4* d4 = reinterpret_cast<float4*>(dst + r * ld + c);
    d4[0] = make_float4(v[0], v[1], v[2], v[3]);
    d4[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

}  // namespace k3
