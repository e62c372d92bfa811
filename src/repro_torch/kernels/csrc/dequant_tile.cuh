// K3: the tile dequant shared by the fused dequant-attention kernels K6
// (decode_attention_quant.cu) and K7 (flash_attention_quant.cu), hand-written
// for Hopper (sm_90a).  A __device__ function, not a launch of its own.
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
// The TPU kernel snapped its blocks to the chunk grid so that each tile came
// with whole scale rows (`quant_block_s`); here a token finds its scale row
// as t / G directly, so tiles of any size and offset work.  dh must be a
// multiple of 8: one call expands 8 consecutive channels of one token from one
// 8-byte (int8) or 4-byte (int4) load.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace k3 {

constexpr int kUnit = 8;  // channels one call to `dequant8` expands

// Channels [c, c + 8) of one token of one head.  `row` is the token's packed
// row for that head (dh' words), `srow` its chunk's scale row, `cglob` the
// channel's index in the full KV*dh width (h*dh + c).
template <int kBits>
__device__ __forceinline__ void dequant8(const uint8_t* __restrict__ row,
                                         int c,
                                         const __half* __restrict__ srow,
                                         int cglob, int group,
                                         float (&out)[kUnit]) {
  int vals[kUnit];
  if constexpr (kBits == 8) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(row + c));
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < kUnit; ++i) vals[i] = b[i];
  } else {
    static_assert(kBits == 4, "packed caches are 8- or 4-bit");
    const unsigned int raw =
        __ldg(reinterpret_cast<const unsigned int*>(row + c / 2));
#pragma unroll
    for (int j = 0; j < kUnit / 2; ++j) {
      const unsigned int byte = (raw >> (8 * j)) & 0xFFu;  // little-endian
      vals[2 * j] = static_cast<int>(byte & 0xFu) - 8;
      vals[2 * j + 1] = static_cast<int>(byte >> 4) - 8;
    }
  }
  // one division for the first scale, then a counter (as kv_dequant.cu)
  int gi = cglob / group;
  int r = cglob - gi * group;
#pragma unroll
  for (int i = 0; i < kUnit; ++i) {
    out[i] = __fmul_rn(static_cast<float>(vals[i]), __half2float(srow[gi]));
    if (++r == group) {
      r = 0;
      ++gi;
    }
  }
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

}  // namespace k3
