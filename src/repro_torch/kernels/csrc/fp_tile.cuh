// Tile loads of fp32 or bf16 K/V into fp32 shared memory, shared by the fp
// attention kernels K4 (flash_attention.cu) and K5 (decode_attention.cu),
// hand-written for Hopper (sm_90a).  The fp counterpart of K3
// (dequant_tile.cuh): the same tile shape in shared memory, filled by plain
// widening instead of a dequant, so the two kernels keep K7's and K6's compute
// loops unchanged.
//
// A bf16 value widens to fp32 exactly, so the tiles hold the inputs' values
// bit for bit.  head_dim must be a multiple of 8 and every row 16-byte
// aligned: one call loads 8 consecutive channels of one token with 16-byte
// loads (two float4 for fp32, one uint4 for bf16).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fpt {

constexpr int kUnit = 8;  // channels one call to `load8` widens

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void load8(const float* __restrict__ p,
                                      float (&out)[kUnit]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  out[0] = a.x;
  out[1] = a.y;
  out[2] = a.z;
  out[3] = a.w;
  out[4] = b.x;
  out[5] = b.y;
  out[6] = b.z;
  out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ p,
                                      float (&out)[kUnit]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < kUnit / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Widen tokens [t0, t0 + kRows) into fp32 shared memory, dst[r * ld + c]
// (dst 16-byte aligned, ld a multiple of 4).  Token t's row starts at
// base + t * row_stride (elements).  Rows at or past `t_end` are written as
// zeros and never read from memory, so stale or padded values past the end
// cannot reach the sums.  All kThreads threads of the block call it; the
// caller synchronises before reading dst.
template <typename T, int kDH, int kRows, int kThreads>
__device__ __forceinline__ void load_tile(const T* __restrict__ base,
                                          long long row_stride, long long t0,
                                          long long t_end, float* dst,
                                          int ld) {
  static_assert(kDH % kUnit == 0, "head_dim must be a multiple of 8");
  constexpr int kUnitsPerRow = kDH / kUnit;
  for (int u = threadIdx.x; u < kRows * kUnitsPerRow; u += kThreads) {
    const int r = u / kUnitsPerRow;
    const int c = (u - r * kUnitsPerRow) * kUnit;
    const long long t = t0 + r;
    float x[kUnit];
    if (t < t_end) {
      load8(base + t * row_stride + c, x);
    } else {
#pragma unroll
      for (int i = 0; i < kUnit; ++i) x[i] = 0.f;
    }
    float4* d4 = reinterpret_cast<float4*>(dst + r * ld + c);
    d4[0] = make_float4(x[0], x[1], x[2], x[3]);
    d4[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
}

}  // namespace fpt
