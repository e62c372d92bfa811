// Tile loads of fp32 K/V into fp32 shared memory for the CUDA-core fp32 path
// of K4 (flash_attention.cu), hand-written for Hopper (sm_90a).  The fp
// counterpart of K3 (dequant_tile.cuh): the same tile shape in shared
// memory, filled by plain copies instead of a dequant, so K4's fp32 loop is
// K7's.  head_dim must be a multiple of 8 and every row 16-byte aligned: one
// step loads 8 consecutive channels of one token as two float4.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fpt {

constexpr int kUnit = 8;  // channels one step loads

// Copy tokens [t0, t0 + kRows) into shared memory, dst[r * ld + c] (dst
// 16-byte aligned, ld a multiple of 4).  Token t's row starts at
// base + t * row_stride (elements).  Rows at or past `t_end` are written as
// zeros and never read from memory, so stale or padded values past the end
// cannot reach the sums.  All kThreads threads of the block call it; the
// caller synchronises before reading dst.
template <int kDH, int kRows, int kThreads>
__device__ __forceinline__ void load_tile(const float* __restrict__ base,
                                          long long row_stride, long long t0,
                                          long long t_end, float* dst,
                                          int ld) {
  static_assert(kDH % kUnit == 0, "head_dim must be a multiple of 8");
  constexpr int kUnitsPerRow = kDH / kUnit;
  for (int u = threadIdx.x; u < kRows * kUnitsPerRow; u += kThreads) {
    const int r = u / kUnitsPerRow;
    const int c = (u - r * kUnitsPerRow) * kUnit;
    const long long t = t0 + r;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (t < t_end) {
      const float4* p =
          reinterpret_cast<const float4*>(base + t * row_stride + c);
      a = __ldg(p);
      b = __ldg(p + 1);
    }
    float4* d4 = reinterpret_cast<float4*>(dst + r * ld + c);
    d4[0] = a;
    d4[1] = b;
  }
}

}  // namespace fpt
