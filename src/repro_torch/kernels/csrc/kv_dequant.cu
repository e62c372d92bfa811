// KV dequantization for the quantized wire codecs, hand-written for Hopper
// (sm_90a).  Plain C interface, bound from Python with ctypes
// (repro_torch/kernels/kv_dequant.py); every launch goes on the caller's
// stream and each entry point returns cudaGetLastError().
//
// Replaces the TPU kernels of src/repro/kernels/kv_dequant.py:
//   kv_dequant_i8      <- kv_dequant          (pallas_call at :88,
//                                               _dequant_kernel :64)
//   kv_dequant_p4      <- kv_dequant_packed4  (pallas_call at :108,
//                                               _dequant_packed4_kernel :70)
//
// What they compute: out[n, r, c] = f32(q[n, r, c]) * f32(scale[n, c / group]),
// rounded once to the output type (fp32 or bf16).  The packed form stores two
// biased nibbles per byte (low nibble = even channel, value = nibble - 8).
// The codes become floats through K3's `k3::unpack8` (dequant_tile.cuh) and
// the products through `k3::widen8` (__fmul_rn, no FMA), so K1, K2, K6 and
// K7 share one exact widening and stay bit-equal to the plain versions.
//
// Bound: memory.  Each output costs one multiply, so the work is the bytes:
// int8 (or packed int4) in, fp16 scales in, bf16 out.  At the serving path's
// shape (N=15 chunks, R=256 tokens, W=KV*dh=1024 channels, bf16 out):
//   int8:  3,932,160 B in + 30,720 B scales + 7,864,320 B out = 11.83 MB
//          -> 3.5 us at 3.35 TB/s
//   int4:  1,966,080 B in + 30,720 B scales + 7,864,320 B out =  9.86 MB
//          -> 2.9 us at 3.35 TB/s
// Two launches (K and V) per layer, 64 per warm request of a 32-layer model.
//
// Design: a thread owns a strip of 16 channels of one chunk and walks rows
// of it: two units of 8 channels (the unit of K3's `unpack8`), 16 bytes of
// int8 codes (K1) or 8 bytes of nibbles (K2) a row.  The strip's 16 scales
// load once into registers, one 16-byte load a unit at group 1 and
// `k3::scales8` otherwise, and serve every row the thread walks.  The two
// units lie a CTA row of threads apart (unit k of thread tx is unit
// tx + k * threads_x of its strip block), so a warp's k-th load covers
// consecutive units (256 contiguous bytes of int8 codes, 128 of nibbles)
// and its k-th store 512 contiguous bytes of bf16.  The launch geometry
// comes from the host (`dequant_plan` in kv_dequant.py), so the kernel
// divides nothing:
//   grid (N, slabs, strip blocks), CTA (threads_x, threads_y) of at most
//   kThreads = 256 threads;
//   chunk n = blockIdx.x; thread tx owns channels [8 u, 8 u + 8) of the
//   units u = blockIdx.z * threads_x * kUnits + tx + k * threads_x,
//   k < kUnits, below W;
//   rows slab * threads_y * rows + threadIdx.y + k * threads_y for
//   k < rows, below R.
// The plan takes the fewest rows a thread (at least 2) that put the whole
// grid in one wave of kMinBlocks CTAs per SM on 132 SMs (at most 16 rows,
// then several waves).  At the serving shape (W = 1024) both kernels run
// CTAs of 64 x 4 threads, 2 rows a thread, grid (15, 32, 1) = 480 CTAs,
// every one resident at once.  A thread issues the code loads of up to
// kU = 4 rows and its scales (read-only path, `__ldg`) before the first use
// of any, so all of a wave's reads are in flight together: a use between
// two loads (scales widened as they arrive) cost a round trip to memory
// each.  Stores stay write-back: the layer step that follows reads K/V,
// and the output fits in the 50 MB L2.
//
// What else was tried at the serving shape (PERF.md): strips of 16
// contiguous int8 channels or 32 nibbles, one 16-byte load a row, ran
// slower than the flat kernel this one replaced, one thread for each 8
// consecutive outputs (a warp's 16-byte stores then each fill half or a
// quarter of 32 sectors); K2 at 32 channels a thread (four units, half
// the threads) ran slower than at 16; one unit a thread was no faster
// than two.
//
// The ragged cases run a per-element path inside the same kernel: a unit
// that the width cuts (the tail of each row), or every unit when the
// plan's `vec` is 0 (a width that is not a multiple of 8, or q, scales or
// out not 16-byte aligned).  The thread then gathers its codes byte by
// byte, takes its scales channel by channel, and stores element by
// element; n and r still come from the grid.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "dequant_tile.cuh"

namespace {

constexpr int kThreads = 256;  // THREADS of kv_dequant.py
constexpr int kMinBlocks = 4;  // CTAS_PER_SM of kv_dequant.py
constexpr int kUnit = k3::kUnit;

constexpr int kStrip = 16;  // channels a thread owns (DEQUANT_STRIP)
constexpr int kUnits = kStrip / kUnit;
constexpr int kU = 4;  // rows whose codes load before the first use

// the 8 codes of a unit: 8 bytes of int8 codes, or 4 bytes of nibble pairs
template <bool kPacked>
using Raw = k3::Raw8<kPacked ? 4 : 8>;

// 8 outputs at p (16-byte aligned)
__device__ __forceinline__ void store8(float* p, const float (&x)[kUnit]) {
  float4* d = reinterpret_cast<float4*>(p);
  d[0] = make_float4(x[0], x[1], x[2], x[3]);
  d[1] = make_float4(x[4], x[5], x[6], x[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&x)[kUnit]) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
    w[j] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// A unit's codes in one row (`row` at its first byte): one load on the
// vector path, else byte by byte (0 past the row's end, `left` bytes on).
template <bool kPacked>
__device__ __forceinline__ Raw<kPacked> unit_codes(
    const uint8_t* __restrict__ row, int left, bool fast) {
  constexpr int kBytes = kPacked ? kUnit / 2 : kUnit;
  if (fast) return __ldg(reinterpret_cast<const Raw<kPacked>*>(row));
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < kBytes; ++i)
    if (i < left)
      w[i / 4] |= static_cast<uint32_t>(__ldg(row + i)) << (8 * (i % 4));
  if constexpr (kPacked) {
    return w[0];
  } else {
    return make_uint2(w[0], w[1]);
  }
}

// q: [N, R, W] int8 (kPacked false) or [N, R, W/2] biased nibble pairs;
// s: [N, W/group] fp16; out: [N, R, W].  Every load of a batch of rows (and
// of the scales) issues before the first use of any: a use between two
// loads would cost a round trip to memory each.
template <bool kPacked, typename OutT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dequant_kernel(const uint8_t* __restrict__ q, const __half* __restrict__ s,
               OutT* __restrict__ out, int R, int W, int group, int rows,
               int vec) {
  // unit k of this thread: channels [c[k], c[k] + 8), a row of threads
  // apart, so a warp's k-th load and store cover consecutive units
  const int tx = blockDim.x;
  const int u0 = blockIdx.z * tx * kUnits + threadIdx.x;
  if (u0 * kUnit >= W) return;
  const int n = blockIdx.x;
  const int row_bytes = kPacked ? W / 2 : W;
  const bool fast = vec;  // vec: W % 8 == 0, so every unit below W is whole
  int c[kUnits];
#pragma unroll
  for (int k = 0; k < kUnits; ++k) c[k] = (u0 + k * tx) * kUnit;

  const uint8_t* qn = q + static_cast<long long>(n) * R * row_bytes;
  OutT* on = out + static_cast<long long>(n) * R * W;
  const int ry = blockDim.y;
  const int r0 = blockIdx.y * ry * rows + threadIdx.y;
  Raw<kPacked> raw[kU][kUnits];
  auto load_batch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kU; ++i) {
      const int r = r0 + (k0 + i) * ry;
      const bool live = k0 + i < rows && r < R;
      const uint8_t* qrow = qn + static_cast<long long>(r) * row_bytes;
#pragma unroll
      for (int k = 0; k < kUnits; ++k) {
        const int b = kPacked ? c[k] / 2 : c[k];
        raw[i][k] = {};
        if (live && c[k] < W)
          raw[i][k] = unit_codes<kPacked>(qrow + b, row_bytes - b, fast);
      }
    }
  };
  load_batch(0);

  // the strip's scales: one 16-byte load a unit at group 1 on the vector
  // path (all issued, then widened), `k3::scales8` for other whole units,
  // channel by channel (0 past the width) for a cut one
  float sc[kUnits][kUnit];
  const __half* srow = s + static_cast<long long>(n) * (W / group);
  if (fast && group == 1) {
    uint4 h[kUnits];
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      h[k] = make_uint4(0u, 0u, 0u, 0u);
      if (c[k] < W) h[k] = __ldg(reinterpret_cast<const uint4*>(srow + c[k]));
    }
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const uint32_t w[4] = {h[k].x, h[k].y, h[k].z, h[k].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f =
            __half22float2(*reinterpret_cast<const __half2*>(&w[j]));
        sc[k][2 * j] = f.x;
        sc[k][2 * j + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      if (c[k] + kUnit <= W) {
        k3::scales8(srow, c[k], group, sc[k]);
      } else {
#pragma unroll
        for (int j = 0; j < kUnit; ++j)
          sc[k][j] = c[k] + j < W
                         ? __half2float(__ldg(srow + (c[k] + j) / group))
                         : 0.f;
      }
    }
  }

  for (int k0 = 0; k0 < rows; k0 += kU) {
    if (k0 > 0) load_batch(k0);
#pragma unroll
    for (int i = 0; i < kU; ++i) {
      const int r = r0 + (k0 + i) * ry;
      if (k0 + i >= rows || r >= R) continue;
      OutT* orow = on + static_cast<long long>(r) * W;
#pragma unroll
      for (int k = 0; k < kUnits; ++k) {
        if (c[k] >= W) continue;
        float v[kUnit], x[kUnit];
        k3::unpack8(raw[i][k], v);
        k3::widen8(v, sc[k], x);
        if (fast) {
          store8(orow + c[k], x);
        } else {
#pragma unroll
          for (int j = 0; j < kUnit; ++j)
            if (c[k] + j < W) store1(orow + c[k] + j, x[j]);
        }
      }
    }
  }
}

template <bool kPacked>
int launch(const void* q, const void* scales, void* out, long long N,
           long long R, long long W, long long group, int out_kind, int vec,
           int strip, int threads_x, int threads_y, int rows, long long slabs,
           long long strip_blocks, void* stream) {
  if (N * R * W == 0) return static_cast<int>(cudaGetLastError());
  if (strip != kStrip || threads_x < 1 || threads_y < 1 ||
      threads_x * threads_y > kThreads || rows < 1 || group < 1 ||
      W % group != 0 || (kPacked && W % 2 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned int>(N),
                  static_cast<unsigned int>(slabs),
                  static_cast<unsigned int>(strip_blocks));
  const dim3 block(threads_x, threads_y);
  const auto* qb = static_cast<const uint8_t*>(q);
  const auto* sh = static_cast<const __half*>(scales);
  const int r = static_cast<int>(R), w = static_cast<int>(W),
            g = static_cast<int>(group);
  if (out_kind == 0) {
    dequant_kernel<kPacked, float><<<grid, block, 0, st>>>(
        qb, sh, static_cast<float*>(out), r, w, g, rows, vec);
  } else if (out_kind == 1) {
    dequant_kernel<kPacked, __nv_bfloat16><<<grid, block, 0, st>>>(
        qb, sh, static_cast<__nv_bfloat16*>(out), r, w, g, rows, vec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out_kind: 0 = fp32, 1 = bf16.  W is the unpacked width (K2's rows hold W/2
// bytes).  The geometry (strip, threads_x, threads_y, rows, slabs,
// strip_blocks, vec) is `dequant_plan`'s.  Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for an unknown out_kind or a geometry
// the kernel does not take).
extern "C" int kv_dequant_i8(const void* q, const void* scales, void* out,
                             long long N, long long R, long long W,
                             long long group, int out_kind, int vec,
                             int strip, int threads_x, int threads_y,
                             int rows, long long slabs,
                             long long strip_blocks, void* stream) {
  return launch<false>(q, scales, out, N, R, W, group, out_kind, vec, strip,
                       threads_x, threads_y, rows, slabs, strip_blocks,
                       stream);
}

extern "C" int kv_dequant_p4(const void* q_packed, const void* scales,
                             void* out, long long N, long long R, long long W,
                             long long group, int out_kind, int vec,
                             int strip, int threads_x, int threads_y,
                             int rows, long long slabs,
                             long long strip_blocks, void* stream) {
  return launch<true>(q_packed, scales, out, N, R, W, group, out_kind, vec,
                      strip, threads_x, threads_y, rows, slabs, strip_blocks,
                      stream);
}
