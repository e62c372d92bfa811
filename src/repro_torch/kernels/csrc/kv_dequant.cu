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
// Design: the Pallas grid of one chunk per step is not carried over.  The
// tensor is flat and each thread makes 8 consecutive outputs: it loads 8
// int8 (8 bytes) or 4 packed bytes with one vector load and writes the 8
// results with one 16-byte store (bf16; two for fp32).  Two thirds of the
// bytes are the output, so the stores are what must coalesce: a warp writes
// 512 contiguous bytes per store instruction, and reads 256 (int8) or 128
// (int4) contiguous bytes.  The 8 values stay inside one row when the width
// is a multiple of 8 and the pointers are aligned (the wrapper checks and
// passes `vec`); otherwise, and for the ragged tail of the flat array, the
// thread takes the scalar path with a bounds check.  The scale row (W/group
// fp16, 2 KB per chunk at group 1) is shared by every row of its chunk, so
// after the first read it comes from L1/L2, not device memory; a thread
// finds its first scale with one division and walks the rest with a counter
// (ScaleWalk): an integer division per element made an earlier version
// bound by instructions, not bytes.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOutPerThread = 8;

__device__ __forceinline__ void store_out(float* out, long long e, float v) {
  out[e] = v;
}

__device__ __forceinline__ void store_out(__nv_bfloat16* out, long long e,
                                          float v) {
  out[e] = __float2bfloat16_rn(v);
}

// Write 8 results starting at out + e0 (16-byte aligned) with vector stores.
__device__ __forceinline__ void store8(float* out, long long e0,
                                       const float* v) {
  float4* dst = reinterpret_cast<float4*>(out + e0);
  dst[0] = make_float4(v[0], v[1], v[2], v[3]);
  dst[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* out, long long e0,
                                       const float* v) {
  __align__(16) __nv_bfloat16 h[kOutPerThread];
#pragma unroll
  for (int i = 0; i < kOutPerThread; ++i) h[i] = __float2bfloat16_rn(v[i]);
  *reinterpret_cast<uint4*>(out + e0) = *reinterpret_cast<const uint4*>(h);
}

__device__ __forceinline__ float scale_at(const __half* __restrict__ s,
                                          long long n, long long c, int ng,
                                          int group) {
  return __half2float(s[n * ng + c / group]);
}

// The scales of consecutive channels c0, c0+1, ... of one chunk's row: one
// division to find the first group, then a counter.
struct ScaleWalk {
  const __half* row;
  int gi, r, group;
  __device__ __forceinline__ ScaleWalk(const __half* row_, int c0, int group_)
      : row(row_), gi(c0 / group_), r(c0 - (c0 / group_) * group_),
        group(group_) {}
  __device__ __forceinline__ float next() {
    const float v = __half2float(row[gi]);
    if (++r == group) {
      r = 0;
      ++gi;
    }
    return v;
  }
};

// q: [N, R, W] int8 flattened (total = N*R*W); s: [N, W/group] fp16.
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
dequant_i8_kernel(const int8_t* __restrict__ q, const __half* __restrict__ s,
                  OutT* __restrict__ out, long long total, long long RW, int W,
                  int group, int vec) {
  const int ng = W / group;
  const long long e0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) *
      kOutPerThread;
  if (e0 >= total) return;
  if (vec && e0 + kOutPerThread <= total) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(q + e0));
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
    const long long n = e0 / RW;
    const int c0 = static_cast<int>((e0 - n * RW) % W);
    ScaleWalk sw(s + n * ng, c0, group);
    float v[kOutPerThread];
#pragma unroll
    for (int j = 0; j < kOutPerThread; ++j) {
      v[j] = __fmul_rn(static_cast<float>(b[j]), sw.next());
    }
    store8(out, e0, v);
    return;
  }
  for (int j = 0; j < kOutPerThread; ++j) {
    const long long e = e0 + j;
    if (e >= total) break;
    const long long n = e / RW;
    const long long c = (e - n * RW) % W;
    store_out(out, e, __fmul_rn(static_cast<float>(q[e]),
                                scale_at(s, n, c, ng, group)));
  }
}

// qp: [N, R, W/2] uint8 flattened (total_bytes = N*R*W/2); s: [N, W/group].
// Byte b holds channels 2*(b % (W/2)) (low nibble) and the next one (high).
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
dequant_p4_kernel(const uint8_t* __restrict__ qp, const __half* __restrict__ s,
                  OutT* __restrict__ out, long long total_bytes,
                  long long RWh, int W, int group, int vec) {
  constexpr int kBytes = kOutPerThread / 2;
  const int ng = W / group;
  const int Wh = W / 2;
  const long long b0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kBytes;
  if (b0 >= total_bytes) return;
  if (vec && b0 + kBytes <= total_bytes) {
    const unsigned int raw =
        __ldg(reinterpret_cast<const unsigned int*>(qp + b0));
    const long long n = b0 / RWh;
    const int c0 = static_cast<int>(2 * ((b0 - n * RWh) % Wh));
    ScaleWalk sw(s + n * ng, c0, group);
    float v[kOutPerThread];
#pragma unroll
    for (int j = 0; j < kBytes; ++j) {
      const unsigned int byte = (raw >> (8 * j)) & 0xFFu;  // little-endian
      const int lo = static_cast<int>(byte & 0xFu) - 8;
      const int hi = static_cast<int>(byte >> 4) - 8;
      v[2 * j] = __fmul_rn(static_cast<float>(lo), sw.next());
      v[2 * j + 1] = __fmul_rn(static_cast<float>(hi), sw.next());
    }
    store8(out, 2 * b0, v);
    return;
  }
  for (int j = 0; j < kBytes; ++j) {
    const long long bi = b0 + j;
    if (bi >= total_bytes) break;
    const long long n = bi / RWh;
    const long long c = 2 * ((bi - n * RWh) % Wh);
    const uint8_t byte = qp[bi];
    store_out(out, 2 * bi,
              __fmul_rn(static_cast<float>(static_cast<int>(byte & 0xF) - 8),
                        scale_at(s, n, c, ng, group)));
    store_out(out, 2 * bi + 1,
              __fmul_rn(static_cast<float>(static_cast<int>(byte >> 4) - 8),
                        scale_at(s, n, c + 1, ng, group)));
  }
}

// Blocks covering `units` input units (elements or packed bytes) at
// `per_thread` units a thread.
inline unsigned int blocks_for(long long units, int per_thread) {
  const long long per_block = static_cast<long long>(kThreads) * per_thread;
  return static_cast<unsigned int>((units + per_block - 1) / per_block);
}

}  // namespace

// out_kind: 0 = fp32, 1 = bf16.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unknown out_kind).
extern "C" int kv_dequant_i8(const void* q, const void* scales, void* out,
                             long long N, long long R, long long W,
                             long long group, int out_kind, int vec,
                             void* stream) {
  const long long total = N * R * W;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned int grid = blocks_for(total, kOutPerThread);
  const auto* qi = static_cast<const int8_t*>(q);
  const auto* si = static_cast<const __half*>(scales);
  if (out_kind == 0) {
    dequant_i8_kernel<float><<<grid, kThreads, 0, st>>>(
        qi, si, static_cast<float*>(out), total, R * W, static_cast<int>(W),
        static_cast<int>(group), vec);
  } else if (out_kind == 1) {
    dequant_i8_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        qi, si, static_cast<__nv_bfloat16*>(out), total, R * W,
        static_cast<int>(W), static_cast<int>(group), vec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// W is the unpacked width (2 * the packed row width).
extern "C" int kv_dequant_p4(const void* q_packed, const void* scales,
                             void* out, long long N, long long R, long long W,
                             long long group, int out_kind, int vec,
                             void* stream) {
  const long long total_bytes = N * R * (W / 2);
  if (total_bytes == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned int grid = blocks_for(total_bytes, kOutPerThread / 2);
  const auto* qi = static_cast<const uint8_t*>(q_packed);
  const auto* si = static_cast<const __half*>(scales);
  if (out_kind == 0) {
    dequant_p4_kernel<float><<<grid, kThreads, 0, st>>>(
        qi, si, static_cast<float*>(out), total_bytes, R * (W / 2),
        static_cast<int>(W), static_cast<int>(group), vec);
  } else if (out_kind == 1) {
    dequant_p4_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        qi, si, static_cast<__nv_bfloat16*>(out), total_bytes, R * (W / 2),
        static_cast<int>(W), static_cast<int>(group), vec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
