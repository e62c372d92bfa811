// K9: the commit's encode of the quantized wire codecs, hand-written for
// Hopper (sm_90a).  Plain C interface, bound from Python with ctypes
// (repro_torch/kernels/kv_encode.py); the launch goes on the caller's stream
// and the entry point returns cudaGetLastError().
//
// Replaces no Pallas kernel: the reference encodes on the host, in numpy
// (src/repro/codec/quant.py `_QuantCodec.encode_chunk` over
// src/repro/codec/ref.py `quantize_grouped`).  It was added because that
// encode, run by the port on the host after a copy of the bf16 KV, was ~96%
// of the serving engine's commit and ~70% of a cold request's wall time,
// while the KV it reads already lives on the card.  Now the engine copies
// only the finished wire image to the host.
//
// What it computes: the wire image of N chunks of G tokens, byte-equal to
// `codec.encode_chunk`.  Input: a strided view x [L, 2, N*G, KV, dh] of the
// engine's cache (bf16 or fp32; a token row of W = KV*dh channels
// contiguous).  Output: [N, chunk_bytes] bytes; layer l's slice starts at
// offset[l] (the codec's `spec.wire_layer_offsets`, a size table for
// mixed-bit) and holds [k_scales fp16 | v_scales fp16 | K codes | V codes].
// For each (chunk, layer, K|V) matrix and each group of `group[l]`
// consecutive channels:
//   absmax over the chunk's G tokens and the group's channels;
//   scale = fp16(min(absmax / qmax, 65504)), the division in fp32, the cast
//           rounding to nearest even;
//   s = scale > 0 ? scale : 1 (an all-zero group codes to 0);
//   q = clamp(rint(x / s), -qmax, qmax), an IEEE fp32 division (no
//       reciprocal: it rounds differently) rounded half to even;
// int8 codes as they are; int4 codes biased by +8, two a byte along the
// channels, the even channel in the low nibble.  The maximum is exact in
// any order, so the kernel and the plain version agree bit for bit (a NaN
// in the input is ignored by the maximum here where numpy's propagates it:
// the model's KV is finite).
//
// Bound: memory.  Each value costs a few operations; the work is the bytes:
// the KV read once, the image written once.  At the serving shape
// (qwen3-14b: L=40, KV=8, dh=128, G=256, bf16, int8), a chunk reads
// 40 x 2 x 256 x 1024 x 2 B = 41.9 MB and writes 21.0 MB of codes and
// 0.16 MB of scales: 63.1 MB, 18.8 us at 3.35 TB/s.  One launch a commit.
//
// Design: a bytes-bound reduce-then-map.  A block owns one strip of
// `strip` channels of one (chunk, layer, matrix) and all G rows of it, so
// each scale group lies inside one block and needs no second kernel or
// atomics.  A thread owns one unit of 8 channels (one 16-byte load of bf16
// a row, two of fp32) on kRows rows, `row_groups` rows apart, and keeps
// them in registers as loaded: the absmax pass and the quantize pass read
// the same registers, so the input crosses from HBM once.  Every load of a
// thread issues before the first use.  The maximum over the block's rows
// goes through shared memory: each thread's 8 channel maxima, then one
// thread a channel over the row groups, then one thread a group over its
// channels, which also writes the group's scale.  Codes leave as one 8-byte
// store (int8; two 4-byte stores where the slice is only 4-byte aligned)
// or one 4-byte store (int4) a unit and row.
// The geometry comes from the host (`encode_plan` in kv_encode.py): strip
// is the smallest multiple of lcm(8, every layer's group) from 64 channels
// up (at most the width); row_groups = min(ceil(G / kRows), 512 / units).
// At the serving shape (groups 1): strip 64, 8 x 32 = 256 threads, each
// 8 rows of 8 channels, grid (16, 80, N), a single pass.  Where G is larger
// than row_groups * kRows (a group of more than 128 channels at G = 256),
// the block walks its rows in several passes; the last stays in registers
// for the quantize pass and the earlier ones are read again (from L2).

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kUnit = 8;           // channels a thread owns (ENCODE_UNIT)
constexpr int kRows = 8;           // rows a thread holds a pass (ENCODE_ROWS)
constexpr int kMaxThreads = 512;   // ENCODE_MAX_THREADS
constexpr int kMaxStrip = 2048;    // ENCODE_MAX_STRIP
constexpr int kMaxLayers = 128;    // ENCODE_MAX_LAYERS
constexpr float kFp16Max = 65504.f;

// per-layer parameters, passed by value (2 KB of the 4 KB of a launch)
struct Layers {
  long long offset[kMaxLayers];  // byte offset of layer l's slice in a chunk
  int bits[kMaxLayers];          // 8 or 4
  int group[kMaxLayers];         // channels sharing one scale
};

// One unit (8 channels) of one row as loaded: 16 bytes of bf16, 32 of fp32.
template <typename InT>
struct Unit;

template <>
struct Unit<__nv_bfloat16> {
  uint4 w;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    w = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void clear() { w = make_uint4(0u, 0u, 0u, 0u); }
  // a bf16 word is the top half of the fp32 of the same value
  __device__ __forceinline__ void widen(float (&v)[kUnit]) const {
    const uint32_t a[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __uint_as_float(a[j] << 16);
      v[2 * j + 1] = __uint_as_float(a[j] & 0xFFFF0000u);
    }
  }
};

template <>
struct Unit<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void clear() {
    a = make_float4(0.f, 0.f, 0.f, 0.f);
    b = a;
  }
  __device__ __forceinline__ void widen(float (&v)[kUnit]) const {
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
};

// code of x against the group's scale s (> 0): rint(x / s) clamped
__device__ __forceinline__ int code(float x, float s, float qmax) {
  const float t = rintf(__fdiv_rn(x, s));
  return __float2int_rn(fminf(fmaxf(t, -qmax), qmax));
}

// x: [L, 2, N*G, W] elements at strides (s_layer, s_mat, s_tok, 1);
// out: [N, chunk_bytes].  Block (strip b, layer l * 2 + matrix m, chunk n);
// thread tid = ry * units + cx owns channels [b * strip + 8 cx, + 8) on
// rows p * row_groups * kRows + ry + k * row_groups, k < kRows, pass p.
template <typename InT>
__global__ void __launch_bounds__(kMaxThreads)
encode_kernel(const InT* __restrict__ x, long long s_layer, long long s_mat,
              long long s_tok, uint8_t* __restrict__ out,
              long long chunk_bytes, int G, int W, int strip, int row_groups,
              const Layers layers) {
  extern __shared__ float smem[];
  const int units = strip / kUnit;
  const int tid = threadIdx.x;
  const int cx = tid % units, ry = tid / units;
  const int l = blockIdx.y >> 1, m = blockIdx.y & 1;
  const int n = blockIdx.z;
  const int c_base = blockIdx.x * strip;
  const int c0 = c_base + cx * kUnit;
  const bool live = c0 < W;  // W % 8 == 0: a unit is whole or past the width
  const int bits = layers.bits[l], group = layers.group[l];
  const float qmax = bits == 8 ? 127.f : 7.f;
  const InT* xm = x + l * s_layer + m * s_mat +
                  static_cast<long long>(n) * G * s_tok + c0;
  const int pass_rows = row_groups * kRows;
  const int passes = (G + pass_rows - 1) / pass_rows;

  Unit<InT> raw[kRows];
  auto load = [&](int p) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int r = p * pass_rows + ry + k * row_groups;
      raw[k].clear();
      if (live && r < G) raw[k].load(xm + r * s_tok);
    }
  };

  // pass 1: this thread's maxima of |x| over its rows, channel by channel
  // (rows past G and channels past W hold 0, which moves no maximum)
  float amax[kUnit];
#pragma unroll
  for (int j = 0; j < kUnit; ++j) amax[j] = 0.f;
  for (int p = 0; p < passes; ++p) {
    load(p);
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      float v[kUnit];
      raw[k].widen(v);
#pragma unroll
      for (int j = 0; j < kUnit; ++j) amax[j] = fmaxf(amax[j], fabsf(v[j]));
    }
  }

  // the block's maximum: red[ry][c] (thread tid's 8 channels at tid * 8),
  // then cmax[c] over the row groups, then one thread a scale group
  float* red = smem;                    // [row_groups][strip]
  float* cmax = red + blockDim.x * kUnit;  // [strip]
  float* safe = cmax + strip;           // [strip / group]
#pragma unroll
  for (int j = 0; j < kUnit; ++j) red[tid * kUnit + j] = amax[j];
  __syncthreads();
  for (int c = tid; c < strip; c += blockDim.x) {
    float a = 0.f;
    for (int g = 0; g < row_groups; ++g) a = fmaxf(a, red[g * strip + c]);
    cmax[c] = a;
  }
  __syncthreads();
  const long long slice = static_cast<long long>(n) * chunk_bytes +
                          layers.offset[l];
  const int wg = W / group;  // scales of one matrix
  for (int gi = tid; gi < strip / group; gi += blockDim.x) {
    const int cg = c_base + gi * group;  // the group's first channel
    if (cg >= W) break;
    float a = 0.f;
    for (int j = 0; j < group; ++j) a = fmaxf(a, cmax[gi * group + j]);
    const __half h = __float2half_rn(fminf(__fdiv_rn(a, qmax), kFp16Max));
    reinterpret_cast<__half*>(out + slice)[m * wg + cg / group] = h;
    const float s = __half2float(h);
    safe[gi] = s > 0.f ? s : 1.f;
  }
  __syncthreads();
  if (!live) return;

  // pass 2: the codes, from the registers of the last pass first
  const long long row_bytes = static_cast<long long>(W) * bits / 8;
  uint8_t* codes = out + slice + 4LL * wg + m * G * row_bytes +
                   static_cast<long long>(c0) * bits / 8;
  float sv[kUnit];
#pragma unroll
  for (int j = 0; j < kUnit; ++j) sv[j] = safe[(cx * kUnit + j) / group];
  for (int p = passes - 1; p >= 0; --p) {
    if (p != passes - 1) load(p);
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int r = p * pass_rows + ry + k * row_groups;
      if (r >= G) continue;
      float v[kUnit];
      raw[k].widen(v);
      uint8_t* dst = codes + r * row_bytes;
      if (bits == 8) {
        uint32_t w[2] = {0u, 0u};
#pragma unroll
        for (int j = 0; j < kUnit; ++j)
          w[j / 4] |= (static_cast<uint32_t>(code(v[j], sv[j], qmax)) & 0xFFu)
                      << (8 * (j % 4));
        if ((reinterpret_cast<uintptr_t>(dst) & 7) == 0) {
          *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
        } else {
          reinterpret_cast<uint32_t*>(dst)[0] = w[0];
          reinterpret_cast<uint32_t*>(dst)[1] = w[1];
        }
      } else {
        uint32_t w = 0u;
#pragma unroll
        for (int j = 0; j < kUnit; ++j)
          w |= static_cast<uint32_t>(code(v[j], sv[j], qmax) + 8)
               << (4 * j);
        *reinterpret_cast<uint32_t*>(dst) = w;
      }
    }
  }
}

template <typename InT>
int launch(const void* x, long long s_layer, long long s_mat, long long s_tok,
           void* out, long long chunk_bytes, int L, int N, int G, int W,
           const long long* offset, const int* bits, const int* group,
           int strip, int row_groups, void* stream) {
  const int units = strip / kUnit;
  if (L < 1 || L > kMaxLayers || N < 1 || N > 65535 || G < 1 || W < kUnit ||
      W % kUnit != 0 || strip < kUnit || strip % kUnit != 0 ||
      strip > kMaxStrip || row_groups < 1 || units * row_groups > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  Layers layers;
  for (int l = 0; l < L; ++l) {
    if ((bits[l] != 8 && bits[l] != 4) || group[l] < 1 ||
        strip % group[l] != 0 || W % group[l] != 0 || offset[l] % 4 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    layers.offset[l] = offset[l];
    layers.bits[l] = bits[l];
    layers.group[l] = group[l];
  }
  const int threads = units * row_groups;
  const size_t smem = (static_cast<size_t>(threads) * kUnit + 2 * strip) *
                      sizeof(float);
  const dim3 grid((W + strip - 1) / strip, 2 * L, N);
  encode_kernel<InT><<<grid, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const InT*>(x), s_layer, s_mat, s_tok,
      static_cast<uint8_t*>(out), chunk_bytes, G, W, strip, row_groups,
      layers);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in_kind: 0 = fp32, 1 = bf16.  Strides in elements; a token row of W
// channels is contiguous, x and every stride 16-byte aligned (the wrapper
// checks).  offset/bits/group: L entries each.  The geometry (strip,
// row_groups) is `encode_plan`'s.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int kv_quant_encode(const void* x, int in_kind, long long s_layer,
                               long long s_mat, long long s_tok, void* out,
                               long long chunk_bytes, int L, int N, int G,
                               int W, const long long* offset,
                               const int* bits, const int* group, int strip,
                               int row_groups, void* stream) {
  if (in_kind == 0)
    return launch<float>(x, s_layer, s_mat, s_tok, out, chunk_bytes, L, N, G,
                         W, offset, bits, group, strip, row_groups, stream);
  if (in_kind == 1)
    return launch<__nv_bfloat16>(x, s_layer, s_mat, s_tok, out, chunk_bytes,
                                 L, N, G, W, offset, bits, group, strip,
                                 row_groups, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
