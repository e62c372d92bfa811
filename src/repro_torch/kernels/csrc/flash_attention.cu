// K4: flash attention over fp32 or bf16 K/V (GQA, causal or full),
// hand-written for Hopper (sm_90a).  Plain C interface, bound from Python with
// ctypes (repro_torch/kernels/flash_attention.py); the launch goes on the
// caller's stream and the entry point returns cudaGetLastError().
//
// Replaces src/repro/kernels/flash_attention.py:106 `flash_attention` (its
// `pallas_call`, body `_kernel`).
//
// What it computes, for head-major q [B, H, Sq, dh] against k/v
// [B, KV, Sk, dh] (one dtype, fp32 or bf16): for query row i of head h (KV
// head h / (H/KV)), logits s_j = (q_i . k_j) * (1/sqrt(dh)) in fp32, masked
// with `causal` to j <= i (top-left aligned, as the TPU kernel's
// `rows >= cols`: row i sees key i whatever Sk - Sq is); m = max_j s_j,
// out = (sum_j exp(s_j - m) v_j) / max(sum_j exp(s_j - m), 1e-30), rounded
// once to q's type.
//
// Bound: operations.  At llama3-1-8b's cold prefill (B=1, Sq=Sk=4096, H=32,
// KV=8, dh=128, causal) the visible (query, key) pairs are
// 32 * 4096 * 4097 / 2, at 4*dh FLOP each: 137.5 GFLOP of fp32 products (the
// reference's fp32 contraction; no tensor cores in this version), 2.05 ms at
// the 67 TFLOP/s fp32 peak, against 83.9 MB of bytes (25 us).  On bf16 tensor
// cores the same work would take 0.14 ms: the target of a later redesign.
//
// Design: K7's (flash_attention_quant.cu) with the tiles loaded directly.
// One CTA of 256 threads per (64 query vectors, KV head, batch row); a query
// vector is one (row, head) pair of the H/KV heads that share the KV head, so
// each K/V tile in shared memory serves the whole GQA group (H/KV = 4 at
// llama's shape: 16 rows x 4 heads per CTA).  In the head-major layout the
// group's heads are H/KV separate [Sq, dh] planes; a vector v maps to row
// v / (H/KV) of plane v % (H/KV), for any group size.  Keys go in tiles of
// 32 tokens widened to fp32 shared memory (fp_tile.cuh); each thread owns 4
// vectors x 2 keys of the logits and 4 vectors x dh/16 channels of the output
// in registers; the 16 threads that share a vector reduce the row max and sum
// with shuffles.  Under `causal` a CTA stops at the last key its rows can see
// (the TPU kernel's skip of tiles above the diagonal), and the CTAs of the
// last rows, which see the most keys, are started first.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fp_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 64;  // query vectors per CTA
constexpr int kTK = 32;    // keys per tile
constexpr int kXG = 16;    // threads that share a vector
constexpr int kVG = kThreads / kXG;  // 16 vector groups
constexpr int kVPT = kVecs / kVG;    // 4 vectors per thread
constexpr int kKPT = kTK / kXG;      // 2 keys per thread
constexpr int kPs = kTK + 1;         // row stride of the probabilities

template <int kDH>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(kVecs) * (kDH + 4) +
          2 * static_cast<size_t>(kTK) * (kDH + 4) +
          static_cast<size_t>(kVecs) * kPs);
}

template <typename T, int kDH>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk,
             int H, int KV, int causal, float sm_scale) {
  constexpr int kLd = kDH + 4;
  constexpr int kDPT = kDH / kXG;  // output channels per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [kVecs][kLd]
  float* kt = qs + kVecs * kLd;     // [kTK][kLd]
  float* vt = kt + kTK * kLd;       // [kTK][kLd]
  float* ps = vt + kTK * kLd;       // [kVecs][kPs]

  const int gs = H / KV;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int vg = tid / kXG;
  const int xg = tid % kXG;
  const long long n_vec = static_cast<long long>(Sq) * gs;
  // the last vectors see the most keys under the causal mask: start first
  const long long v0 =
      static_cast<long long>(gridDim.x - 1 - blockIdx.x) * kVecs;
  // plane of (b, head) in q and out: [Sq, kDH]
  auto plane = [&](int head) {
    return (static_cast<long long>(b) * H + head) * Sq * kDH;
  };

  for (int e = tid; e < kVecs * kDH; e += kThreads) {
    const int vl = e / kDH;
    const int d = e - vl * kDH;
    const long long vi = v0 + vl;
    float x = 0.f;
    if (vi < n_vec) {
      const long long row = vi / gs;
      const int g = static_cast<int>(vi - row * gs);
      x = fpt::to_f32(q[plane(kh * gs + g) + row * kDH + d]);
    }
    qs[vl * kLd + d] = x;
  }

  // keys this CTA's rows can see
  const long long v_last = (v0 + kVecs < n_vec ? v0 + kVecs : n_vec) - 1;
  long long k_end = Sk;
  if (causal) {
    const long long bound = v_last / gs + 1;
    k_end = bound < k_end ? bound : k_end;
  }

  long long row_of[kVPT];  // query row of each of this thread's vectors
  float m[kVPT], l[kVPT], acc[kVPT][kDPT];
#pragma unroll
  for (int i = 0; i < kVPT; ++i) {
    row_of[i] = (v0 + vg + kVG * i) / gs;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < kDPT; ++d) acc[i][d] = 0.f;
  }

  const long long kv_plane = (static_cast<long long>(b) * KV + kh) * Sk * kDH;
  const T* kb = k + kv_plane;
  const T* vb = v + kv_plane;

  for (long long t0 = 0; t0 < k_end; t0 += kTK) {
    __syncthreads();  // the previous tile is no longer read
    fpt::load_tile<T, kDH, kTK, kThreads>(kb, kDH, t0, k_end, kt, kLd);
    fpt::load_tile<T, kDH, kTK, kThreads>(vb, kDH, t0, k_end, vt, kLd);
    __syncthreads();

    float s[kVPT][kKPT];
#pragma unroll
    for (int i = 0; i < kVPT; ++i)
#pragma unroll
      for (int j = 0; j < kKPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kDH; d += 4) {
      float4 qv[kVPT], kv[kKPT];
#pragma unroll
      for (int i = 0; i < kVPT; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (vg + kVG * i) * kLd + d);
#pragma unroll
      for (int j = 0; j < kKPT; ++j)
        kv[j] = *reinterpret_cast<const float4*>(kt + (xg + kXG * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < kVPT; ++i)
#pragma unroll
        for (int j = 0; j < kKPT; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < kVPT; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKPT; ++j) {
        const long long key = t0 + xg + kXG * j;
        const bool seen = key < k_end && (!causal || row_of[i] >= key);
        s[i][j] = seen ? s[i][j] * sm_scale : -INFINITY;
        tmax = fmaxf(tmax, s[i][j]);
      }
#pragma unroll
      for (int off = kXG / 2; off > 0; off /= 2)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      // a row with no key seen yet keeps m = -inf: guard the exponents
      const float m_new = fmaxf(m[i], tmax);
      const float safe = isfinite(m_new) ? m_new : 0.f;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kKPT; ++j) {
        const float p = isfinite(s[i][j]) ? expf(s[i][j] - safe) : 0.f;
        ps[(vg + kVG * i) * kPs + xg + kXG * j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = kXG / 2; off > 0; off /= 2)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float alpha = isfinite(m[i]) ? expf(m[i] - safe) : 0.f;
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < kDPT; ++d) acc[i][d] *= alpha;
    }
    __syncwarp();  // a vector's probabilities come from its own half-warp

#pragma unroll 4
    for (int kk = 0; kk < kTK; ++kk) {
      float vv[kDPT];
#pragma unroll
      for (int d = 0; d < kDPT; ++d) vv[d] = vt[kk * kLd + xg * kDPT + d];
#pragma unroll
      for (int i = 0; i < kVPT; ++i) {
        const float p = ps[(vg + kVG * i) * kPs + kk];
#pragma unroll
        for (int d = 0; d < kDPT; ++d) acc[i][d] = fmaf(p, vv[d], acc[i][d]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kVPT; ++i) {
    const long long vi = v0 + vg + kVG * i;
    if (vi >= n_vec) continue;
    const long long row = vi / gs;
    const int head = kh * gs + static_cast<int>(vi - row * gs);
    T* o = out + plane(head) + row * kDH + xg * kDPT;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int d = 0; d < kDPT; ++d) fpt::store(o + d, acc[i][d] / den);
  }
}

template <typename T, int kDH>
int launch(const void* q, const void* k, const void* v, void* out,
           long long B, long long Sq, long long Sk, long long H, long long KV,
           int causal, float sm_scale, cudaStream_t st) {
  auto kernel = flash_kernel<T, kDH>;
  const size_t smem = smem_bytes<kDH>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_vec = Sq * (H / KV);
  const dim3 grid(static_cast<unsigned int>((n_vec + kVecs - 1) / kVecs),
                  static_cast<unsigned int>(KV), static_cast<unsigned int>(B));
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), static_cast<int>(Sq),
      static_cast<int>(Sk), static_cast<int>(H), static_cast<int>(KV), causal,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(long long dh, const void* q, const void* k, const void* v,
              void* out, long long B, long long Sq, long long Sk, long long H,
              long long KV, int causal, float sm_scale, cudaStream_t st) {
  switch (dh) {
    case 64:
      return launch<T, 64>(q, k, v, out, B, Sq, Sk, H, KV, causal, sm_scale,
                           st);
    case 128:
      return launch<T, 128>(q, k, v, out, B, Sq, Sk, H, KV, causal, sm_scale,
                            st);
    case 256:
      return launch<T, 256>(q, k, v, out, B, Sq, Sk, H, KV, causal, sm_scale,
                            st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// kind: 0 = fp32, 1 = bf16 (q, k, v and out); dh: 64, 128 or 256.  q and out
// [B, H, Sq, dh], k and v [B, KV, Sk, dh], all contiguous and 16-byte
// aligned.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a kind or head_dim it was not built for).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, long long B, long long Sq,
                               long long Sk, long long H, long long KV,
                               long long dh, int kind, int causal,
                               float sm_scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    return launch_dh<float>(dh, q, k, v, out, B, Sq, Sk, H, KV, causal,
                            sm_scale, st);
  if (kind == 1)
    return launch_dh<__nv_bfloat16>(dh, q, k, v, out, B, Sq, Sk, H, KV,
                                    causal, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
