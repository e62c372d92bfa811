// K7: fused dequant + flash attention over a packed-resident prefix,
// hand-written for Hopper (sm_90a).  Plain C interface, bound from Python with
// ctypes (repro_torch/kernels/flash_attention.py); the launch goes on the
// caller's stream and the entry point returns cudaGetLastError().
//
// Replaces src/repro/kernels/flash_attention.py:237 `flash_attention_quant`
// (its `pallas_call`, body `_quant_kernel`).
//
// What it computes, for q [B, Sq, H, dh] (fp32 or bf16) over a packed cache
// k_q/v_q [B, Sk, KV, dh'] with per-chunk scale rows [B, Sk/G, KV*dh/group]:
// for query row i of head h (KV head h / (H/KV)), logits
// s_j = (q_i . k_j) * (1/sqrt(dh)) in fp32 over the dequantized keys
// (K3, dequant_tile.cuh), masked to j <= q_offset + i when `causal`;
// m = max_j s_j, l = sum_j exp(s_j - m), out = (sum_j exp(s_j - m) v_j) / l,
// rounded once to q's type; m and l are written in fp32 so a caller can merge
// the result with attention over other keys.  A row that sees no key gets
// out = 0, m = -inf, l = 0.
//
// Bound: operations.  At the serving path's shape (B=1, Sq=256, Sk=3840,
// H=32, KV=8, dh=128, int8) the work is 4*Sq*H*Sk*dh = 16.1 GFLOP of fp32
// products (the reference's fp32 contraction; no tensor cores in this
// version): 240 us at the 67 TFLOP/s fp32 peak, against 12.2 MB of bytes
// (3.6 us).  The same work on bf16 tensor cores would take about 16 us: the
// target of a later redesign.
//
// Design: one CTA of 256 threads per (64 query vectors, KV head, batch row).
// A query vector is one (row, head) pair of the H/KV heads that share the KV
// head, so each dequantized K/V tile in shared memory serves all of them
// (H/KV = 4 at the path's shape: 16 rows x 4 heads, 16 x 8 = 128 CTAs).
// Keys go in tiles of 32 tokens: K3 expands the K and V tiles into fp32 shared
// memory, then each thread owns 4 vectors x 2 keys of the logits and 4
// vectors x dh/16 channels of the output, kept in registers; the 16 threads
// that share a vector reduce the row max and sum with shuffles and pass the
// probabilities through shared memory inside their warp.  fp32 FMA throughout;
// rows padded by 4 floats so the 16-byte shared loads do not collide.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dequant_tile.cuh"

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

template <typename T, int kBits, int kDH>
__global__ void __launch_bounds__(kThreads)
flash_quant_kernel(const T* __restrict__ q, const uint8_t* __restrict__ kq,
                   const uint8_t* __restrict__ vq,
                   const __half* __restrict__ ks,
                   const __half* __restrict__ vs, T* __restrict__ out,
                   float* __restrict__ m_out, float* __restrict__ l_out,
                   int Sq, int Sk, int H, int KV, int G, int group,
                   int causal, long long q_offset, float sm_scale) {
  constexpr int kLd = kDH + 4;
  constexpr int kDPT = kDH / kXG;  // output channels per thread
  constexpr long long kRowWords = kBits == 8 ? kDH : kDH / 2;
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
  const int ng = KV * kDH / group;
  const long long n_vec = static_cast<long long>(Sq) * gs;
  const long long v0 = static_cast<long long>(blockIdx.x) * kVecs;

  for (int e = tid; e < kVecs * kDH; e += kThreads) {
    const int vl = e / kDH;
    const int d = e - vl * kDH;
    const long long v = v0 + vl;
    float x = 0.f;
    if (v < n_vec) {
      const long long row = v / gs;
      const int g = static_cast<int>(v - row * gs);
      x = k3::to_f32(q[((static_cast<long long>(b) * Sq + row) * H +
                        kh * gs + g) * kDH + d]);
    }
    qs[vl * kLd + d] = x;
  }

  // keys this CTA's rows can see
  const long long v_last = (v0 + kVecs < n_vec ? v0 + kVecs : n_vec) - 1;
  long long k_end = Sk;
  if (causal) {
    const long long bound = q_offset + v_last / gs + 1;
    k_end = bound < k_end ? bound : k_end;
  }

  long long row_abs[kVPT];  // absolute position of each vector's row
  float m[kVPT], l[kVPT], acc[kVPT][kDPT];
#pragma unroll
  for (int i = 0; i < kVPT; ++i) {
    const long long v = v0 + vg + kVG * i;
    row_abs[i] = q_offset + v / gs;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < kDPT; ++d) acc[i][d] = 0.f;
  }

  const long long cache_rows = static_cast<long long>(Sk) * KV * kRowWords;
  const uint8_t* kb = kq + b * cache_rows;
  const uint8_t* vb = vq + b * cache_rows;
  const long long scale_rows = static_cast<long long>(Sk / G) * ng;
  const __half* ksb = ks + b * scale_rows;
  const __half* vsb = vs + b * scale_rows;

  for (long long t0 = 0; t0 < k_end; t0 += kTK) {
    __syncthreads();  // the previous tile is no longer read
    k3::dequant_tile<kBits, kDH, kTK, kThreads>(kb, ksb, KV, kh, G, ng,
                                                group, t0, k_end, kt, kLd);
    k3::dequant_tile<kBits, kDH, kTK, kThreads>(vb, vsb, KV, kh, G, ng,
                                                group, t0, k_end, vt, kLd);
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
        const bool seen = key < k_end && (!causal || row_abs[i] >= key);
        s[i][j] = seen ? s[i][j] * sm_scale : -INFINITY;
        tmax = fmaxf(tmax, s[i][j]);
      }
#pragma unroll
      for (int off = kXG / 2; off > 0; off /= 2)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
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
    for (int k = 0; k < kTK; ++k) {
      float vv[kDPT];
#pragma unroll
      for (int d = 0; d < kDPT; ++d) vv[d] = vt[k * kLd + xg * kDPT + d];
#pragma unroll
      for (int i = 0; i < kVPT; ++i) {
        const float p = ps[(vg + kVG * i) * kPs + k];
#pragma unroll
        for (int d = 0; d < kDPT; ++d) acc[i][d] = fmaf(p, vv[d], acc[i][d]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kVPT; ++i) {
    const long long v = v0 + vg + kVG * i;
    if (v >= n_vec) continue;
    const long long row = v / gs;
    const int head = kh * gs + static_cast<int>(v - row * gs);
    const long long o = (static_cast<long long>(b) * Sq + row) * H + head;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int d = 0; d < kDPT; ++d)
      k3::store(out + o * kDH + xg * kDPT + d, acc[i][d] / den);
    if (xg == 0) {
      m_out[o] = m[i];
      l_out[o] = l[i];
    }
  }
}

template <typename T, int kBits, int kDH>
int launch(const void* q, const void* kq, const void* vq, const void* ks,
           const void* vs, void* out, void* m, void* l, long long B,
           long long Sq, long long Sk, long long H, long long KV, long long G,
           long long group, int causal, long long q_offset, float sm_scale,
           cudaStream_t st) {
  auto kernel = flash_quant_kernel<T, kBits, kDH>;
  const size_t smem = smem_bytes<kDH>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_vec = Sq * (H / KV);
  const dim3 grid(static_cast<unsigned int>((n_vec + kVecs - 1) / kVecs),
                  static_cast<unsigned int>(KV), static_cast<unsigned int>(B));
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const uint8_t*>(kq),
      static_cast<const uint8_t*>(vq), static_cast<const __half*>(ks),
      static_cast<const __half*>(vs), static_cast<T*>(out),
      static_cast<float*>(m), static_cast<float*>(l), static_cast<int>(Sq),
      static_cast<int>(Sk), static_cast<int>(H), static_cast<int>(KV),
      static_cast<int>(G), static_cast<int>(group), causal, q_offset,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kBits>
int launch_dh(long long dh, const void* q, const void* kq, const void* vq,
              const void* ks, const void* vs, void* out, void* m, void* l,
              long long B, long long Sq, long long Sk, long long H,
              long long KV, long long G, long long group, int causal,
              long long q_offset, float sm_scale, cudaStream_t st) {
  switch (dh) {
    case 64:
      return launch<T, kBits, 64>(q, kq, vq, ks, vs, out, m, l, B, Sq, Sk, H,
                                  KV, G, group, causal, q_offset, sm_scale,
                                  st);
    case 128:
      return launch<T, kBits, 128>(q, kq, vq, ks, vs, out, m, l, B, Sq, Sk,
                                   H, KV, G, group, causal, q_offset,
                                   sm_scale, st);
    case 256:
      return launch<T, kBits, 256>(q, kq, vq, ks, vs, out, m, l, B, Sq, Sk,
                                   H, KV, G, group, causal, q_offset,
                                   sm_scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q_kind: 0 = fp32, 1 = bf16 (q and out); bits: 8 or 4; dh: 64, 128 or 256.
// m and l are fp32 [B, Sq, H].  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a kind, width or head_dim it was not built for).
extern "C" int flash_attention_quant(
    const void* q, const void* kq, const void* vq, const void* ks,
    const void* vs, void* out, void* m, void* l, long long B, long long Sq,
    long long Sk, long long H, long long KV, long long dh, long long G,
    long long group, int bits, int q_kind, int causal, long long q_offset,
    float sm_scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_kind == 0 && bits == 8)
    return launch_dh<float, 8>(dh, q, kq, vq, ks, vs, out, m, l, B, Sq, Sk,
                               H, KV, G, group, causal, q_offset, sm_scale,
                               st);
  if (q_kind == 0 && bits == 4)
    return launch_dh<float, 4>(dh, q, kq, vq, ks, vs, out, m, l, B, Sq, Sk,
                               H, KV, G, group, causal, q_offset, sm_scale,
                               st);
  if (q_kind == 1 && bits == 8)
    return launch_dh<__nv_bfloat16, 8>(dh, q, kq, vq, ks, vs, out, m, l, B,
                                       Sq, Sk, H, KV, G, group, causal,
                                       q_offset, sm_scale, st);
  if (q_kind == 1 && bits == 4)
    return launch_dh<__nv_bfloat16, 4>(dh, q, kq, vq, ks, vs, out, m, l, B,
                                       Sq, Sk, H, KV, G, group, causal,
                                       q_offset, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
