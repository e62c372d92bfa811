// K5: decode attention over an fp32 or bf16 cache, hand-written for Hopper
// (sm_90a).  Plain C interface, bound from Python with ctypes
// (repro_torch/kernels/decode_attention.py); both launches go on the caller's
// stream and the entry point returns cudaGetLastError().
//
// Replaces src/repro/kernels/decode_attention.py:130 `decode_attention` (its
// `pallas_call`, body `_kernel` / `_attend_block`).
//
// What it computes, for one query token per sequence, q [B, H, dh], over
// caches k/v [B, S, KV, dh] (one dtype, fp32 or bf16) and lengths [B]: for
// head h (KV head h / (H/KV)), logits s_t = (q . k_t) * (1/sqrt(dh)) in fp32
// for t < lengths[b] (clamped to [0, S]); m = max_t s_t,
// out = (sum_t exp(s_t - m) v_t) / max(sum_t exp(s_t - m), 1e-30), rounded
// once to q's type.  A row with length 0 gets out = 0, as the TPU kernel's.
// Cache rows at or past a row's length are never read, so stale or padded
// values there (even NaN) cannot reach the result.
//
// Bound: bytes.  At llama3-1-8b's decode after the cold prefill (B=1,
// S=4104, lengths [4097], H=32, KV=8, dh=128, bf16) the rows the lengths
// select are 16.8 MB of K/V: 5.0 us at 3.35 TB/s, against 67 MFLOP (1.0 us at
// the fp32 peak).
//
// Design: K6's (decode_attention_quant.cu) with the tiles loaded directly.
// The TPU kernel walked the cache in order, one program per sequence; copied
// block for block that would be 8 programs for 132 SMs at batch 1.  Here the
// cache is split: one CTA of 128 threads per (split of 64 tokens, KV head,
// batch row), 520 CTAs at llama's shape, each reading its share of the
// cache once.  A CTA widens its keys and values tile by tile (32 tokens) into
// fp32 shared memory (fp_tile.cuh) and keeps an online softmax for the H/KV
// query heads of its KV head; it writes its unnormalised partial sum with its
// (m, l).  A second small kernel merges the partials of each head with the
// log-sum-exp formula: weight exp(m_s - m) for split s,
// out = sum w_s acc_s / sum w_s l_s.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fp_tile.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTK = 32;        // tokens per tile
constexpr int kMaxGroup = 16;  // query heads per KV head
constexpr int kPs = kTK + 1;   // row stride of the logits/probabilities

template <int kDH>
size_t smem_bytes(int gs) {
  return sizeof(float) * (static_cast<size_t>(gs) * (kDH + 4) +
                          2 * static_cast<size_t>(kTK) * (kDH + 4) +
                          static_cast<size_t>(gs) * kPs + 3 * kMaxGroup);
}

// partial index of (b, kh, split, g)
__device__ __forceinline__ long long part(int b, int kh, int s, int g, int KV,
                                          int nsplit, int gs) {
  return ((static_cast<long long>(b) * KV + kh) * nsplit + s) * gs + g;
}

template <typename T, int kDH>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int* __restrict__ lengths,
                    float* __restrict__ pacc, float* __restrict__ pm,
                    float* __restrict__ pl, int S, int H, int KV, int split,
                    float sm_scale) {
  constexpr int kDPT = (kDH + kThreads - 1) / kThreads;  // channels/thread
  constexpr int kLd = kDH + 4;
  const int gs = H / KV;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;              // [gs][kLd]
  float* kt = qs + gs * kLd;     // [kTK][kLd]
  float* vt = kt + kTK * kLd;    // [kTK][kLd]
  float* ps = vt + kTK * kLd;    // [gs][kPs]
  float* sm_m = ps + gs * kPs;   // [kMaxGroup] running max
  float* sm_l = sm_m + kMaxGroup;  // running sum
  float* sm_a = sm_l + kMaxGroup;  // this tile's rescale factor

  const int si = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const long long s0 = static_cast<long long>(si) * split;
  const long long s1 = s0 + split < len ? s0 + split : len;

  for (int e = tid; e < gs * kDH; e += kThreads) {
    const int g = e / kDH;
    const int d = e - g * kDH;
    qs[g * kLd + d] = fpt::to_f32(
        q[(static_cast<long long>(b) * H + kh * gs + g) * kDH + d]);
  }
  if (tid < gs) {
    sm_m[tid] = -INFINITY;
    sm_l[tid] = 0.f;
  }
  float acc[kDPT][kMaxGroup];  // channel tid + kThreads * j, head g
#pragma unroll
  for (int j = 0; j < kDPT; ++j)
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) acc[j][g] = 0.f;

  // token t of KV head kh in batch row b: (b*S + t)*KV + kh rows of kDH
  const long long head0 = (static_cast<long long>(b) * S * KV + kh) * kDH;
  const long long row_stride = static_cast<long long>(KV) * kDH;
  const T* kb = kc + head0;
  const T* vb = vc + head0;

  for (long long t0 = s0; t0 < s1; t0 += kTK) {
    __syncthreads();  // the previous tile is no longer read
    fpt::load_tile<T, kDH, kTK, kThreads>(kb, row_stride, t0, s1, kt, kLd);
    fpt::load_tile<T, kDH, kTK, kThreads>(vb, row_stride, t0, s1, vt, kLd);
    __syncthreads();
    for (int pr = tid; pr < gs * kTK; pr += kThreads) {
      const int g = pr / kTK;
      const int k = pr - g * kTK;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < kDH; d += 4) {
        const float4 a = *reinterpret_cast<const float4*>(qs + g * kLd + d);
        const float4 c = *reinterpret_cast<const float4*>(kt + k * kLd + d);
        s = fmaf(a.x, c.x, s);
        s = fmaf(a.y, c.y, s);
        s = fmaf(a.z, c.z, s);
        s = fmaf(a.w, c.w, s);
      }
      ps[g * kPs + k] = t0 + k < s1 ? s * sm_scale : -INFINITY;
    }
    __syncthreads();
    for (int g = warp; g < gs; g += kWarps) {
      const float s = ps[g * kPs + lane];
      float tmax = s;
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_prev = sm_m[g];
      const float m_new = fmaxf(m_prev, tmax);
      const float safe = isfinite(m_new) ? m_new : 0.f;
      const float p = isfinite(s) ? expf(s - safe) : 0.f;
      float psum = p;
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      ps[g * kPs + lane] = p;
      if (lane == 0) {
        const float alpha = isfinite(m_prev) ? expf(m_prev - safe) : 0.f;
        sm_l[g] = sm_l[g] * alpha + psum;
        sm_m[g] = m_new;
        sm_a[g] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kDPT; ++j) {
      const int d = tid + kThreads * j;
      if (d >= kDH) continue;
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < gs) acc[j][g] *= sm_a[g];
      }
      for (int k = 0; k < kTK; ++k) {
        const float vv = vt[k * kLd + d];
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          if (g < gs) acc[j][g] = fmaf(ps[g * kPs + k], vv, acc[j][g]);
        }
      }
    }
  }
  __syncthreads();  // sm_m / sm_l written by the last tile
#pragma unroll
  for (int j = 0; j < kDPT; ++j) {
    const int d = tid + kThreads * j;
    if (d >= kDH) continue;
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < gs)
        pacc[part(b, kh, si, g, KV, nsplit, gs) * kDH + d] = acc[j][g];
    }
  }
  if (tid < gs) {
    pm[part(b, kh, si, tid, KV, nsplit, gs)] = sm_m[tid];
    pl[part(b, kh, si, tid, KV, nsplit, gs)] = sm_l[tid];
  }
}

// One CTA of dh threads per (batch row, head): the log-sum-exp merge of the
// splits' partials.  A row whose splits all saw no key gets 0.
template <typename T>
__global__ void decode_merge_kernel(const float* __restrict__ pacc,
                                    const float* __restrict__ pm,
                                    const float* __restrict__ pl,
                                    T* __restrict__ out, int H, int KV,
                                    int nsplit, int dh) {
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int gs = H / KV;
  const int kh = h / gs;
  const int g = h - kh * gs;
  const int d = threadIdx.x;
  float m = -INFINITY;
  for (int s = 0; s < nsplit; ++s)
    m = fmaxf(m, pm[part(b, kh, s, g, KV, nsplit, gs)]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const long long i = part(b, kh, s, g, KV, nsplit, gs);
    const float ms = pm[i];
    const float w = isfinite(ms) ? expf(ms - m) : 0.f;
    num = fmaf(w, pacc[i * dh + d], num);
    den = fmaf(w, pl[i], den);
  }
  fpt::store(out + (static_cast<long long>(b) * H + h) * dh + d,
             num / fmaxf(den, 1e-30f));
}

template <typename T, int kDH>
int launch(const void* q, const void* kc, const void* vc, const void* lengths,
           void* out, void* pacc, void* pm, void* pl, long long B, long long S,
           long long H, long long KV, long long split, float sm_scale,
           cudaStream_t st) {
  const int gs = static_cast<int>(H / KV);
  const long long nsplit = (S + split - 1) / split;
  const dim3 grid(static_cast<unsigned int>(nsplit),
                  static_cast<unsigned int>(KV), static_cast<unsigned int>(B));
  auto kernel = decode_split_kernel<T, kDH>;
  const size_t smem = smem_bytes<kDH>(gs);
  if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic memory
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int*>(lengths),
      static_cast<float*>(pacc), static_cast<float*>(pm),
      static_cast<float*>(pl), static_cast<int>(S), static_cast<int>(H),
      static_cast<int>(KV), static_cast<int>(split), sm_scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge_kernel<T><<<static_cast<unsigned int>(B * H), kDH, 0, st>>>(
      static_cast<const float*>(pacc), static_cast<const float*>(pm),
      static_cast<const float*>(pl), static_cast<T*>(out),
      static_cast<int>(H), static_cast<int>(KV), static_cast<int>(nsplit),
      kDH);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(long long dh, const void* q, const void* kc, const void* vc,
              const void* lengths, void* out, void* pacc, void* pm, void* pl,
              long long B, long long S, long long H, long long KV,
              long long split, float sm_scale, cudaStream_t st) {
  switch (dh) {
    case 64:
      return launch<T, 64>(q, kc, vc, lengths, out, pacc, pm, pl, B, S, H, KV,
                           split, sm_scale, st);
    case 128:
      return launch<T, 128>(q, kc, vc, lengths, out, pacc, pm, pl, B, S, H,
                            KV, split, sm_scale, st);
    case 256:
      return launch<T, 256>(q, kc, vc, lengths, out, pacc, pm, pl, B, S, H,
                            KV, split, sm_scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// kind: 0 = fp32, 1 = bf16 (q, caches and out); dh: 64, 128 or 256;
// H/KV <= 16.  q and out [B, H, dh], caches [B, S, KV, dh] (contiguous,
// 16-byte aligned), lengths int32 [B].  pacc [B, KV, nsplit, H/KV, dh], pm
// and pl [B, KV, nsplit, H/KV] (fp32, nsplit = ceil(S / split)) are the
// caller's scratch for the partials.  Returns cudaGetLastError() after the
// launches (cudaErrorInvalidValue for a kind or head_dim it was not built
// for).
extern "C" int decode_attention(const void* q, const void* kc, const void* vc,
                                const void* lengths, void* out, void* pacc,
                                void* pm, void* pl, long long B, long long S,
                                long long H, long long KV, long long dh,
                                int kind, long long split, float sm_scale,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H / KV > kMaxGroup || split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kind == 0)
    return launch_dh<float>(dh, q, kc, vc, lengths, out, pacc, pm, pl, B, S,
                            H, KV, split, sm_scale, st);
  if (kind == 1)
    return launch_dh<__nv_bfloat16>(dh, q, kc, vc, lengths, out, pacc, pm, pl,
                                    B, S, H, KV, split, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
