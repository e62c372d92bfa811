// The CUDA-core flash-attention loop of the port (sm_90a), over fp32 tiles
// in shared memory, templated on the policy that fills them and places the
// query rows.  It takes fp32 queries, which the tensor cores would take
// only as TF32 (10 bits of mantissa, beyond the 1e-5 fp32 tolerance), so
// it is bounded by the 67 TFLOP/s fp32 peak.  K4's fp32 path
// (flash_attention.cu) instantiates it with plain tile copies
// (`load_fp_tile` below), K7's fp32 path (flash_attention_quant.cu) with
// K3's tile dequant (dequant_tile.cuh).
//
// One CTA of 256 threads per (64 query vectors, KV head, batch row); a
// query vector is one (row, head) pair of the H/KV heads that share the KV
// head, so each K/V tile in shared memory serves the whole GQA group.
// Vector v is query row v / (H/KV) of head kh (H/KV) + v % (H/KV), wherever
// the policy keeps that row (`row(b, head, r)`: its element offset in q and
// out).  Keys go in tiles of 32 tokens; each thread owns 4 vectors x 2 keys
// of the logits and 4 vectors x dh/16 channels of the output in registers;
// the 16 threads that share a vector reduce the row max and sum with
// shuffles and pass the probabilities through shared memory inside their
// warp.  Rows padded by 4 floats so the 16-byte shared loads do not
// collide.  With `causal`, row r sees key j iff q_offset + r >= j; a CTA
// stops at the last key its rows can see, and the CTAs of the last rows,
// which see the most keys, are started first.  m = max_j s_j and
// l = sum_j exp(s_j - m) are written where the caller asks for them (m_out
// and l_out non-null, indexed by row offset / dh).
//
// The policy (template parameter `T`) has
//   row(b, head, r): the element offset of query row r of head `head` in q
//     and out;
//   load(value, b, kh, t0, t_end, dst, ld): tokens [t0, t0 + 32) of KV head
//     kh's K (value false) or V as fp32 into dst[r * ld + c], zeros at or
//     past t_end, called by all 256 threads (the loop synchronises).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ff {

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

// Copy tokens [t0, t0 + kTK) of an fp32 [tokens, kDH] plane into shared
// memory, dst[r * ld + c] (dst 16-byte aligned, ld a multiple of 4); rows
// at or past `t_end` are written as zeros and never read from memory, so
// stale or padded values past the end cannot reach the sums.  One step
// loads 8 consecutive channels of one token as two float4 (rows 16-byte
// aligned).
template <int kDH>
__device__ __forceinline__ void load_fp_tile(const float* __restrict__ base,
                                             long long t0, long long t_end,
                                             float* dst, int ld) {
  constexpr int kUnitsPerRow = kDH / 8;
  for (int u = threadIdx.x; u < kTK * kUnitsPerRow; u += kThreads) {
    const int r = u / kUnitsPerRow;
    const int c = (u - r * kUnitsPerRow) * 8;
    const long long t = t0 + r;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (t < t_end) {
      const float4* p = reinterpret_cast<const float4*>(base + t * kDH + c);
      a = __ldg(p);
      b = __ldg(p + 1);
    }
    float4* d4 = reinterpret_cast<float4*>(dst + r * ld + c);
    d4[0] = a;
    d4[1] = b;
  }
}

template <int kDH, class T>
__global__ void __launch_bounds__(kThreads)
flash_fp32_kernel(const T tiles, const float* __restrict__ q,
                  float* __restrict__ out, float* __restrict__ m_out,
                  float* __restrict__ l_out, int Sq, int Sk, int H, int KV,
                  int causal, long long q_offset, float sm_scale) {
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
  // element offset of vector vi's row in q and out
  auto row_of_vec = [&](long long vi) {
    const long long row = vi / gs;
    return tiles.row(b, kh * gs + static_cast<int>(vi - row * gs), row);
  };

  for (int e = tid; e < kVecs * kDH; e += kThreads) {
    const int vl = e / kDH;
    const int d = e - vl * kDH;
    const long long vi = v0 + vl;
    qs[vl * kLd + d] = vi < n_vec ? q[row_of_vec(vi) + d] : 0.f;
  }

  // keys this CTA's rows can see
  const long long v_last = (v0 + kVecs < n_vec ? v0 + kVecs : n_vec) - 1;
  long long k_end = Sk;
  if (causal) {
    const long long bound = q_offset + v_last / gs + 1;
    k_end = bound < k_end ? bound : k_end;
  }

  long long pos[kVPT];  // query position of each of this thread's vectors
  float m[kVPT], l[kVPT], acc[kVPT][kDPT];
#pragma unroll
  for (int i = 0; i < kVPT; ++i) {
    pos[i] = q_offset + (v0 + vg + kVG * i) / gs;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < kDPT; ++d) acc[i][d] = 0.f;
  }

  for (long long t0 = 0; t0 < k_end; t0 += kTK) {
    __syncthreads();  // the previous tile is no longer read
    tiles.load(false, b, kh, t0, k_end, kt, kLd);
    tiles.load(true, b, kh, t0, k_end, vt, kLd);
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
        const bool seen = key < k_end && (!causal || pos[i] >= key);
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
    const long long o = row_of_vec(vi);
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int d = 0; d < kDPT; ++d)
      out[o + xg * kDPT + d] = acc[i][d] / den;
    if (m_out != nullptr && xg == 0) {
      m_out[o / kDH] = m[i];
      l_out[o / kDH] = l[i];
    }
  }
}

// Launch the loop over B batch rows: a grid of (ceil(Sq * H/KV / 64), KV,
// B) CTAs.  Returns cudaGetLastError() after the launch.
template <int kDH, class T>
int launch(const T& tiles, const float* q, float* out, float* m, float* l,
           long long B, long long Sq, long long Sk, long long H, long long KV,
           int causal, long long q_offset, float sm_scale, cudaStream_t st) {
  auto kernel = flash_fp32_kernel<kDH, T>;
  const size_t smem = smem_bytes<kDH>();
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_vec = Sq * (H / KV);
  const dim3 grid(static_cast<unsigned int>((n_vec + kVecs - 1) / kVecs),
                  static_cast<unsigned int>(KV), static_cast<unsigned int>(B));
  kernel<<<grid, kThreads, smem, st>>>(
      tiles, q, out, m, l, static_cast<int>(Sq), static_cast<int>(Sk),
      static_cast<int>(H), static_cast<int>(KV), causal, q_offset, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ff
