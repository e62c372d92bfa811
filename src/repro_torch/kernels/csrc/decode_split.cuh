// The split-decode loop of the port (sm_90a): one query token per sequence
// against a slice of its cache, templated on the policy that reads cache
// rows.  K5 (decode_attention.cu) instantiates it with a loader of fp32 or
// bf16 rows, K6 (decode_attention_quant.cu) with one that dequantizes packed
// int8/int4 rows.
//
// Decode attention reads each cache byte once and does little arithmetic on
// it, so the card's memory rate bounds it, and at batch 1 the rate is set by
// how many bytes are in flight: about 25 KB per SM at 3.35 TB/s (Little's
// law).  So:
//   - the host cuts S into splits of at least 128 tokens, enough of them
//     that B x KV x splits fill two waves of the 132 SMs
//     (`decode_split_tokens` in decode_attention.py); one CTA of 128
//     threads takes one split of one KV head (and up to kHeadBlock of its
//     query heads);
//   - a warp streams its own rows with no block barrier in the loop: the
//     lanes of a row load a raw word each straight to registers (16 bytes:
//     16 lanes per bf16 row at dh 128, 32 per fp32 row; the 8 or 4 bytes of
//     8 packed codes: 16 lanes per int8 or int4 row), a warp holds kU steps
//     of rows in flight (4 KB of K/V per warp at llama's bf16 and int8
//     shapes, 2 KB at int4: a narrower word takes twice the steps; the next
//     batch's K loading while this batch's V is used), computes the dot
//     products for all query heads held in registers, reduces each across
//     the row's lanes with shuffles and keeps a private online softmax per
//     row slot;
//   - the row slots of a warp merge with shuffles, the warps once through
//     shared memory at the end, and the CTA writes its unnormalised partial
//     (acc, m, l) per query head, m in log2 units (m = max_t s_t log2(e),
//     p = exp2(s log2(e) - m));
//   - the last CTA of each (batch row, KV head, head block) to finish, found
//     with a counter in device memory that it resets to 0 for the next
//     call, merges the splits' partials with the log-sum-exp formula and
//     writes out (and, where the caller asks, m and l in the units of the
//     logits).  That saves a second kernel and the gap before its
//     launch, for a counter whose contents outlive the call.  The counters
//     are the caller's: one zeroed buffer per stream, so that two calls
//     that may run at once never share one.
// Rows at or past the length are never read, so stale values there (even
// NaN) cannot reach the result; a CTA whose split starts at or past the
// length exits at once and the merge reads only the splits below it; a row
// of length 0 gets out = 0, m = -inf, l = 0.
//
// The loader (template parameter `Loader`) has
//   Raw: the word a lane loads per chunk (16 bytes, or less);
//   kChunk: channels per chunk of a row;
//   raw(value, b, kh, t, chunk): chunk `chunk` of token t's K (value false)
//     or V row of KV head kh, batch row b;
//   Cursor: what a lane keeps between its rows of K and of V (a loader
//     that dequantizes keeps its channels' scales while the rows stay in
//     one chunk of tokens); a lane's rows come in increasing t;
//   widen(value, cursor, b, kh, t, chunk, raw, x): those channels as fp32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ds {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kHeadBlock = 8;  // most query heads of one KV head per CTA

// partial index of (b, kh, split, g)
__device__ __forceinline__ long long part(int b, int kh, int s, int g, int KV,
                                          int nsplit, int gs) {
  return ((static_cast<long long>(b) * KV + kh) * nsplit + s) * gs + g;
}

__device__ __forceinline__ int clamp_length(const int* lengths, int b,
                                            int S) {
  const int len = lengths[b];
  return len < 0 ? 0 : (len > S ? S : len);
}

// The log-sum-exp merge of the n_active splits' partials of query heads
// g0 .. g0 + ng of KV head kh, batch row b, by one CTA: out =
// sum_s w_s acc_s / sum_s w_s l_s with w_s = exp2(m_s - m), m the largest
// m_s (log2 units).  A thread owns a float4 column of one head's output and
// folds the splits in kMergeLoads at a time, with every load of a batch
// (m_s, l_s and the column) in flight together and the running max
// rescaled between batches, as the online softmax does: at llama's shape
// (33 splits) two rounds of memory latency and no barrier.  The partials
// were written by other CTAs: read them through L2 (__ldcg), not a stale
// L1.
constexpr int kMergeLoads = 24;

template <int kDH, typename T>
__device__ __forceinline__ void merge_splits(
    const float* pacc, const float* pm, const float* pl, T* out,
    float* m_out, float* l_out, int b, int kh, int g0, int ng, int H,
    int KV, int n_active, int nsplit) {
  const int gs = H / KV;
  constexpr int kCols = kDH / 4;
  for (int item = threadIdx.x; item < ng * kCols; item += kThreads) {
    const int g = item / kCols;
    const int c = item - g * kCols;
    float m = -INFINITY, l = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < n_active; s0 += kMergeLoads) {
      float ms[kMergeLoads], ls[kMergeLoads];
      float4 v[kMergeLoads];
#pragma unroll
      for (int j = 0; j < kMergeLoads; ++j) {
        if (s0 + j < n_active) {
          const long long i = part(b, kh, s0 + j, g0 + g, KV, nsplit, gs);
          ms[j] = __ldcg(pm + i);
          ls[j] = __ldcg(pl + i);
          v[j] = __ldcg(reinterpret_cast<const float4*>(pacc + i * kDH) + c);
        } else {
          ms[j] = -INFINITY;
        }
      }
      float mx = m;
#pragma unroll
      for (int j = 0; j < kMergeLoads; ++j) mx = fmaxf(mx, ms[j]);
      // every split below the length saw a row: mx is finite
      const float alpha = exp2f(m - mx);  // 0 while m = -inf
      l *= alpha;
      a.x *= alpha;
      a.y *= alpha;
      a.z *= alpha;
      a.w *= alpha;
#pragma unroll
      for (int j = 0; j < kMergeLoads; ++j) {
        if (s0 + j < n_active) {
          const float w = exp2f(ms[j] - mx);
          l = fmaf(w, ls[j], l);
          a.x = fmaf(w, v[j].x, a.x);
          a.y = fmaf(w, v[j].y, a.y);
          a.z = fmaf(w, v[j].z, a.z);
          a.w = fmaf(w, v[j].w, a.w);
        }
      }
      m = mx;
    }
    const long long row = static_cast<long long>(b) * H + kh * gs + g0 + g;
    if (m_out != nullptr && c == 0) {  // log2 -> natural units, once
      m_out[row] = m * 0.6931471805599453f;
      l_out[row] = l;
    }
    const float den = fmaxf(l, 1e-30f);
    T* o = out + row * kDH + 4 * c;
    o[0] = static_cast<T>(a.x / den);
    o[1] = static_cast<T>(a.y / den);
    o[2] = static_cast<T>(a.z / den);
    o[3] = static_cast<T>(a.w / den);
  }
}

// one CTA per (split, KV head x head block, batch row); kG >= the heads of
// a block (4 or 8); q and out [B, H, dh]; m_out and l_out [B, H] or null;
// partials [B, KV, nsplit, H/KV, (dh)]; counters [B, KV x head blocks],
// zero between calls
template <int kDH, int kG, typename TQ, class Loader>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const Loader ld, const TQ* __restrict__ q,
                    const int* __restrict__ lengths, TQ* __restrict__ out,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    float* __restrict__ pacc, float* __restrict__ pm,
                    float* __restrict__ pl, int* __restrict__ counters,
                    int S, int H, int KV, int split, float sm_scale) {
  using Raw = typename Loader::Raw;
  constexpr int kC = Loader::kChunk;
  constexpr int kCPR = kDH / kC;                // chunks per row
  constexpr int kLPR = kCPR < 32 ? kCPR : 32;   // lanes per row
  constexpr int kCPL = kCPR / kLPR;             // chunks per lane
  constexpr int kRPS = 32 / kLPR;               // rows per warp step
  constexpr int kE = kCPL * kC;                 // channels per lane
  // steps in flight: a narrower word takes more (at most twice as many:
  // the logits of a batch stay in registers)
  constexpr int kU = (16 / (kG * kCPL) > 0 ? 16 / (kG * kCPL) : 1) *
                     (sizeof(Raw) < 16 ? 2 : 1);
  constexpr int kStride = kWarps * kRPS;        // rows between a warp's steps
  static_assert(kCPR % kLPR == 0 && 32 % kLPR == 0, "row layout");

  const int gs = H / KV;
  const int n_hb = (gs + kHeadBlock - 1) / kHeadBlock;
  const int kh = blockIdx.y / n_hb;
  const int g0 = (blockIdx.y % n_hb) * kHeadBlock;
  const int ng = gs - g0 < kHeadBlock ? gs - g0 : kHeadBlock;
  const int b = blockIdx.z;
  const int si = blockIdx.x;
  const int len = clamp_length(lengths, b, S);
  const long long s0 = static_cast<long long>(si) * split;
  if (s0 >= len) {  // the merge reads only splits below the length
    if (len == 0 && si == 0) {  // a row that sees no key gets 0
      const long long row0 = static_cast<long long>(b) * H + kh * gs + g0;
      for (int i = threadIdx.x; i < ng * kDH; i += kThreads)
        out[row0 * kDH + i] = static_cast<TQ>(0.f);
      if (m_out != nullptr && threadIdx.x < ng) {
        m_out[row0 + threadIdx.x] = -INFINITY;
        l_out[row0 + threadIdx.x] = 0.f;
      }
    }
    return;
  }
  const long long s1 = s0 + split < len ? s0 + split : len;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / kLPR;  // the row slot of this lane in a step
  const int cl = lane % kLPR;   // its lane within the row
  // channel of element e = c * kC + j of this lane: (cl + c kLPR) kC + j
  auto channel = [&](int e) { return (cl + (e / kC) * kLPR) * kC + e % kC; };

  // A warp's batches start at rows tw = s0 + warp kRPS, tw + kU kStride,
  // ...; this lane's step u of a batch is row tw + u kStride + sub (the loop
  // bound is the same for the whole warp).  The loop is software-pipelined:
  // the next batch's K rows load while this batch's V rows are used, and
  // its V rows while its logits are computed.  Rows at or past s1 are not
  // loaded.  The first batch is asked for before q.
  const long long batch = static_cast<long long>(kU) * kStride;
  typename Loader::Cursor kcur{}, vcur{};
  Raw kr[kU][kCPL], vr[kU][kCPL];
  auto load = [&](Raw(&r)[kU][kCPL], bool value, long long tw) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const long long t = tw + u * kStride + sub;
#pragma unroll
      for (int c = 0; c < kCPL; ++c)
        r[u][c] = t < s1 ? ld.raw(value, b, kh, t, cl + c * kLPR) : Raw{};
    }
  };
  long long tw = s0 + warp * kRPS;
  load(kr, false, tw);
  load(vr, true, tw);
  // q in registers; the raw logits q . k become log2 units in one fused
  // multiply-add against the running max m (log2 units, rounded once per
  // step), so that m's rounding is common to a slot's terms and cancels
  const float scale_log2 = sm_scale * 1.4426950408889634f;
  float qr[kG][kE];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int e = 0; e < kE; ++e)
      qr[g][e] = g < ng ? static_cast<float>(
                              q[(static_cast<long long>(b) * H + kh * gs + g0 +
                                 g) * kDH + channel(e)])
                        : 0.f;
  float m[kG], l[kG], acc[kG][kE];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[g][e] = 0.f;
  }

  for (; tw < s1; tw += batch) {
    float s[kU][kG];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const long long t = tw + u * kStride + sub;
      float kx[kE];
#pragma unroll
      for (int c = 0; c < kCPL; ++c)
        ld.widen(false, kcur, b, kh, t, cl + c * kLPR, kr[u][c],
                 *reinterpret_cast<float(*)[kC]>(kx + c * kC));
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kE; ++e) dot = fmaf(qr[g][e], kx[e], dot);
#pragma unroll
        for (int off = kLPR / 2; off > 0; off /= 2)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[u][g] = t < s1 ? dot : -INFINITY;
      }
    }
    load(kr, false, tw + batch);
    float safe[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float tmax = s[0][g];
#pragma unroll
      for (int u = 1; u < kU; ++u) tmax = fmaxf(tmax, s[u][g]);
      const float m_new = fmaxf(m[g], tmax * scale_log2);
      // a slot with no row seen yet keeps m = -inf: guard the exponents
      safe[g] = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = m[g] == -INFINITY ? 0.f : exp2f(m[g] - safe[g]);
      m[g] = m_new;
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const long long t = tw + u * kStride + sub;
      if (t >= s1) continue;
      float vx[kE];
#pragma unroll
      for (int c = 0; c < kCPL; ++c)
        ld.widen(true, vcur, b, kh, t, cl + c * kLPR, vr[u][c],
                 *reinterpret_cast<float(*)[kC]>(vx + c * kC));
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float p = exp2f(fmaf(s[u][g], scale_log2, -safe[g]));
        l[g] += p;
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[g][e] = fmaf(p, vx[e], acc[g][e]);
      }
    }
    load(vr, true, tw + batch);
  }

  // merge the row slots of the warp (lanes kLPR apart hold the same
  // channels of different slots)
#pragma unroll
  for (int off = kLPR; off < 32; off *= 2) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float safe = mn == -INFINITY ? 0.f : mn;
      const float ws = m[g] == -INFINITY ? 0.f : exp2f(m[g] - safe);
      const float wo = mo == -INFINITY ? 0.f : exp2f(mo - safe);
      l[g] = l[g] * ws + lo * wo;
#pragma unroll
      for (int e = 0; e < kE; ++e)
        acc[g][e] = acc[g][e] * ws +
                    __shfl_xor_sync(0xffffffffu, acc[g][e], off) * wo;
      m[g] = mn;
    }
  }

  // then the warps, once, through shared memory
  __shared__ float sm_m[kWarps][kG], sm_l[kWarps][kG];
  __shared__ float sm_acc[kWarps][kG][kDH];
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
#pragma unroll
      for (int e = 0; e < kE; ++e) sm_acc[warp][g][channel(e)] = acc[g][e];
      if (cl == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  const int nsplit = gridDim.x;
  for (int i = threadIdx.x; i < ng * kDH; i += kThreads) {
    const int g = i / kDH;
    const int d = i - g * kDH;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float a = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt =
          sm_m[w][g] == -INFINITY ? 0.f : exp2f(sm_m[w][g] - mx);
      a = fmaf(wt, sm_acc[w][g][d], a);
      den = fmaf(wt, sm_l[w][g], den);
    }
    const long long pi = part(b, kh, si, g0 + g, KV, nsplit, gs);
    pacc[pi * kDH + d] = a;
    if (d == 0) {
      pm[pi] = mx;
      pl[pi] = den;
    }
  }

  // The last CTA of this (b, KV head, head block) to finish merges the
  // splits' partials and resets the counter for the next call.  The
  // barrier orders the CTA's partials before thread 0's count, whose
  // acquire-release atomic publishes them and, in the last CTA, acquires
  // every other CTA's.
  __shared__ bool last;
  __syncthreads();
  const int n_active = static_cast<int>((len + split - 1) / split);
  int* counter = counters + static_cast<long long>(b) * gridDim.y +
                 blockIdx.y;
  if (threadIdx.x == 0) {
    int before;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                 : "=r"(before)
                 : "l"(counter)
                 : "memory");
    last = before == n_active - 1;
  }
  __syncthreads();
  if (!last) return;
  merge_splits<kDH>(pacc, pm, pl, out, m_out, l_out, b, kh, g0, ng, H, KV,
                    n_active, nsplit);
  if (threadIdx.x == 0) *counter = 0;
}

}  // namespace ds
