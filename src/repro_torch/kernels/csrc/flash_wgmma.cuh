// The tensor-core flash-attention loop of the port (sm_90a), over bf16 tiles
// in shared memory, templated on the policy that fills them and places the
// rows.  K4's bf16 path (flash_attention.cu) instantiates it with a TMA
// loader over head-major tensors; K7's bf16 path (flash_attention_quant.cu)
// with a loader that dequantizes packed int8/int4 codes into bf16 pieces.
//
// A CTA of 384 threads takes kRows = 128 query rows ("vectors") of one
// plane against the keys of the plane's KV head.  A plane is what the
// policy says: one head for K4, the H/KV heads of one KV head for K7 (so a
// dequantized tile serves the whole GQA group).  Vector v of a plane sits
// at query position v / gs (gs = 1 for K4, H/KV for K7).
//   - warps 0-7 are two consumer warpgroups of 64 rows each, grown to
//     consumer_regs() registers a thread (the 64 x dh output accumulator,
//     the 64 x kBK logits and the bf16 halves of p live in registers);
//   - warps 8-11 are the producer warpgroup, shrunk to the policy's
//     kProducerRegs: its first kLoaderThreads threads (one for TMA, all
//     128 for a loader that expands codes) ask the policy for the Q tile
//     once and then for K and V tiles of kBK keys into a ring of kStages
//     stages, each stage guarded by a "full" mbarrier per tile (K and V
//     apart, so the logits start before V has landed) and an "empty"
//     mbarrier that each of the 8 consumer warps arrives on when it is done
//     with the stage.
// A row block's keys may be cut into `nsplit` ranges of tiles, one CTA
// each (the grid's y is row blocks x nsplit), when the row blocks alone
// would leave SMs idle; the last CTA of a row block to finish merges the
// others' partials (scratch `pacc`, `pml`, one counter per row block that
// is zero between calls) with the log-sum-exp formula before the store.
// Per key tile a warpgroup computes S = Q K^T with wgmma (both operands
// K-major in shared memory, or Q from registers where the policy sets
// kQRegs, which halves the shared-memory bytes the logits read), masks and
// runs the online softmax on the accumulator fragment in registers (a
// thread holds rows r and r + 8 of its warp's 16; the row max and sum
// reduce over the quad of threads that share a row), and adds P V with
// wgmma, P from registers as the A operand (the
// fp32 accumulator fragment of S is, pair by pair, the bf16 A fragment of
// the product) and V read MN-major (transposed) from shared memory.  A
// tile's P V is left in flight while the warpgroup issues the next tile's
// logits: one wait covers both.
//
// Numerics: a K or V tile may come as kKPieces / kVPieces bf16 tiles whose
// sum is the value (a loader of bf16 data gives one).  The logits are fp32
// sums of exact bf16 products over every K piece, and p takes its exponent
// from the raw logit in one fused multiply-add against the row's running
// max (log2 units); p is split as p = p_hi + p_lo, both bf16, and P V adds
// p_hi V_0 + p_lo V_0 (+ p_hi V_1 with two V pieces; the dropped p_lo V_1
// is below 2^-16 p|v|) into the same fp32 accumulator, so P V keeps about
// 16 significant bits of p (a single bf16 p would move out by up to 2^-9
// sum p|v|); l sums the fp32 p.  out = acc / max(l, 1e-30), rounded once to
// bf16; m (max_j s_j, s_j = q.k_j / sqrt(dh)) is converted from log2 units
// once at the store.
//
// Masks: with `causal` vector v sees key j iff q_offset + v / gs >= j
// (K4: q_offset 0, gs 1, the top-left mask whatever Sk - Sq is); keys
// j >= Sk are masked to -inf (a loader's zero fill there gives s = 0, which
// must not count).  Only tiles that cross the diagonal or Sk are masked
// element by element; a warpgroup skips the products of tiles wholly above
// its rows' diagonal, and a CTA loads no tile past its last row's.  Rows
// >= n_vec are computed on zeros and never stored.  A row that sees no key
// gets out = 0, m = -inf, l = 0.
//
// The policy (template parameter `P`) is an object in kernel parameter
// space with
//   kDH, kBK, kStages, kKPieces, kVPieces, kQRegs, kProducerRegs,
//   kLoaderThreads, kArrivals (arrivals that complete a "full" barrier);
//   n_vec, gs, q_offset: vectors per plane, vectors per query position and
//     the position of query row 0;
//   kv_head(y): the KV head of plane y;
//   load_q(pt, dst, bar, b, y, v0): vectors [v0, v0 + 128) of plane y;
//   load_kv(pt, k_dst, k_bar, v_dst, v_bar, b, kh, t0, free): the K and V
//     tiles of keys [t0, t0 + kBK) of KV head kh, piece i at dst + i *
//     kTileBytes; it calls free() before it writes the stage (and may read
//     global memory before that, to overlap the wait);
//   out_row(b, y, v): the bf16 output row of vector v; store_ml(b, y, v, m,
//     l): its softmax residuals (a no-op where the caller takes none);
// the loads are called by producer threads pt < kLoaderThreads.  They fill
// `dst` (shared address, 1024-byte aligned) with the tile as bf16 panels of
// 64 channels, rows at 128 bytes, 128-byte swizzle (hopper.cuh), zeros past
// the tensor's end, and complete the mbarrier `bar`: kArrivals arrivals plus
// any transaction bytes they declare.  A loader that writes shared memory
// with ordinary stores has each writer call hop::fence_proxy_async() after
// its stores, since wgmma reads the tile through the async proxy, and
// arrives only after that: each writer (kArrivals = writers), or one after
// the writers meet at a named barrier.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace fw {

constexpr int kThreads = 384;  // two consumer warpgroups + a producer one
constexpr int kConsumers = 256;
constexpr int kProducers = 128;
constexpr int kRows = 128;  // query rows per CTA, 64 per warpgroup

// registers a consumer thread grows to: 2 x 128 x consumer + 128 x
// producer <= the CTA's registers at launch, 384 x 168 (65,536 / 384 in
// steps of 8); `setmaxnreg.inc` waits for registers the CTA does not hold
// (240 beside a producer of 24)
template <int kProducerRegs>
__host__ __device__ constexpr int consumer_regs() {
  return (kThreads / kProducers * (65536 / kThreads / 8 * 8) - kProducerRegs)
         / 2 / 8 * 8;
}

template <class P>
struct Shape {
  static_assert(P::kDH == 64 || P::kDH == 128 || P::kDH == 256, "head_dim");
  static_assert(P::kVPieces == 1 || P::kVPieces == 2, "V pieces");
  static constexpr uint32_t kQBytes = kRows * P::kDH * 2;
  static constexpr uint32_t kTileBytes = P::kBK * P::kDH * 2;  // one piece
  static constexpr uint32_t kKBytes = P::kKPieces * kTileBytes;  // a stage
  static constexpr uint32_t kVBytes = P::kVPieces * kTileBytes;
  // 1024 bytes of slack to align the tiles, then Q, K ring, V ring, barriers
  static constexpr size_t kSmem =
      1024 + kQBytes +
      P::kStages * static_cast<size_t>(kKBytes + kVBytes) + 64;
};

// keys [0, key_end) that vectors [v0, v0 + rows) of a plane can see
__device__ __forceinline__ int key_end(int v0, int rows, int n_vec, int gs,
                                       int q_offset, int Sk, int causal) {
  if (!causal) return Sk;
  const int last = (v0 + rows < n_vec ? v0 + rows : n_vec) - 1;
  const int e = q_offset + last / gs + 1;
  return e < Sk ? e : Sk;
}

template <class P>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ P pol, int Sk, int causal,
                   float scale_log2, int nsplit, float* __restrict__ pacc,
                   float* __restrict__ pml, int* __restrict__ counters) {
  using Sh = Shape<P>;
  constexpr int kDH = P::kDH;
  constexpr int kBK = P::kBK;
  constexpr int kS = P::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hop::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + Sh::kQBytes;         // stage st at + st * kKBytes
  const uint32_t v_s = k_s + kS * Sh::kKBytes;    // stage st at + st * kVBytes
  const uint32_t bars = v_s + kS * Sh::kVBytes;   // 8 bytes each
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8u * (1 + st); };
  auto v_full = [&](int st) { return bars + 8u * (1 + kS + st); };
  auto empty = [&](int st) { return bars + 8u * (1 + 2 * kS + st); };

  const int y = blockIdx.x;  // the plane
  const int b = blockIdx.z;
  const int kh = pol.kv_head(y);
  const int n_vec = pol.n_vec;
  const int gs = pol.gs;
  const int q_offset = pol.q_offset;
  // blockIdx.y = row block (the last first: under the causal mask it sees
  // the most keys) x nsplit + split
  const int n_rb = gridDim.y / nsplit;
  const int rb = n_rb - 1 - static_cast<int>(blockIdx.y) / nsplit;
  const int sp = blockIdx.y % nsplit;
  const int v0 = rb * kRows;
  // this split's tiles [t_lo, t_hi) of the row block's key range
  const int n_all =
      (key_end(v0, kRows, n_vec, gs, q_offset, Sk, causal) + kBK - 1) / kBK;
  const int t_lo = sp * n_all / nsplit;
  const int t_hi = (sp + 1) * n_all / nsplit;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    hop::mbar_init(q_full, P::kArrivals);
    for (int st = 0; st < kS; ++st) {
      hop::mbar_init(k_full(st), P::kArrivals);
      hop::mbar_init(v_full(st), P::kArrivals);
      hop::mbar_init(empty(st), kConsumers / 32);  // one per warp
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // the producer warpgroup
    hop::regs_dec<P::kProducerRegs>();
    const int pt = threadIdx.x - kConsumers;
    if (pt < P::kLoaderThreads) {
      pol.load_q(pt, q_s, q_full, b, y, v0);
      for (int t = t_lo; t < t_hi; ++t) {
        const int i = t - t_lo;
        const int st = i % kS;
        // the loader calls `free` before it writes the stage (a loader that
        // reads global memory first issues those reads before)
        auto free = [&] {
          if (i >= kS) hop::mbar_wait(empty(st), ((i / kS) - 1) & 1);
        };
        pol.load_kv(pt, k_s + st * Sh::kKBytes, k_full(st),
                    v_s + st * Sh::kVBytes, v_full(st), b, kh, t * kBK, free);
      }
    }
    return;
  }

  // consumer warpgroup wg: vectors [wg_v0, wg_v0 + 64); this thread's rows
  // are row_a and row_a + 8, at query positions pos[0] and pos[1]
  hop::regs_inc<consumer_regs<P::kProducerRegs>()>();
  const int wg = warp / 4;
  const int w = warp % 4;
  const int wg_v0 = v0 + wg * 64;
  const int row_a = wg_v0 + w * 16 + lane / 4;
  const int pos[2] = {q_offset + row_a / gs, q_offset + (row_a + 8) / gs};
  const int wg_pos0 = q_offset + wg_v0 / gs;  // the warpgroup's first
  const int wg_tiles =
      wg_v0 < n_vec
          ? (key_end(wg_v0, 64, n_vec, gs, q_offset, Sk, causal) + kBK - 1) /
                kBK
          : 0;
  // this warpgroup's 64 rows of Q: 8-row groups at 1024 bytes, panels of
  // 128 rows at 16 KiB
  const uint32_t q_wg = q_s + wg * 64 * 128;

  float o[kDH / 2];
#pragma unroll
  for (int i = 0; i < kDH / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  // with kQRegs, Q's A fragments in registers (channels [16 kk, 16 kk + 16)
  // of this thread's rows, as the p fragments below), so S reads only K
  // from shared memory
  uint32_t qf[P::kQRegs ? kDH / 16 : 1][4];
  if (wg_tiles > t_lo) {
    hop::mbar_wait(q_full, 0);
    if constexpr (P::kQRegs) {
#pragma unroll
      for (int kk = 0; kk < kDH / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = row_a - v0 + 8 * (j % 2);  // the CTA's row
          const int c = 16 * kk + 8 * (j / 2) + 2 * (lane % 4);
          qf[kk][j] = hop::ld_shared_u32(
              q_s + (c / 64) * kRows * 128 + r * 128 +
              ((((c % 64) / 8) ^ (r % 8)) * 16) + (c % 8) * 2);
        }
    }
  }
  // A tile's P V runs on while the next tile's logits are issued: the
  // stage whose P V is in flight (`pend`) is released (its `empty`
  // arrival) once the next wait for the tensor cores has returned, and p
  // lives across iterations so that its registers stay the A operand's
  // until then.
  uint32_t p_hi[kBK / 16][4], p_lo[kBK / 16][4];
  int pend = -1;
  auto release = [&](int st) {  // this warp is done with stage st
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(empty(st));
  };
  auto settle = [&] {  // the in-flight P V is done; release its stage
    hop::wgmma_wait<0>();
    hop::fence_regs(o);
    hop::fence_regs(p_hi);
    hop::fence_regs(p_lo);
    if (pend >= 0) release(pend);
    pend = -1;
  };
  for (int t = t_lo; t < t_hi; ++t) {
    const int st = (t - t_lo) % kS;
    const uint32_t phase = ((t - t_lo) / kS) & 1;
    // every consumer waits for every tile, used or not: an arrival on
    // `empty` before the tile has landed would count toward the stage's
    // next use and let the producer overwrite it while the other warpgroup
    // still reads it
    hop::mbar_wait(k_full(st), phase);
    if (t < wg_tiles) {
      const uint32_t k_t = k_s + st * Sh::kKBytes;
      const uint32_t v_t = v_s + st * Sh::kVBytes;
      float s[kBK / 2];
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDH / 16; ++kk) {
        // step kk: channels [16 kk, 16 kk + 16), in panel kk / 4 at byte
        // offset 32 (kk % 4) of each swizzled row; every K piece adds into
        // the same logits
        const uint32_t off = (kk % 4) * 32;
        const uint32_t qa = q_wg + (kk / 4) * kRows * 128 + off;
#pragma unroll
        for (int pc = 0; pc < P::kKPieces; ++pc) {
          const uint64_t dk = hop::desc_sw128(
              k_t + pc * Sh::kTileBytes + (kk / 4) * kBK * 128 + off, 16,
              1024);
          if constexpr (P::kQRegs)
            hop::wgmma_rs_kmajor(s, qf[kk], dk, kk > 0 || pc > 0);
          else
            hop::wgmma_ss(s, hop::desc_sw128(qa, 16, 1024), dk,
                          kk > 0 || pc > 0);
        }
      }
      hop::wgmma_commit();
      settle();  // these logits, and the previous tile's P V
      hop::fence_regs(s);

      // element i of s is the raw logit q . k of key
      // key0 + 8 (i / 4) + 2 (lane % 4) + i % 2, row row_a + 8 ((i / 2) % 2)
      const int key0 = t * kBK;
      const bool edge =
          key0 + kBK > Sk || (causal && key0 + kBK - 1 > wg_pos0);
      if (edge) {
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          const int key = key0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
          if (key >= Sk || (causal && key > pos[(i / 2) % 2]))
            s[i] = -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i)
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
      // m is kept in log2 units, rounded once per row and tile; p and alpha
      // take their exponents from that same m (one fused multiply-add from
      // the raw logit), so its rounding is common to a row's terms and
      // cancels in out = acc / l
      float safe[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        // a row with no key seen yet keeps m = -inf: guard the exponents
        safe[r] = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = m[r] == -INFINITY ? 0.f : exp2f(m[r] - safe[r]);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < kDH / 2; ++i) o[i] *= alpha[(i / 2) % 2];

      // p = exp2(s log2(e) / sqrt(dh) - m) in fp32, split into bf16 halves
      // as A fragments:
      // keys [16 kk, 16 kk + 16) are s[8 kk .. 8 kk + 7], register j holds
      // the pair (s[8 kk + 2 j], s[8 kk + 2 j + 1])
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 8 * kk + 2 * j;
          const int r = j % 2;
          const float p0 = exp2f(fmaf(s[i], scale_log2, -safe[r]));
          const float p1 = exp2f(fmaf(s[i + 1], scale_log2, -safe[r]));
          l[r] += p0 + p1;
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
          const float2 hf = __bfloat1622float2(hi);
          const __nv_bfloat162 lo =
              __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
          p_hi[kk][j] = *reinterpret_cast<const uint32_t*>(&hi);
          p_lo[kk][j] = *reinterpret_cast<const uint32_t*>(&lo);
        }
      }

      hop::mbar_wait(v_full(st), phase);
      hop::fence_regs(o);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // keys [16 kk, 16 kk + 16): two 8-row groups of every panel; panels
        // (64 channels each) kBK * 128 bytes apart
        const uint64_t dv =
            hop::desc_sw128(v_t + kk * 16 * 128, kBK * 128, 1024);
        hop::wgmma_rs(o, p_hi[kk], dv, 1);
        hop::wgmma_rs(o, p_lo[kk], dv, 1);
        if constexpr (P::kVPieces == 2) {
          const uint64_t dv1 = hop::desc_sw128(
              v_t + Sh::kTileBytes + kk * 16 * 128, kBK * 128, 1024);
          hop::wgmma_rs(o, p_hi[kk], dv1, 1);
        }
      }
      hop::wgmma_commit();
      pend = st;
    } else {
      settle();
      hop::mbar_wait(v_full(st), phase);
      release(st);
    }
  }
  settle();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  if (nsplit > 1) {
    // The splits of a row block meet through partials in device memory:
    // each CTA writes its unnormalised (o, m, l), m in log2 units; the last
    // to finish, found with a counter that it resets to 0 for the next
    // call, folds the others' into its registers with the log-sum-exp
    // formula (as decode_split.cuh's merge) and stores the result.  The
    // consumers' barrier orders their partials before thread 0's count,
    // whose acquire-release atomic publishes them and, in the last CTA,
    // acquires every other CTA's; those are read through L2 (__ldcg).
    const long long blk =
        (static_cast<long long>(b) * gridDim.x + y) * n_rb + rb;
    auto part = [&](int s_) { return (blk * nsplit + s_) * kRows; };
    const int la = row_a - v0;  // this thread's rows in the block
#pragma unroll
    for (int i = 0; i < kDH / 2; i += 2) {
      const int r = (i / 2) % 2;
      const int d = 8 * (i / 4) + 2 * (lane % 4);
      *reinterpret_cast<float2*>(pacc + (part(sp) + la + 8 * r) * kDH + d) =
          make_float2(o[i], o[i + 1]);
    }
    if (lane % 4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(pml + 2 * (part(sp) + la + 8 * r)) =
            make_float2(m[r], l[r]);
    }
    __shared__ int last;
    hop::named_barrier(1, kConsumers);
    int* counter = counters + blk;
    if (threadIdx.x == 0) {
      int before;
      asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                   : "=r"(before)
                   : "l"(counter)
                   : "memory");
      last = before == nsplit - 1;
    }
    hop::named_barrier(1, kConsumers);
    if (!last) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      auto ml = [&](int s_) {
        return __ldcg(reinterpret_cast<const float2*>(
            pml + 2 * (part(s_) + la + 8 * r)));
      };
      float mt = m[r];
      for (int s_ = 0; s_ < nsplit; ++s_)
        if (s_ != sp) mt = fmaxf(mt, ml(s_).x);
      const float own = m[r] == -INFINITY ? 0.f : exp2f(m[r] - mt);
      l[r] *= own;
#pragma unroll
      for (int i = 2 * r; i < kDH / 2; i += 4) {
        o[i] *= own;
        o[i + 1] *= own;
      }
      for (int s_ = 0; s_ < nsplit; ++s_) {
        const float2 x = ml(s_);
        if (s_ == sp || x.x == -INFINITY) continue;
        const float wt = exp2f(x.x - mt);
        l[r] = fmaf(wt, x.y, l[r]);
        const float* po = pacc + (part(s_) + la + 8 * r) * kDH;
#pragma unroll
        for (int i = 2 * r; i < kDH / 2; i += 4) {
          const float2 v = __ldcg(reinterpret_cast<const float2*>(
              po + 8 * (i / 4) + 2 * (lane % 4)));
          o[i] = fmaf(wt, v.x, o[i]);
          o[i + 1] = fmaf(wt, v.y, o[i + 1]);
        }
      }
      m[r] = mt;
    }
    if (threadIdx.x == 0) *counter = 0;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    // m in the units of the logits s: log2 -> natural once
    if (lane % 4 == 0 && row < n_vec)
      pol.store_ml(b, y, row, m[r] * 0.6931471805599453f, l[r]);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  // element i of o is channel 8 (i / 4) + 2 (lane % 4) + i % 2 of row
  // row_a + 8 ((i / 2) % 2)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= n_vec) continue;
    __nv_bfloat16* dst = pol.out_row(b, y, row);
#pragma unroll
    for (int i = 2 * r; i < kDH / 2; i += 4) {
      const int d = 8 * (i / 4) + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(dst + d) =
          __floats2bfloat162_rn(o[i] / l[r], o[i + 1] / l[r]);
    }
  }
}

}  // namespace fw
