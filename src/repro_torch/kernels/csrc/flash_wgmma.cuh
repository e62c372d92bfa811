// The tensor-core flash-attention loop of the port (sm_90a), over bf16 tiles
// in shared memory, templated on the policy that fills them.  K4's bf16 path
// (flash_attention.cu) instantiates it with a TMA loader; a loader that
// dequantizes packed codes into the same tile layout plugs in the same way.
//
// One CTA of 384 threads takes kRows = 128 query rows of one head against
// the keys of its KV head:
//   - warps 0-7 are two consumer warpgroups of 64 rows each, grown to 240
//     registers a thread (the 64 x dh output accumulator, the 64 x kBK
//     logits and the bf16 halves of p live in registers);
//   - warps 8-11 are the producer warpgroup, shrunk to 24 registers: one
//     lane of it asks the loader for the Q tile once and then for K and V
//     tiles of kBK keys into a ring of kStages stages, each stage guarded by
//     a "full" mbarrier per tile (K and V apart, so the logits start before
//     V has landed) and an "empty" mbarrier that all 256 consumer threads
//     arrive on when they are done with the stage.
// Per key tile a warpgroup computes S = Q K^T with wgmma (both operands
// K-major in shared memory), masks and runs the online softmax on the
// accumulator fragment in registers (a thread holds rows r and r + 8 of its
// warp's 16; the row max and sum reduce over the quad of threads that share
// a row), and adds P V with wgmma, P from registers as the A operand (the
// fp32 accumulator fragment of S is, pair by pair, the bf16 A fragment of
// the product) and V read MN-major (transposed) from shared memory.
//
// Numerics: the logits are fp32 sums of exact bf16 products, and p takes
// its exponent from the raw logit in one fused multiply-add against the
// row's running max (log2 units); p is split as
// p = p_hi + p_lo, both bf16, and both halves go through the tensor cores
// into the same fp32 accumulator, so P V keeps about 16 significant bits of
// p (a single bf16 p would move out by up to 2^-9 sum p|v|); l sums the fp32
// p.  out = acc / max(l, 1e-30), rounded once to bf16.
//
// Masks: with `causal` row i sees key j iff i >= j (top-left aligned,
// whatever Sk - Sq is); keys j >= Sk are masked to -inf (a loader's zero fill
// there gives s = 0, which must not count).  Only tiles that cross the
// diagonal or Sk are masked element by element; a warpgroup skips the
// products of tiles wholly above its rows' diagonal, and a CTA loads no
// tile past its last row's.  Rows >= Sq are computed on zeros and never
// stored.
//
// The loader (template parameter `Loader`) is a policy object in kernel
// parameter space with
//   load_q(dst, bar, b, h, r0): rows [r0, r0 + 128) of query head h;
//   load_k(dst, bar, b, kh, t0), load_v(...): keys [t0, t0 + kBK) of KV
//     head kh;
// each called by one thread of the producer warpgroup.  It fills `dst`
// (shared address, 1024-byte aligned) with the tile as bf16 panels of 64
// channels, rows at 128 bytes, 128-byte swizzle (hopper.cuh), zeros past
// the tensor's end, and completes the mbarrier `bar` (one arrival, plus any
// transaction bytes it declares).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace fw {

constexpr int kThreads = 384;  // two consumer warpgroups + a producer one
constexpr int kConsumers = 256;
// registers a thread: 2 x 128 x 240 + 128 x 24 <= the SM's 65,536
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;
constexpr int kRows = 128;  // query rows per CTA, 64 per warpgroup

template <int kDH>
struct Shape {
  static_assert(kDH == 64 || kDH == 128 || kDH == 256, "head_dim");
  // keys per tile: at dh 256 a 128-key tile would not leave the registers
  // for the 64 x 256 output accumulator
  static constexpr int kBK = kDH == 256 ? 64 : 128;
  static constexpr int kStages = 2;
  static constexpr uint32_t kQBytes = kRows * kDH * 2;
  static constexpr uint32_t kTileBytes = kBK * kDH * 2;  // one K or V tile
  // 1024 bytes of slack to align the tiles, then Q, K ring, V ring, barriers
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kStages * static_cast<size_t>(kTileBytes) + 64;
};

// rows of the causal/length-limited key range of `rows` query rows starting
// at row r0: keys [0, key_end)
__device__ __forceinline__ int key_end(int r0, int rows, int Sq, int Sk,
                                       int causal) {
  if (!causal) return Sk;
  int e = r0 + rows < Sq ? r0 + rows : Sq;
  return e < Sk ? e : Sk;
}

template <int kDH, class Loader>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ Loader loader,
                   __nv_bfloat16* __restrict__ out, int Sq, int Sk, int H,
                   int KV, int causal, float scale_log2) {
  using Sh = Shape<kDH>;
  constexpr int kBK = Sh::kBK;
  constexpr int kS = Sh::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hop::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + Sh::kQBytes;           // stage st at + st * tile
  const uint32_t v_s = k_s + kS * Sh::kTileBytes;
  const uint32_t bars = v_s + kS * Sh::kTileBytes;  // 8 bytes each
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8u * (1 + st); };
  auto v_full = [&](int st) { return bars + 8u * (1 + kS + st); };
  auto empty = [&](int st) { return bars + 8u * (1 + 2 * kS + st); };

  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int kh = h / (H / KV);
  // the last row blocks see the most keys under the causal mask: start first
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int n_tiles = (key_end(r0, kRows, Sq, Sk, causal) + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    hop::mbar_init(q_full, 1);
    for (int st = 0; st < kS; ++st) {
      hop::mbar_init(k_full(st), 1);
      hop::mbar_init(v_full(st), 1);
      hop::mbar_init(empty(st), kConsumers);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // the producer warpgroup
    hop::regs_dec<kProducerRegs>();
    if (warp == kConsumers / 32 && lane == 0) {
      loader.load_q(q_s, q_full, b, h, r0);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kS;
        if (t >= kS) hop::mbar_wait(empty(st), ((t / kS) - 1) & 1);
        loader.load_k(k_s + st * Sh::kTileBytes, k_full(st), b, kh, t * kBK);
        loader.load_v(v_s + st * Sh::kTileBytes, v_full(st), b, kh, t * kBK);
      }
    }
    return;
  }

  // consumer warpgroup wg: rows [wg_r0, wg_r0 + 64); this thread's rows are
  // row_a and row_a + 8
  hop::regs_inc<kConsumerRegs>();
  const int wg = warp / 4;
  const int w = warp % 4;
  const int wg_r0 = r0 + wg * 64;
  const int row_a = wg_r0 + w * 16 + lane / 4;
  const int wg_tiles =
      wg_r0 < Sq ? (key_end(wg_r0, 64, Sq, Sk, causal) + kBK - 1) / kBK : 0;
  // this warpgroup's 64 rows of Q: 8-row groups at 1024 bytes, panels of
  // 128 rows at 16 KiB
  const uint32_t q_wg = q_s + wg * 64 * 128;

  float o[kDH / 2];
#pragma unroll
  for (int i = 0; i < kDH / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  if (wg_tiles > 0) hop::mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kS;
    const uint32_t phase = (t / kS) & 1;
    // every consumer waits for every tile, used or not: an arrival on
    // `empty` before the tile has landed would count toward the stage's
    // next use and let the producer overwrite it while the other warpgroup
    // still reads it
    hop::mbar_wait(k_full(st), phase);
    if (t < wg_tiles) {
      const uint32_t k_t = k_s + st * Sh::kTileBytes;
      const uint32_t v_t = v_s + st * Sh::kTileBytes;
      float s[kBK / 2];
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDH / 16; ++kk) {
        // step kk: channels [16 kk, 16 kk + 16), in panel kk / 4 at byte
        // offset 32 (kk % 4) of each swizzled row
        const uint32_t off = (kk % 4) * 32;
        const uint32_t qa = q_wg + (kk / 4) * kRows * 128 + off;
        const uint32_t ka = k_t + (kk / 4) * kBK * 128 + off;
        hop::wgmma_ss(s, hop::desc_sw128(qa, 16, 1024),
                      hop::desc_sw128(ka, 16, 1024), kk > 0);
      }
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(s);

      // element i of s is the raw logit q . k of key
      // key0 + 8 (i / 4) + 2 (lane % 4) + i % 2, row row_a + 8 ((i / 2) % 2)
      const int key0 = t * kBK;
      const bool edge =
          key0 + kBK > Sk || (causal && key0 + kBK - 1 > wg_r0);
      if (edge) {
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          const int key = key0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
          const int row = row_a + 8 * ((i / 2) % 2);
          if (key >= Sk || (causal && key > row)) s[i] = -INFINITY;
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
      uint32_t p_hi[kBK / 16][4], p_lo[kBK / 16][4];
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
      }
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(o);
      hop::fence_regs(p_hi);
      hop::fence_regs(p_lo);
    } else {
      hop::mbar_wait(v_full(st), phase);
    }
    hop::mbar_arrive(empty(st));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  // element i of o is channel 8 (i / 4) + 2 (lane % 4) + i % 2 of row
  // row_a + 8 ((i / 2) % 2)
  __nv_bfloat16* plane =
      out + (static_cast<long long>(b) * H + h) * Sq * kDH;
#pragma unroll
  for (int i = 0; i < kDH / 2; i += 2) {
    const int r = (i / 2) % 2;
    const int row = row_a + 8 * r;
    if (row < Sq) {
      const int d = 8 * (i / 4) + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(plane + row * kDH + d) =
          __floats2bfloat162_rn(o[i] / l[r], o[i + 1] / l[r]);
    }
  }
}

}  // namespace fw
