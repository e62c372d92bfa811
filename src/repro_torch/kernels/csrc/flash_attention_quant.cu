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
// s_j = (q_i . k_j) * (1/sqrt(dh)) in fp32 over the dequantized keys (K3,
// dequant_tile.cuh), masked to j <= q_offset + i when `causal`;
// m = max_j s_j, l = sum_j exp(s_j - m), out = (sum_j exp(s_j - m) v_j) / l,
// rounded once to q's type; m and l are written in fp32 so a caller can merge
// the result with attention over other keys.  A row that sees no key gets
// out = 0, m = -inf, l = 0.
//
// Bound: operations.  At the serving path's shape (B=1, Sq=256, Sk=3840,
// H=32, KV=8, dh=128, int8) the work is 4*Sq*H*Sk*dh = 16.1 GFLOP: 16.3 us
// at the 989 TFLOP/s bf16 tensor-core peak, against 12.2 MB of bytes
// (3.6 us).
//
// This file holds the two loaders and the entry point; the loops are the
// port's shared ones.
//
// bf16 q: the tensor-core loop of flash_wgmma.cuh (`fw::flash_wgmma_kernel`)
// with the policy `DequantTiles`.  A plane is one KV head: a CTA's 128 rows
// are 128 / (H/KV) query positions x the H/KV heads of the group, adjacent
// in q's [B, Sq, H, dh] layout (vector v = position v / gs, head
// kh gs + v % gs), so each dequantized K/V tile serves the whole group.  At
// the serving shape that is 32 positions x 4 heads: 8 row blocks x 8 KV
// heads = 64 CTAs, half of the 132 SMs, so the host cuts each row block's
// keys in two (`flash_quant_splits`): 128 CTAs of 30 tiles, the last of
// each pair merging the other's partial.  All 128 producer threads expand
// a tile: thread pt owns the 8-channel unit pt % (dh/8) of rows
// pt / (dh/8), pt / (dh/8) + 128 / (dh/8), ...; it loads the codes of its
// rows of the next K and V tiles (one 8- or 4-byte word each, all in
// flight together) and its unit's K scales before it waits for the stage to
// be free, keeps those scales while its rows stay in one chunk of G
// tokens, forms each value as K3 does (code x scale, one rounding, exact:
// at most 19 significant bits) and stores it as bf16 pieces into the
// swizzled tiles; then each thread fences the async proxy, the warpgroup
// meets at a named barrier and one thread arrives on the tile's barrier.
// The pieces:
//   - K as three bf16 pieces, k = k_hi + k_mid + k_lo exactly (the first two
//     truncate to 8 significant bits each and the rest fits the third), so
//     the logits are fp32 sums of exact products, as K4's: S takes three
//     wgmmas.  A single bf16 k would move a logit by up to 2^-9
//     sum |q_d k_d| and break the m and l bounds (1e-5);
//   - V as two, v = v_hi + v_lo + e with |e| <= 2^-16 |v|, against p's two
//     halves: P V = p_hi v_hi + p_lo v_hi + p_hi v_lo (three wgmmas; the
//     dropped p_lo v_lo is below 2^-16 p|v|), so out moves by at most about
//     3 x 2^-16 sum_j p_j |v_j| / l from the exact sum, as K4's p split
//     alone moves it by 2^-16, before the one bf16 rounding of out.
// tests/test_torch_attention_quant.py holds both splits for every int8 and
// int4 code against every finite fp16 scale.  Pieces multiply the tile
// bytes: tiles of 64 keys (32 at dh 256) keep the two-stage ring, Q and the
// five pieces within the 227 KB of shared memory (193 KB at dh 128).  Q's
// A fragments sit in the consumers' registers (dh <= 128), so the logits'
// three wgmmas read only K from shared memory, which the producer's stores
// also use.  The producer keeps 88 registers a thread, the consumers 208.
// Three wgmma products for S and three for P V issue 3x the bound's
// operations.
//
// fp32 q: the CUDA-core loop of flash_fp32.cuh (shared with K4's fp32
// path) with the policy `DequantTilesFp32`, whose tiles
// come from K3's `dequant_tile`.  fp32 FMA throughout: the tensor cores
// would take fp32 q only as TF32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dequant_tile.cuh"
#include "flash_fp32.cuh"
#include "flash_wgmma.cuh"

namespace {

// What both loaders read: the packed cache of one call.
struct Packed {
  const uint8_t* kq;
  const uint8_t* vq;
  const __half* ks;
  const __half* vs;
  int Sk, KV, G, group, ng;  // ng = KV * dh / group scales a chunk row
};

// The key splits of the tensor-core loop: n CTAs per row block, and the
// caller's scratch for their partials and counters (unused when n is 1).
struct Splits {
  int n;
  float* pacc;
  float* pml;
  int* counters;
};

// -- bf16 q: the tensor-core loop --------------------------------------------

template <int kBits, int kDH_>
struct DequantTiles {
  static constexpr int kDH = kDH_;
  static constexpr int kBK = kDH == 256 ? 32 : 64;
  static constexpr int kStages = 2;
  static constexpr int kKPieces = 3;
  static constexpr int kVPieces = 2;
  // Q's fragments in registers where they fit beside the dh/2 accumulators
  static constexpr bool kQRegs = kDH <= 128;
  static constexpr int kProducerRegs = 88;
  static constexpr int kLoaderThreads = fw::kProducers;
  static constexpr int kArrivals = 1;
  static constexpr int kUnits = kDH / k3::kUnit;        // per row
  static constexpr int kRowStep = fw::kProducers / kUnits;  // rows per pass
  static constexpr int kPasses = kBK / kRowStep;
  static constexpr uint32_t kTileBytes = kBK * kDH * 2;
  static constexpr long long kRowWords = kBits == 8 ? kDH : kDH / 2;
  static_assert(kBK % kRowStep == 0, "tile rows");

  Packed c;
  const __nv_bfloat16* q;
  __nv_bfloat16* out;
  float* m;
  float* l;
  int Sq, H;
  int n_vec, gs, q_offset;  // Sq * H/KV, H/KV, q_offset

  __device__ int kv_head(int y) const { return y; }

  // shared address of the 16-byte chunk u (channels 8u .. 8u + 7) of row r
  // of a tile of `rows` rows: panels of 64 channels, 128-byte swizzle
  static __device__ __forceinline__ uint32_t at(uint32_t tile, int rows,
                                                int r, int u) {
    return tile + (u / 8) * rows * 128 + r * 128 + (((u % 8) ^ (r % 8)) * 16);
  }

  __device__ long long q_row(int b, int y, int v) const {
    const int p = v / gs;
    return ((static_cast<long long>(b) * Sq + p) * H + y * gs + (v - p * gs)) *
           kDH;
  }

  __device__ void load_q(int pt, uint32_t dst, uint32_t bar, int b, int y,
                         int v0) const {
    for (int e = pt; e < fw::kRows * kUnits; e += fw::kProducers) {
      const int r = e / kUnits;
      const int u = e - r * kUnits;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (v0 + r < n_vec)
        x = __ldg(reinterpret_cast<const uint4*>(q + q_row(b, y, v0 + r)) + u);
      hop::st_shared_v4(at(dst, fw::kRows, r, u), x);
    }
    done(pt, bar);
  }

  // Every producer thread's stores are in the tile at `bar`: each fences
  // them for the async proxy, the warpgroup meets at a named barrier, and
  // one thread arrives (one arrival completes the barrier).
  static __device__ __forceinline__ void done(int pt, uint32_t bar) {
    hop::fence_proxy_async();
    hop::named_barrier(2, fw::kProducers);
    if (pt == 0) hop::mbar_arrive(bar);
  }

  // What a thread holds of one tile before it may write the stage: its
  // rows' codes (one word each, all in flight together) and, where asked,
  // the scales of its unit in the chunk of its first row (chunk -1: none
  // yet).
  struct Fetched {
    k3::Raw8<kBits> raw[kPasses];
    float s[k3::kUnit];
    int chunk;
  };

  __device__ __forceinline__ void fetch(int pt, const uint8_t* codes,
                                        const __half* scales, int b, int kh,
                                        int t0, bool with_scales,
                                        Fetched& f) const {
    const int u = pt % kUnits;
    const int r0 = pt / kUnits;
    const uint8_t* rows = codes + (static_cast<long long>(b) * c.Sk * c.KV +
                                   kh) * kRowWords;
    const long long row_words = c.KV * kRowWords;
#pragma unroll
    for (int i = 0; i < kPasses; ++i) {
      const int t = t0 + r0 + i * kRowStep;
      f.raw[i] = {};
      if (t < c.Sk)
        f.raw[i] = __ldg(reinterpret_cast<const k3::Raw8<kBits>*>(
            rows + t * row_words + u * k3::kUnit * kBits / 8));
    }
    f.chunk = -1;
    if (!with_scales) return;
    const int t = t0 + r0 < c.Sk ? t0 + r0 : c.Sk - 1;
    f.chunk = t / c.G;
    k3::scales8(scales + (static_cast<long long>(b) * (c.Sk / c.G) +
                          f.chunk) * c.ng,
                kh * kDH + u * k3::kUnit, c.group, f.s);
  }

  // The fetched rows as kPieces bf16 tiles at dst, then `done`.
  template <int kPieces>
  __device__ __forceinline__ void expand(int pt, Fetched& f,
                                         const __half* scales, uint32_t dst,
                                         uint32_t bar, int b, int kh,
                                         int t0) const {
    const int u = pt % kUnits;
    const int r0 = pt / kUnits;
#pragma unroll
    for (int i = 0; i < kPasses; ++i) {
      const int r = r0 + i * kRowStep;
      const int t = t0 + r;
      float x[k3::kUnit];
      if (t < c.Sk) {
        if (t / c.G != f.chunk) {  // the unit's scales change with the chunk
          f.chunk = t / c.G;
          k3::scales8(scales + (static_cast<long long>(b) * (c.Sk / c.G) +
                                f.chunk) * c.ng,
                      kh * kDH + u * k3::kUnit, c.group, f.s);
        }
        float vals[k3::kUnit];
        k3::unpack8(f.raw[i], vals);
        k3::widen8(vals, f.s, x);
      } else {
#pragma unroll
        for (int j = 0; j < k3::kUnit; ++j) x[j] = 0.f;
      }
      // x = piece 0 + piece 1 + ...: each piece is the bf16 of what the
      // earlier ones left (an exact fp32 difference).  Three pieces (K)
      // truncate: the top 8 significant bits of x, then of the rest, and
      // the rest fits the third exactly, with integer instructions (the
      // pair's high halves); two pieces (V) round to nearest.
      uint32_t w[kPieces][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float a = x[2 * j], bb = x[2 * j + 1];
#pragma unroll
        for (int pc = 0; pc < kPieces; ++pc) {
          if constexpr (kPieces == 3) {
            const uint32_t ua = __float_as_uint(a), ub = __float_as_uint(bb);
            w[pc][j] = __byte_perm(ua, ub, 0x7632);
            a -= __uint_as_float(ua & 0xFFFF0000u);
            bb -= __uint_as_float(ub & 0xFFFF0000u);
          } else {
            const __nv_bfloat162 h = __floats2bfloat162_rn(a, bb);
            w[pc][j] = *reinterpret_cast<const uint32_t*>(&h);
            const float2 fl = __bfloat1622float2(h);
            a -= fl.x;
            bb -= fl.y;
          }
        }
      }
#pragma unroll
      for (int pc = 0; pc < kPieces; ++pc)
        hop::st_shared_v4(at(dst + pc * kTileBytes, kBK, r, u),
                          make_uint4(w[pc][0], w[pc][1], w[pc][2], w[pc][3]));
    }
    done(pt, bar);
  }

  // the codes of both tiles, and K's scales, load while the stage is still
  // in use (V's scales load as V is expanded, K's stores in flight)
  template <class Free>
  __device__ void load_kv(int pt, uint32_t k_dst, uint32_t k_bar,
                          uint32_t v_dst, uint32_t v_bar, int b, int kh,
                          int t0, Free free) const {
    Fetched kf, vf;
    fetch(pt, c.kq, c.ks, b, kh, t0, true, kf);
    fetch(pt, c.vq, c.vs, b, kh, t0, false, vf);
    free();
    expand<kKPieces>(pt, kf, c.ks, k_dst, k_bar, b, kh, t0);
    expand<kVPieces>(pt, vf, c.vs, v_dst, v_bar, b, kh, t0);
  }
  __device__ __nv_bfloat16* out_row(int b, int y, int v) const {
    return out + q_row(b, y, v);
  }
  __device__ void store_ml(int b, int y, int v, float mv, float lv) const {
    const long long i = q_row(b, y, v) / kDH;
    m[i] = mv;
    l[i] = lv;
  }
};

template <int kBits, int kDH>
int launch_bf16(const Packed& c, const void* q, void* out, void* m, void* l,
                long long B, long long Sq, long long H, int causal,
                long long q_offset, float sm_scale, const Splits& sp,
                cudaStream_t st) {
  using P = DequantTiles<kBits, kDH>;
  const int gs = static_cast<int>(H / c.KV);
  P pol;
  pol.c = c;
  pol.q = static_cast<const __nv_bfloat16*>(q);
  pol.out = static_cast<__nv_bfloat16*>(out);
  pol.m = static_cast<float*>(m);
  pol.l = static_cast<float*>(l);
  pol.Sq = static_cast<int>(Sq);
  pol.H = static_cast<int>(H);
  pol.n_vec = static_cast<int>(Sq) * gs;
  pol.gs = gs;
  pol.q_offset = static_cast<int>(q_offset);
  auto kernel = fw::flash_wgmma_kernel<P>;
  const size_t smem = fw::Shape<P>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(c.KV),
                  static_cast<unsigned int>((pol.n_vec + fw::kRows - 1) /
                                            fw::kRows * sp.n),
                  static_cast<unsigned int>(B));
  kernel<<<grid, fw::kThreads, smem, st>>>(
      pol, c.Sk, causal, sm_scale * 1.4426950408889634f, sp.n, sp.pacc,
      sp.pml, sp.counters);
  return static_cast<int>(cudaGetLastError());
}

// -- fp32 q: the CUDA-core loop ----------------------------------------------

template <int kBits, int kDH>
struct DequantTilesFp32 {
  Packed c;
  int Sq, H;

  __device__ __forceinline__ long long row(int b, int head,
                                           long long r) const {
    return ((static_cast<long long>(b) * Sq + r) * H + head) * kDH;
  }
  __device__ __forceinline__ void load(bool value, int b, int kh,
                                       long long t0, long long t_end,
                                       float* dst, int ld) const {
    constexpr long long kRowWords = kBits == 8 ? kDH : kDH / 2;
    const long long cache = static_cast<long long>(c.Sk) * c.KV * kRowWords;
    const long long srows = static_cast<long long>(c.Sk / c.G) * c.ng;
    k3::dequant_tile<kBits, kDH, ff::kTK, ff::kThreads>(
        (value ? c.vq : c.kq) + b * cache, (value ? c.vs : c.ks) + b * srows,
        c.KV, kh, c.G, c.ng, c.group, t0, t_end, dst, ld);
  }
};

template <int kBits, int kDH>
int launch_fp32(const Packed& c, const void* q, void* out, void* m, void* l,
                long long B, long long Sq, long long H, int causal,
                long long q_offset, float sm_scale, const Splits&,
                cudaStream_t st) {
  const DequantTilesFp32<kBits, kDH> tiles{c, static_cast<int>(Sq),
                                           static_cast<int>(H)};
  return ff::launch<kDH>(tiles, static_cast<const float*>(q),
                         static_cast<float*>(out), static_cast<float*>(m),
                         static_cast<float*>(l), B, Sq, c.Sk, H, c.KV, causal,
                         q_offset, sm_scale, st);
}

template <int kBits, int kDH>
int launch(int q_kind, const Packed& c, const void* q, void* out, void* m,
           void* l, long long B, long long Sq, long long H, int causal,
           long long q_offset, float sm_scale, const Splits& sp,
           cudaStream_t st) {
  return (q_kind ? launch_bf16<kBits, kDH> : launch_fp32<kBits, kDH>)(
      c, q, out, m, l, B, Sq, H, causal, q_offset, sm_scale, sp, st);
}

template <int kBits>
int launch_dh(long long dh, int q_kind, const Packed& c, const void* q,
              void* out, void* m, void* l, long long B, long long Sq,
              long long H, int causal, long long q_offset, float sm_scale,
              const Splits& sp, cudaStream_t st) {
  switch (dh) {
    case 64:
      return launch<kBits, 64>(q_kind, c, q, out, m, l, B, Sq, H, causal,
                               q_offset, sm_scale, sp, st);
    case 128:
      return launch<kBits, 128>(q_kind, c, q, out, m, l, B, Sq, H, causal,
                                q_offset, sm_scale, sp, st);
    case 256:
      return launch<kBits, 256>(q_kind, c, q, out, m, l, B, Sq, H, causal,
                                q_offset, sm_scale, sp, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q_kind: 0 = fp32, 1 = bf16 (q and out); bits: 8 or 4; dh: 64, 128 or 256.
// q and out [B, Sq, H, dh] (16-byte aligned), m and l fp32 [B, Sq, H].
// bf16 q: each of the R = B x KV x ceil(Sq H/KV / 128) row blocks takes
// `nsplit` CTAs (1-8); with nsplit > 1, pacc [R, nsplit, 128, dh] and pml
// [R, nsplit, 128, 2] (fp32) are the caller's scratch and counters int32
// [R] are zero before the call and after it (the stream's own buffer).
// fp32 q takes no split.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a kind, width, head_dim or split count it was
// not built for).
extern "C" int flash_attention_quant(
    const void* q, const void* kq, const void* vq, const void* ks,
    const void* vs, void* out, void* m, void* l, long long B, long long Sq,
    long long Sk, long long H, long long KV, long long dh, long long G,
    long long group, int bits, int q_kind, int causal, long long q_offset,
    float sm_scale, int nsplit, void* pacc, void* pml, void* counters,
    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((q_kind != 0 && q_kind != 1) || (bits != 8 && bits != 4) ||
      nsplit < 1 || nsplit > 8 || (q_kind == 0 && nsplit != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Splits sp{nsplit, static_cast<float*>(pacc), static_cast<float*>(pml),
                  static_cast<int*>(counters)};
  const Packed c{static_cast<const uint8_t*>(kq),
                 static_cast<const uint8_t*>(vq),
                 static_cast<const __half*>(ks),
                 static_cast<const __half*>(vs),
                 static_cast<int>(Sk),
                 static_cast<int>(KV),
                 static_cast<int>(G),
                 static_cast<int>(group),
                 static_cast<int>(KV * dh / group)};
  return (bits == 8 ? launch_dh<8> : launch_dh<4>)(
      dh, q_kind, c, q, out, m, l, B, Sq, H, causal, q_offset, sm_scale, sp,
      st);
}
