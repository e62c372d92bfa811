// K6: fused dequant + decode attention over a packed-resident cache,
// hand-written for Hopper (sm_90a).  Plain C interface, bound from Python with
// ctypes (repro_torch/kernels/decode_attention.py); the launch goes on the
// caller's stream and the entry point returns cudaGetLastError().
//
// Replaces src/repro/kernels/decode_attention.py:252 `decode_attention_quant`
// (its `pallas_call`, body `_quant_kernel`).
//
// What it computes, for one query token per sequence, q [B, H, dh] (fp32 or
// bf16), over a packed cache k_q/v_q [B, S, KV, dh'] with per-chunk scale rows
// [B, S/G, KV*dh/group] and lengths [B]: for head h (KV head h / (H/KV)),
// logits s_t = (q . k_t) * (1/sqrt(dh)) in fp32 over the dequantized keys
// (K3, dequant_tile.cuh) for t < lengths[b]; m = max_t s_t,
// l = sum_t exp(s_t - m), out = (sum_t exp(s_t - m) v_t) / l rounded once to
// q's type, m and l in fp32.  A row with length 0 gets out = 0, m = -inf,
// l = 0.
//
// Bound: bytes.  At the serving path's shape (B=1, S=3840, H=32, KV=8,
// dh=128) the cache is 7.9 MB of int8 words and scales (3.9 MB at int4):
// 2.4 us (int8) and 1.2 us (int4) at 3.35 TB/s, against 63 MFLOP.
//
// This file holds the row loader and the entry point; the loop is the
// split decode of decode_split.cuh (`ds::decode_split_kernel`), K5's: one
// launch of splits x KV heads x batch rows, sized by the host
// (`decode_split_tokens`: 30 splits of 128 tokens, 240 CTAs at the serving
// shape), warps streaming rows straight to registers, the last CTA of each
// KV head merging the splits' partials and writing out, m and l.  A lane
// loads the 8 codes of one K3 unit per row (8 bytes int8, 4 bytes int4; 16
// lanes a row at dh 128), so a lane's channels, and with them its share of
// q and of the output in registers, are those of a bf16 row of K5; the loop
// holds twice (int8) or four times (int4) the steps in flight to keep the
// same bytes in flight.  `widen` unpacks the codes and multiplies them by
// their chunk's scales as K3 does (one rounding), so the values are those
// of the plain version; a lane keeps its 8 channels' scales in registers
// (the loop's cursor) and reloads them only when its rows enter another
// chunk of G tokens.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_split.cuh"
#include "dequant_tile.cuh"

namespace {

constexpr int kMaxGroup = 16;  // MAX_GROUP of decode_attention.py

// The loader of decode_split.cuh over a packed cache [B, S, KV, dh'] with
// scale rows [B, S/G, ng].
template <int kBits, int kDH>
struct PackedRows {
  using Raw = k3::Raw8<kBits>;
  static constexpr int kChunk = k3::kUnit;
  static_assert(kDH / kChunk <= 32, "one chunk a lane: the cursor's unit");
  // a lane's 8 scales, good for its rows below `end` (one chunk of G
  // tokens); its channels are fixed, so a new chunk is the only reload
  struct Cursor {
    long long end = -1;
    float s[k3::kUnit];
  };
  static constexpr long long kRowWords = kBits == 8 ? kDH : kDH / 2;
  const uint8_t* kq;
  const uint8_t* vq;
  const __half* ks;
  const __half* vs;
  int S, KV, G, group, ng;

  __device__ __forceinline__ Raw raw(bool value, int b, int kh, long long t,
                                     int chunk) const {
    const uint8_t* row = (value ? vq : kq) +
                         ((static_cast<long long>(b) * S + t) * KV + kh) *
                             kRowWords;
    return __ldg(reinterpret_cast<const Raw*>(row) + chunk);
  }

  __device__ __forceinline__ void widen(bool value, Cursor& cur, int b,
                                        int kh, long long t, int chunk,
                                        const Raw& r,
                                        float (&x)[kChunk]) const {
    if (t >= cur.end) {
      // the loop widens K words of rows past the split's end too (zeros,
      // whose logits it masks): keep their scale row inside the cache
      const long long c = (t < S ? t : S - 1) / G;
      cur.end = (c + 1) * G;
      k3::scales8((value ? vs : ks) +
                      (static_cast<long long>(b) * (S / G) + c) * ng,
                  kh * kDH + chunk * k3::kUnit, group, cur.s);
    }
    float vals[k3::kUnit];
    k3::unpack8(r, vals);
    k3::widen8(vals, cur.s, x);
  }
};

template <typename T, int kBits, int kDH>
int launch(const void* q, const void* kq, const void* vq, const void* ks,
           const void* vs, const void* lengths, void* out, void* m, void* l,
           void* pacc, void* pm, void* pl, void* counters, long long B,
           long long S, long long H, long long KV, long long G,
           long long group, long long split, float sm_scale,
           cudaStream_t st) {
  using Rows = PackedRows<kBits, kDH>;
  const int gs = static_cast<int>(H / KV);
  const int n_hb = (gs + ds::kHeadBlock - 1) / ds::kHeadBlock;
  const long long nsplit = (S + split - 1) / split;
  const dim3 grid(static_cast<unsigned int>(nsplit),
                  static_cast<unsigned int>(KV * n_hb),
                  static_cast<unsigned int>(B));
  const Rows rows{static_cast<const uint8_t*>(kq),
                  static_cast<const uint8_t*>(vq),
                  static_cast<const __half*>(ks),
                  static_cast<const __half*>(vs),
                  static_cast<int>(S),
                  static_cast<int>(KV),
                  static_cast<int>(G),
                  static_cast<int>(group),
                  static_cast<int>(KV * kDH / group)};
  // register arrays sized for the heads a CTA serves: 4, or up to 8
  auto kernel = gs <= 4 ? ds::decode_split_kernel<kDH, 4, T, Rows>
                        : ds::decode_split_kernel<kDH, 8, T, Rows>;
  kernel<<<grid, ds::kThreads, 0, st>>>(
      rows, static_cast<const T*>(q), static_cast<const int*>(lengths),
      static_cast<T*>(out), static_cast<float*>(m), static_cast<float*>(l),
      static_cast<float*>(pacc), static_cast<float*>(pm),
      static_cast<float*>(pl), static_cast<int*>(counters),
      static_cast<int>(S), static_cast<int>(H), static_cast<int>(KV),
      static_cast<int>(split), sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kBits>
int launch_dh(long long dh, const void* q, const void* kq, const void* vq,
              const void* ks, const void* vs, const void* lengths, void* out,
              void* m, void* l, void* pacc, void* pm, void* pl,
              void* counters, long long B, long long S, long long H,
              long long KV, long long G, long long group, long long split,
              float sm_scale, cudaStream_t st) {
  switch (dh) {
    case 64:
      return launch<T, kBits, 64>(q, kq, vq, ks, vs, lengths, out, m, l, pacc,
                                  pm, pl, counters, B, S, H, KV, G, group,
                                  split, sm_scale, st);
    case 128:
      return launch<T, kBits, 128>(q, kq, vq, ks, vs, lengths, out, m, l,
                                   pacc, pm, pl, counters, B, S, H, KV, G,
                                   group, split, sm_scale, st);
    case 256:
      return launch<T, kBits, 256>(q, kq, vq, ks, vs, lengths, out, m, l,
                                   pacc, pm, pl, counters, B, S, H, KV, G,
                                   group, split, sm_scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q_kind: 0 = fp32, 1 = bf16 (q and out); bits: 8 or 4; dh: 64, 128 or 256;
// H/KV <= 16.  lengths is int32 [B]; m and l are fp32 [B, H].  `split` is
// the tokens per CTA and nsplit = ceil(S / split); pacc
// [B, KV, nsplit, H/KV, dh], pm and pl [B, KV, nsplit, H/KV] (fp32) are the
// caller's scratch for the partials, and counters int32
// [B, KV x ceil(H/KV / 8)] are zero before the call and after it (the
// stream's own buffer).  The packed rows are 8-byte aligned.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a kind,
// width, head_dim or group it was not built for, or a split below 1).
extern "C" int decode_attention_quant(
    const void* q, const void* kq, const void* vq, const void* ks,
    const void* vs, const void* lengths, void* out, void* m, void* l,
    void* pacc, void* pm, void* pl, void* counters, long long B, long long S,
    long long H, long long KV, long long dh, long long G, long long group,
    int bits, int q_kind, long long split, float sm_scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H / KV > kMaxGroup || split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (q_kind == 0 && bits == 8)
    return launch_dh<float, 8>(dh, q, kq, vq, ks, vs, lengths, out, m, l,
                               pacc, pm, pl, counters, B, S, H, KV, G, group,
                               split, sm_scale, st);
  if (q_kind == 0 && bits == 4)
    return launch_dh<float, 4>(dh, q, kq, vq, ks, vs, lengths, out, m, l,
                               pacc, pm, pl, counters, B, S, H, KV, G, group,
                               split, sm_scale, st);
  if (q_kind == 1 && bits == 8)
    return launch_dh<__nv_bfloat16, 8>(dh, q, kq, vq, ks, vs, lengths, out, m,
                                       l, pacc, pm, pl, counters, B, S, H, KV,
                                       G, group, split, sm_scale, st);
  if (q_kind == 1 && bits == 4)
    return launch_dh<__nv_bfloat16, 4>(dh, q, kq, vq, ks, vs, lengths, out, m,
                                       l, pacc, pm, pl, counters, B, S, H, KV,
                                       G, group, split, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
