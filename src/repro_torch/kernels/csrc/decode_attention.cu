// K5: decode attention over an fp32 or bf16 cache, hand-written for Hopper
// (sm_90a).  Plain C interface, bound from Python with ctypes
// (repro_torch/kernels/decode_attention.py); the launch goes on the caller's
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
// select are 16.8 MB of K/V: 5.0 us at 3.35 TB/s, against 67 MFLOP.
//
// Design: the TPU kernel walked the cache in order, one program per
// sequence; copied block for block that would be 8 programs for 132 SMs at
// batch 1.  Here one launch of the split pass of decode_split.cuh (a grid of
// splits x KV heads x batch rows, warps streaming their rows straight to
// registers, the last CTA of each KV head merging the splits' partials)
// runs with a loader of plain fp32 or bf16 rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_split.cuh"

namespace {

constexpr int kMaxGroup = 16;  // MAX_GROUP of decode_attention.py

// The loader of decode_split.cuh over caches [B, S, KV, dh] of T.
template <typename T, int kDH>
struct FpRows {
  using Raw = uint4;
  struct Cursor {};
  static constexpr int kChunk = 16 / static_cast<int>(sizeof(T));
  const T* k;
  const T* v;
  int S, KV;

  __device__ __forceinline__ uint4 raw(bool value, int b, int kh,
                                       long long t, int chunk) const {
    const T* row = (value ? v : k) +
                   ((static_cast<long long>(b) * S + t) * KV + kh) * kDH;
    return __ldg(reinterpret_cast<const uint4*>(row) + chunk);
  }

  __device__ __forceinline__ void widen(bool, Cursor&, int, int, long long,
                                        int, const uint4& r,
                                        float (&x)[kChunk]) const {
    if constexpr (sizeof(T) == 4) {
      x[0] = __uint_as_float(r.x);
      x[1] = __uint_as_float(r.y);
      x[2] = __uint_as_float(r.z);
      x[3] = __uint_as_float(r.w);
    } else {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
      for (int i = 0; i < kChunk / 2; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        x[2 * i] = f.x;
        x[2 * i + 1] = f.y;
      }
    }
  }
};

template <typename T, int kDH>
int launch(const void* q, const void* kc, const void* vc, const void* lengths,
           void* out, void* pacc, void* pm, void* pl, void* counters,
           long long B, long long S, long long H, long long KV,
           long long split, float sm_scale, cudaStream_t st) {
  const int gs = static_cast<int>(H / KV);
  const int n_hb = (gs + ds::kHeadBlock - 1) / ds::kHeadBlock;
  const long long nsplit = (S + split - 1) / split;
  const dim3 grid(static_cast<unsigned int>(nsplit),
                  static_cast<unsigned int>(KV * n_hb),
                  static_cast<unsigned int>(B));
  const FpRows<T, kDH> rows{static_cast<const T*>(kc),
                            static_cast<const T*>(vc), static_cast<int>(S),
                            static_cast<int>(KV)};
  // register arrays sized for the heads a CTA serves: 4, or up to 8
  auto kernel = gs <= 4 ? ds::decode_split_kernel<kDH, 4, T, FpRows<T, kDH>>
                        : ds::decode_split_kernel<kDH, 8, T, FpRows<T, kDH>>;
  kernel<<<grid, ds::kThreads, 0, st>>>(
      rows, static_cast<const T*>(q), static_cast<const int*>(lengths),
      static_cast<T*>(out), nullptr, nullptr, static_cast<float*>(pacc),
      static_cast<float*>(pm), static_cast<float*>(pl),
      static_cast<int*>(counters), static_cast<int>(S), static_cast<int>(H),
      static_cast<int>(KV), static_cast<int>(split), sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(long long dh, const void* q, const void* kc, const void* vc,
              const void* lengths, void* out, void* pacc, void* pm, void* pl,
              void* counters, long long B, long long S, long long H,
              long long KV, long long split, float sm_scale,
              cudaStream_t st) {
  switch (dh) {
    case 64:
      return launch<T, 64>(q, kc, vc, lengths, out, pacc, pm, pl, counters, B,
                           S, H, KV, split, sm_scale, st);
    case 128:
      return launch<T, 128>(q, kc, vc, lengths, out, pacc, pm, pl, counters,
                            B, S, H, KV, split, sm_scale, st);
    case 256:
      return launch<T, 256>(q, kc, vc, lengths, out, pacc, pm, pl, counters,
                            B, S, H, KV, split, sm_scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// kind: 0 = fp32, 1 = bf16 (q, caches and out); dh: 64, 128 or 256;
// H/KV <= 16.  q and out [B, H, dh], caches [B, S, KV, dh] (contiguous,
// 16-byte aligned), lengths int32 [B].  `split` is the tokens per CTA and
// nsplit = ceil(S / split); pacc [B, KV, nsplit, H/KV, dh], pm and pl
// [B, KV, nsplit, H/KV] (fp32) are the caller's scratch for the partials,
// and counters int32 [B, KV x ceil(H/KV / 8)] are zero before the call and
// after it (the stream's own buffer).  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a kind, head_dim or group it was not
// built for, or a split below 1).
extern "C" int decode_attention(const void* q, const void* kc, const void* vc,
                                const void* lengths, void* out, void* pacc,
                                void* pm, void* pl, void* counters,
                                long long B, long long S, long long H,
                                long long KV, long long dh, int kind,
                                long long split, float sm_scale,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H / KV > kMaxGroup || split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kind == 0)
    return launch_dh<float>(dh, q, kc, vc, lengths, out, pacc, pm, pl,
                            counters, B, S, H, KV, split, sm_scale, st);
  if (kind == 1)
    return launch_dh<__nv_bfloat16>(dh, q, kc, vc, lengths, out, pacc, pm,
                                    pl, counters, B, S, H, KV, split,
                                    sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
