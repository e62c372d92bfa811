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
// 32 * 4096 * 4097 / 2, at 4*dh FLOP each: 137.5 GFLOP, 0.139 ms at the
// 989 TFLOP/s bf16 tensor-core peak, against 83.9 MB of bytes (25 us).
//
// bf16 (the timed path): the tensor-core loop of flash_wgmma.cuh with a TMA
// loader.  One CTA of 384 threads per (128 query rows, head, batch row):
// two consumer warpgroups run S = Q K^T and P V on wgmma; one thread of a
// producer warpgroup keeps K/V tiles of 128 keys (64 at dh 256) in flight
// through TMA into a two-stage ring guarded by mbarriers.  Each tensor map
// is 3-d, [B*heads, S, dh] with boxes of 64 channels x rows, so a box past
// the end of one head's S is zero-filled instead of reading the next head;
// the loop masks those keys.  The maps are encoded on the host per call with
// the driver's cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint
// so the library needs no -lcuda.  The heads of a GQA group read the same
// K/V tiles from L2.  The p split (p_hi + p_lo) doubles the P V products:
// 1.5x the operations the bound counts.  The row blocks that see the most
// keys are started first.
//
// fp32: the CUDA-core kernel below (K7's design over fp32 tiles in shared
// memory, fp_tile.cuh), at most 67 TFLOP/s.  The tensor cores would
// take fp32 only as TF32, which keeps 10 bits of mantissa and would break
// the 1e-5 fp32 tolerance against the plain version.  One CTA of 256
// threads per (64 query vectors, KV head, batch row); a query vector is one
// (row, head) pair of the H/KV heads that share the KV head, so each K/V
// tile in shared memory serves the whole GQA group.  In the head-major
// layout the group's heads are H/KV separate [Sq, dh] planes; a vector v
// maps to row v / (H/KV) of plane v % (H/KV), for any group size.  Keys go
// in tiles of 32 tokens; each thread owns 4 vectors x 2 keys of the logits
// and 4 vectors x dh/16 channels of the output in registers; the 16
// threads that share a vector reduce the row max and sum with shuffles.
// Under `causal` a CTA stops at the last key its rows can see, and the
// CTAs of the last rows, which see the most keys, are started first.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_wgmma.cuh"
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

template <int kDH>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int Sq,
             int Sk, int H, int KV, int causal, float sm_scale) {
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
      x = q[plane(kh * gs + g) + row * kDH + d];
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
  const float* kb = k + kv_plane;
  const float* vb = v + kv_plane;

  for (long long t0 = 0; t0 < k_end; t0 += kTK) {
    __syncthreads();  // the previous tile is no longer read
    fpt::load_tile<kDH, kTK, kThreads>(kb, kDH, t0, k_end, kt, kLd);
    fpt::load_tile<kDH, kTK, kThreads>(vb, kDH, t0, k_end, vt, kLd);
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
    float* o = out + plane(head) + row * kDH + xg * kDPT;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int d = 0; d < kDPT; ++d) o[d] = acc[i][d] / den;
  }
}

template <int kDH>
int launch(const void* q, const void* k, const void* v, void* out,
           long long B, long long Sq, long long Sk, long long H, long long KV,
           int causal, float sm_scale, cudaStream_t st) {
  auto kernel = flash_kernel<kDH>;
  const size_t smem = smem_bytes<kDH>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_vec = Sq * (H / KV);
  const dim3 grid(static_cast<unsigned int>((n_vec + kVecs - 1) / kVecs),
                  static_cast<unsigned int>(KV), static_cast<unsigned int>(B));
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<int>(Sq), static_cast<int>(Sk), static_cast<int>(H),
      static_cast<int>(KV), causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_dh(long long dh, const void* q, const void* k, const void* v,
              void* out, long long B, long long Sq, long long Sk, long long H,
              long long KV, int causal, float sm_scale, cudaStream_t st) {
  switch (dh) {
    case 64:
      return launch<64>(q, k, v, out, B, Sq, Sk, H, KV, causal, sm_scale,
                           st);
    case 128:
      return launch<128>(q, k, v, out, B, Sq, Sk, H, KV, causal, sm_scale,
                            st);
    case 256:
      return launch<256>(q, k, v, out, B, Sq, Sk, H, KV, causal, sm_scale,
                            st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// -- bf16: the tensor-core loop with TMA loads -------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, or null where the driver lacks it
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 tensor [planes, rows, dh] (contiguous) read in boxes of 64 channels
// x box_rows rows of one plane, 128-byte swizzle, zeros past each plane's
// rows.
bool encode_map(CUtensorMap* map, const void* base, long long planes,
                long long rows, int dh, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(dh) * 2,
                                 static_cast<cuuint64_t>(rows) * dh * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The loader policy of flash_wgmma.cuh over head-major q [B, H, Sq, dh] and
// k/v [B, KV, Sk, dh]: one TMA box per 64-channel panel of a tile.
template <int kDH>
struct TmaLoader {
  CUtensorMap q, k, v;  // [B*H, Sq, dh] and [B*KV, Sk, dh]
  int H, KV;

  __device__ void load(const CUtensorMap* map, uint32_t dst, uint32_t bar,
                       int plane, int row0, int rows) const {
    hop::mbar_expect_tx(bar, static_cast<uint32_t>(rows) * kDH * 2);
#pragma unroll
    for (int p = 0; p < kDH / 64; ++p)
      hop::tma_load_3d(dst + p * rows * 128, map, bar, 64 * p, row0, plane);
  }
  __device__ void load_q(uint32_t dst, uint32_t bar, int b, int h,
                         int r0) const {
    load(&q, dst, bar, b * H + h, r0, fw::kRows);
  }
  __device__ void load_k(uint32_t dst, uint32_t bar, int b, int kh,
                         int t0) const {
    load(&k, dst, bar, b * KV + kh, t0, fw::Shape<kDH>::kBK);
  }
  __device__ void load_v(uint32_t dst, uint32_t bar, int b, int kh,
                         int t0) const {
    load(&v, dst, bar, b * KV + kh, t0, fw::Shape<kDH>::kBK);
  }
};

template <int kDH>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                long long B, long long Sq, long long Sk, long long H,
                long long KV, int causal, float sm_scale, cudaStream_t st) {
  TmaLoader<kDH> loader;
  loader.H = static_cast<int>(H);
  loader.KV = static_cast<int>(KV);
  if (!encode_map(&loader.q, q, B * H, Sq, kDH, fw::kRows) ||
      !encode_map(&loader.k, k, B * KV, Sk, kDH, fw::Shape<kDH>::kBK) ||
      !encode_map(&loader.v, v, B * KV, Sk, kDH, fw::Shape<kDH>::kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = fw::flash_wgmma_kernel<kDH, TmaLoader<kDH>>;
  const size_t smem = fw::Shape<kDH>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(H),
                  static_cast<unsigned int>((Sq + fw::kRows - 1) / fw::kRows),
                  static_cast<unsigned int>(B));
  kernel<<<grid, fw::kThreads, smem, st>>>(
      loader, static_cast<__nv_bfloat16*>(out), static_cast<int>(Sq),
      static_cast<int>(Sk), static_cast<int>(H), static_cast<int>(KV), causal,
      sm_scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kind: 0 = fp32, 1 = bf16 (q, k, v and out); dh: 64, 128 or 256.  q and out
// [B, H, Sq, dh], k and v [B, KV, Sk, dh], all contiguous and 16-byte
// aligned.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a kind or head_dim it was not built for, or
// when a tensor map cannot be encoded).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, long long B, long long Sq,
                               long long Sk, long long H, long long KV,
                               long long dh, int kind, int causal,
                               float sm_scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    return launch_dh(dh, q, k, v, out, B, Sq, Sk, H, KV, causal, sm_scale,
                     st);
  if (kind != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (dh) {
    case 64:
      return launch_bf16<64>(q, k, v, out, B, Sq, Sk, H, KV, causal,
                             sm_scale, st);
    case 128:
      return launch_bf16<128>(q, k, v, out, B, Sq, Sk, H, KV, causal,
                              sm_scale, st);
    case 256:
      return launch_bf16<256>(q, k, v, out, B, Sq, Sk, H, KV, causal,
                              sm_scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
