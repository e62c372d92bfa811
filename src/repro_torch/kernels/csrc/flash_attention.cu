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
// loader policy (`TmaLoader` below).  One CTA of 384 threads per (128
// query rows, head, batch row): two consumer warpgroups run S = Q K^T and
// P V on wgmma; one thread of a producer warpgroup keeps K/V tiles of 128
// keys (64 at dh 256) in flight through TMA into a two-stage ring guarded
// by mbarriers.  Each tensor map is 3-d, [B*heads, S, dh] with boxes of 64
// channels x rows, so a box past the end of one head's S is zero-filled
// instead of reading the next head; the loop masks those keys.  The maps
// are encoded on the host per call with the driver's
// cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint so the
// library needs no -lcuda.  The heads of a GQA group read the same
// K/V tiles from L2.  The p split (p_hi + p_lo) doubles the P V products:
// 1.5x the operations the bound counts.  The row blocks that see the most
// keys are started first.
//
// fp32: the CUDA-core loop of flash_fp32.cuh with plain tile copies, at
// most 67 TFLOP/s.  The tensor cores would take fp32 only as TF32, which
// keeps 10 bits of mantissa and would break the 1e-5 fp32 tolerance against
// the plain version.  In the head-major layout the GQA group's heads are
// H/KV separate [Sq, dh] planes; the policy places a row of head h at
// ((b H + h) Sq + row) dh.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_fp32.cuh"
#include "flash_wgmma.cuh"

namespace {

// -- fp32: the CUDA-core loop with plain tile copies -------------------------

// The tile policy of flash_fp32.cuh over head-major q/out [B, H, Sq, dh] and
// k/v [B, KV, Sk, dh].
template <int kDH>
struct FpTiles {
  const float* k;
  const float* v;
  int Sq, Sk, H, KV;

  __device__ __forceinline__ long long row(int b, int head,
                                           long long r) const {
    return ((static_cast<long long>(b) * H + head) * Sq + r) * kDH;
  }
  __device__ __forceinline__ void load(bool value, int b, int kh,
                                       long long t0, long long t_end,
                                       float* dst, int ld) const {
    const long long plane = (static_cast<long long>(b) * KV + kh) * Sk * kDH;
    ff::load_fp_tile<kDH>((value ? v : k) + plane, t0, t_end, dst, ld);
  }
};

template <int kDH>
int launch_fp32(const void* q, const void* k, const void* v, void* out,
                long long B, long long Sq, long long Sk, long long H,
                long long KV, int causal, float sm_scale, cudaStream_t st) {
  const FpTiles<kDH> tiles{static_cast<const float*>(k),
                           static_cast<const float*>(v), static_cast<int>(Sq),
                           static_cast<int>(Sk), static_cast<int>(H),
                           static_cast<int>(KV)};
  return ff::launch<kDH>(tiles, static_cast<const float*>(q),
                         static_cast<float*>(out), nullptr, nullptr, B, Sq,
                         Sk, H, KV, causal, 0, sm_scale, st);
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

// The policy of flash_wgmma.cuh over head-major q/out [B, H, Sq, dh] and
// k/v [B, KV, Sk, dh]: a plane is one head, one TMA box per 64-channel
// panel of a tile, asked for by one producer thread.
template <int kDH_>
struct TmaLoader {
  static constexpr int kDH = kDH_;
  // keys per tile: at dh 256 a 128-key tile would not leave the registers
  // for the 64 x 256 output accumulator
  static constexpr int kBK = kDH == 256 ? 64 : 128;
  static constexpr int kStages = 2;
  static constexpr int kKPieces = 1;
  static constexpr int kVPieces = 1;
  static constexpr bool kQRegs = false;
  static constexpr int kProducerRegs = 24;
  static constexpr int kLoaderThreads = 1;
  static constexpr int kArrivals = 1;
  CUtensorMap q, k, v;  // [B*H, Sq, dh] and [B*KV, Sk, dh]
  __nv_bfloat16* out;
  int H, KV;
  int n_vec, gs, q_offset;  // Sq, 1, 0

  __device__ int kv_head(int h) const { return h / (H / KV); }
  __device__ void load(const CUtensorMap* map, uint32_t dst, uint32_t bar,
                       int plane, int row0, int rows) const {
    hop::mbar_expect_tx(bar, static_cast<uint32_t>(rows) * kDH * 2);
#pragma unroll
    for (int p = 0; p < kDH / 64; ++p)
      hop::tma_load_3d(dst + p * rows * 128, map, bar, 64 * p, row0, plane);
  }
  __device__ void load_q(int, uint32_t dst, uint32_t bar, int b, int h,
                         int r0) const {
    load(&q, dst, bar, b * H + h, r0, fw::kRows);
  }
  template <class Free>
  __device__ void load_kv(int, uint32_t k_dst, uint32_t k_bar,
                          uint32_t v_dst, uint32_t v_bar, int b, int kh,
                          int t0, Free free) const {
    free();
    load(&k, k_dst, k_bar, b * KV + kh, t0, kBK);
    load(&v, v_dst, v_bar, b * KV + kh, t0, kBK);
  }
  __device__ __nv_bfloat16* out_row(int b, int h, int row) const {
    return out + ((static_cast<long long>(b) * H + h) * n_vec + row) * kDH;
  }
  __device__ void store_ml(int, int, int, float, float) const {}
};

template <int kDH>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                long long B, long long Sq, long long Sk, long long H,
                long long KV, int causal, float sm_scale, cudaStream_t st) {
  using P = TmaLoader<kDH>;
  P pol;
  pol.out = static_cast<__nv_bfloat16*>(out);
  pol.H = static_cast<int>(H);
  pol.KV = static_cast<int>(KV);
  pol.n_vec = static_cast<int>(Sq);
  pol.gs = 1;
  pol.q_offset = 0;
  if (!encode_map(&pol.q, q, B * H, Sq, kDH, fw::kRows) ||
      !encode_map(&pol.k, k, B * KV, Sk, kDH, P::kBK) ||
      !encode_map(&pol.v, v, B * KV, Sk, kDH, P::kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = fw::flash_wgmma_kernel<P>;
  const size_t smem = fw::Shape<P>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(H),
                  static_cast<unsigned int>((Sq + fw::kRows - 1) / fw::kRows),
                  static_cast<unsigned int>(B));
  kernel<<<grid, fw::kThreads, smem, st>>>(
      pol, static_cast<int>(Sk), causal, sm_scale * 1.4426950408889634f, 1,
      nullptr, nullptr, nullptr);
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
  if (kind != 0 && kind != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (dh) {
    case 64:
      return (kind ? launch_bf16<64> : launch_fp32<64>)(
          q, k, v, out, B, Sq, Sk, H, KV, causal, sm_scale, st);
    case 128:
      return (kind ? launch_bf16<128> : launch_fp32<128>)(
          q, k, v, out, B, Sq, Sk, H, KV, causal, sm_scale, st);
    case 256:
      return (kind ? launch_bf16<256> : launch_fp32<256>)(
          q, k, v, out, B, Sq, Sk, H, KV, causal, sm_scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
