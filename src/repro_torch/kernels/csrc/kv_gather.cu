// K8: gather of chunk tiles from a paged arena by an index vector,
// hand-written for Hopper (sm_90a).  Plain C interface, bound from Python with
// ctypes (repro_torch/kernels/kv_gather.py); the launch goes on the caller's
// stream and the entry point returns cudaGetLastError().
//
// Replaces src/repro/kernels/kv_gather.py:48 `kv_gather` (its `pallas_call`,
// body `_kernel`): the last hop of the server-side aggregation, which copies
// the [G, W] tiles of the matched chunks out of the device's paged arena
// [P, G, W] into one contiguous [N, G, W] buffer, out[n] = pool[idx[n]].
//
// The copy moves bytes and does no arithmetic, so it serves any element type:
// a tile is tile_bytes bytes.  Indices are int32 or int64; each is clamped
// into [0, P) so the kernel never reads outside the pool (the contract is
// 0 <= idx < P; the TPU kernel leaves an index outside it undefined).
// Repeated indices copy the same tile again.
//
// Bound: bytes.  At the warm request's shape (N=15 tiles of one layer slice
// of a llama3-1-8b chunk, 256 x 2048 bf16 words = 1 MiB each) it reads and
// writes 15.7 MB each: 9.4 us at 3.35 TB/s.
//
// Design: the TPU kernel ran one grid step per tile and let the DMA engine
// copy it; one CTA per tile would leave most of the 132 SMs idle at N=15.
// Here a tile is cut into pieces of 32 KiB, one CTA of 256 threads each
// (32 per 1 MiB tile, 480 CTAs at N=15).  Each thread copies words of 16
// bytes when the tile size and both base pointers allow it (the narrowest
// of them sets the word: 16, 8, 4, 2 or 1 bytes), four words in flight: all
// loads of a round are issued before its stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;            // words in flight per thread
constexpr long long kCtaBytes = 32768;  // bytes of a tile one CTA copies

template <typename W, typename I>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const W* __restrict__ pool, const I* __restrict__ idx,
              W* __restrict__ out, long long P, long long tile_words,
              long long cta_words) {
  const long long n = blockIdx.x;
  long long src = static_cast<long long>(idx[n]);
  src = src < 0 ? 0 : (src >= P ? P - 1 : src);
  const W* from = pool + src * tile_words;
  W* to = out + n * tile_words;
  const long long lo = static_cast<long long>(blockIdx.y) * cta_words;
  const long long hi =
      lo + cta_words < tile_words ? lo + cta_words : tile_words;
  for (long long i = lo + threadIdx.x; i < hi;
       i += static_cast<long long>(kThreads) * kUnroll) {
    W buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + static_cast<long long>(u) * kThreads;
      if (j < hi) buf[u] = from[j];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + static_cast<long long>(u) * kThreads;
      if (j < hi) to[j] = buf[u];
    }
  }
}

template <typename W, typename I>
int launch(const void* pool, const void* idx, void* out, long long P,
           long long N, long long tile_bytes, cudaStream_t st) {
  const long long tile_words = tile_bytes / static_cast<long long>(sizeof(W));
  const long long cta_words = kCtaBytes / static_cast<long long>(sizeof(W));
  const long long pieces = (tile_words + cta_words - 1) / cta_words;
  if (N > 0x7fffffffLL || pieces > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(N),
                  static_cast<unsigned int>(pieces));
  gather_kernel<W, I><<<grid, kThreads, 0, st>>>(
      static_cast<const W*>(pool), static_cast<const I*>(idx),
      static_cast<W*>(out), P, tile_words, cta_words);
  return static_cast<int>(cudaGetLastError());
}

template <typename I>
int launch_word(const void* pool, const void* idx, void* out, long long P,
                long long N, long long tile_bytes, cudaStream_t st) {
  // the widest word that divides the tile and both base addresses
  const unsigned long long align =
      static_cast<unsigned long long>(tile_bytes) |
      reinterpret_cast<uintptr_t>(pool) | reinterpret_cast<uintptr_t>(out);
  if (align % 16 == 0)
    return launch<uint4, I>(pool, idx, out, P, N, tile_bytes, st);
  if (align % 8 == 0)
    return launch<uint2, I>(pool, idx, out, P, N, tile_bytes, st);
  if (align % 4 == 0)
    return launch<uint32_t, I>(pool, idx, out, P, N, tile_bytes, st);
  if (align % 2 == 0)
    return launch<uint16_t, I>(pool, idx, out, P, N, tile_bytes, st);
  return launch<uint8_t, I>(pool, idx, out, P, N, tile_bytes, st);
}

}  // namespace

// pool [P, tile_bytes] and out [N, tile_bytes] as bytes (contiguous); idx [N]
// int32 (idx64 = 0) or int64 (idx64 = 1).  N >= 1, tile_bytes >= 1.  Returns
// cudaGetLastError() after the launch.
extern "C" int kv_gather(const void* pool, const void* idx, int idx64,
                         void* out, long long P, long long N,
                         long long tile_bytes, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P < 1 || N < 1 || tile_bytes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (idx64)
    return launch_word<long long>(pool, idx, out, P, N, tile_bytes, st);
  return launch_word<int>(pool, idx, out, P, N, tile_bytes, st);
}
