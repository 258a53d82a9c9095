// A yardstick for the depthwise forward kernel of
// ssd_tpu_torch/csrc/depthwise_conv.cu, built and timed only by
// scripts/bench_depthwise_variants.py: the same function (bias first, then
// the taps j = 0 … K − 1 as an unfused multiply and add, bit-equal to the
// plain version) in the backward kernel's design. One CTA takes (batch row,
// kFwdCh channels, a strip of 64-row tiles) and walks it through a
// kFwdStages-deep cp.async ring in shared memory (16-byte copies where
// C % 4 == 0 and x is 16-byte aligned, 4-byte ones otherwise; rows outside
// [0, T) and channels past C zero-filled by the copy), each tile's K − 1 halo
// carried from the previous tile, the next tile's copies issued before this
// tile's arithmetic under one barrier a tile; the strip count comes from the
// backward's cost model (bwd_strips). Same C ABI as the package's forward.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kGroups = 8;                     // row groups a CTA
constexpr int kRows = 8;                       // output rows a thread and tile
constexpr int kTile = kGroups * kRows;         // 64 time rows a tile
constexpr int kMaxK = 31;
constexpr int kRingRows = 256;                 // rows the ring holds, a power of 2
constexpr int kFwdCh = 32;                     // channels a CTA
constexpr int kFwdThreads = kFwdCh * kGroups;  // 256
constexpr int kFwdStages = 2;                  // tiles in flight
constexpr int kFwdStripTiles = 0;              // tiles a strip; 0: the cost model
static_assert(kFwdStages * kTile + kMaxK - 1 <= kRingRows,
              "the ring holds a tile, its halo and the tiles in flight");

__device__ __forceinline__ unsigned smem_addr(const float* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(in ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(in ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Tile i's copies as one group: time row t sits in ring row
// (t − ts + pad) mod kRingRows; group 0 brings [ts − pad, ts + 64 + pad),
// group i > 0 [ts + 64·i + pad, ts + 64·(i + 1) + pad); empty past the strip.
template <bool kVec>
__device__ __forceinline__ void copy_tile(float* ring, const float* x, int i, int tiles, int ts,
                                          int pad, int T, int C, int c0, long long slab) {
  if (i < tiles) {
    const int r0 = i == 0 ? ts - pad : ts + i * kTile + pad;
    const int n = i == 0 ? kTile + 2 * pad : kTile;
    constexpr int kPer = kVec ? 4 : 1;
    constexpr int kCopies = kFwdCh / kPer;
    for (int q = threadIdx.x; q < n * kCopies; q += kFwdThreads) {
      const int r = r0 + q / kCopies;
      const int cc = (q % kCopies) * kPer;
      const bool in = r >= 0 && r < T && c0 + cc < C;
      const long long off = in ? slab + static_cast<long long>(r) * C + c0 + cc : 0;
      float* dst = ring + ((r - ts + pad) & (kRingRows - 1)) * kFwdCh + cc;
      if constexpr (kVec) {
        cp_async16(dst, x + off, in);
      } else {
        cp_async4(dst, x + off, in);
      }
    }
  }
  cp_async_commit();
}

template <int KMAX, bool kVec>
__global__ void __launch_bounds__(kFwdThreads)
dw_fwd_ring_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ y, int T, int C, int K,
                   int strip_tiles) {
  extern __shared__ float ring[];  // kRingRows × kFwdCh
  const int pad = (K - 1) / 2;
  const int cl = threadIdx.x % kFwdCh;
  const int grp = threadIdx.x / kFwdCh;
  const int c0 = blockIdx.x * kFwdCh;
  const int c = c0 + cl;
  const long long slab = static_cast<long long>(blockIdx.z) * T * C;
  const int tile0 = blockIdx.y * strip_tiles;
  const int tiles = max(0, min(strip_tiles, (T + kTile - 1) / kTile - tile0));
  const int ts = tile0 * kTile;
#pragma unroll
  for (int i = 0; i < kFwdStages - 1; ++i)
    copy_tile<kVec>(ring, x, i, tiles, ts, pad, T, C, c0, slab);
  float taps[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) taps[j] = (j < K && c < C) ? w[j * C + c] : 0.f;
  const float b0 = c < C ? bias[c] : 0.f;
  for (int i = 0; i < tiles; ++i) {
    cp_async_wait<kFwdStages - 2>();
    __syncthreads();
    copy_tile<kVec>(ring, x, i + kFwdStages - 1, tiles, ts, pad, T, C, c0, slab);
    const int base = i * kTile + grp * kRows;
    const int t0 = ts + base;
    float win[kRows + KMAX - 1];
#pragma unroll
    for (int q = 0; q < kRows + KMAX - 1; ++q)
      win[q] = q < kRows + K - 1 ? ring[((base + q) & (kRingRows - 1)) * kFwdCh + cl] : 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float acc = b0;
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        if (j < K) acc = __fadd_rn(acc, __fmul_rn(win[r + j], taps[j]));
      if (t0 + r < T && c < C) y[slab + static_cast<long long>(t0 + r) * C + c] = acc;
    }
  }
}

// The backward's strip cost model (csrc/depthwise_conv.cu bwd_strips).
int strips_for(int B, int T, int C, int sms) {
  const int tiles = (T + kTile - 1) / kTile;
  const long long rows = static_cast<long long>(B) * ((C + kFwdCh - 1) / kFwdCh);
  int best = tiles;
  float best_cost = 0.f;
  for (int p = 1; p <= tiles; ++p) {
    const long long ctas = rows * ((tiles + p - 1) / p);
    const float cost = static_cast<float>((ctas + sms - 1) / sms) * (p + 0.5f);
    if (p == 1 || cost < best_cost) best = p, best_cost = cost;
  }
  if (kFwdStripTiles > 0) best = kFwdStripTiles < tiles ? kFwdStripTiles : tiles;
  return (tiles + best - 1) / best;
}

template <int KMAX, bool kVec>
cudaError_t launch(const float* x, const float* w, const float* b, float* y, int B, int T, int C,
                   int K, int strips, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kRingRows) * kFwdCh * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(dw_fwd_ring_kernel<KMAX, kVec>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (T + kTile - 1) / kTile;
  const dim3 grid((C + kFwdCh - 1) / kFwdCh, strips, B);
  dw_fwd_ring_kernel<KMAX, kVec><<<grid, kFwdThreads, smem, stream>>>(
      x, w, b, y, T, C, K, (tiles + strips - 1) / strips);
  return cudaGetLastError();
}

template <int KMAX>
cudaError_t launch_k(const float* x, const float* w, const float* b, float* y, int B, int T,
                     int C, int K, int strips, cudaStream_t stream) {
  const bool vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return vec ? launch<KMAX, true>(x, w, b, y, B, T, C, K, strips, stream)
             : launch<KMAX, false>(x, w, b, y, B, T, C, K, strips, stream);
}

}  // namespace

extern "C" {

const char* ssd_dw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int ssd_dw_fwd_strips(int B, int T, int C, int sms) { return strips_for(B, T, C, sms); }

cudaError_t ssd_dw_fwd_launch(const float* x, const float* w, const float* b, float* y, int B,
                              int T, int C, int K, cudaStream_t stream) {
  if (B < 1 || T < 1 || C < 1 || K < 1 || K % 2 == 0 || K > kMaxK || B > 65535)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int strips = strips_for(B, T, C, sms);
  if (K <= 15) return launch_k<15>(x, w, b, y, B, T, C, K, strips, stream);
  return launch_k<kMaxK>(x, w, b, y, B, T, C, K, strips, stream);
}

}  // extern "C"
