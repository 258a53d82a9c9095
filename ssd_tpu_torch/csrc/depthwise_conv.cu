// Depthwise 'SAME' 1-D convolution, forward and backward, for Hopper (sm_90a).
//
// Replace the Pallas kernels ssd_tpu/ops/depthwise_conv.py:_fwd_kernel
// (called through _fwd_call) and ssd_tpu/ops/depthwise_conv.py:_bwd_kernel
// (called through _bwd_call). Channel-last x, g, y, dx (B, T, C) fp32, taps
// w (K, C), odd K, pad = (K − 1) / 2, rows outside [0, T) read as zero:
//
//   y[t, c]       = b[c] + Σ_j w[j, c] · x[t + j − pad, c]
//   dx[t, c]      = Σ_j w[j, c] · g[t + pad − j, c]        (the flipped stencil)
//   dwp[b, i, j, c] = Σ_{t in time tile i} g[t, c] · x[t + j − pad, c]
//
// with the taps accumulated in the TPU kernel's order (bias first, then
// j = 0 … K − 1) as an unfused multiply and add, so the forward equals a
// plain mul-then-add loop bit for bit. The per-tile dw partials are summed
// over (b, i) outside the kernel with torch.sum, as the JAX VJP sums its
// (B, K, C) partials outside its kernel; db = Σ g is likewise outside.
//
// What bounds it: 2·K flops per output against 8 bytes (one read, one write)
// — 3.75 flops a byte at K = 15, far below the card's 20 fp32 flops a byte,
// so the op is bytes-bound: 7.37 MB at B = 5, T = 640, C = 288 is 2.2 µs at
// 3.35 TB/s. The backward reads x and g and writes dx: 1.5× the bytes.
//
// What the design does about it. The TPU kernel keeps one batch element's
// whole (T, C) tile in VMEM; 227 KB of shared memory holds no such tile, so:
//   * one CTA takes (32 channels, 64 time rows, one batch row); its rows plus
//     the K − 1 halo are staged in shared memory, one warp per row, 128
//     contiguous bytes a warp (channel-last is contiguous in C);
//   * 256 threads = 32 channels × 8 row groups; a thread keeps its channel's
//     K taps and a sliding window of 8 + K − 1 inputs in registers (K is
//     unrolled up to a compile-time bound of 15 or 31) and writes 8 rows;
//   * the dw partials of the 8 row groups meet in shared memory and are
//     summed in a fixed order: one row per (b, time tile), no atomics, so
//     the gradients are bit-reproducible from run to run.

#include <cuda_runtime.h>

namespace {

constexpr int kCh = 32;                  // channels per CTA
constexpr int kGroups = 8;               // row groups per CTA
constexpr int kRows = 8;                 // output rows per thread
constexpr int kTile = kGroups * kRows;   // 64 time rows per CTA
constexpr int kThreads = kCh * kGroups;  // 256
constexpr int kMaxK = 31;

// Stage rows [r0, r0 + n) × channels [c0, c0 + kCh) of one (T, C) slab into
// dst (n × kCh); zero outside [0, T) and past C.
__device__ __forceinline__ void stage(const float* __restrict__ src, float* dst, int r0, int n,
                                      int T, int C, int c0) {
  for (int i = threadIdx.x; i < n * kCh; i += kThreads) {
    const int r = r0 + i / kCh;
    const int c = c0 + i % kCh;
    dst[i] = (r >= 0 && r < T && c < C) ? src[static_cast<long long>(r) * C + c] : 0.f;
  }
}

template <int KMAX>
__global__ void __launch_bounds__(kThreads)
dw_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ bias, float* __restrict__ y, int T, int C, int K) {
  extern __shared__ float xs[];  // (kTile + K − 1) × kCh: x rows t0 − pad …
  const int pad = (K - 1) / 2;
  const int cl = threadIdx.x % kCh;
  const int grp = threadIdx.x / kCh;
  const int c0 = blockIdx.x * kCh;
  const int t0 = blockIdx.y * kTile;
  const int c = c0 + cl;
  const long long slab = static_cast<long long>(blockIdx.z) * T * C;

  stage(x + slab, xs, t0 - pad, kTile + K - 1, T, C, c0);
  float taps[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) taps[j] = (j < K && c < C) ? w[j * C + c] : 0.f;
  const float b0 = c < C ? bias[c] : 0.f;
  __syncthreads();
  if (c >= C) return;

  const int rbase = grp * kRows;
  float win[kRows + KMAX - 1];  // x rows t0 − pad + rbase + i
#pragma unroll
  for (int i = 0; i < kRows + KMAX - 1; ++i)
    win[i] = i < kRows + K - 1 ? xs[(rbase + i) * kCh + cl] : 0.f;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float acc = b0;
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if (j < K) acc = __fadd_rn(acc, __fmul_rn(win[r + j], taps[j]));
    const int t = t0 + rbase + r;
    if (t < T) y[slab + static_cast<long long>(t) * C + c] = acc;
  }
}

template <int KMAX>
__global__ void __launch_bounds__(kThreads)
dw_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ g, float* __restrict__ dx, float* __restrict__ dwp,
              int T, int C, int K, int n_tiles) {
  extern __shared__ float smem[];
  const int halo_rows = kTile + K - 1;
  float* xs = smem;                      // halo_rows × kCh: x rows t0 − pad …
  float* gs = smem + halo_rows * kCh;    // halo_rows × kCh: g rows t0 − pad …
  float* red = gs + halo_rows * kCh;     // kGroups × K × kCh dw partials
  const int pad = (K - 1) / 2;
  const int cl = threadIdx.x % kCh;
  const int grp = threadIdx.x / kCh;
  const int c0 = blockIdx.x * kCh;
  const int t0 = blockIdx.y * kTile;
  const int c = c0 + cl;
  const long long slab = static_cast<long long>(blockIdx.z) * T * C;

  stage(x + slab, xs, t0 - pad, halo_rows, T, C, c0);
  stage(g + slab, gs, t0 - pad, halo_rows, T, C, c0);
  __syncthreads();
  const int rbase = grp * kRows;

  if (c < C) {
    // dx[t] = Σ_j w[j] · g[t + pad − j]; with flipped taps f[i] = w[K − 1 − i]
    // it is Σ_i f[i] · g[t − pad + i], taken for i = K − 1 … 0, i.e. j = 0 … K − 1
    float flip[KMAX];
#pragma unroll
    for (int i = 0; i < KMAX; ++i) flip[i] = i < K ? w[(K - 1 - i) * C + c] : 0.f;
    float win[kRows + KMAX - 1];  // g rows t0 − pad + rbase + i
#pragma unroll
    for (int i = 0; i < kRows + KMAX - 1; ++i)
      win[i] = i < kRows + K - 1 ? gs[(rbase + i) * kCh + cl] : 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float acc = 0.f;
#pragma unroll
      for (int i = KMAX - 1; i >= 0; --i)
        if (i < K) acc = __fadd_rn(acc, __fmul_rn(win[r + i], flip[i]));
      const int t = t0 + rbase + r;
      if (t < T) dx[slab + static_cast<long long>(t) * C + c] = acc;
    }
  }

  // dw partials of this thread's 8 rows: Σ_r g[t] · x[t + j − pad]; g rows
  // at or past T are staged as zeros and add nothing
  float part[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) part[j] = 0.f;
  {
    float win[kRows + KMAX - 1];  // x rows t0 − pad + rbase + i
#pragma unroll
    for (int i = 0; i < kRows + KMAX - 1; ++i)
      win[i] = i < kRows + K - 1 ? xs[(rbase + i) * kCh + cl] : 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float gv = gs[(pad + rbase + r) * kCh + cl];
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        if (j < K) part[j] = __fadd_rn(part[j], __fmul_rn(gv, win[r + j]));
    }
  }
#pragma unroll
  for (int j = 0; j < KMAX; ++j)
    if (j < K) red[(grp * K + j) * kCh + cl] = part[j];
  __syncthreads();
  const long long row = (static_cast<long long>(blockIdx.z) * n_tiles + blockIdx.y) * K;
  for (int i = threadIdx.x; i < K * kCh; i += kThreads) {
    const int j = i / kCh;
    const int cc = c0 + i % kCh;
    if (cc >= C) continue;
    float s = 0.f;
    for (int q = 0; q < kGroups; ++q) s = __fadd_rn(s, red[(q * K + j) * kCh + i % kCh]);
    dwp[(row + j) * C + cc] = s;
  }
}

inline dim3 grid_for(int B, int T, int C) {
  return dim3((C + kCh - 1) / kCh, (T + kTile - 1) / kTile, B);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int KMAX>
cudaError_t launch_fwd(const float* x, const float* w, const float* b, float* y, int B, int T,
                       int C, int K, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kTile + K - 1) * kCh * sizeof(float);
  cudaError_t err = allow_smem(dw_fwd_kernel<KMAX>, smem);
  if (err != cudaSuccess) return err;
  dw_fwd_kernel<KMAX><<<grid_for(B, T, C), kThreads, smem, stream>>>(x, w, b, y, T, C, K);
  return cudaGetLastError();
}

template <int KMAX>
cudaError_t launch_bwd(const float* x, const float* w, const float* g, float* dx, float* dwp,
                       int B, int T, int C, int K, cudaStream_t stream) {
  const size_t smem =
      (2 * static_cast<size_t>(kTile + K - 1) * kCh + static_cast<size_t>(kGroups) * K * kCh) *
      sizeof(float);
  cudaError_t err = allow_smem(dw_bwd_kernel<KMAX>, smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (T + kTile - 1) / kTile;
  dw_bwd_kernel<KMAX><<<grid_for(B, T, C), kThreads, smem, stream>>>(x, w, g, dx, dwp, T, C, K,
                                                                     n_tiles);
  return cudaGetLastError();
}

inline bool valid(int B, int T, int C, int K) {
  return B >= 1 && T >= 1 && C >= 1 && K >= 1 && K % 2 == 1 && K <= kMaxK && B <= 65535;
}

}  // namespace

extern "C" {

const char* ssd_dw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (B, T, C), w (K, C), b (C,), y (B, T, C), all f32 contiguous; odd K ≤ 31.
cudaError_t ssd_dw_fwd_launch(const float* x, const float* w, const float* b, float* y, int B,
                              int T, int C, int K, cudaStream_t stream) {
  if (!valid(B, T, C, K)) return cudaErrorInvalidValue;
  if (K <= 15) return launch_fwd<15>(x, w, b, y, B, T, C, K, stream);
  return launch_fwd<kMaxK>(x, w, b, y, B, T, C, K, stream);
}

// x, g, dx (B, T, C); w (K, C); dwp (B, ⌈T / 64⌉, K, C); f32
// contiguous; odd K ≤ 31.
cudaError_t ssd_dw_bwd_launch(const float* x, const float* w, const float* g, float* dx,
                              float* dwp, int B, int T, int C, int K, cudaStream_t stream) {
  if (!valid(B, T, C, K)) return cudaErrorInvalidValue;
  if (K <= 15) return launch_bwd<15>(x, w, g, dx, dwp, B, T, C, K, stream);
  return launch_bwd<kMaxK>(x, w, g, dx, dwp, B, T, C, K, stream);
}

}  // extern "C"
