// Depthwise 'SAME' 1-D convolution, forward and backward, for Hopper (sm_90a).
//
// Replace the Pallas kernels ssd_tpu/ops/depthwise_conv.py:_fwd_kernel
// (called through _fwd_call) and ssd_tpu/ops/depthwise_conv.py:_bwd_kernel
// (called through _bwd_call). Channel-last x, g, y, dx (B, T, C) fp32, taps
// w (K, C), odd K, pad = (K − 1) / 2, rows outside [0, T) read as zero:
//
//   y[t, c]       = b[c] + Σ_j w[j, c] · x[t + j − pad, c]
//   dx[t, c]      = Σ_j w[j, c] · g[t + pad − j, c]        (the flipped stencil)
//   part[b, s, j, c] = Σ_{t in strip s} g[t, c] · x[t + j − pad, c]   (j < K)
//   part[b, s, K, c] = Σ_{t in strip s} g[t, c]                       (db)
//
// with the taps accumulated in the TPU kernel's order (bias first, then
// j = 0 … K − 1) as an unfused multiply and add, so the forward equals a
// plain mul-then-add loop bit for bit. The backward's partials are summed
// over (b, s) outside the kernel with one torch.sum, as the JAX VJP sums its
// (B, K, C) dw partials outside its kernel (it takes db = Σ g outside too;
// here g is already staged, so its sum rides along as the (K + 1)-th row).
//
// What bounds it: 2·K flops per output against 8 bytes (one read, one write)
// — 3.75 flops a byte at K = 15, far below the card's 20 fp32 flops a byte,
// so the op is bytes-bound: 7.37 MB at B = 5, T = 640, C = 288 is 2.2 µs at
// 3.35 TB/s. The backward reads x and g and writes dx: 1.5× the bytes.
//
// What the design does about it. The TPU kernel keeps one batch element's
// whole (T, C) tile in VMEM; 227 KB of shared memory holds no such tile, so:
//   * forward: one CTA takes (32 channels, 64 time rows, one batch row); its
//     rows plus the K − 1 halo are staged in shared memory, one warp per row,
//     128 contiguous bytes a warp (channel-last is contiguous in C);
//     256 threads = 32 channels × 8 row groups; a thread keeps its channel's
//     K taps and a sliding window of 8 + K − 1 inputs in registers (K is
//     unrolled up to a compile-time bound of 15 or 31) and writes 8 rows;
//   * backward: one CTA takes one batch row × kBwdCh channels over a strip of
//     whole 64-row tiles — strips as long as balance the SMs (bwd_strips) —
//     and walks it through a kStages-deep cp.async ring of x and g rows in
//     shared memory (16-byte copies where C and the pointers allow, 4-byte
//     ones otherwise; rows outside [0, T) and channels past C zero-filled by
//     the copy itself). A tile's K − 1 halo rows are the previous tile's, still
//     in the ring, so a strip reads each row once; the next tile's copies
//     overlap this tile's arithmetic, under one barrier a tile. A thread
//     (channel, row group) keeps its flipped taps, its K dw partials and
//     its db partial in registers across the strip, each a chain of fused
//     multiply-adds (dx stays within 1e-5 of the plain version's unfused
//     sum); at its end the row groups meet in shared memory and are summed
//     in a fixed order into one (K + 1) × kBwdCh row per (b, strip): no
//     atomics, so the gradients are bit-reproducible from run to run.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCh = 32;                  // forward: channels per CTA
constexpr int kGroups = 8;               // row groups per CTA
constexpr int kRows = 8;                 // output rows per thread and tile
constexpr int kTile = kGroups * kRows;   // 64 time rows a tile
constexpr int kThreads = kCh * kGroups;  // 256
constexpr int kMaxK = 31;
constexpr int kBwdCh = 32;                     // backward: channels per CTA
constexpr int kBwdThreads = kBwdCh * kGroups;  // 256
constexpr int kStages = 2;                     // backward ring: tiles in flight
constexpr int kRingRows = 256;                 // x (and g) rows the ring holds, a power of 2
constexpr int kBwdMinBlocks = 1;               // CTAs an SM the K ≤ 15 instance is built for
constexpr int kStripTiles = 0;                 // tiles a strip; 0: bwd_strips' cost model
static_assert(kStages * kTile + kMaxK - 1 <= kRingRows,
              "the ring holds a tile, its halo and the tiles in flight");

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

__device__ __forceinline__ unsigned smem_addr(const float* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// Copy 16 (4) bytes, or zero-fill them when in is false (no bytes read).
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

// The backward over one (channel slab, strip of strip_tiles tiles, batch
// row). Ring: kRingRows × kBwdCh floats of x, then of g; time row t sits in
// ring row (t − t_s + pad) mod kRingRows, t_s the strip's first row. Copy
// group i brings tile i's new rows: for i = 0 the tile and both halos,
// [t_s − pad, t_s + 64 + pad), after that [t_s + 64·i + pad, t_s + 64·(i+1) + pad).
template <int KMAX, bool kVec>
__global__ void __launch_bounds__(kBwdThreads, KMAX <= 15 ? kBwdMinBlocks : 1)
dw_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ g, float* __restrict__ dx, float* __restrict__ part,
              int T, int C, int K, int strips, int strip_tiles) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* gs = smem + kRingRows * kBwdCh;
  const int pad = (K - 1) / 2;
  const int cl = threadIdx.x % kBwdCh;
  const int grp = threadIdx.x / kBwdCh;
  const int c0 = blockIdx.x * kBwdCh;
  const int c = c0 + cl;
  const int strip = blockIdx.y;
  const long long slab = static_cast<long long>(blockIdx.z) * T * C;
  const int tile0 = strip * strip_tiles;
  const int tiles = max(0, min(strip_tiles, (T + kTile - 1) / kTile - tile0));
  const int ts = tile0 * kTile;

  auto issue = [&](int i) {
    if (i < tiles) {
      const int r0 = i == 0 ? ts - pad : ts + i * kTile + pad;
      const int n = i == 0 ? kTile + 2 * pad : kTile;
      constexpr int kPer = kVec ? 4 : 1;         // floats a copy
      constexpr int kCopies = kBwdCh / kPer;     // copies a row
      for (int q = threadIdx.x; q < n * kCopies; q += kBwdThreads) {
        const int r = r0 + q / kCopies;
        const int cc = (q % kCopies) * kPer;
        const bool in = r >= 0 && r < T && c0 + cc < C;
        const long long off = in ? slab + static_cast<long long>(r) * C + c0 + cc : 0;
        const int at = ((r - ts + pad) & (kRingRows - 1)) * kBwdCh + cc;
        if constexpr (kVec) {
          cp_async16(xs + at, x + off, in);
          cp_async16(gs + at, g + off, in);
        } else {
          cp_async4(xs + at, x + off, in);
          cp_async4(gs + at, g + off, in);
        }
      }
    }
    cp_async_commit();  // one group a tile, empty past the strip
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  // dx[t] = Σ_j w[j] · g[t + pad − j]; with flipped taps f[i] = w[K − 1 − i]
  // it is Σ_i f[i] · g[t − pad + i], taken for i = K − 1 … 0, i.e. j = 0 … K − 1
  float flip[KMAX], dwp[KMAX];
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    flip[i] = (i < K && c < C) ? w[(K - 1 - i) * C + c] : 0.f;
    dwp[i] = 0.f;
  }
  float db = 0.f;
  for (int i = 0; i < tiles; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile i landed …
    __syncthreads();               // … and everyone's; tile i − 1 is read
    issue(i + kStages - 1);
    const int base = i * kTile + grp * kRows;  // ring row of this thread's first window row
    const int t0 = ts + base;                  // its first output row
    float win[kRows + KMAX - 1];
#pragma unroll
    for (int q = 0; q < kRows + KMAX - 1; ++q)
      win[q] = q < kRows + K - 1 ? gs[((base + q) & (kRingRows - 1)) * kBwdCh + cl] : 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float acc = 0.f;
#pragma unroll
      for (int q = KMAX - 1; q >= 0; --q)
        if (q < K) acc = fmaf(win[r + q], flip[q], acc);
      if (t0 + r < T && c < C) dx[slab + static_cast<long long>(t0 + r) * C + c] = acc;
    }
    // dw partials Σ_r g[t] · x[t + j − pad] and db Σ_r g[t]; rows at or
    // past T were zero-filled and add nothing
    float gc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      gc[r] = gs[((base + pad + r) & (kRingRows - 1)) * kBwdCh + cl];
      db += gc[r];
    }
#pragma unroll
    for (int q = 0; q < kRows + KMAX - 1; ++q)
      win[q] = q < kRows + K - 1 ? xs[((base + q) & (kRingRows - 1)) * kBwdCh + cl] : 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        if (j < K) dwp[j] = fmaf(gc[r], win[r + j], dwp[j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is read: reuse it for the row groups' partials
  float* red = smem;  // kGroups × (K + 1) × kBwdCh
#pragma unroll
  for (int j = 0; j < KMAX; ++j)
    if (j < K) red[(grp * (K + 1) + j) * kBwdCh + cl] = dwp[j];
  red[(grp * (K + 1) + K) * kBwdCh + cl] = db;
  __syncthreads();
  const long long row = (static_cast<long long>(blockIdx.z) * strips + strip) * (K + 1);
  for (int q = threadIdx.x; q < (K + 1) * kBwdCh; q += kBwdThreads) {
    const int j = q / kBwdCh;
    const int cc = q % kBwdCh;
    if (c0 + cc >= C) continue;
    float s = 0.f;
    for (int gi = 0; gi < kGroups; ++gi) s = __fadd_rn(s, red[(gi * (K + 1) + j) * kBwdCh + cc]);
    part[(row + j) * C + c0 + cc] = s;
  }
}

// Strips per (batch row, channel slab): p tiles a strip, the p that
// minimises a CTA's cost, p tiles plus kStripCost for its halo, start-up
// and reduction, times the CTAs that each of the card's sms SMs takes in
// turn, ⌈rows · ⌈tiles / p⌉ / sms⌉ — short strips balance the SMs, long
// ones pay the fixed cost less often. kStripTiles > 0 fixes p.
constexpr float kStripCost = 0.5f;
inline int bwd_strips(int B, int T, int C, int sms) {
  const int tiles = (T + kTile - 1) / kTile;
  const long long rows = static_cast<long long>(B) * ((C + kBwdCh - 1) / kBwdCh);
  int best = tiles;
  float best_cost = 0.f;
  for (int p = 1; p <= tiles; ++p) {
    const long long ctas = rows * ((tiles + p - 1) / p);
    const float cost = static_cast<float>((ctas + sms - 1) / sms) * (p + kStripCost);
    if (p == 1 || cost < best_cost) best = p, best_cost = cost;
  }
  if (kStripTiles > 0) best = kStripTiles < tiles ? kStripTiles : tiles;
  return (tiles + best - 1) / best;
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

template <int KMAX, bool kVec>
cudaError_t launch_bwd(const float* x, const float* w, const float* g, float* dx, float* part,
                       int B, int T, int C, int K, int strips, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(kRingRows) * kBwdCh * sizeof(float);
  cudaError_t err = allow_smem(dw_bwd_kernel<KMAX, kVec>, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (T + kTile - 1) / kTile;
  const dim3 grid((C + kBwdCh - 1) / kBwdCh, strips, B);
  dw_bwd_kernel<KMAX, kVec><<<grid, kBwdThreads, smem, stream>>>(
      x, w, g, dx, part, T, C, K, strips, (tiles + strips - 1) / strips);
  return cudaGetLastError();
}

template <int KMAX>
cudaError_t launch_bwd_k(const float* x, const float* w, const float* g, float* dx, float* part,
                         int B, int T, int C, int K, int strips, cudaStream_t stream) {
  const bool vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0;
  return vec ? launch_bwd<KMAX, true>(x, w, g, dx, part, B, T, C, K, strips, stream)
             : launch_bwd<KMAX, false>(x, w, g, dx, part, B, T, C, K, strips, stream);
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

// The strip count ssd_dw_bwd_launch takes for (B, T, C) on a card of sms SMs.
int ssd_dw_bwd_strips(int B, int T, int C, int sms) {
  return bwd_strips(B, T, C, sms);
}

// x, g, dx (B, T, C); w (K, C); part (B, strips, K + 1, C); f32
// contiguous; odd K ≤ 31; 1 ≤ strips ≤ ⌈T / 64⌉.
cudaError_t ssd_dw_bwd_launch(const float* x, const float* w, const float* g, float* dx,
                              float* part, int B, int T, int C, int K, int strips,
                              cudaStream_t stream) {
  if (!valid(B, T, C, K) || strips < 1 || strips > (T + kTile - 1) / kTile)
    return cudaErrorInvalidValue;
  if (K <= 15) return launch_bwd_k<15>(x, w, g, dx, part, B, T, C, K, strips, stream);
  return launch_bwd_k<kMaxK>(x, w, g, dx, part, B, T, C, K, strips, stream);
}

}  // extern "C"
