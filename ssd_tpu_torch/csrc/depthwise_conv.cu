// Depthwise 'SAME' 1-D convolution, forward and backward, for Hopper (sm_90a).
//
// Replace the Pallas kernels ssd_tpu/ops/depthwise_conv.py:_fwd_kernel
// (called through _fwd_call) and ssd_tpu/ops/depthwise_conv.py:_bwd_kernel
// (called through _bwd_call). Channel-last x, g, y, dx (B, T, C), taps
// w (K, C), bias b (C,), all fp32 or all bf16 (two instances of each
// kernel); odd K, pad = (K − 1) / 2, rows outside [0, T) read as zero:
//
//   y[t, c]       = b[c] + Σ_j w[j, c] · x[t + j − pad, c]
//   dx[t, c]      = Σ_j w[j, c] · g[t + pad − j, c]        (the flipped stencil)
//   part[b, s, j, c] = Σ_{t in strip s} g[t, c] · x[t + j − pad, c]   (j < K)
//   part[b, s, K, c] = Σ_{t in strip s} g[t, c]                       (db)
//
// with the taps accumulated in the TPU kernel's order (bias first, then
// j = 0 … K − 1) as an unfused multiply and add, so the forward equals a
// plain mul-then-add loop bit for bit. The bf16 instances compute in fp32
// from bf16 loads and store bf16, with the Pallas kernel's rounding under
// compute_dtype: bfloat16 — each tap's product x · w is formed in bf16
// (the exact fp32 product rounded to nearest even) before the fp32 sum, in
// the forward and in dx, so both equal the plain bf16 version bit for bit;
// the dw / db partials are fp32 products of the upcast values (part stays
// fp32 in both instances). The backward's partials are summed
// over (b, s) outside the kernel with one torch.sum, as the JAX VJP sums its
// (B, K, C) dw partials outside its kernel (it takes db = Σ g outside too;
// here g is already staged, so its sum rides along as the (K + 1)-th row).
//
// What bounds it: 2·K flops per output against 8 bytes (one read, one write)
// — 3.75 flops a byte at K = 15, far below the card's 20 fp32 flops a byte,
// so the op is bytes-bound: 7.37 MB at B = 5, T = 640, C = 288 is 2.2 µs at
// 3.35 TB/s. The backward reads x and g and writes dx: 1.5× the bytes. The
// bf16 instances move half the bytes with the same design: a warp's load
// or store is then 64 contiguous bytes, and the ring holds bf16 rows.
//
// What the design does about it. The TPU kernel keeps one batch element's
// whole (T, C) tile in VMEM; 227 KB of shared memory holds no such tile, so:
//   * forward: no shared memory. A thread takes one channel and kFwdRows
//     output rows; it loads its whole window, kFwdRows + K − 1 rows, from
//     global memory into registers with every load issued before the first
//     is used, keeps its channel's K taps and the bias in registers (K is
//     unrolled up to a compile-time bound of 15 or 31), and writes its rows.
//     A warp is 32 neighbouring channels, so each load and store is 128
//     contiguous bytes (channel-last is contiguous in C); the kFwdWarps warps
//     of a CTA take consecutive row segments of one channel slab, so a
//     segment's K − 1 halo rows are mostly its neighbour's rows, read
//     through the read-only cache. At 72 registers and no barrier an SM
//     holds 7 CTAs, each with all its loads outstanding at once — the bytes
//     in flight a bytes-bound kernel needs. (A cp.async ring of 64-row tiles
//     in shared memory, the backward's design, takes 80 registers, so 3
//     CTAs an SM with one tile in flight each, and was 1.4–1.5× slower on an
//     H100 80GB HBM3 at 700 W: scripts/bench_depthwise_variants.py builds it
//     from scripts/depthwise_fwd_ring.cu and times it beside this one.)
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kFwdRows = 16;                   // forward: output rows a thread
constexpr int kFwdWarps = 4;                   // forward: warps (row segments) a CTA
constexpr int kFwdThreads = 32 * kFwdWarps;    // 128: 32 channels × kFwdWarps segments
constexpr int kGroups = 8;               // backward: row groups per CTA
constexpr int kRows = 8;                 // backward: output rows per thread and tile
constexpr int kTile = kGroups * kRows;   // 64 time rows a tile
constexpr int kMaxK = 31;
constexpr int kBwdCh = 32;                     // backward: channels per CTA
constexpr int kBwdThreads = kBwdCh * kGroups;  // 256
constexpr int kStages = 2;                     // backward ring: tiles in flight
constexpr int kRingRows = 256;                 // x (and g) rows the ring holds, a power of 2
constexpr int kBwdMinBlocks = 1;               // CTAs an SM the K ≤ 15 instance is built for
constexpr int kStripTiles = 0;                 // tiles a strip; 0: bwd_strips' cost model
static_assert(kStages * kTile + kMaxK - 1 <= kRingRows,
              "the ring holds a tile, its halo and the tiles in flight");

using bf16 = __nv_bfloat16;

// An element (float or bf16) read as float through the read-only cache, read
// from shared memory, and stored from float (bf16: rounded to nearest even).
__device__ __forceinline__ float ldg_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f(const bf16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// One tap's product a · b of two values of type E, as the plain version
// forms it: in fp32, then (bf16) rounded to bf16 — the product of two bf16
// values is exact in fp32, so this is bf16 multiplication.
template <typename E>
__device__ __forceinline__ float tap_product(float a, float b) {
  const float p = __fmul_rn(a, b);
  if constexpr (std::is_same_v<E, float>) return p;
  else return __bfloat162float(__float2bfloat16_rn(p));
}

// The forward over (32 channels, kFwdWarps segments of kFwdRows rows, one
// batch row): thread (channel c, segment) computes rows [t0, t0 + kFwdRows).
template <typename E, int KMAX>
__global__ void __launch_bounds__(kFwdThreads)
dw_fwd_kernel(const E* __restrict__ x, const E* __restrict__ w,
              const E* __restrict__ bias, E* __restrict__ y, int T, int C, int K) {
  const int pad = (K - 1) / 2;
  const int c = blockIdx.x * 32 + threadIdx.x % 32;
  const int t0 = (blockIdx.y * kFwdWarps + threadIdx.x / 32) * kFwdRows;
  if (t0 >= T || c >= C) return;  // no barrier follows
  const long long slab = static_cast<long long>(blockIdx.z) * T * C;
  const E* xc = x + slab + c;
  float win[kFwdRows + KMAX - 1];  // x rows t0 − pad + q, zero outside [0, T)
#pragma unroll
  for (int q = 0; q < kFwdRows + KMAX - 1; ++q) {
    const int r = t0 - pad + q;
    win[q] = (q < kFwdRows + K - 1 && r >= 0 && r < T) ? ldg_f(xc + static_cast<long long>(r) * C)
                                                        : 0.f;
  }
  float taps[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) taps[j] = j < K ? ldg_f(w + j * C + c) : 0.f;
  const float b0 = ldg_f(bias + c);
#pragma unroll
  for (int r = 0; r < kFwdRows; ++r) {
    float acc = b0;
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if (j < K) acc = __fadd_rn(acc, tap_product<E>(win[r + j], taps[j]));
    if (t0 + r < T) store_f(y + slab + static_cast<long long>(t0 + r) * C + c, acc);
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// Copy 16 (4) bytes, or zero-fill them when in is false (no bytes read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(in ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(in ? 4 : 0) : "memory");
}
// One element of x or g into the ring, or a zero when in is false: a cp.async
// of 4 bytes for fp32; a plain load and store for bf16, whose 2 bytes no
// cp.async takes (the copy is visible after the barrier that starts its
// tile, like the asynchronous ones).
__device__ __forceinline__ void copy_one(float* dst, const float* src, bool in) {
  cp_async4(dst, src, in);
}
__device__ __forceinline__ void copy_one(bf16* dst, const bf16* src, bool in) {
  *dst = in ? *src : __float2bfloat16_rn(0.f);
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The backward over one (channel slab, strip of strip_tiles tiles, batch
// row). Ring: kRingRows × kBwdCh elements of x, then of g; time row t sits in
// ring row (t − t_s + pad) mod kRingRows, t_s the strip's first row. Copy
// group i brings tile i's new rows: for i = 0 the tile and both halos,
// [t_s − pad, t_s + 64 + pad), after that [t_s + 64·i + pad, t_s + 64·(i+1) + pad).
template <typename E, int KMAX, bool kVec>
__global__ void __launch_bounds__(kBwdThreads, KMAX <= 15 ? kBwdMinBlocks : 1)
dw_bwd_kernel(const E* __restrict__ x, const E* __restrict__ w,
              const E* __restrict__ g, E* __restrict__ dx, float* __restrict__ part,
              int T, int C, int K, int strips, int strip_tiles) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  E* xs = reinterpret_cast<E*>(smem_bytes);
  E* gs = xs + kRingRows * kBwdCh;
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
      constexpr int kPer = kVec ? 16 / sizeof(E) : 1;  // elements a copy
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
          copy_one(xs + at, x + off, in);
          copy_one(gs + at, g + off, in);
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
    flip[i] = (i < K && c < C) ? to_f(w[(K - 1 - i) * C + c]) : 0.f;
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
      win[q] = q < kRows + K - 1 ? to_f(gs[((base + q) & (kRingRows - 1)) * kBwdCh + cl]) : 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float acc = 0.f;
#pragma unroll
      for (int q = KMAX - 1; q >= 0; --q) {
        if (q >= K) continue;
        if constexpr (std::is_same_v<E, float>)
          acc = fmaf(win[r + q], flip[q], acc);
        else  // the plain bf16 version's sum: rounded products, unfused adds
          acc = __fadd_rn(acc, tap_product<E>(win[r + q], flip[q]));
      }
      if (t0 + r < T && c < C) store_f(dx + slab + static_cast<long long>(t0 + r) * C + c, acc);
    }
    // dw partials Σ_r g[t] · x[t + j − pad] and db Σ_r g[t]; rows at or
    // past T were zero-filled and add nothing
    float gc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      gc[r] = to_f(gs[((base + pad + r) & (kRingRows - 1)) * kBwdCh + cl]);
      db += gc[r];
    }
#pragma unroll
    for (int q = 0; q < kRows + KMAX - 1; ++q)
      win[q] = q < kRows + K - 1 ? to_f(xs[((base + q) & (kRingRows - 1)) * kBwdCh + cl]) : 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        if (j < K) dwp[j] = fmaf(gc[r], win[r + j], dwp[j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is read: reuse it for the row groups' partials
  float* red = reinterpret_cast<float*>(smem_bytes);  // kGroups × (K + 1) × kBwdCh
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

inline bool valid(int B, int T, int C, int K) {
  return B >= 1 && T >= 1 && C >= 1 && K >= 1 && K % 2 == 1 && K <= kMaxK && B <= 65535 &&
         T <= 65535 * kFwdRows * kFwdWarps;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename E, int KMAX>
cudaError_t launch_fwd(const E* x, const E* w, const E* b, E* y, int B, int T,
                       int C, int K, cudaStream_t stream) {
  constexpr int kSeg = kFwdRows * kFwdWarps;  // rows a CTA
  const dim3 grid((C + 31) / 32, (T + kSeg - 1) / kSeg, B);
  dw_fwd_kernel<E, KMAX><<<grid, kFwdThreads, 0, stream>>>(x, w, b, y, T, C, K);
  return cudaGetLastError();
}

template <typename E, int KMAX, bool kVec>
cudaError_t launch_bwd(const E* x, const E* w, const E* g, E* dx, float* part,
                       int B, int T, int C, int K, int strips, cudaStream_t stream) {
  // the ring, reused at the end for the row groups' fp32 partials
  const size_t ring = 2 * static_cast<size_t>(kRingRows) * kBwdCh * sizeof(E);
  const size_t red = static_cast<size_t>(kGroups) * (KMAX + 1) * kBwdCh * sizeof(float);
  const size_t smem = ring > red ? ring : red;
  cudaError_t err = allow_smem(dw_bwd_kernel<E, KMAX, kVec>, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (T + kTile - 1) / kTile;
  const dim3 grid((C + kBwdCh - 1) / kBwdCh, strips, B);
  dw_bwd_kernel<E, KMAX, kVec><<<grid, kBwdThreads, smem, stream>>>(
      x, w, g, dx, part, T, C, K, strips, (tiles + strips - 1) / strips);
  return cudaGetLastError();
}

template <typename E, int KMAX>
cudaError_t launch_bwd_k(const E* x, const E* w, const E* g, E* dx, float* part,
                         int B, int T, int C, int K, int strips, cudaStream_t stream) {
  const bool vec = C % (16 / sizeof(E)) == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0;
  return vec ? launch_bwd<E, KMAX, true>(x, w, g, dx, part, B, T, C, K, strips, stream)
             : launch_bwd<E, KMAX, false>(x, w, g, dx, part, B, T, C, K, strips, stream);
}

template <typename E>
cudaError_t dw_fwd(const E* x, const E* w, const E* b, E* y, int B, int T, int C, int K,
                   cudaStream_t stream) {
  if (!valid(B, T, C, K)) return cudaErrorInvalidValue;
  if (K <= 15) return launch_fwd<E, 15>(x, w, b, y, B, T, C, K, stream);
  return launch_fwd<E, kMaxK>(x, w, b, y, B, T, C, K, stream);
}

template <typename E>
cudaError_t dw_bwd(const E* x, const E* w, const E* g, E* dx, float* part, int B, int T, int C,
                   int K, int strips, cudaStream_t stream) {
  if (!valid(B, T, C, K) || strips < 1 || strips > (T + kTile - 1) / kTile)
    return cudaErrorInvalidValue;
  if (K <= 15) return launch_bwd_k<E, 15>(x, w, g, dx, part, B, T, C, K, strips, stream);
  return launch_bwd_k<E, kMaxK>(x, w, g, dx, part, B, T, C, K, strips, stream);
}

}  // namespace

extern "C" {

const char* ssd_dw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (B, T, C), w (K, C), b (C,), y (B, T, C), all f32 contiguous; odd K ≤ 31.
cudaError_t ssd_dw_fwd_launch(const float* x, const float* w, const float* b, float* y, int B,
                              int T, int C, int K, cudaStream_t stream) {
  return dw_fwd<float>(x, w, b, y, B, T, C, K, stream);
}

// The same with every tensor bf16.
cudaError_t ssd_dw_fwd_bf16_launch(const void* x, const void* w, const void* b, void* y, int B,
                                   int T, int C, int K, cudaStream_t stream) {
  return dw_fwd<bf16>(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                      static_cast<const bf16*>(b), static_cast<bf16*>(y), B, T, C, K, stream);
}

// The CTAs ssd_dw_fwd_launch takes for (B, T, C), of 32 × kFwdWarps threads.
int ssd_dw_fwd_ctas(int B, int T, int C) {
  return B * ((C + 31) / 32) * ((T + kFwdRows * kFwdWarps - 1) / (kFwdRows * kFwdWarps));
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
  return dw_bwd<float>(x, w, g, dx, part, B, T, C, K, strips, stream);
}

// The same with x, w, g and dx bf16; part stays f32.
cudaError_t ssd_dw_bwd_bf16_launch(const void* x, const void* w, const void* g, void* dx,
                                   float* part, int B, int T, int C, int K, int strips,
                                   cudaStream_t stream) {
  return dw_bwd<bf16>(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                      static_cast<const bf16*>(g), static_cast<bf16*>(dx), part, B, T, C, K,
                      strips, stream);
}

}  // extern "C"
