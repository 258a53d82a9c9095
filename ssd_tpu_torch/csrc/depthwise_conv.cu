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
// plain mul-then-add loop bit for bit. The bf16 instances sum in fp32 from
// bf16 loads and store bf16, with the Pallas kernel's rounding under
// compute_dtype: bfloat16 — each tap's product x · w is formed in bf16
// (the exact product rounded to nearest even) before the fp32 sum, in the
// forward and in dx, so both equal the plain bf16 version bit for bit; the
// dw / db partials are fp32 products of the upcast values (part stays fp32
// in both instances). The backward's partials are summed over (b, s)
// outside the kernel with one torch.sum, as the JAX VJP sums its (B, K, C)
// dw partials outside its kernel (it takes db = Σ g outside too; here g is
// already staged, so its sum rides along as the (K + 1)-th row).
//
// What bounds it: 2·K flops per output against 8 bytes (one read, one write)
// — 3.75 flops a byte at K = 15, far below the card's 20 fp32 flops a byte,
// so the fp32 op is bytes-bound: 7.37 MB at B = 5, T = 640, C = 288 is 2.2 µs
// at 3.35 TB/s. The backward reads x and g and writes dx: 1.5× the bytes.
// bf16 halves the bytes and keeps the work: each output still takes K
// rounded products and K unfused adds, 2·K instructions at the least, so
// at tpu_scaled_large's B = 32, T = 384, C 768, K 15 the forward's 141.6 M
// taps need ~9 µs of the card's instruction issue against its 11.3 µs
// bytes bound — both bounds at once. Formed as an fp32 product, a
// conversion to bf16 and back (the fp32 design's instance), the rounding
// adds two instructions a tap, one on the conversion unit (16 results a
// clock an SM), and a thread per channel makes a warp's access 64 bytes.
//
// What the design does about it. The TPU kernel keeps one batch element's
// whole (T, C) tile in VMEM; 227 KB of shared memory holds no such tile, so:
//   * forward: no shared memory. A thread takes one channel (fp32) or
//     kFwdPairs pairs of channels as bf16x2 words (bf16) and kFwdRows output
//     rows; it loads its whole window, kFwdRows + K − 1 rows, from global
//     memory into registers with every load issued before the first is
//     used (unpredicated where the window lies inside [0, T)), keeps its
//     taps and bias in registers (K is unrolled up to a compile-time bound
//     of 15 or 31; the bf16 instances also have one for K equal to it, whose
//     taps carry no guard, so the rows' chains interleave), and writes its
//     rows. A warp is 32 neighbouring channels (fp32) or 64 (bf16), so each
//     load and store is 128 contiguous bytes (channel-last is contiguous in
//     C); the kFwdWarps warps of a CTA take consecutive row segments of one
//     channel slab, so a segment's K − 1 halo rows are mostly its
//     neighbour's rows, read through the read-only cache. At 72 (fp32) or
//     96 (bf16, kFwdMinBlocks) registers and no barrier an SM holds 7 or 5
//     CTAs, each with all its loads outstanding at once — the bytes in
//     flight a bytes-bound kernel needs. (A cp.async ring of 64-row tiles
//     in shared memory, the backward's design, takes 80 registers, so 3
//     CTAs an SM with one tile in flight each, and was 1.4–1.5× slower on an
//     H100 80GB HBM3 at 700 W: scripts/bench_depthwise_variants.py builds it
//     from scripts/depthwise_fwd_ring.cu and times it beside this one.)
//   * bf16 products, no conversion unit: a thread works on one channel of
//     its pair at a time, its window and taps split once into fp32 bit
//     patterns (the bf16 in the high half, a zero low half: a shift or a
//     mask), and forms each tap's product with one mul.rn.bf16x2 of two such
//     words. Its high lane is the exact product rounded once to bf16 and its
//     low lane +0 · +0 = +0, so the word is the rounded product as an fp32
//     value, added unfused with no unpacking. The plain version forms the
//     fp32 product, then rounds it to bf16; the two agree on every input: a
//     product of two bf16 significands has at most 16 bits, so it is exact
//     in fp32 unless it lies below 2⁻¹³⁴, and there both roundings give a
//     signed zero (2⁻¹³⁴ is half of bf16's least subnormal, a tie that
//     rounds to the even 0). (kZeroLane false: both channels' products in
//     one multiply, each unpacked to fp32 after it — the same instruction
//     count and time, more of it on the integer pipe.) A pair's two sums are
//     rounded to one bf16x2 word by one cvt.rn.bf16x2. Odd C, or x or y not
//     4-byte aligned (4·kFwdPairs bytes), takes element loads and stores
//     into the same words, the channels past C zero; the taps and the bias
//     are read as elements always (once a thread).
//   * backward: one CTA takes one batch row × kBwdCh channels (fp32) or
//     kPairCh channels, two a thread (bf16), over a strip of whole 64-row
//     tiles — strips as long as balance the SMs (strips_for) — and walks it
//     through a cp.async ring of x and g rows in shared memory, kStages deep
//     (fp32) or kPairStages (bf16): a bf16 ring row is 128 bytes, and two
//     tiles in flight a CTA put 32 KB of x and g in flight. Copies are 16
//     bytes where C and the pointers allow, else 4-byte cp.async (fp32) or
//     element loads and stores (bf16); rows outside [0, T) and channels
//     past C are zero-filled. A tile's K − 1 halo rows are the previous
//     tile's, still in the ring, so a strip reads each row once; the next
//     tile's copies overlap this tile's arithmetic, under one barrier a tile.
//     A thread (channel or pair, row group) keeps its flipped taps, its K dw
//     partials and its db partial in registers across the strip; dw and db
//     are chains of fp32 fused multiply-adds, dx (fp32) too (within 1e-5 of
//     the plain version's unfused sum), or (bf16) the forward's products
//     added unfused, bit-equal, one channel at a time as the forward's. At
//     its end the row groups meet in shared memory and are summed in a fixed
//     order into one (K + 1) × channels row per (b, strip): no atomics, so
//     the gradients are bit-reproducible from run to run. The bf16 backward
//     runs at 128 registers, 2 CTAs an SM; more stages do not help it (the
//     fill is not what limits it), so the ring is not filled by TMA.

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

// The bf16 instances: channel pairs as bf16x2 words (false: the fp32
// design with one channel a thread, kept for the bench)
constexpr bool kBf16Pairs = true;
constexpr bool kRoundTaps = true;  // false: not bit-equal, for the bench's timing only
// bf16 products: one channel a multiply, its operands fp32 bit patterns (a
// zero low half, so the bf16x2 product is the fp32 value of the rounded
// product); false: two channels a multiply, each product unpacked after it
constexpr bool kZeroLane = true;
constexpr int kFwdPairs = 1;       // bf16 forward: channel pairs a thread (1: 4-byte loads)
constexpr int kFwdMinBlocks = 5;     // bf16 forward: CTAs an SM it is built for (≤ 102 registers)
constexpr int kPairCh = 64;                              // bf16 backward: channels a CTA, two a thread
constexpr int kPairRows = 8;                             // bf16 backward: rows a thread and tile
constexpr int kPairGroups = kTile / kPairRows;           // row groups a CTA
constexpr int kPairThreads = kPairCh / 2 * kPairGroups;  // 256
constexpr int kPairStages = 3;                       // bf16 ring: tiles in flight + 1
constexpr int kPairRingRows = kPairStages * kTile + kMaxK - 1 <= 256 ? 256 : 512;
constexpr int kPairMinBlocks = 2;                    // CTAs an SM the K ≤ 15 instance is built for
constexpr int kPairStripTiles = 0;                   // tiles a strip; 0: the cost model
static_assert(kFwdPairs == 1 || kFwdPairs == 2, "4- or 8-byte words a thread");

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
  if constexpr (std::is_same_v<E, float> || !kRoundTaps) return p;
  else return __bfloat162float(__float2bfloat16_rn(p));
}

// bf16x2 words: channel c in the low half, c + 1 in the high half.
__device__ __forceinline__ unsigned mul_bf16x2(unsigned a, unsigned b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
// Channel e (0: low half, 1: high half) of a word as an fp32 bit pattern.
__device__ __forceinline__ unsigned lane_bits(unsigned v, int e) {
  return e ? v & 0xffff0000u : v << 16;
}
__device__ __forceinline__ float lo_f(unsigned v) { return __uint_as_float(lane_bits(v, 0)); }
__device__ __forceinline__ float hi_f(unsigned v) { return __uint_as_float(lane_bits(v, 1)); }
// x · w rounded to bf16, as fp32, for x and w fp32 bit patterns of bf16
// values: the high lane's product; the low lane's, +0 · +0, is +0.
__device__ __forceinline__ float product_f(unsigned x, unsigned w) {
  return __uint_as_float(mul_bf16x2(x, w));
}
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  unsigned d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}
__device__ __forceinline__ unsigned ldg_u16(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}
// The word of channels (c, c + 1) at p = row + c, element loads; left = C − c
// channels remain, a channel past C reads as zero.
__device__ __forceinline__ unsigned ldg_pair(const bf16* p, int left) {
  return ldg_u16(p) | (left > 1 ? ldg_u16(p + 1) << 16 : 0u);
}

// kFwdPairs words of a row from p = row + c: one 4- or 8-byte load (kWide),
// or element loads; zero when in is false.
template <bool kWide>
__device__ __forceinline__ void load_words(unsigned (&v)[kFwdPairs], const bf16* p, bool in,
                                           int left) {
  if (!in) {
#pragma unroll
    for (int i = 0; i < kFwdPairs; ++i) v[i] = 0u;
  } else if constexpr (kWide && kFwdPairs == 1) {
    v[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  } else if constexpr (kWide) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = u.x;
    v[1] = u.y;
  } else {
#pragma unroll
    for (int i = 0; i < kFwdPairs; ++i) v[i] = 2 * i < left ? ldg_pair(p + 2 * i, left - 2 * i) : 0u;
  }
}

// 2·kFwdPairs fp32 sums rounded to bf16 and stored at p = row + c: one 4- or
// 8-byte store (kWide), or element stores of the channels below C.
template <bool kWide>
__device__ __forceinline__ void store_words(bf16* p, const float (&acc)[2 * kFwdPairs], int left) {
  if constexpr (kWide && kFwdPairs == 1) {
    *reinterpret_cast<unsigned*>(p) = pack_bf16x2(acc[0], acc[1]);
  } else if constexpr (kWide) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(acc[0], acc[1]), pack_bf16x2(acc[2], acc[3]));
  } else {
#pragma unroll
    for (int e = 0; e < 2 * kFwdPairs; ++e)
      if (e < left) p[e] = __float2bfloat16_rn(acc[e]);
  }
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

// The bf16 forward over (32 × 2·kFwdPairs channels, kFwdWarps segments of
// kFwdRows rows, one batch row): thread (channels c … c + 2·kFwdPairs − 1,
// segment) computes rows [t0, t0 + kFwdRows) from a window of words.
// kExact: K == KMAX, known to the compiler, so the unrolled taps carry no
// guard and the rows' chains interleave.
template <int KMAX, bool kWide, bool kExact>
__global__ void __launch_bounds__(kFwdThreads, kFwdMinBlocks)
dw_fwd_pair_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const bf16* __restrict__ bias, bf16* __restrict__ y, int T, int C, int K) {
  if constexpr (kExact) K = KMAX;
  constexpr int kWin = kFwdRows + KMAX - 1;
  const int pad = (K - 1) / 2;
  const int c = (blockIdx.x * 32 + threadIdx.x % 32) * 2 * kFwdPairs;
  const int t0 = (blockIdx.y * kFwdWarps + threadIdx.x / 32) * kFwdRows;
  if (t0 >= T || c >= C) return;  // no barrier follows
  const int left = C - c;
  const long long slab = static_cast<long long>(blockIdx.z) * T * C;
  const bf16* xc = x + slab + c + static_cast<long long>(t0 - pad) * C;
  unsigned win[kWin][kFwdPairs];  // x rows t0 − pad + q, zero outside [0, T)
  if (t0 >= pad && t0 + kFwdRows + pad <= T) {  // the window lies inside [0, T)
#pragma unroll
    for (int q = 0; q < kWin; ++q)
      load_words<kWide>(win[q], xc + static_cast<long long>(q) * C, q < kFwdRows + K - 1, left);
  } else {
#pragma unroll
    for (int q = 0; q < kWin; ++q) {
      const int r = t0 - pad + q;
      load_words<kWide>(win[q], xc + static_cast<long long>(q) * C,
                        q < kFwdRows + K - 1 && r >= 0 && r < T, left);
    }
  }
  unsigned taps[KMAX][kFwdPairs];
#pragma unroll
  for (int j = 0; j < KMAX; ++j)
#pragma unroll
    for (int i = 0; i < kFwdPairs; ++i)
      taps[j][i] = j < K && 2 * i < left ? ldg_pair(w + j * C + c + 2 * i, left - 2 * i) : 0u;
  float acc[kFwdRows][2 * kFwdPairs];
#pragma unroll
  for (int e = 0; e < 2 * kFwdPairs; ++e) {
    const float b0 = e < left ? ldg_f(bias + c + e) : 0.f;
#pragma unroll
    for (int r = 0; r < kFwdRows; ++r) acc[r][e] = b0;
  }
  if constexpr (kZeroLane) {
#pragma unroll
    for (int e = 0; e < 2 * kFwdPairs; ++e) {  // one channel at a time
      unsigned xe[kWin], we[KMAX];
#pragma unroll
      for (int q = 0; q < kWin; ++q) xe[q] = lane_bits(win[q][e / 2], e % 2);
#pragma unroll
      for (int j = 0; j < KMAX; ++j) we[j] = lane_bits(taps[j][e / 2], e % 2);
#pragma unroll
      for (int r = 0; r < kFwdRows; ++r)
#pragma unroll
        for (int j = 0; j < KMAX; ++j)
          if (j < K) acc[r][e] = __fadd_rn(acc[r][e], product_f(xe[r + j], we[j]));
    }
  } else {
#pragma unroll
    for (int r = 0; r < kFwdRows; ++r)
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (j >= K) continue;
#pragma unroll
        for (int i = 0; i < kFwdPairs; ++i) {
          const unsigned p = mul_bf16x2(win[r + j][i], taps[j][i]);
          acc[r][2 * i] = __fadd_rn(acc[r][2 * i], lo_f(p));
          acc[r][2 * i + 1] = __fadd_rn(acc[r][2 * i + 1], hi_f(p));
        }
      }
  }
#pragma unroll
  for (int r = 0; r < kFwdRows; ++r)
    if (t0 + r < T) store_words<kWide>(y + slab + static_cast<long long>(t0 + r) * C + c, acc[r], left);
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

// Copy group i of a strip's ring, CH channels of x and g a row, by THREADS
// threads: tile i's new rows, for i = 0 the tile and both halos,
// [t_s − pad, t_s + 64 + pad), after that [t_s + 64·i + pad, t_s + 64·(i+1) + pad);
// time row t sits in ring row (t − t_s + pad) mod RING, t_s the strip's first
// row. One commit a tile, an empty group past the strip.
template <int CH, int THREADS, int RING, bool kVec, typename E>
__device__ __forceinline__ void issue_tile(E* xs, E* gs, const E* x, const E* g, int i, int tiles,
                                           int ts, int pad, int T, int C, int c0, long long slab) {
  if (i < tiles) {
    const int r0 = i == 0 ? ts - pad : ts + i * kTile + pad;
    const int n = i == 0 ? kTile + 2 * pad : kTile;
    constexpr int kPer = kVec ? 16 / sizeof(E) : 1;  // elements a copy
    constexpr int kCopies = CH / kPer;               // copies a row
    for (int q = threadIdx.x; q < n * kCopies; q += THREADS) {
      const int r = r0 + q / kCopies;
      const int cc = (q % kCopies) * kPer;
      const bool in = r >= 0 && r < T && c0 + cc < C;
      const long long off = in ? slab + static_cast<long long>(r) * C + c0 + cc : 0;
      const int at = ((r - ts + pad) & (RING - 1)) * CH + cc;
      if constexpr (kVec) {
        cp_async16(xs + at, x + off, in);
        cp_async16(gs + at, g + off, in);
      } else {
        copy_one(xs + at, x + off, in);
        copy_one(gs + at, g + off, in);
      }
    }
  }
  cp_async_commit();
}

// The backward over one (channel slab, strip of strip_tiles tiles, batch
// row) through a kStages-deep ring of kRingRows × kBwdCh elements of x,
// then of g (issue_tile).
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
    issue_tile<kBwdCh, kBwdThreads, kRingRows, kVec>(xs, gs, x, g, i, tiles, ts, pad, T, C, c0,
                                                     slab);
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

// The bf16 backward over one (slab of kPairCh channels, strip, batch row):
// thread (pair l, row group) takes channels c0 + 2l, c0 + 2l + 1, reading
// bf16x2 words from a kPairStages-deep ring of kPairRingRows × kPairCh bf16
// elements of x, then of g (issue_tile). wide: dx rows take 4-byte stores
// (C even, dx 4-byte aligned).
template <int KMAX, bool kVec, bool kExact>
__global__ void __launch_bounds__(kPairThreads, KMAX <= 15 ? kPairMinBlocks : 1)
dw_bwd_pair_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const bf16* __restrict__ g, bf16* __restrict__ dx, float* __restrict__ part,
                   int T, int C, int K, int strips, int strip_tiles, bool wide) {
  if constexpr (kExact) K = KMAX;  // as the forward's
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  bf16* xs = reinterpret_cast<bf16*>(smem_bytes);
  bf16* gs = xs + kPairRingRows * kPairCh;
  const unsigned* xw = reinterpret_cast<const unsigned*>(xs);  // ring rows of kPairCh / 2 words
  const unsigned* gw = reinterpret_cast<const unsigned*>(gs);
  constexpr int kWords = kPairCh / 2;
  const int pad = (K - 1) / 2;
  const int l = threadIdx.x % kWords;
  const int grp = threadIdx.x / kWords;
  const int c0 = blockIdx.x * kPairCh;
  const int c = c0 + 2 * l;
  const int left = C - c;
  const int strip = blockIdx.y;
  const long long slab = static_cast<long long>(blockIdx.z) * T * C;
  const int tile0 = strip * strip_tiles;
  const int tiles = max(0, min(strip_tiles, (T + kTile - 1) / kTile - tile0));
  const int ts = tile0 * kTile;

  auto issue = [&](int i) {
    issue_tile<kPairCh, kPairThreads, kPairRingRows, kVec>(xs, gs, x, g, i, tiles, ts, pad, T, C,
                                                           c0, slab);
  };
#pragma unroll
  for (int i = 0; i < kPairStages - 1; ++i) issue(i);

  // dx as in dw_bwd_kernel, from flipped tap words f[i] = w[K − 1 − i]
  unsigned flip[KMAX];
  float dwp[KMAX][2];
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    flip[i] = i < K && left > 0 ? ldg_pair(w + (K - 1 - i) * C + c, left) : 0u;
    dwp[i][0] = dwp[i][1] = 0.f;
  }
  float db[2] = {0.f, 0.f};
  for (int i = 0; i < tiles; ++i) {
    cp_async_wait<kPairStages - 2>();  // this thread's copies of tile i landed …
    __syncthreads();                   // … and everyone's; tile i − 1 is read
    issue(i + kPairStages - 1);
    const int base = i * kTile + grp * kPairRows;  // ring row of this thread's first window row
    const int t0 = ts + base;                  // its first output row
    auto ring = [&](const unsigned* words, int q) {
      return words[((base + q) & (kPairRingRows - 1)) * kWords + l];
    };
    float out[kPairRows][2];
    if constexpr (kZeroLane) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // one channel at a time
        unsigned ge[kPairRows + KMAX - 1], fe[KMAX];
#pragma unroll
        for (int q = 0; q < kPairRows + KMAX - 1; ++q)
          ge[q] = q < kPairRows + K - 1 ? lane_bits(ring(gw, q), e) : 0u;
#pragma unroll
        for (int q = 0; q < KMAX; ++q) fe[q] = lane_bits(flip[q], e);
#pragma unroll
        for (int r = 0; r < kPairRows; ++r) {
          float acc = 0.f;
#pragma unroll
          for (int q = KMAX - 1; q >= 0; --q)
            if (q < K) acc = __fadd_rn(acc, product_f(ge[r + q], fe[q]));
          out[r][e] = acc;
        }
        // dw partials Σ_r g[t] · x[t + j − pad] and db Σ_r g[t] on the
        // upcast values, window row q feeding tap j of row q − j; rows at or
        // past T were zero-filled and add nothing
        float gc[kPairRows];
#pragma unroll
        for (int r = 0; r < kPairRows; ++r) {
          if constexpr (kExact) gc[r] = __uint_as_float(ge[pad + r]);
          else gc[r] = __uint_as_float(lane_bits(ring(gw, pad + r), e));
          db[e] += gc[r];
        }
#pragma unroll
        for (int q = 0; q < kPairRows + KMAX - 1; ++q) {
          if (q >= kPairRows + K - 1) continue;
          const float xv = __uint_as_float(lane_bits(ring(xw, q), e));
#pragma unroll
          for (int j = 0; j < KMAX; ++j) {
            const int r = q - j;
            if (j < K && r >= 0 && r < kPairRows) dwp[j][e] = fmaf(gc[r], xv, dwp[j][e]);
          }
        }
      }
    } else {
      unsigned win[kPairRows + KMAX - 1];
#pragma unroll
      for (int q = 0; q < kPairRows + KMAX - 1; ++q) win[q] = q < kPairRows + K - 1 ? ring(gw, q) : 0u;
#pragma unroll
      for (int r = 0; r < kPairRows; ++r) {
        out[r][0] = out[r][1] = 0.f;
#pragma unroll
        for (int q = KMAX - 1; q >= 0; --q) {
          if (q >= K) continue;
          const unsigned p = mul_bf16x2(win[r + q], flip[q]);
          out[r][0] = __fadd_rn(out[r][0], lo_f(p));
          out[r][1] = __fadd_rn(out[r][1], hi_f(p));
        }
      }
      float gc[kPairRows][2];
#pragma unroll
      for (int r = 0; r < kPairRows; ++r) {
        const unsigned v = ring(gw, pad + r);
        gc[r][0] = lo_f(v);
        gc[r][1] = hi_f(v);
        db[0] += gc[r][0];
        db[1] += gc[r][1];
      }
#pragma unroll
      for (int q = 0; q < kPairRows + KMAX - 1; ++q) {
        if (q >= kPairRows + K - 1) continue;
        const unsigned v = ring(xw, q);
        const float x0 = lo_f(v), x1 = hi_f(v);
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          const int r = q - j;
          if (j >= K || r < 0 || r >= kPairRows) continue;
          dwp[j][0] = fmaf(gc[r][0], x0, dwp[j][0]);
          dwp[j][1] = fmaf(gc[r][1], x1, dwp[j][1]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kPairRows; ++r) {
      if (t0 + r >= T || left <= 0) continue;
      bf16* dst = dx + slab + static_cast<long long>(t0 + r) * C + c;
      if (wide) {
        *reinterpret_cast<unsigned*>(dst) = pack_bf16x2(out[r][0], out[r][1]);
      } else {
        dst[0] = __float2bfloat16_rn(out[r][0]);
        if (left > 1) dst[1] = __float2bfloat16_rn(out[r][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is read: reuse it for the row groups' partials
  float* red = reinterpret_cast<float*>(smem_bytes);  // kPairGroups × (K + 1) × kPairCh
#pragma unroll
  for (int j = 0; j < KMAX; ++j)
    if (j < K)
      *reinterpret_cast<float2*>(red + (grp * (K + 1) + j) * kPairCh + 2 * l) =
          make_float2(dwp[j][0], dwp[j][1]);
  *reinterpret_cast<float2*>(red + (grp * (K + 1) + K) * kPairCh + 2 * l) = make_float2(db[0], db[1]);
  __syncthreads();
  const long long row = (static_cast<long long>(blockIdx.z) * strips + strip) * (K + 1);
  for (int q = threadIdx.x; q < (K + 1) * kPairCh; q += kPairThreads) {
    const int j = q / kPairCh;
    const int cc = q % kPairCh;
    if (c0 + cc >= C) continue;
    float s = 0.f;
    for (int gi = 0; gi < kPairGroups; ++gi) s = __fadd_rn(s, red[(gi * (K + 1) + j) * kPairCh + cc]);
    part[(row + j) * C + c0 + cc] = s;
  }
}

// Strips per (batch row, slab of ch channels): p tiles a strip, the p that
// minimises a CTA's cost, p tiles plus kStripCost for its halo, start-up
// and reduction, times the CTAs that each of the card's slots (SMs × CTAs an
// SM) takes in turn, ⌈rows · ⌈tiles / p⌉ / slots⌉ — short strips balance the
// SMs, long ones pay the fixed cost less often. fixed > 0 fixes p.
constexpr float kStripCost = 0.5f;
inline int strips_for(int B, int T, int C, int ch, int slots, int fixed) {
  const int tiles = (T + kTile - 1) / kTile;
  const long long rows = static_cast<long long>(B) * ((C + ch - 1) / ch);
  int best = tiles;
  float best_cost = 0.f;
  for (int p = 1; p <= tiles; ++p) {
    const long long ctas = rows * ((tiles + p - 1) / p);
    const float cost = static_cast<float>((ctas + slots - 1) / slots) * (p + kStripCost);
    if (p == 1 || cost < best_cost) best = p, best_cost = cost;
  }
  if (fixed > 0) best = fixed < tiles ? fixed : tiles;
  return (tiles + best - 1) / best;
}
// fp32 (and bf16 in the one-channel design): one CTA an SM in the model
inline int bwd_strips(int B, int T, int C, int sms) {
  return strips_for(B, T, C, kBwdCh, sms, kStripTiles);
}
inline int bwd_pair_strips(int B, int T, int C, int sms) {
  return strips_for(B, T, C, kPairCh, sms, kPairStripTiles);
}

inline bool valid(int B, int T, int C, int K) {
  return B >= 1 && T >= 1 && C >= 1 && K >= 1 && K % 2 == 1 && K <= kMaxK && B <= 65535 &&
         T <= 65535 * kFwdRows * kFwdWarps;
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename E, int KMAX>
cudaError_t launch_fwd(const E* x, const E* w, const E* b, E* y, int B, int T, int C, int K,
                       cudaStream_t stream) {
  constexpr int kSeg = kFwdRows * kFwdWarps;  // rows a CTA
  if constexpr (std::is_same_v<E, bf16> && kBf16Pairs) {
    constexpr int kCh = 64 * kFwdPairs;  // channels a CTA
    const dim3 grid((C + kCh - 1) / kCh, (T + kSeg - 1) / kSeg, B);
    const int word = 4 * kFwdPairs;
    const bool wide = C % (2 * kFwdPairs) == 0 && aligned(x, word) && aligned(y, word);
    if (wide && K == KMAX)
      dw_fwd_pair_kernel<KMAX, true, true><<<grid, kFwdThreads, 0, stream>>>(x, w, b, y, T, C, K);
    else if (wide)
      dw_fwd_pair_kernel<KMAX, true, false><<<grid, kFwdThreads, 0, stream>>>(x, w, b, y, T, C, K);
    else if (K == KMAX)
      dw_fwd_pair_kernel<KMAX, false, true><<<grid, kFwdThreads, 0, stream>>>(x, w, b, y, T, C, K);
    else
      dw_fwd_pair_kernel<KMAX, false, false><<<grid, kFwdThreads, 0, stream>>>(x, w, b, y, T, C, K);
  } else {
    const dim3 grid((C + 31) / 32, (T + kSeg - 1) / kSeg, B);
    dw_fwd_kernel<E, KMAX><<<grid, kFwdThreads, 0, stream>>>(x, w, b, y, T, C, K);
  }
  return cudaGetLastError();
}

template <typename E, int KMAX, bool kVec>
cudaError_t launch_bwd(const E* x, const E* w, const E* g, E* dx, float* part,
                       int B, int T, int C, int K, int strips, cudaStream_t stream) {
  const int tiles = (T + kTile - 1) / kTile;
  const int strip_tiles = (tiles + strips - 1) / strips;
  if constexpr (std::is_same_v<E, bf16> && kBf16Pairs) {
    // the ring, reused at the end for the row groups' fp32 partials
    const size_t ring = 2 * static_cast<size_t>(kPairRingRows) * kPairCh * sizeof(bf16);
    const size_t red = static_cast<size_t>(kPairGroups) * (KMAX + 1) * kPairCh * sizeof(float);
    const size_t smem = ring > red ? ring : red;
    auto kernel = K == KMAX ? dw_bwd_pair_kernel<KMAX, kVec, true>
                            : dw_bwd_pair_kernel<KMAX, kVec, false>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((C + kPairCh - 1) / kPairCh, strips, B);
    kernel<<<grid, kPairThreads, smem, stream>>>(x, w, g, dx, part, T, C, K, strips, strip_tiles,
                                                 C % 2 == 0 && aligned(dx, 4));
  } else {
    const size_t ring = 2 * static_cast<size_t>(kRingRows) * kBwdCh * sizeof(E);
    const size_t red = static_cast<size_t>(kGroups) * (KMAX + 1) * kBwdCh * sizeof(float);
    const size_t smem = ring > red ? ring : red;
    cudaError_t err = allow_smem(dw_bwd_kernel<E, KMAX, kVec>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((C + kBwdCh - 1) / kBwdCh, strips, B);
    dw_bwd_kernel<E, KMAX, kVec><<<grid, kBwdThreads, smem, stream>>>(
        x, w, g, dx, part, T, C, K, strips, strip_tiles);
  }
  return cudaGetLastError();
}

template <typename E, int KMAX>
cudaError_t launch_bwd_k(const E* x, const E* w, const E* g, E* dx, float* part,
                         int B, int T, int C, int K, int strips, cudaStream_t stream) {
  const bool vec = C % (16 / sizeof(E)) == 0 && aligned(x, 16) && aligned(g, 16);
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

// The same for ssd_dw_bwd_bf16_launch.
int ssd_dw_bwd_bf16_strips(int B, int T, int C, int sms) {
  return kBf16Pairs ? bwd_pair_strips(B, T, C, sms) : bwd_strips(B, T, C, sms);
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
