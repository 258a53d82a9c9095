// Fused self-attention, forward and backward, for Hopper (sm_90a).
//
// Replace the Pallas kernels ssd_tpu/ops/attention.py:_attn_fwd_kernel
// (called through _fwd_call) and ssd_tpu/ops/attention.py:_attn_bwd_kernel
// (called through _bwd_call). Per (batch b, head h), with q, k, v (T, hd)
// fp32, scale = hd^-½, the key mask km (B, T) and an optional (T, T)
// dropout multiplier μ:
//
//   s[i, j] = (q_i · k_j) · scale,  or −1e30 where km[b, j] == 0
//   w       = softmax_j(s)  (fp32),  out_i = Σ_j w[i, j] · μ[i, j] · v_j
//
// and its VJP: dv_j = Σ_i w μ · do_i, ds = w ∘ (μ ∘ dP − D) · scale with
// dP = do · vᵀ and D_i = Σ_j w μ dP (the plain version's rowsum(dw ∘ w);
// = do_i · out_i in exact arithmetic), dq_i = Σ_j ds · k_j,
// dk_j = Σ_i ds · q_i. The scale multiplies after the
// dot and masked keys sit at −1e30 — the Pallas kernel's numerics, not
// flax's; keys past T are left out. A fully masked row gets uniform weights,
// as on the TPU. The forward saves the row max m and row sum l, not the
// log-sum-exp: for a fully masked row m + log l rounds back to −1e30 and
// the backward would recompute weights of 1 instead of 1/T. μ scales p in
// the output sum, not in the running sum. Padded keys get dk = dv = 0
// exactly. Outputs are written through strided views, in the (B, T, H, hd)
// storage the output projection reads.
//
// What bounds it: 4·T²·hd flops per (b, h) forward and 10·T²·hd backward
// (the TPU cost estimates) against 16·T·hd bytes and a few more: at T = 640,
// hd = 48 that is 160 flops a byte forward, bound by operations. The
// products run on the tensor cores as 3×TF32, the arithmetic of PyTorch's
// fp32 memory-efficient SDPA (CUTLASS's OpMultiplyAddFastF32): each fp32
// operand x splits into big = tf32(x) and small = tf32(x − big), both
// rounded as cvt.rna.tf32.f32 rounds, and small·big + big·small + big·big
// is accumulated in fp32 (small·small is dropped). That keeps fp32-grade
// accuracy (a CPU emulation in tests/test_torch_attention.py holds it to
// float64 within the fp32 tolerances; 1×TF32 misses them) at 3 × flops /
// 495 TFLOP/s: 14.3 µs for the forward at B = 5, H = 6, where the fp32
// SIMT pipe's 67 TFLOP/s would take 35.2 µs. On the card the kernels reach
// 9–16 % of that bound: with 2 CTAs (8 warps) an SM they are bound by the
// latency of the dependent split → mma chains, not by the tensor cores.
//
// What the design does about it.
//   * Products are mma.sync.m16n8k8 tf32 in inline PTX. A CTA of 4 warps
//     takes 64 queries (forward, dq) or 64 keys (dk/dv); each warp owns 16
//     of them and holds their operand (q, do, or k and v) as A fragments in
//     registers for the whole loop over the other side's 64-row tiles,
//     splitting one k-step at a time as it is used. Scores and dP stay in
//     mma accumulators: the online softmax reduces over the 4 lanes of a
//     quad with shuffles, with no CTA barrier and no round trip through
//     shared memory. The backward holds 16 columns of scores at a time
//     (kChunk), which keeps it near the 255-register limit.
//   * The TF32 accumulator layout (row g, columns 2t and 2t + 1) is not the
//     A-operand layout (columns t and t + 4). A sum over k does not depend
//     on the order of k, so the next product takes each 8-column step in
//     the permuted order k = t ↔ column 2t, k = t + 4 ↔ column 2t + 1, and
//     its B operand reads the matching rows 2t and 2t + 1: p∘μ and ds go
//     from accumulators to A fragments in registers, with no shuffle and
//     no shared memory.
//   * The split rounds with integer operations (tf32_rna): cvt.rna runs on
//     the conversion unit at a sixteenth of the fp32 rate, and the B
//     fragments are split as they are loaded, two values a k-step — with
//     cvt the backward takes 1.28× as long (bench_attention_variants.py).
//   * The tensor cores truncate what they add into an accumulator; over a
//     640-row sum that tripled the gradients' largest error on the card
//     (scripts/bench_attention_variants.py) and put dv outside the
//     tolerance in tests/test_torch_cuda.py. Products summed over keys or
//     queries therefore start each 8-row step from a fresh accumulator and
//     join the running sum with an fp32 add (mma3_sum).
//   * hd runs in 6 k-steps of 8 (hd ≤ 48: hd 48 pads no output column) or
//     8 (48 < hd ≤ 64), a template argument; columns past hd are zero in
//     shared memory.
//   * The streamed tiles (k, v, the 64 × 64 μ tile and the key mask; in the
//     dk/dv kernel q, do, μ, m, l and D) go through a two-stage ring of
//     cp.async copies: tile j + 1 is in flight while tile j computes, with
//     one wait and one barrier a tile. Rows are copied 16 bytes at a time
//     where hd % 4 == 0 and the views are 16-byte aligned, else 4 bytes
//     at a time (a template argument of the same kernels).
//   * Shared-memory rows have a stride of hdp + 4 floats (hdp: 48 or 64).
//     Fragment loads read a tile either as (row g, column t) — q, k, do or
//     v as the B operand of a score product — or as (row 2t, column g) —
//     v, k, q or do as the B operand of a product that sums over rows. Both
//     are free of bank conflicts at that stride, so k in the dq kernel
//     feeds both products from one copy. The μ tile is read as float2 at
//     (row g, columns 2t..2t + 1) with a stride of 72 floats in the forward
//     and dq kernels, and at (row 2t, column g) with a stride of 68 in the
//     dk/dv kernel.
//   * A masked key adds a bias: s · scale + 0, −1e30 (exactly −1e30, since
//     |s · scale| is far below half its ulp) or −inf past T.
//   * The backward is two launches with one owner per output, as in FA2:
//     (1) one CTA per 64 queries accumulates dq over the key tiles and
//     stores D for its rows; (2) one CTA per 64 keys accumulates dk and dv
//     over the query tiles. No atomics: the gradients are bit-reproducible.
//     μ is staged through shared memory. D is summed from the same w and
//     dP that ds uses, not taken as do · out (FA2's shortcut): where one
//     key holds a row's whole weight (a row of length 1), μ dP − D must
//     cancel exactly, and the rounding of out against dP left dk outside
//     the tolerance there at T = 640 on the card. So the dq
//     kernel, which cannot know D before its sweep ends, accumulates
//     Σ_j w μ dP k_j and Σ_j w k_j and forms dq = scale · (first − D ·
//     second) at the end; and the dk/dv kernel computes its transposed
//     scores and dP with the operands' roles swapped in the same order
//     (mma3_swapped), so they equal the dq kernel's and the cancellation is
//     exact. The two launches do 8 T × T × hd products (the function needs
//     five: both recompute the scores and dP, and Σ_j w k_j is the price
//     of the consistent D).
//   * q, k, v, do and the outputs are strided (B, H, T, hd) views with a unit
//     hd stride; the (B, T, H, hd) projections are read in place.
//
// The bf16 instances (compute_dtype: bfloat16; the ..._bf16 kernels below)
// compute what the Pallas kernels compute when q, k, v (and do, μ) are bf16:
// every product takes bf16 operands and accumulates in fp32, the softmax
// runs in fp32 (row max and row sum stay fp32), the weights are rounded to
// bf16 before they multiply v (ssd_tpu/ops/attention.py:109), the backward
// rounds w ∘ μ and ds to bf16 before its products (:130-139), and out, dq,
// dk, dv are bf16. There is no 3×TF32 split: 4·T²·hd flops forward and
// 10·T²·hd backward over 989 TFLOP/s (dense bf16) against q, k, v, out (and
// do, dq, dk, dv) in bf16 — at tpu_scaled_large's T′ 384, hd 64 the bytes
// bound them. Their design, for Hopper's tensor cores:
//   * A warpgroup (4 warps) takes 64 queries (forward, dq) or 64 keys
//     (dk/dv), 16 a warp; a backward CTA is one warpgroup, a forward CTA one
//     (mma.sync) or two (wgmma). The streamed tiles (k, v, the μ tile
//     and the key mask; q, do and the row values in the dk/dv kernel) go
//     through a two-stage cp.async ring (16-byte copies where hd % 8 == 0 and
//     the views allow, element copies otherwise).
//   * hd 64 (kSw; tpu_scaled_large): the products run on wgmma m64nNk16.
//     Tiles are 64-element rows of 128 bytes in the 128-byte swizzle, written
//     so by the cp.async ring itself (tile_off) and read by wgmma through
//     shared-memory descriptors. Score products (q · kᵀ, do · vᵀ, k · qᵀ,
//     v · doᵀ) read their B operand K-major; products that sum over a tile's
//     rows (p · v, ds · k, (w ∘ μ)ᵀ · do, dsᵀ · q) read it MN-major, through
//     wgmma's transpose. The forward's q · kᵀ takes q from its own shared
//     tile as well; the backward's scores take the CTA's rows (q and do, or
//     k and v) from registers, loaded once through ldmatrix. The backward
//     holds 32 columns of scores at a time and its launch bounds ask for 3
//     CTAs an SM; the forward's for 2 of 8 warps. (The forward with q in
//     registers, and the backward holding 64 columns, came out wrong on the
//     card: PERF.md §7.)
//   * hd ≤ 48: ldmatrix.x4 feeds mma.sync.m16n8k16 from tiles whose rows
//     are padded to hdp + 8 elements (free of bank conflicts): A fragments
//     of the CTA's own rows, B fragments of score products plainly and of
//     row-summing products through ldmatrix.trans; 4 CTAs an SM, 16 columns
//     of backward scores at a time. scripts/bench_attention_variants.py
//     --dtype bf16 times both designs at hd 64 and their settings.
//   * The accumulator of two adjacent 8-column steps is, column for column,
//     the A fragment of a 16-deep product (mma.sync's and wgmma's layouts
//     agree), so p ∘ μ and ds go from accumulators to A fragments in
//     registers (rounded to bf16 as they are packed), with no shuffle and no
//     shared memory. The μ tile is read through ldmatrix, transposed in the
//     dk/dv kernel.
//   * Exponentials are exp2((x − m) · log2 e) (one MUFU op; expf does a
//     range reduction first), x = S · hd^-½ + the mask's bias in one FMA:
//     the row max and row sum keep their meaning (the custom op's CPU
//     version computes them), a fully masked row still gets exp2(0) = 1 on
//     every key, and the backward recomputes x bit for bit, so the max key's
//     weight is exactly 1. (Folding log2 e into the score's FMA would save
//     the multiply but breaks both: m · log2 e is not exact.)
//   * The forward writes, on the training call, its output in fp32 as well
//     (õ, before the bf16 rounding). The dq kernel takes D_i = do_i · õ_i
//     from it in its prologue (fp32, a fixed order) and sweeps the key tiles
//     once: 7 T × T × hd products in the two launches (S, dP and ds · k;
//     then Sᵀ, dPᵀ, (w ∘ μ)ᵀ · do and dsᵀ · q). D from the bf16 out would
//     carry its 2⁻⁸ rounding into μ dP − D; from õ the two sides differ by
//     fp32 rounding where a row's whole weight sits on one key, and there ds
//     is set to 0 (w == 1 exactly: D = μ dP up to fp32 resolution), the
//     exact cancellation the Pallas kernel gets from its fp32 D. Elsewhere
//     õ's weights are bf16(p̃ μ) where D's are fp32: a bf16 rounding, the
//     size of ds's own.
//   * The dq kernel stores D and 1 / l for the dk/dv launch, which recomputes
//     its transposed scores with the roles of the operands swapped; the tensor
//     cores sum a 16-deep bf16 product in an order set by k, not by which
//     operand is A, so its w and dP are the dq kernel's. One owner per output,
//     no atomics: the gradients are bit-reproducible.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;                  // queries or keys per CTA and per streamed tile
constexpr int kWarps = 4;                  // a warp owns 16 rows of the CTA's 64
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxHeadDim = 64;
constexpr int kRowSteps = kTile / 8;       // 8-row steps of a streamed tile
constexpr int kChunk = 2;                  // 8-row steps a backward warp holds scores for at once
constexpr int kMuLdRow = kTile + 8;        // μ tile read as (row g, columns 2t..2t + 1)
constexpr int kMuLdCol = kTile + 4;        // μ tile read as (row 2t, column g)
constexpr float kMasked = -1.0e30f;

struct View {  // a (B, H, T, hd) tensor with unit stride along hd
  float* p;
  long long sb, sh, st;
  __device__ __forceinline__ float* row(int b, int h, int t) const {
    return p + b * sb + h * sh + t * st;
  }
};

struct Problem {
  const int* kmask;   // (B, T), nonzero = valid key
  const float* mult;  // (T, T) dropout multiplier, or null
  int H, T, hd;
  int hdp;            // hd zero-padded to the kernel's k-steps: 8 · kSteps (48 or 64)
  int ld;             // shared-memory row stride of a (64, hd) tile: hdp + 4
  int mu_floats;      // floats of a stage's μ tile, 0 without a multiplier
  bool mult_vec;      // μ rows can be copied 16 bytes at a time
  float scale;
};

// ------------------------------------------------------------ cp.async

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src, or zeros when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [t0, t0 + 64) of one (b, h) slice → dst (64 × P.ld), zeros past T and
// in the columns [hd, hdp).
template <bool kVec>
__device__ __forceinline__ void stage_rows(const View& v, int b, int h, int t0, const Problem& P,
                                           float* dst) {
  if (kVec) {  // hd % 4 == 0: a 16-byte chunk is all inside hd or all outside
    const int chunks = P.hdp / 4;
    for (int i = threadIdx.x; i < kTile * chunks; i += kThreads) {
      const int r = i / chunks, c = 4 * (i - r * chunks);
      const bool ok = t0 + r < P.T && c < P.hd;
      cp_async16(dst + r * P.ld + c, ok ? v.row(b, h, t0 + r) + c : v.p, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kTile * P.hdp; i += kThreads) {
      const int r = i / P.hdp, c = i - r * P.hdp;
      const bool ok = t0 + r < P.T && c < P.hd;
      cp_async4(dst + r * P.ld + c, ok ? v.row(b, h, t0 + r) + c : v.p, ok);
    }
  }
}

// μ[r0 + r][c0 + c], r, c < 64 → dst (64 × ld), zeros outside T × T.
__device__ __forceinline__ void stage_mult(const Problem& P, int r0, int c0, float* dst, int ld) {
  if (P.mult_vec) {  // T % 4 == 0 and c0 % 64 == 0: a chunk is all inside T or all outside
    for (int i = threadIdx.x; i < kTile * kTile / 4; i += kThreads) {
      const int r = i / (kTile / 4), c = 4 * (i % (kTile / 4));
      const bool ok = r0 + r < P.T && c0 + c < P.T;
      cp_async16(dst + r * ld + c,
                 ok ? P.mult + static_cast<long long>(r0 + r) * P.T + c0 + c : P.mult, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
      const int r = i / kTile, c = i % kTile;
      const bool ok = r0 + r < P.T && c0 + c < P.T;
      cp_async4(dst + r * ld + c,
                ok ? P.mult + static_cast<long long>(r0 + r) * P.T + c0 + c : P.mult, ok);
    }
  }
}

// The 64 4-byte values src[t0 + i] of a (·, T) row → dst, zeros past T.
__device__ __forceinline__ void stage_vector(const void* src, int t0, int T, void* dst) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const bool ok = t0 + i < T;
    cp_async4(static_cast<char*>(dst) + 4 * i,
              static_cast<const char*>(src) + 4 * static_cast<long long>(ok ? t0 + i : 0), ok);
  }
}

// -------------------------------------------------------- 3×TF32 products

struct Frag {  // an m16n8k8 A fragment, split into its tf32 big and small parts
  uint32_t big[4], small[4];
};

// x rounded to tf32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero, on the 13 low mantissa bits), on the integer pipe: the
// conversion unit runs at a sixteenth of the fp32 rate, and the kernels
// split two B values for every three mma.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a · b in 3×TF32: small·big and big·small first, then big·big.
// b0 = B[k = t][n = g], b1 = B[k = t + 4][n = g] of this lane.
__device__ __forceinline__ void mma3(float c[4], const Frag& a, float b0, float b1) {
  uint32_t bb[2], bs[2];
  split(b0, bb[0], bs[0]);
  split(b1, bb[1], bs[1]);
  mma_tf32(c, a.small, bb);
  mma_tf32(c, a.big, bs);
  mma_tf32(c, a.big, bb);
}

// acc += a · b for a product summed over a long axis (keys or queries): the
// tensor cores align and truncate each product to the accumulator they
// add into, so a chain of mma.sync over 640 rows loses bits to a running
// sum that has grown large (see the note at the top). The three products
// of each k-step go into a fresh accumulator instead, which then joins the
// running sum with an fp32 add.
__device__ __forceinline__ void mma3_sum(float acc[4], const Frag& a, const uint32_t bb[2],
                                         const uint32_t bs[2]) {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(c, a.small, bb);
  mma_tf32(c, a.big, bs);
  mma_tf32(c, a.big, bb);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += c[e];
}

// The same products as mma3 with the roles of the two operands swapped
// (big·small before small·big): the dk/dv kernel's transposed scores and dP
// then equal the dq kernel's bit for bit, given the same order of k.
__device__ __forceinline__ void mma3_swapped(float c[4], const Frag& a, float b0, float b1) {
  uint32_t bb[2], bs[2];
  split(b0, bb[0], bs[0]);
  split(b1, bb[1], bs[1]);
  mma_tf32(c, a.big, bs);
  mma_tf32(c, a.small, bb);
  mma_tf32(c, a.big, bb);
}

// The A fragment of rows [row0, row0 + 16), columns [8kk, 8kk + 8) of a
// shared-memory tile, unsplit: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4).
// A warp keeps its operand so (4 registers a k-step, not 8) and splits one
// k-step at a time as the products need it.
struct RawFrag {
  float x[4];
};

__device__ __forceinline__ RawFrag load_a(const float* tile, int ld, int row0, int kk, int g,
                                          int t) {
  const float* p = tile + (row0 + g) * ld + 8 * kk + t;
  return RawFrag{{p[0], p[8 * ld], p[4], p[8 * ld + 4]}};
}

__device__ __forceinline__ Frag split_a(const RawFrag& r) {
  Frag f;
#pragma unroll
  for (int i = 0; i < 4; ++i) split(r.x[i], f.big[i], f.small[i]);
  return f;
}

// An accumulator (rows g, g + 8; columns 2t, 2t + 1 of an 8-column step) as
// the A fragment of the product that sums over those 8 columns, in the
// permuted k order k = t ↔ column 2t, k = t + 4 ↔ column 2t + 1. The B
// operand of that product reads rows 2t and 2t + 1 (see the loops).
__device__ __forceinline__ Frag acc_as_a(const float c[4]) {
  Frag f;
  split(c[0], f.big[0], f.small[0]);
  split(c[2], f.big[1], f.small[1]);
  split(c[1], f.big[2], f.small[2]);
  split(c[3], f.big[3], f.small[3]);
  return f;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows row0 + g + 8r (r < 2), columns 8nd + 2t + e (e < 2) of an
// accumulator strip (16 × hd) → dst rows, divided by div[r] when given.
template <int kSteps>
__device__ __forceinline__ void store_strip(const View& dst, int b, int h, int row0,
                                            const Problem& P, int g, int t,
                                            const float acc[kSteps][4], const float* div) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= P.T) continue;
    float* out = dst.row(b, h, row);
#pragma unroll
    for (int nd = 0; nd < kSteps; ++nd) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * nd + 2 * t + e;
        if (d < P.hd) out[d] = div ? acc[nd][2 * r + e] / div[r] : acc[nd][2 * r + e];
      }
    }
  }
}

// What a key's score gets added after the scale: 0 for a valid key, −1e30
// for a masked one (the sum is then −1e30 exactly: |s · scale| is far below
// half its ulp) and −inf past T.
__device__ __forceinline__ float key_bias(int key, int valid, int T) {
  return key >= T ? -INFINITY : (valid ? 0.f : kMasked);
}

// A stage of the forward / dq ring: k and v (64 × ld each), μ, key mask.
struct KeyStage {
  float* k;
  float* v;
  float* mu;  // 64 × kMuLdRow, when P.mult
  int* km;
};

__device__ __forceinline__ int key_stage_floats(const Problem& P) {
  return 2 * kTile * P.ld + P.mu_floats + kTile;
}

__device__ __forceinline__ KeyStage key_stage(float* smem, int s, const Problem& P) {
  float* base = smem + s * key_stage_floats(P);
  KeyStage st;
  st.k = base;
  st.v = base + kTile * P.ld;
  st.mu = st.v + kTile * P.ld;
  st.km = reinterpret_cast<int*>(st.mu + P.mu_floats);
  return st;
}

// Queue the copies of the key tile at k0 for the query tile at q0.
template <bool kVec>
__device__ __forceinline__ void load_key_tile(const View& k, const View& v, int b, int h, int q0,
                                              int k0, const Problem& P, const KeyStage& st) {
  stage_rows<kVec>(k, b, h, k0, P, st.k);
  stage_rows<kVec>(v, b, h, k0, P, st.v);
  if (P.mult != nullptr) stage_mult(P, q0, k0, st.mu, kMuLdRow);
  stage_vector(P.kmask + static_cast<long long>(b) * P.T, k0, P.T, st.km);
}

// s[n] (rows g, g + 8 of the warp; columns 8n + 2t, 2t + 1), n < kN, = the
// warp's 16 rows of A (kept as raw fragments) times rows [0, 8kN) of a
// tile, summed over the head dimension: q · kᵀ, or do · vᵀ.
template <int kSteps, int kN, bool kSwapped = false>
__device__ __forceinline__ void score_tile(float s[kN][4], const RawFrag a[kSteps],
                                           const float* tile, int ld, int g, int t) {
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const Frag f = split_a(a[kk]);
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const float* p = tile + (8 * n + g) * ld + 8 * kk + t;
      if (kSwapped)
        mma3_swapped(s[n], f, p[0], p[4]);
      else
        mma3(s[n], f, p[0], p[4]);
    }
  }
}

// acc (the warp's 16 rows × hd) += w · tile, summed over rows [0, 8kN) of
// the tile: w (16 × 8kN) is in accumulator layout and goes in as A
// fragments in the permuted k order, one 8-row step at a time. With w2 and
// acc2 also acc2 += w2 · tile, on the same split B fragments.
template <int kSteps, int kN, bool kTwo = false>
__device__ __forceinline__ void row_product(float acc[kSteps][4], const float w[kN][4],
                                            const float* tile, int ld, int g, int t,
                                            float acc2[kSteps][4] = nullptr,
                                            const float w2[kN][4] = nullptr) {
#pragma unroll
  for (int kk = 0; kk < kN; ++kk) {
    const Frag f = acc_as_a(w[kk]);
    Frag f2;
    if (kTwo) f2 = acc_as_a(w2[kk]);
    const float* p = tile + (8 * kk + 2 * t) * ld + g;
#pragma unroll
    for (int nd = 0; nd < kSteps; ++nd) {
      uint32_t bb[2], bs[2];
      split(p[8 * nd], bb[0], bs[0]);
      split(p[ld + 8 * nd], bb[1], bs[1]);
      mma3_sum(acc[nd], f, bb, bs);
      if (kTwo) mma3_sum(acc2[nd], f2, bb, bs);
    }
  }
}

// ------------------------------------------------------------------ forward

template <bool kVec, int kSteps>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(View q, View k, View v, View out, float* __restrict__ row_max,
                float* __restrict__ row_sum, Problem P) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int ntiles = (P.T + kTile - 1) / kTile;

  // the query tile lands in stage 1's k slot and is read into registers
  // before key tile 1 is queued there
  stage_rows<kVec>(q, b, h, q0, P, key_stage(smem, 1, P).k);
  load_key_tile<kVec>(k, v, b, h, q0, 0, P, key_stage(smem, 0, P));
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  RawFrag qf[kSteps];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
    qf[kk] = load_a(key_stage(smem, 1, P).k, P.ld, 16 * warp, kk, g, t);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g, g + 8
  float o[kSteps][4];
#pragma unroll
  for (int nd = 0; nd < kSteps; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait_all();
    __syncthreads();  // tile j is in for every thread; every warp is done with tile j − 1
    if (j + 1 < ntiles)
      load_key_tile<kVec>(k, v, b, h, q0, (j + 1) * kTile, P, key_stage(smem, (j + 1) & 1, P));
    cp_async_commit();
    const KeyStage st = key_stage(smem, j & 1, P);
    const int k0 = j * kTile;

    float s[kRowSteps][4];
    score_tile<kSteps, kRowSteps>(s, qf, st.k, P.ld, g, t);

    // scale and mask; the row max over the tile (a quad holds a row's 64 keys)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kRowSteps; ++nt) {
      const int c = 8 * nt + 2 * t;
      const int2 km = *reinterpret_cast<const int2*>(st.km + c);
      const float kb[2] = {key_bias(k0 + c, km.x, P.T), key_bias(k0 + c + 1, km.y, P.T)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = fmaf(s[nt][e], P.scale, kb[e & 1]);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));  // finite: the tile has a key < T
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
    const float* mu0 = st.mu + (16 * warp + g) * kMuLdRow + 2 * t;
#pragma unroll
    for (int nt = 0; nt < kRowSteps; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m[e >> 1]);  // 0 past T
        rs[e >> 1] += s[nt][e];
      }
      if (P.mult != nullptr) {  // μ scales p in the output sum only
        const float2 u0 = *reinterpret_cast<const float2*>(mu0 + 8 * nt);
        const float2 u1 = *reinterpret_cast<const float2*>(mu0 + 8 * kMuLdRow + 8 * nt);
        s[nt][0] *= u0.x;
        s[nt][1] *= u0.y;
        s[nt][2] *= u1.x;
        s[nt][3] *= u1.y;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(rs[r]);
#pragma unroll
    for (int nd = 0; nd < kSteps; ++nd) {
      o[nd][0] *= corr[0];
      o[nd][1] *= corr[0];
      o[nd][2] *= corr[1];
      o[nd][3] *= corr[1];
    }
    row_product<kSteps, kRowSteps>(o, s, st.v, P.ld, g, t);  // out += (p ∘ μ) · v
  }

  store_strip<kSteps>(out, b, h, q0 + 16 * warp, P, g, t, o, l);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + 16 * warp + g + 8 * r;
      if (row < P.T) {
        const long long i = (static_cast<long long>(b) * P.H + h) * P.T + row;
        row_max[i] = m[r];
        row_sum[i] = l[r];
      }
    }
  }
}

// ----------------------------------------------------------------- backward

template <bool kVec, int kSteps>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(View q, View k, View v, View dout, View dq,
                   const float* __restrict__ row_max, const float* __restrict__ row_sum,
                   float* __restrict__ delta, Problem P) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int ntiles = (P.T + kTile - 1) / kTile;
  const int row0 = q0 + 16 * warp;

  // q and do land in stage 1's k and v slots
  stage_rows<kVec>(q, b, h, q0, P, key_stage(smem, 1, P).k);
  stage_rows<kVec>(dout, b, h, q0, P, key_stage(smem, 1, P).v);
  load_key_tile<kVec>(k, v, b, h, q0, 0, P, key_stage(smem, 0, P));
  cp_async_commit();
  float m[2], rl[2];  // rows g and g + 8: the row max and 1 / the row sum
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    const long long i = (static_cast<long long>(b) * P.H + h) * P.T + row;
    m[r] = row < P.T ? row_max[i] : 0.f;
    rl[r] = 1.f / (row < P.T ? row_sum[i] : 1.f);
  }
  cp_async_wait_all();
  __syncthreads();
  RawFrag qf[kSteps], df[kSteps];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    qf[kk] = load_a(key_stage(smem, 1, P).k, P.ld, 16 * warp, kk, g, t);
    df[kk] = load_a(key_stage(smem, 1, P).v, P.ld, 16 * warp, kk, g, t);
  }
  // dq_i = scale · Σ_j w (μ dP − D_i) k_j = scale · (Σ_j w μ dP k_j − D_i Σ_j w k_j):
  // one sweep over the key tiles sums D_i = Σ_j w μ dP and both products
  float D[2] = {0.f, 0.f};
  float acc[kSteps][4], accw[kSteps][4];
#pragma unroll
  for (int nd = 0; nd < kSteps; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = accw[nd][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait_all();
    __syncthreads();
    if (j + 1 < ntiles)
      load_key_tile<kVec>(k, v, b, h, q0, (j + 1) * kTile, P, key_stage(smem, (j + 1) & 1, P));
    cp_async_commit();
    const KeyStage st = key_stage(smem, j & 1, P);
    const int k0 = j * kTile;
#pragma unroll 1
    for (int c0 = 0; c0 < kRowSteps; c0 += kChunk) {  // kChunk 8-key steps at a time
      float s[kChunk][4], dp[kChunk][4];
      score_tile<kSteps, kChunk>(s, qf, st.k + 8 * c0 * P.ld, P.ld, g, t);
      score_tile<kSteps, kChunk>(dp, df, st.v + 8 * c0 * P.ld, P.ld, g, t);
      const float* mu0 = st.mu + (16 * warp + g) * kMuLdRow + 2 * t + 8 * c0;
#pragma unroll
      for (int n = 0; n < kChunk; ++n) {
        float mu[4] = {1.f, 1.f, 1.f, 1.f};
        if (P.mult != nullptr) {
          const float2 u0 = *reinterpret_cast<const float2*>(mu0 + 8 * n);
          const float2 u1 = *reinterpret_cast<const float2*>(mu0 + 8 * kMuLdRow + 8 * n);
          mu[0] = u0.x;
          mu[1] = u0.y;
          mu[2] = u1.x;
          mu[3] = u1.y;
        }
        const int c = 8 * (c0 + n) + 2 * t;
        const int2 km = *reinterpret_cast<const int2*>(st.km + c);
        const float kb[2] = {key_bias(k0 + c, km.x, P.T), key_bias(k0 + c + 1, km.y, P.T)};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float w = expf(fmaf(s[n][e], P.scale, kb[e & 1]) - m[r]) * rl[r];  // 0 past T
          const float wd = w * (mu[e] * dp[n][e]);
          D[r] += wd;
          s[n][e] = wd;
          dp[n][e] = w;
        }
      }
      // acc += (w μ dP) · k, accw += w · k over these keys
      row_product<kSteps, kChunk, true>(acc, s, st.k + 8 * c0 * P.ld, P.ld, g, t, accw, dp);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // D is complete: stored for the dk/dv launch
    D[r] = quad_sum(D[r]);
    const int row = row0 + g + 8 * r;
    if (t == 0 && row < P.T) delta[(static_cast<long long>(b) * P.H + h) * P.T + row] = D[r];
  }
#pragma unroll
  for (int nd = 0; nd < kSteps; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = (acc[nd][e] - D[e >> 1] * accw[nd][e]) * P.scale;
  store_strip<kSteps>(dq, b, h, row0, P, g, t, acc, nullptr);
}

// A stage of the dk/dv ring: q and do (64 × ld each), μ (queries × keys),
// and the queries' m, l and D.
struct QueryStage {
  float* q;
  float* dout;
  float* mu;  // 64 × kMuLdCol, when P.mult
  float* m;
  float* l;
  float* D;
};

__device__ __forceinline__ int query_stage_floats(const Problem& P) {
  return 2 * kTile * P.ld + P.mu_floats + 3 * kTile;
}

__device__ __forceinline__ QueryStage query_stage(float* smem, int s, const Problem& P) {
  float* base = smem + s * query_stage_floats(P);
  QueryStage st;
  st.q = base;
  st.dout = base + kTile * P.ld;
  st.mu = st.dout + kTile * P.ld;
  st.m = st.mu + P.mu_floats;
  st.l = st.m + kTile;
  st.D = st.l + kTile;
  return st;
}

template <bool kVec>
__device__ __forceinline__ void load_query_tile(const View& q, const View& dout, int b, int h,
                                                int q0, int k0, const float* row_max,
                                                const float* row_sum, const float* delta,
                                                const Problem& P, const QueryStage& st) {
  stage_rows<kVec>(q, b, h, q0, P, st.q);
  stage_rows<kVec>(dout, b, h, q0, P, st.dout);
  if (P.mult != nullptr) stage_mult(P, q0, k0, st.mu, kMuLdCol);
  const long long bh = (static_cast<long long>(b) * P.H + h) * P.T;
  stage_vector(row_max + bh, q0, P.T, st.m);
  stage_vector(row_sum + bh, q0, P.T, st.l);
  stage_vector(delta + bh, q0, P.T, st.D);
}

template <bool kVec, int kSteps>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(View q, View k, View v, View dout, View dk, View dv,
                     const float* __restrict__ row_max, const float* __restrict__ row_sum,
                     const float* __restrict__ delta, Problem P) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int ntiles = (P.T + kTile - 1) / kTile;
  const int key0 = k0 + 16 * warp;

  // k and v land in stage 1's q and do slots
  stage_rows<kVec>(k, b, h, k0, P, query_stage(smem, 1, P).q);
  stage_rows<kVec>(v, b, h, k0, P, query_stage(smem, 1, P).dout);
  load_query_tile<kVec>(q, dout, b, h, 0, k0, row_max, row_sum, delta, P, query_stage(smem, 0, P));
  cp_async_commit();
  float kb[2];  // the bias of keys g and g + 8 of the warp
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + g + 8 * r;
    kb[r] = key_bias(key, key < P.T ? P.kmask[static_cast<long long>(b) * P.T + key] : 0, P.T);
  }
  cp_async_wait_all();
  __syncthreads();
  RawFrag kf[kSteps], vf[kSteps];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    kf[kk] = load_a(query_stage(smem, 1, P).q, P.ld, 16 * warp, kk, g, t);
    vf[kk] = load_a(query_stage(smem, 1, P).dout, P.ld, 16 * warp, kk, g, t);
  }
  float dka[kSteps][4], dva[kSteps][4];
#pragma unroll
  for (int nd = 0; nd < kSteps; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nd][e] = dva[nd][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait_all();
    __syncthreads();
    if (j + 1 < ntiles)
      load_query_tile<kVec>(q, dout, b, h, (j + 1) * kTile, k0, row_max, row_sum, delta, P,
                            query_stage(smem, (j + 1) & 1, P));
    cp_async_commit();
    const QueryStage st = query_stage(smem, j & 1, P);
    const int q0 = j * kTile;

    // transposed scores and dP: rows are the warp's keys, columns the
    // queries, computed as the dq kernel computes them (bit for bit)
#pragma unroll 1
    for (int c0 = 0; c0 < kRowSteps; c0 += kChunk) {  // kChunk 8-query steps at a time
      float s[kChunk][4], dp[kChunk][4];
      score_tile<kSteps, kChunk, true>(s, kf, st.q + 8 * c0 * P.ld, P.ld, g, t);
      score_tile<kSteps, kChunk, true>(dp, vf, st.dout + 8 * c0 * P.ld, P.ld, g, t);
      const float* mu0 = st.mu + (8 * c0 + 2 * t) * kMuLdCol + 16 * warp + g;
#pragma unroll
      for (int n = 0; n < kChunk; ++n) {
        const int cq = 8 * (c0 + n) + 2 * t;
        const float rl[2] = {1.f / st.l[cq], 1.f / st.l[cq + 1]};  // inf past T: not used
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = cq + (e & 1), r = e >> 1;
          const float w =
              q0 + c < P.T ? expf(fmaf(s[n][e], P.scale, kb[r]) - st.m[c]) * rl[e & 1] : 0.f;
          const float mu =
              P.mult != nullptr ? mu0[(8 * n + (e & 1)) * kMuLdCol + 8 * r] : 1.f;
          s[n][e] = w * mu;                                     // w ∘ μ
          dp[n][e] = w * (dp[n][e] * mu - st.D[c]) * P.scale;  // ds
        }
      }
      row_product<kSteps, kChunk>(dva, s, st.dout + 8 * c0 * P.ld, P.ld, g, t);  // dv += (w ∘ μ)ᵀ · do
      row_product<kSteps, kChunk>(dka, dp, st.q + 8 * c0 * P.ld, P.ld, g, t);    // dk += dsᵀ · q
    }
  }
  store_strip<kSteps>(dk, b, h, key0, P, g, t, dka, nullptr);
  store_strip<kSteps>(dv, b, h, key0, P, g, t, dva, nullptr);
}


// ============================================================ bf16 instances

using bf16 = __nv_bfloat16;

constexpr int kMuLdH = kTile + 8;         // bf16 μ tile row stride (ldmatrix reads conflict-free)
constexpr int kFwdWarpsH = 4;             // forward: 16 queries a warp, 16 · kFwdWarpsH a CTA
constexpr int kFwdMinBlocksH = 4;         // forward CTAs an SM must hold (caps its registers)
constexpr int kBwdMinBlocksH = 4;         // the same for each backward kernel (4 warps a CTA)
constexpr int kBwdChunkH = 2;             // 8-column blocks of scores a backward warp holds at once
constexpr int kFwdWarpsWg = 8;            // the wgmma instances' kFwdWarpsH, kFwdMinBlocksH,
constexpr int kFwdMinBlocksWg = 2;        //   kBwdMinBlocksH and kBwdChunkH
constexpr int kBwdMinBlocksWg = 3;
constexpr int kBwdChunkWg = 4;

template <bool kSw>
__host__ __device__ constexpr int fwd_warps() {
  return kSw ? kFwdWarpsWg : kFwdWarpsH;
}
constexpr float kLog2e = 1.4426950408889634f;

struct ViewH {  // a (B, H, T, hd) bf16 tensor with unit stride along hd
  bf16* p;
  long long sb, sh, st;
  __device__ __forceinline__ bf16* row(int b, int h, int t) const {
    return p + b * sb + h * sh + t * st;
  }
};

struct ProblemH {
  const int* kmask;  // (B, T), nonzero = valid key
  const bf16* mult;  // (T, T) dropout multiplier, or null
  int H, T, hd;
  int hdp;           // hd zero-padded to the kernel's 16-deep k-steps: 16 · kK (48 or 64)
  int ld;            // shared-memory row stride of a (rows, hd) tile, in elements: hdp + 8
  bool mult_vec;     // μ rows can be copied 16 bytes at a time
  float scale;       // hd^-½
};

__device__ __forceinline__ bf16 bf16_zero() { return __float2bfloat16_rn(0.f); }

// Element (r, c) of a streamed (rows, hdp) tile: rows of P.ld elements, or
// (kSw, hdp = ld = 64) the layout wgmma reads with the 128-byte swizzle:
// 128-byte rows whose 16-byte chunk c / 8 sits at chunk (c / 8) ^ (r % 8),
// the tile 1024-byte aligned.
template <bool kSw>
__device__ __forceinline__ int tile_off(int r, int c, int ld) {
  return kSw ? r * 64 + ((((c >> 3) ^ r) & 7) << 3) + (c & 7) : r * ld + c;
}

// Rows [t0, t0 + rows) of one (b, h) slice → dst (rows × P.ld), zeros past T
// and in the columns [hd, hdp).
template <bool kVec, int kThr, bool kSw>
__device__ __forceinline__ void stage_rows_h(const ViewH& v, int b, int h, int t0, int rows,
                                             const ProblemH& P, bf16* dst) {
  if (kVec) {  // hd % 8 == 0: a 16-byte chunk is all inside hd or all outside
    const int chunks = P.hdp / 8;
    for (int i = threadIdx.x; i < rows * chunks; i += kThr) {
      const int r = i / chunks, c = 8 * (i - r * chunks);
      const bool ok = t0 + r < P.T && c < P.hd;
      cp_async16(dst + tile_off<kSw>(r, c, P.ld), ok ? v.row(b, h, t0 + r) + c : v.p, ok);
    }
  } else {  // element by element, synchronous: visible after the tile's barrier
    for (int i = threadIdx.x; i < rows * P.hdp; i += kThr) {
      const int r = i / P.hdp, c = i - r * P.hdp;
      const bool ok = t0 + r < P.T && c < P.hd;
      dst[tile_off<kSw>(r, c, P.ld)] = ok ? v.row(b, h, t0 + r)[c] : bf16_zero();
    }
  }
}

// μ[r0 + r][c0 + c], r < rows, c < 64 → dst (rows × kMuLdH), zeros outside T × T.
template <int kThr>
__device__ __forceinline__ void stage_mult_h(const ProblemH& P, int r0, int c0, int rows, bf16* dst) {
  if (P.mult_vec) {  // T % 8 == 0 and c0 % 64 == 0: a chunk is all inside T or all outside
    for (int i = threadIdx.x; i < rows * kTile / 8; i += kThr) {
      const int r = i / (kTile / 8), c = 8 * (i % (kTile / 8));
      const bool ok = r0 + r < P.T && c0 + c < P.T;
      cp_async16(dst + r * kMuLdH + c,
                 ok ? P.mult + static_cast<long long>(r0 + r) * P.T + c0 + c : P.mult, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * kTile; i += kThr) {
      const int r = i / kTile, c = i % kTile;
      const bool ok = r0 + r < P.T && c0 + c < P.T;
      dst[r * kMuLdH + c] = ok ? P.mult[static_cast<long long>(r0 + r) * P.T + c0 + c] : bf16_zero();
    }
  }
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 × 8 bf16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8. Plain: lane (g, t) receives (row g, columns 2t,
// 2t + 1) of each; .trans: (rows 2t, 2t + 1, column g), packed low first.
__device__ __forceinline__ void ldsm4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm4_t(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// (lo, hi) rounded to bf16 and packed, lo in the low half (the lower k)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

struct FragH {  // an m16n8k16 bf16 A fragment
  uint32_t r[4];
};

// The A fragment of rows [row0, row0 + 16), columns [16kk, 16kk + 16) of a
// tile: (g, 2t..), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..).
template <bool kSw>
__device__ __forceinline__ FragH lda_h(const bf16* tile, int ld, int row0, int kk, int lane) {
  const int j = lane >> 3;
  FragH f;
  ldsm4(f.r, tile + tile_off<kSw>(row0 + (lane & 7) + 8 * (j & 1), 16 * kk + 8 * (j >> 1), ld));
  return f;
}

// ---- wgmma: the warpgroup's 4 warps × 16 rows are one m64 tile, each warp's
// A fragment and accumulator blocks laid out as mma.sync's (the A operand
// from registers), B read from a swizzled tile (tile_off<true>) through a
// descriptor: start address, the 128-byte swizzle, and 1024 bytes (8 rows of
// 128) as the stride between 8-row groups. That stride is SBO; LBO is unused
// where a B tile is 64 columns wide, and takes the same value, which is right
// under either reading of the two for the transposed layout. A 16-deep step
// along a row adds 32 bytes to the start, a 16-row step 2048. kTransB 0: B's
// summed axis runs along the tile's rows (scores: q · kᵀ); 1: down its
// columns (p · v).
__device__ __forceinline__ uint64_t wg_desc(const bf16* tile) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4) | (64ull << 16) | (64ull << 32) |
         (1ull << 62);
}

template <int kN>  // d += a · b: kN 8-column blocks (m64n{8kN}k16)
struct Wgmma;

template <>
struct Wgmma<2> {
  template <int kTransB>
  static __device__ __forceinline__ void run(float (&d)[2][4], const uint32_t a[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, %13;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(kTransB), "r"(1));
  }
};

template <>
struct Wgmma<4> {
  template <int kTransB>
  static __device__ __forceinline__ void run(float (&d)[4][4], const uint32_t a[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %21;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(kTransB), "r"(1));
  }
};

template <>
struct Wgmma<8> {
  template <int kTransB>
  static __device__ __forceinline__ void run(float (&d)[8][4], const uint32_t a[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(kTransB), "r"(1));
  }
};

// d += a · b with both operands in swizzled shared tiles (descriptors): the
// forward's scores, q · kᵀ, from the CTA's own q tile (m64n64k16).
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wg_arrive() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins registers an asynchronous wgmma writes or reads: the compiler may not
// move their other uses across this point.
template <int kN>
__device__ __forceinline__ void wg_fence(float (&d)[kN][4]) {
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
}

template <int kN>
__device__ __forceinline__ void wg_fence(uint32_t (&a)[kN][4]) {
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[n][e])::"memory");
}

// The dynamic shared memory's start, rounded up to 1024 bytes for swizzled
// tiles (the launch adds 1024 bytes).
template <bool kSw>
__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  return kSw ? p + ((1024u - (smem_addr(p) & 1023u)) & 1023u) : p;
}

// Generic-proxy writes to shared memory (cp.async, stores) made visible to
// wgmma's reads, which go through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// s[n], n < kN += the warpgroup's rows of A (kK 16-deep fragments) times rows
// [0, 8kN) of a swizzled tile, summed over hd. Issued, not waited for.
template <int kK, int kN>
__device__ __forceinline__ void wg_scores(float (&s)[kN][4], const FragH (&a)[kK],
                                          const bf16* tile) {
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) Wgmma<kN>::template run<0>(s, a[kk].r, wg_desc(tile + 16 * kk));
}

// The backward's scores and dP of one chunk: s = a · rows of ta, dp = b ·
// rows of tb, from zero, both issued before one wait.
template <int kK, int kN>
__device__ __forceinline__ void wg_pair(float (&s)[kN][4], float (&dp)[kN][4], const FragH (&a)[kK],
                                        const FragH (&b)[kK], const bf16* ta, const bf16* tb) {
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
  wg_fence(s);
  wg_fence(dp);
  wg_arrive();
  wg_scores<kK, kN>(s, a, ta);
  wg_scores<kK, kN>(dp, b, tb);
  wg_commit_wait();
  wg_fence(s);
  wg_fence(dp);
}

// w (each warp's 16 × 16, two accumulator blocks) rounded to bf16 and packed
// as an A fragment.
__device__ __forceinline__ void pack_a(uint32_t a[4], const float w0[4], const float w1[4]) {
  a[0] = pack_bf16(w0[0], w0[1]);
  a[1] = pack_bf16(w0[2], w0[3]);
  a[2] = pack_bf16(w1[0], w1[1]);
  a[3] = pack_bf16(w1[2], w1[3]);
}

// B fragments of a product that sums over a tile's columns (q · kᵀ, do · vᵀ,
// k · qᵀ, v · doᵀ): rows [8n, 8n + 16) of the tile as two 8-column blocks of
// the result, columns [16kk, 16kk + 16). b[0], b[1] feed block n; b[2], b[3]
// block n + 1.
__device__ __forceinline__ void ldb_rows(uint32_t b[4], const bf16* tile, int ld, int n, int kk,
                                         int lane) {
  const int j = lane >> 3;
  ldsm4(b, tile + (8 * n + (lane & 7) + 8 * (j >> 1)) * ld + 16 * kk + 8 * (j & 1));
}

// B fragments of a product that sums over a tile's rows (p · v, ds · k,
// (w ∘ μ)ᵀ · do, dsᵀ · q): rows [16ks, 16ks + 16) of the tile, columns
// [8nd, 8nd + 16) as two 8-column blocks of the result, through ldmatrix's
// transpose. b[0], b[1] feed block nd; b[2], b[3] block nd + 1.
__device__ __forceinline__ void ldb_cols(uint32_t b[4], const bf16* tile, int ld, int ks, int nd,
                                         int lane) {
  const int j = lane >> 3;
  ldsm4_t(b, tile + (16 * ks + (lane & 7) + 8 * (j & 1)) * ld + 8 * nd + 8 * (j >> 1));
}

// s[n], n < kN (rows g, g + 8 of the warp; columns 8n + 2t, 2t + 1) = the
// warp's 16 rows of A times rows [0, 8kN) of a tile, summed over hd.
template <int kK, int kN>
__device__ __forceinline__ void score_tile_h(float s[kN][4], const FragH a[kK], const bf16* tile,
                                             int ld, int lane) {
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kK; ++kk)
#pragma unroll
    for (int n = 0; n < kN; n += 2) {
      uint32_t bb[4];
      ldb_rows(bb, tile, ld, n, kk, lane);
      mma_bf16(s[n], a[kk].r, bb[0], bb[1]);
      mma_bf16(s[n + 1], a[kk].r, bb[2], bb[3]);
    }
}

// acc (the warp's 16 rows × hdp, 2kK 8-column blocks) += w · tile rows
// [16ks, 16ks + 16): w (16 × 16, two accumulator blocks) goes in as an A
// fragment, rounded to bf16 as it is packed (the accumulator of two
// adjacent 8-column blocks is, column for column, a 16-deep A fragment).
template <int kK>
__device__ __forceinline__ void row_product_h(float acc[2 * kK][4], const float w0[4],
                                              const float w1[4], const bf16* tile, int ld, int ks,
                                              int lane) {
  const uint32_t a[4] = {pack_bf16(w0[0], w0[1]), pack_bf16(w0[2], w0[3]),
                         pack_bf16(w1[0], w1[1]), pack_bf16(w1[2], w1[3])};
#pragma unroll
  for (int nd = 0; nd < 2 * kK; nd += 2) {
    uint32_t bb[4];
    ldb_cols(bb, tile, ld, ks, nd, lane);
    mma_bf16(acc[nd], a, bb[0], bb[1]);
    mma_bf16(acc[nd + 1], a, bb[2], bb[3]);
  }
}

// μ of the accumulator blocks n, n + 1 of rows row0 + g, + 8 (forward, dq:
// rows are queries, the tile is μ[query][key]): u[0] (row g) and u[1]
// (row g + 8) of block n, u[2], u[3] of block n + 1, each a bf16 pair at
// columns 2t, 2t + 1.
__device__ __forceinline__ void ld_mu_rows(uint32_t u[4], const bf16* mu, int row0, int n,
                                           int lane) {
  const int j = lane >> 3;
  ldsm4(u, mu + (row0 + (lane & 7) + 8 * (j & 1)) * kMuLdH + 8 * n + 8 * (j >> 1));
}

// The same for the dk/dv kernel, whose rows are keys key0 + g, + 8 and
// columns queries: μ[query][key] read through the transpose.
__device__ __forceinline__ void ld_mu_cols(uint32_t u[4], const bf16* mu, int key0, int n,
                                           int lane) {
  const int j = lane >> 3;
  ldsm4_t(u, mu + (8 * n + (lane & 7) + 8 * (j >> 1)) * kMuLdH + key0 + 8 * (j & 1));
}

// exp(x − m) as 2^((x − m) · log2 e) on MUFU.EX2 (ex2.approx.ftz: relative
// error ~2⁻²², results below 2⁻¹²⁶ flushed to 0), where expf does a range
// reduction first and exp2f guards denormal results (6 % of the backward,
// scripts/bench_attention_variants.py). x − m is exactly 0 at the row's max
// (the backward recomputes x bit for bit) and 2⁰ is exactly 1, so the max
// key's p̃ is 1 and a row whose whole weight sits on one key gets w = 1.
__device__ __forceinline__ float exp_shifted(float x, float m) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"((x - m) * kLog2e));
  return r;
}

// ds = w ∘ (μ dP − D) · scale, and exactly 0 where w == 1: every other key
// of the row then weighs below fp32's resolution, so D = μ dP up to it and
// the difference is rounding alone (D = do · õ sums in another order than
// the tensor cores' dP). The Pallas kernel's D, summed from w and dP, makes
// that cancellation exact; this keeps it exact.
__device__ __forceinline__ float ds_of(float w, float mu, float dp, float D, float scale) {
  return w == 1.f ? 0.f : w * (mu * dp - D) * scale;
}

// Rows row0 + g + 8r, columns 8nd + 2t + e of an accumulator strip → bf16
// dst rows (and fp32 dst32 rows unless dst32.p is null), divided by div[r]
// first when given.
template <int kK>
__device__ __forceinline__ void store_strip_h(const ViewH& dst, const View& dst32, int b, int h,
                                              int row0, const ProblemH& P, int g, int t,
                                              const float acc[2 * kK][4], const float* div) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= P.T) continue;
    bf16* out = dst.row(b, h, row);
    float* out32 = dst32.p != nullptr ? dst32.row(b, h, row) : nullptr;
#pragma unroll
    for (int nd = 0; nd < 2 * kK; ++nd)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * nd + 2 * t + e;
        if (d < P.hd) {
          const float x = div ? acc[nd][2 * r + e] / div[r] : acc[nd][2 * r + e];
          out[d] = __float2bfloat16_rn(x);
          if (out32 != nullptr) out32[d] = x;
        }
      }
  }
}

// A stage of the forward / dq ring: k and v (64 × ld each), μ (kRows
// queries × 64 keys), key mask.
struct KeyStageH {
  bf16* k;
  bf16* v;
  bf16* mu;
  int* km;
};

// a stage starts 1024-byte aligned, as a swizzled tile must
__host__ __device__ __forceinline__ int key_stage_bytes_h(const ProblemH& P, int rows) {
  return (2 * (2 * kTile * P.ld + (P.mult != nullptr ? rows * kMuLdH : 0)) + 4 * kTile + 1023) &
         ~1023;
}

__device__ __forceinline__ KeyStageH key_stage_h(unsigned char* smem, int s, int rows,
                                                 const ProblemH& P) {
  KeyStageH st;
  st.k = reinterpret_cast<bf16*>(smem + s * key_stage_bytes_h(P, rows));
  st.v = st.k + kTile * P.ld;
  st.mu = st.v + kTile * P.ld;
  st.km = reinterpret_cast<int*>(st.mu + (P.mult != nullptr ? rows * kMuLdH : 0));
  return st;
}

template <bool kVec, int kThr, bool kSw>
__device__ __forceinline__ void load_key_tile_h(const ViewH& k, const ViewH& v, int b, int h,
                                                int q0, int rows, int k0, const ProblemH& P,
                                                const KeyStageH& st) {
  stage_rows_h<kVec, kThr, kSw>(k, b, h, k0, kTile, P, st.k);
  stage_rows_h<kVec, kThr, kSw>(v, b, h, k0, kTile, P, st.v);
  if (P.mult != nullptr) stage_mult_h<kThr>(P, q0, k0, rows, st.mu);
  stage_vector(P.kmask + static_cast<long long>(b) * P.T, k0, P.T, st.km);
}

// The forward. A CTA of fwd_warps warps takes 16 · fwd_warps queries, a
// warp 16 of them as bf16 A fragments in registers, and streams the 64-key
// tiles of k, v, μ and the key mask through a two-stage cp.async ring. Per
// tile: S = q · kᵀ (B from k through ldmatrix), x = S · hd^-½ + the mask's
// bias in one FMA, the online max and sum over a quad with p̃ = exp2((x − m)
// · log2 e), and out += bf16(p̃ ∘ μ) · v (B from v through ldmatrix.trans).
// The row max and row sum are stored as the plain version computes them.
// With out32 the kernel also writes the output in fp32 before its bf16
// rounding, for the backward's D = do · õ. With kSw (hd 64) the tiles are
// swizzled and both products run on wgmma, a warpgroup (4 warps, 64 queries)
// each: q · kᵀ with q from its own shared tile behind the ring, bf16(p̃ ∘ μ)
// · v with p̃ from registers.
template <bool kVec, int kK, bool kSw>
__global__ void __launch_bounds__(32 * fwd_warps<kSw>(), kSw ? kFwdMinBlocksWg : kFwdMinBlocksH)
attn_fwd_bf16_kernel(ViewH q, ViewH k, ViewH v, ViewH out, View out32,
                     float* __restrict__ row_max, float* __restrict__ row_sum, ProblemH P) {
  static_assert(!kSw || kK == 4, "wgmma tiles are 64 columns wide");
  constexpr int kThr = 32 * fwd_warps<kSw>(), kRows = 16 * fwd_warps<kSw>();
  extern __shared__ __align__(16) unsigned char smem_h[];
  unsigned char* const smem = align_smem<kSw>(smem_h);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int ntiles = (P.T + kTile - 1) / kTile;

  // the query tile (kRows ≤ 128 rows) lands in stage 1's k and v slots and
  // is read into registers before key tile 1 is queued there; with kSw it
  // stays in shared memory, after the ring
  bf16* qs = kSw ? reinterpret_cast<bf16*>(smem + 2 * key_stage_bytes_h(P, kRows))
                 : key_stage_h(smem, 1, kRows, P).k;
  stage_rows_h<kVec, kThr, kSw>(q, b, h, q0, kRows, P, qs);
  load_key_tile_h<kVec, kThr, kSw>(k, v, b, h, q0, kRows, 0, P, key_stage_h(smem, 0, kRows, P));
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  FragH qf[kSw ? 1 : kK];
  if constexpr (!kSw) {
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) qf[kk] = lda_h<kSw>(qs, P.ld, 16 * warp, kk, lane);
  }
  const bf16* qwg = qs + 64 * 64 * (warp / 4);  // this warpgroup's 64 queries (kSw)

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g, g + 8
  float o[2 * kK][4];
#pragma unroll
  for (int nd = 0; nd < 2 * kK; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait_all();
    if (kSw) fence_proxy_async();
    __syncthreads();  // tile j is in for every thread; every warp is done with tile j − 1
    if (j + 1 < ntiles)
      load_key_tile_h<kVec, kThr, kSw>(k, v, b, h, q0, kRows, (j + 1) * kTile, P,
                                       key_stage_h(smem, (j + 1) & 1, kRows, P));
    cp_async_commit();
    const KeyStageH st = key_stage_h(smem, j & 1, kRows, P);
    const int k0 = j * kTile;

    float s[kRowSteps][4];
    if constexpr (kSw) {
#pragma unroll
      for (int n = 0; n < kRowSteps; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      wg_fence(s);
      wg_arrive();
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) wgmma_ss(s, wg_desc(qwg + 16 * kk), wg_desc(st.k + 16 * kk));
      wg_commit_wait();
      wg_fence(s);
    } else {
      score_tile_h<kK, kRowSteps>(s, qf, st.k, P.ld, lane);
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kRowSteps; ++nt) {
      const int c = 8 * nt + 2 * t;
      const int2 km = *reinterpret_cast<const int2*>(st.km + c);
      const float kb[2] = {key_bias(k0 + c, km.x, P.T), key_bias(k0 + c + 1, km.y, P.T)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = fmaf(s[nt][e], P.scale, kb[e & 1]);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));  // finite: the tile has a key < T
      corr[r] = exp_shifted(m[r], m_new);
      m[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kRowSteps; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp_shifted(s[nt][e], m[e >> 1]);  // 0 past T
        rs[e >> 1] += s[nt][e];
      }
    if (P.mult != nullptr) {  // μ scales p in the output sum only
#pragma unroll
      for (int nt = 0; nt < kRowSteps; nt += 2) {
        uint32_t u[4];
        ld_mu_rows(u, st.mu, 16 * warp, nt, lane);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = unpack_bf16(u[i]);
          float* c = s[nt + (i >> 1)] + 2 * (i & 1);
          c[0] *= f.x;
          c[1] *= f.y;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(rs[r]);
#pragma unroll
    for (int nd = 0; nd < 2 * kK; ++nd) {
      o[nd][0] *= corr[0];
      o[nd][1] *= corr[0];
      o[nd][2] *= corr[1];
      o[nd][3] *= corr[1];
    }
    if constexpr (kSw) {  // out += bf16(p̃ ∘ μ) · v
      uint32_t a[kRowSteps / 2][4];
#pragma unroll
      for (int ks = 0; ks < kRowSteps / 2; ++ks) pack_a(a[ks], s[2 * ks], s[2 * ks + 1]);
      wg_fence(o);
      wg_fence(a);
      wg_arrive();
#pragma unroll
      for (int ks = 0; ks < kRowSteps / 2; ++ks)
        Wgmma<2 * kK>::template run<1>(o, a[ks], wg_desc(st.v + 16 * 64 * ks));
      wg_commit_wait();
      wg_fence(o);
      wg_fence(a);
    } else {
#pragma unroll
      for (int ks = 0; ks < kRowSteps / 2; ++ks)  // out += bf16(p̃ ∘ μ) · v
        row_product_h<kK>(o, s[2 * ks], s[2 * ks + 1], st.v, P.ld, ks, lane);
    }
  }

  store_strip_h<kK>(out, out32, b, h, q0 + 16 * warp, P, g, t, o, l);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + 16 * warp + g + 8 * r;
      if (row < P.T) {
        const long long i = (static_cast<long long>(b) * P.H + h) * P.T + row;
        row_max[i] = m[r];
        row_sum[i] = l[r];
      }
    }
  }
}

// The backward's per-row scratch, (2, B, H, T) fp32: D and 1 / the row
// sum, written by the dq kernel for the dk/dv one.
struct RowScratch {
  float* D;
  float* rl;
};

// dq, in one sweep of the key tiles. The CTA's 64 queries first get
// D_i = do_i · õ_i (fp32 õ from the forward, summed in a fixed order), then
// each 16-key chunk of a tile: S = q · kᵀ and dP = do · vᵀ (B through
// ldmatrix), w = exp(S · hd^-½ + bias − m) / l (the forward's x and p̃, bit
// for bit), ds = w ∘ (μ dP − D) · hd^-½, and dq += bf16(ds) · k (B through
// ldmatrix.trans): three T × T × hd products. With kSw (hd 64) the three run
// on wgmma from swizzled tiles.
template <bool kVec, int kK, bool kSw>
__global__ void __launch_bounds__(kThreads, kSw ? kBwdMinBlocksWg : kBwdMinBlocksH)
attn_bwd_dq_bf16_kernel(ViewH q, ViewH k, ViewH v, View out32, ViewH dout, ViewH dq,
                        const float* __restrict__ row_max, const float* __restrict__ row_sum,
                        RowScratch rows, ProblemH P) {
  static_assert(!kSw || kK == 4, "wgmma tiles are 64 columns wide");
  constexpr int kChunkH = kSw ? kBwdChunkWg : kBwdChunkH;
  extern __shared__ __align__(16) unsigned char smem_h[];
  unsigned char* const smem = align_smem<kSw>(smem_h);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int ntiles = (P.T + kTile - 1) / kTile;
  const int row0 = q0 + 16 * warp;
  const long long bh = (static_cast<long long>(b) * P.H + h) * P.T;

  // q and do land in stage 1's k and v slots
  const KeyStageH st1 = key_stage_h(smem, 1, kTile, P);
  stage_rows_h<kVec, kThreads, kSw>(q, b, h, q0, kTile, P, st1.k);
  stage_rows_h<kVec, kThreads, kSw>(dout, b, h, q0, kTile, P, st1.v);
  load_key_tile_h<kVec, kThreads, kSw>(k, v, b, h, q0, kTile, 0, P,
                                       key_stage_h(smem, 0, kTile, P));
  cp_async_commit();
  float m[2], rl[2];  // rows g and g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    m[r] = row < P.T ? row_max[bh + row] : 0.f;
    rl[r] = 1.f / (row < P.T ? row_sum[bh + row] : 1.f);
  }
  cp_async_wait_all();
  __syncthreads();
  FragH qf[kK], df[kK];
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
    qf[kk] = lda_h<kSw>(st1.k, P.ld, 16 * warp, kk, lane);
    df[kk] = lda_h<kSw>(st1.v, P.ld, 16 * warp, kk, lane);
  }
  // D: lanes 2i and 2i + 1 each sum half of row i's hd, then add the halves
  float D[2];
  {
    const int i = lane >> 1, row = row0 + i, half = (P.hd + 1) / 2;
    const int d0 = (lane & 1) * half, d1 = min(P.hd, d0 + half);
    float part = 0.f;
    if (row < P.T) {
      const float* orow = out32.row(b, h, row);
      for (int d = d0; d < d1; ++d)
        part = fmaf(__bfloat162float(st1.v[tile_off<kSw>(16 * warp + i, d, P.ld)]), orow[d], part);
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    D[0] = __shfl_sync(0xffffffffu, part, 2 * g);
    D[1] = __shfl_sync(0xffffffffu, part, 2 * g + 16);
    if ((lane & 1) == 0 && row < P.T) {
      rows.D[bh + row] = part;
      rows.rl[bh + row] = 1.f / row_sum[bh + row];
    }
  }
  float acc[2 * kK][4];
#pragma unroll
  for (int nd = 0; nd < 2 * kK; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait_all();
    if (kSw) fence_proxy_async();
    __syncthreads();
    if (j + 1 < ntiles)
      load_key_tile_h<kVec, kThreads, kSw>(k, v, b, h, q0, kTile, (j + 1) * kTile, P,
                                           key_stage_h(smem, (j + 1) & 1, kTile, P));
    cp_async_commit();
    const KeyStageH st = key_stage_h(smem, j & 1, kTile, P);
    const int k0 = j * kTile;
#pragma unroll 1
    for (int c0 = 0; c0 < kRowSteps; c0 += kChunkH) {  // 8 · kChunkH keys at a time
      float s[kChunkH][4], dp[kChunkH][4];
      if constexpr (kSw) {
        wg_pair(s, dp, qf, df, st.k + 8 * c0 * P.ld, st.v + 8 * c0 * P.ld);
      } else {
        score_tile_h<kK, kChunkH>(s, qf, st.k + 8 * c0 * P.ld, P.ld, lane);
        score_tile_h<kK, kChunkH>(dp, df, st.v + 8 * c0 * P.ld, P.ld, lane);
      }
#pragma unroll
      for (int n2 = 0; n2 < kChunkH; n2 += 2) {
        uint32_t u[4] = {0x3f803f80u, 0x3f803f80u, 0x3f803f80u, 0x3f803f80u};  // bf16 (1, 1)
        if (P.mult != nullptr) ld_mu_rows(u, st.mu, 16 * warp, c0 + n2, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int n = n2 + i, c = 8 * (c0 + n) + 2 * t;
          const int2 km = *reinterpret_cast<const int2*>(st.km + c);
          const float kb[2] = {key_bias(k0 + c, km.x, P.T), key_bias(k0 + c + 1, km.y, P.T)};
          const float2 mu[2] = {unpack_bf16(u[2 * i]), unpack_bf16(u[2 * i + 1])};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const float w = exp_shifted(fmaf(s[n][e], P.scale, kb[e & 1]), m[r]) * rl[r];  // 0 past T
            s[n][e] = ds_of(w, (e & 1) ? mu[r].y : mu[r].x, dp[n][e], D[r], P.scale);
          }
        }
      }
      if constexpr (kSw) {  // dq += bf16(ds) · k
        uint32_t a[kChunkH / 2][4];
#pragma unroll
        for (int n2 = 0; n2 < kChunkH; n2 += 2) pack_a(a[n2 / 2], s[n2], s[n2 + 1]);
        wg_fence(acc);
        wg_fence(a);
        wg_arrive();
#pragma unroll
        for (int n2 = 0; n2 < kChunkH; n2 += 2)
          Wgmma<2 * kK>::template run<1>(acc, a[n2 / 2], wg_desc(st.k + 8 * (c0 + n2) * 64));
        wg_commit_wait();
        wg_fence(acc);
        wg_fence(a);
      } else {
#pragma unroll
        for (int n2 = 0; n2 < kChunkH; n2 += 2)  // dq += bf16(ds) · k
          row_product_h<kK>(acc, s[n2], s[n2 + 1], st.k, P.ld, (c0 + n2) / 2, lane);
      }
    }
  }
  store_strip_h<kK>(dq, View{}, b, h, row0, P, g, t, acc, nullptr);
}

// A stage of the dk/dv ring: q and do (64 × ld each), μ (queries × keys),
// and the queries' row max, D and 1 / l.
struct QueryStageH {
  bf16* q;
  bf16* dout;
  bf16* mu;
  float* m;
  float* D;
  float* rl;
};

__host__ __device__ __forceinline__ int query_stage_bytes_h(const ProblemH& P) {
  return (2 * (2 * kTile * P.ld + (P.mult != nullptr ? kTile * kMuLdH : 0)) + 3 * 4 * kTile + 1023) &
         ~1023;
}

__device__ __forceinline__ QueryStageH query_stage_h(unsigned char* smem, int s,
                                                     const ProblemH& P) {
  QueryStageH st;
  st.q = reinterpret_cast<bf16*>(smem + s * query_stage_bytes_h(P));
  st.dout = st.q + kTile * P.ld;
  st.mu = st.dout + kTile * P.ld;
  st.m = reinterpret_cast<float*>(st.mu + (P.mult != nullptr ? kTile * kMuLdH : 0));
  st.D = st.m + kTile;
  st.rl = st.D + kTile;
  return st;
}

template <bool kVec, bool kSw>
__device__ __forceinline__ void load_query_tile_h(const ViewH& q, const ViewH& dout, int b,
                                                  int h, int q0, int k0, const float* row_max,
                                                  const RowScratch& rows, const ProblemH& P,
                                                  const QueryStageH& st) {
  stage_rows_h<kVec, kThreads, kSw>(q, b, h, q0, kTile, P, st.q);
  stage_rows_h<kVec, kThreads, kSw>(dout, b, h, q0, kTile, P, st.dout);
  if (P.mult != nullptr) stage_mult_h<kThreads>(P, q0, k0, kTile, st.mu);
  const long long bh = (static_cast<long long>(b) * P.H + h) * P.T;
  stage_vector(row_max + bh, q0, P.T, st.m);
  stage_vector(rows.D + bh, q0, P.T, st.D);
  stage_vector(rows.rl + bh, q0, P.T, st.rl);
}

// dk and dv: a CTA owns 64 keys (a warp 16, k and v as A fragments) and
// sweeps the query tiles: Sᵀ = k · qᵀ and dPᵀ = v · doᵀ, w and ds as in the
// dq kernel from the staged row max, D and 1 / l, then dv += bf16(w ∘ μ)ᵀ · do
// and dk += bf16(ds)ᵀ · q (B through ldmatrix.trans): four products, on
// wgmma from swizzled tiles with kSw (hd 64). One owner per output, no
// atomics.
template <bool kVec, int kK, bool kSw>
__global__ void __launch_bounds__(kThreads, kSw ? kBwdMinBlocksWg : kBwdMinBlocksH)
attn_bwd_dkdv_bf16_kernel(ViewH q, ViewH k, ViewH v, ViewH dout, ViewH dk, ViewH dv,
                          const float* __restrict__ row_max, RowScratch rows, ProblemH P) {
  static_assert(!kSw || kK == 4, "wgmma tiles are 64 columns wide");
  constexpr int kChunkH = kSw ? kBwdChunkWg : kBwdChunkH;
  extern __shared__ __align__(16) unsigned char smem_h[];
  unsigned char* const smem = align_smem<kSw>(smem_h);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int ntiles = (P.T + kTile - 1) / kTile;
  const int key0 = k0 + 16 * warp;

  // k and v land in stage 1's q and do slots
  const QueryStageH st1 = query_stage_h(smem, 1, P);
  stage_rows_h<kVec, kThreads, kSw>(k, b, h, k0, kTile, P, st1.q);
  stage_rows_h<kVec, kThreads, kSw>(v, b, h, k0, kTile, P, st1.dout);
  load_query_tile_h<kVec, kSw>(q, dout, b, h, 0, k0, row_max, rows, P,
                               query_stage_h(smem, 0, P));
  cp_async_commit();
  float kb[2];  // the bias of keys g and g + 8 of the warp
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + g + 8 * r;
    kb[r] = key_bias(key, key < P.T ? P.kmask[static_cast<long long>(b) * P.T + key] : 0, P.T);
  }
  cp_async_wait_all();
  __syncthreads();
  FragH kf[kK], vf[kK];
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
    kf[kk] = lda_h<kSw>(st1.q, P.ld, 16 * warp, kk, lane);
    vf[kk] = lda_h<kSw>(st1.dout, P.ld, 16 * warp, kk, lane);
  }
  float dka[2 * kK][4], dva[2 * kK][4];
#pragma unroll
  for (int nd = 0; nd < 2 * kK; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nd][e] = dva[nd][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait_all();
    if (kSw) fence_proxy_async();
    __syncthreads();
    if (j + 1 < ntiles)
      load_query_tile_h<kVec, kSw>(q, dout, b, h, (j + 1) * kTile, k0, row_max, rows, P,
                                   query_stage_h(smem, (j + 1) & 1, P));
    cp_async_commit();
    const QueryStageH st = query_stage_h(smem, j & 1, P);
    const int q0 = j * kTile;
    // transposed scores and dP: rows are the warp's keys, columns the queries
#pragma unroll 1
    for (int c0 = 0; c0 < kRowSteps; c0 += kChunkH) {  // 8 · kChunkH queries at a time
      float s[kChunkH][4], dp[kChunkH][4];
      if constexpr (kSw) {
        wg_pair(s, dp, kf, vf, st.q + 8 * c0 * P.ld, st.dout + 8 * c0 * P.ld);
      } else {
        score_tile_h<kK, kChunkH>(s, kf, st.q + 8 * c0 * P.ld, P.ld, lane);
        score_tile_h<kK, kChunkH>(dp, vf, st.dout + 8 * c0 * P.ld, P.ld, lane);
      }
#pragma unroll
      for (int n2 = 0; n2 < kChunkH; n2 += 2) {
        uint32_t u[4] = {0x3f803f80u, 0x3f803f80u, 0x3f803f80u, 0x3f803f80u};  // bf16 (1, 1)
        if (P.mult != nullptr) ld_mu_cols(u, st.mu, 16 * warp, c0 + n2, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int n = n2 + i, cq = 8 * (c0 + n) + 2 * t;
          const float2 mu[2] = {unpack_bf16(u[2 * i]), unpack_bf16(u[2 * i + 1])};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // a query past T has a zero q row, m = 0 and 1 / l = 0 staged: w = 0
            const int c = cq + (e & 1), r = e >> 1;
            const float w = exp_shifted(fmaf(s[n][e], P.scale, kb[r]), st.m[c]) * st.rl[c];
            const float mue = (e & 1) ? mu[r].y : mu[r].x;
            s[n][e] = w * mue;                                      // w ∘ μ
            dp[n][e] = ds_of(w, mue, dp[n][e], st.D[c], P.scale);  // ds
          }
        }
      }
      if constexpr (kSw) {  // dv += bf16(w ∘ μ)ᵀ · do, dk += bf16(ds)ᵀ · q
        uint32_t aw[kChunkH / 2][4], ad[kChunkH / 2][4];
#pragma unroll
        for (int n2 = 0; n2 < kChunkH; n2 += 2) {
          pack_a(aw[n2 / 2], s[n2], s[n2 + 1]);
          pack_a(ad[n2 / 2], dp[n2], dp[n2 + 1]);
        }
        wg_fence(dva);
        wg_fence(dka);
        wg_fence(aw);
        wg_fence(ad);
        wg_arrive();
#pragma unroll
        for (int n2 = 0; n2 < kChunkH; n2 += 2) {
          Wgmma<2 * kK>::template run<1>(dva, aw[n2 / 2], wg_desc(st.dout + 8 * (c0 + n2) * 64));
          Wgmma<2 * kK>::template run<1>(dka, ad[n2 / 2], wg_desc(st.q + 8 * (c0 + n2) * 64));
        }
        wg_commit_wait();
        wg_fence(dva);
        wg_fence(dka);
        wg_fence(aw);
        wg_fence(ad);
      } else {
#pragma unroll
        for (int n2 = 0; n2 < kChunkH; n2 += 2) {
          const int ks = (c0 + n2) / 2;
          row_product_h<kK>(dva, s[n2], s[n2 + 1], st.dout, P.ld, ks, lane);  // dv += bf16(w ∘ μ)ᵀ · do
          row_product_h<kK>(dka, dp[n2], dp[n2 + 1], st.q, P.ld, ks, lane);   // dk += bf16(ds)ᵀ · q
        }
      }
    }
  }
  store_strip_h<kK>(dk, View{}, b, h, key0, P, g, t, dka, nullptr);
  store_strip_h<kK>(dv, View{}, b, h, key0, P, g, t, dva, nullptr);
}

// ------------------------------------------------------------------- launch

View view(const float* p, const long long* s) {
  return View{const_cast<float*>(p), s[0], s[1], s[2]};
}

bool aligned16(const View& v) {
  return (reinterpret_cast<uintptr_t>(v.p) & 15) == 0 && v.sb % 4 == 0 && v.sh % 4 == 0 &&
         v.st % 4 == 0;
}

Problem problem(const int* kmask, const float* mult, int H, int T, int hd, float scale) {
  Problem P;
  P.kmask = kmask;
  P.mult = mult;
  P.H = H;
  P.T = T;
  P.hd = hd;
  P.mu_floats = 0;
  P.mult_vec = mult != nullptr && T % 4 == 0 && (reinterpret_cast<uintptr_t>(mult) & 15) == 0;
  P.scale = scale;
  return P;
}

// hd ≤ 48 runs 6 k-steps (every config but the largest), 48 < hd ≤ 64 runs 8
template <int kSteps>
void pad_head_dim(Problem& P) {
  P.hdp = 8 * kSteps;
  P.ld = P.hdp + 4;
}

template <bool kVec, int kSteps>
cudaError_t launch_fwd(View q, View k, View v, View o, float* rmax, float* rsum, int B,
                       Problem P, cudaStream_t stream) {
  pad_head_dim<kSteps>(P);
  P.mu_floats = P.mult != nullptr ? kTile * kMuLdRow : 0;
  const size_t smem = 2 * sizeof(float) * (2 * kTile * P.ld + P.mu_floats + kTile);
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<kVec, kSteps>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((P.T + kTile - 1) / kTile, P.H, B);
  attn_fwd_kernel<kVec, kSteps><<<grid, kThreads, smem, stream>>>(q, k, v, o, rmax, rsum, P);
  return cudaGetLastError();
}

template <bool kVec, int kSteps>
cudaError_t launch_bwd(View q, View k, View v, View g, View dq, View dk, View dv,
                       const float* rmax, const float* rsum, float* delta, int B, Problem P,
                       cudaStream_t stream) {
  pad_head_dim<kSteps>(P);
  const dim3 grid((P.T + kTile - 1) / kTile, P.H, B);
  P.mu_floats = P.mult != nullptr ? kTile * kMuLdRow : 0;
  const size_t smem_dq = 2 * sizeof(float) * (2 * kTile * P.ld + P.mu_floats + kTile);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_kernel<kVec, kSteps>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_dq));
  if (err != cudaSuccess) return err;
  attn_bwd_dq_kernel<kVec, kSteps><<<grid, kThreads, smem_dq, stream>>>(q, k, v, g, dq, rmax, rsum, delta,
                                                                 P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  P.mu_floats = P.mult != nullptr ? kTile * kMuLdCol : 0;
  const size_t smem_kv = 2 * sizeof(float) * (2 * kTile * P.ld + P.mu_floats + 3 * kTile);
  err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<kVec, kSteps>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return err;
  attn_bwd_dkdv_kernel<kVec, kSteps><<<grid, kThreads, smem_kv, stream>>>(q, k, v, g, dk, dv, rmax, rsum,
                                                                   delta, P);
  return cudaGetLastError();
}

ViewH view_h(const void* p, const long long* s) {
  return ViewH{static_cast<bf16*>(const_cast<void*>(p)), s[0], s[1], s[2]};
}

bool aligned16_h(const ViewH& v) {
  return (reinterpret_cast<uintptr_t>(v.p) & 15) == 0 && v.sb % 8 == 0 && v.sh % 8 == 0 &&
         v.st % 8 == 0;
}

ProblemH problem_h(const int* kmask, const void* mult, int H, int T, int hd, float scale) {
  ProblemH P;
  P.kmask = kmask;
  P.mult = static_cast<const bf16*>(mult);
  P.H = H;
  P.T = T;
  P.hd = hd;
  P.hdp = hd <= 48 ? 48 : 64;
  P.ld = P.hdp + 8;
  P.mult_vec = mult != nullptr && T % 8 == 0 && (reinterpret_cast<uintptr_t>(mult) & 15) == 0;
  P.scale = scale;
  return P;
}

// kSw: the wgmma instances (hd 64), whose streamed tiles are swizzled rows
// of 64 elements
template <bool kSw>
ProblemH tiled(ProblemH P) {
  if (kSw) P.ld = 64;
  return P;
}

template <bool kVec, int kK, bool kSw>
cudaError_t launch_fwd_h(ViewH q, ViewH k, ViewH v, ViewH o, View o32, float* rmax, float* rsum,
                         int B, const ProblemH& P0, cudaStream_t stream) {
  constexpr int kThr = 32 * fwd_warps<kSw>(), kRows = 16 * fwd_warps<kSw>();
  const ProblemH P = tiled<kSw>(P0);
  const size_t smem = 2 * key_stage_bytes_h(P, kRows) + (kSw ? 1024 + 2 * 64 * kRows : 0);
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_bf16_kernel<kVec, kK, kSw>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((P.T + kRows - 1) / kRows, P.H, B);
  attn_fwd_bf16_kernel<kVec, kK, kSw><<<grid, kThr, smem, stream>>>(q, k, v, o, o32, rmax, rsum,
                                                                    P);
  return cudaGetLastError();
}

template <bool kVec, int kK, bool kSw>
cudaError_t launch_bwd_h(ViewH q, ViewH k, ViewH v, View o32, ViewH g, ViewH dq, ViewH dk,
                         ViewH dv, const float* rmax, const float* rsum, RowScratch rows, int B,
                         const ProblemH& P0, cudaStream_t stream) {
  const ProblemH P = tiled<kSw>(P0);
  const dim3 grid((P.T + kTile - 1) / kTile, P.H, B);
  const size_t smem_dq = 2 * key_stage_bytes_h(P, kTile) + (kSw ? 1024 : 0);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_bf16_kernel<kVec, kK, kSw>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_dq));
  if (err != cudaSuccess) return err;
  attn_bwd_dq_bf16_kernel<kVec, kK, kSw><<<grid, kThreads, smem_dq, stream>>>(q, k, v, o32, g, dq,
                                                                               rmax, rsum, rows, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem_kv = 2 * query_stage_bytes_h(P) + (kSw ? 1024 : 0);
  err = cudaFuncSetAttribute(attn_bwd_dkdv_bf16_kernel<kVec, kK, kSw>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return err;
  attn_bwd_dkdv_bf16_kernel<kVec, kK, kSw><<<grid, kThreads, smem_kv, stream>>>(q, k, v, g, dk, dv,
                                                                                 rmax, rows, P);
  return cudaGetLastError();
}

inline bool valid(int B, int H, int T, int hd) {
  return B >= 1 && B <= 65535 && H >= 1 && H <= 65535 && T >= 1 && hd >= 1 && hd <= kMaxHeadDim;
}

}  // namespace

extern "C" {

const char* ssd_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k, v, o: (B, H, T, hd) f32 views, unit stride along hd; strides holds
// the (b, h, t) element strides of q, k, v, o in that order (12 values).
// kmask (B, T) i32; mult (T, T) f32 or null; row_max, row_sum (B, H, T) f32.
// hd ≤ 64.
cudaError_t ssd_attn_fwd_launch(const float* q, const float* k, const float* v, const int* kmask,
                                const float* mult, float* o, float* row_max, float* row_sum,
                                const long long* strides, int B, int H, int T, int hd,
                                float scale, cudaStream_t stream) {
  if (!valid(B, H, T, hd)) return cudaErrorInvalidValue;
  const Problem P = problem(kmask, mult, H, T, hd, scale);
  const View vq = view(q, strides), vk = view(k, strides + 3), vv = view(v, strides + 6),
             vo = view(o, strides + 9);
  const bool vec = hd % 4 == 0 && aligned16(vq) && aligned16(vk) && aligned16(vv);
  if (hd <= 48)
    return vec ? launch_fwd<true, 6>(vq, vk, vv, vo, row_max, row_sum, B, P, stream)
               : launch_fwd<false, 6>(vq, vk, vv, vo, row_max, row_sum, B, P, stream);
  return vec ? launch_fwd<true, 8>(vq, vk, vv, vo, row_max, row_sum, B, P, stream)
             : launch_fwd<false, 8>(vq, vk, vv, vo, row_max, row_sum, B, P, stream);
}

// The two backward launches. q, k, v, o, dout, dq, dk, dv: (B, H, T, hd) f32
// views as above, strides in that order (24 values; o is checked by the
// wrapper but read by neither kernel, see D above); row_max, row_sum from
// the forward; delta (B, H, T) f32 scratch, written by the first launch and
// read by the second.
cudaError_t ssd_attn_bwd_launch(const float* q, const float* k, const float* v, const float* o,
                                const float* dout, const int* kmask, const float* mult,
                                const float* row_max, const float* row_sum, float* delta,
                                float* dq, float* dk, float* dv, const long long* strides, int B,
                                int H, int T, int hd, float scale, cudaStream_t stream) {
  if (!valid(B, H, T, hd)) return cudaErrorInvalidValue;
  const Problem P = problem(kmask, mult, H, T, hd, scale);
  const View vq = view(q, strides), vk = view(k, strides + 3), vv = view(v, strides + 6),
             vg = view(dout, strides + 12),
             vdq = view(dq, strides + 15), vdk = view(dk, strides + 18),
             vdv = view(dv, strides + 21);
  const bool vec = hd % 4 == 0 && aligned16(vq) && aligned16(vk) && aligned16(vv) && aligned16(vg);
  if (hd <= 48)
    return vec ? launch_bwd<true, 6>(vq, vk, vv, vg, vdq, vdk, vdv, row_max, row_sum, delta, B, P,
                                     stream)
               : launch_bwd<false, 6>(vq, vk, vv, vg, vdq, vdk, vdv, row_max, row_sum, delta, B, P,
                                      stream);
  return vec ? launch_bwd<true, 8>(vq, vk, vv, vg, vdq, vdk, vdv, row_max, row_sum, delta, B, P,
                                   stream)
             : launch_bwd<false, 8>(vq, vk, vv, vg, vdq, vdk, vdv, row_max, row_sum, delta, B, P,
                                    stream);
}

// The bf16 instances: q, k, v, o (and dout, dq, dk, dv) bf16 views, mult
// (T, T) bf16 or null; kmask, row_max, row_sum, strides and the launch
// geometry as above. The forward also writes o32, the output in fp32 before
// its bf16 rounding, as a (B, H, T, hd) view with o's strides slot taken by
// o32_strides (3 values), unless o32 is null (serving). The backward takes
// that fp32 output in o's place (its strides in o's slot) and a (2, B, H, T)
// fp32 scratch: D and 1 / the row sum, written by the first launch and read
// by the second.
cudaError_t ssd_attn_fwd_bf16_launch(const void* q, const void* k, const void* v,
                                     const int* kmask, const void* mult, void* o, float* o32,
                                     float* row_max, float* row_sum, const long long* strides,
                                     const long long* o32_strides, int B, int H, int T, int hd,
                                     float scale, cudaStream_t stream) {
  if (!valid(B, H, T, hd)) return cudaErrorInvalidValue;
  const ProblemH P = problem_h(kmask, mult, H, T, hd, scale);
  const ViewH vq = view_h(q, strides), vk = view_h(k, strides + 3), vv = view_h(v, strides + 6),
              vo = view_h(o, strides + 9);
  const View vo32 = o32 != nullptr ? view(o32, o32_strides) : View{};
  const bool vec = hd % 8 == 0 && aligned16_h(vq) && aligned16_h(vk) && aligned16_h(vv);
  if (hd <= 48)
    return vec ? launch_fwd_h<true, 3, false>(vq, vk, vv, vo, vo32, row_max, row_sum, B, P, stream)
               : launch_fwd_h<false, 3, false>(vq, vk, vv, vo, vo32, row_max, row_sum, B, P, stream);
  // hd 64: wgmma
  return vec ? launch_fwd_h<true, 4, true>(vq, vk, vv, vo, vo32, row_max, row_sum, B, P, stream)
             : launch_fwd_h<false, 4, true>(vq, vk, vv, vo, vo32, row_max, row_sum, B, P, stream);
}

cudaError_t ssd_attn_bwd_bf16_launch(const void* q, const void* k, const void* v, const float* o32,
                                     const void* dout, const int* kmask, const void* mult,
                                     const float* row_max, const float* row_sum, float* scratch,
                                     void* dq, void* dk, void* dv, const long long* strides,
                                     int B, int H, int T, int hd, float scale,
                                     cudaStream_t stream) {
  if (!valid(B, H, T, hd)) return cudaErrorInvalidValue;
  const ProblemH P = problem_h(kmask, mult, H, T, hd, scale);
  const ViewH vq = view_h(q, strides), vk = view_h(k, strides + 3), vv = view_h(v, strides + 6),
              vg = view_h(dout, strides + 12), vdq = view_h(dq, strides + 15),
              vdk = view_h(dk, strides + 18), vdv = view_h(dv, strides + 21);
  const View vo32 = view(o32, strides + 9);
  const long long n = static_cast<long long>(B) * H * T;
  const RowScratch rows{scratch, scratch + n};
  const bool vec =
      hd % 8 == 0 && aligned16_h(vq) && aligned16_h(vk) && aligned16_h(vv) && aligned16_h(vg);
  if (hd <= 48)
    return vec ? launch_bwd_h<true, 3, false>(vq, vk, vv, vo32, vg, vdq, vdk, vdv, row_max,
                                              row_sum, rows, B, P, stream)
               : launch_bwd_h<false, 3, false>(vq, vk, vv, vo32, vg, vdq, vdk, vdv, row_max,
                                               row_sum, rows, B, P, stream);
  // hd 64: wgmma
  return vec ? launch_bwd_h<true, 4, true>(vq, vk, vv, vo32, vg, vdq, vdk, vdv, row_max, row_sum,
                                           rows, B, P, stream)
             : launch_bwd_h<false, 4, true>(vq, vk, vv, vo32, vg, vdq, vdk, vdv, row_max, row_sum,
                                            rows, B, P, stream);
}

}  // extern "C"
