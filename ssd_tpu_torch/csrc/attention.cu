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
// dk, dv are bf16. There is no 3×TF32 split — it exists only to keep fp32
// accuracy — so the products are plain mma.sync.m16n8k16 bf16 ones:
// 4·T²·hd flops forward over 989 TFLOP/s (dense bf16) bound them, against
// half the fp32 bytes. The design is the fp32 one with bf16 tiles:
//   * 4 warps a CTA, 64 queries (forward, dq) or keys (dk/dv), a warp's 16
//     rows held as bf16 A fragments (m16n8k16: rows g, g + 8; columns 2t,
//     2t + 1, 2t + 8, 2t + 9, packed two to a register) for the whole sweep.
//   * The accumulator of two adjacent 8-column steps is, column for column,
//     the A fragment of a 16-deep product, so p ∘ μ and ds go from
//     accumulators to A fragments in registers (rounded to bf16 as they are
//     packed), with no shuffle and no shared memory.
//   * Score products read k (or q, do) rows as B operands, two bf16 a
//     32-bit load at (row g, columns 2t, 2t + 1); products that sum over
//     rows read v (or k, q, do) as (rows 2t, 2t + 1, column g), two 16-bit
//     loads packed. Tiles are staged through the same two-stage cp.async
//     ring (16-byte copies where hd % 8 == 0 and the views allow, plain
//     loads otherwise), rows padded to hdp + 8 elements: both read patterns
//     are free of bank conflicts.
//   * The forward rounds exp(s − m_running) ∘ μ to bf16 and divides by the
//     row sum at the end, where the Pallas kernel rounds the normalised
//     weights: the two differ by bf16 rounding, so the kernel is held to its
//     plain version within a stated tolerance, not bit for bit.
//   * The backward forms ds as the Pallas kernel does, from fp32 w, dP and
//     D = Σ_j w μ dP (not from do · out, whose bf16 rounding D would carry),
//     and rounds it to bf16 before the products. The dq kernel cannot know D
//     before its sweep ends, so it sweeps the key tiles twice: once to sum D
//     (stored for the dk/dv launch), once to form ds and dq. The dk/dv kernel
//     recomputes its transposed scores with the roles of the operands
//     swapped; the tensor cores sum a 16-deep bf16 product in an order set
//     by k, not by which operand is A, so its w and dP are the dq kernel's.

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

constexpr int kMuLdH = kTile + 8;  // bf16 μ tile row stride (both read patterns)

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
  int ld;            // shared-memory row stride of a (64, hd) tile, in elements: hdp + 8
  bool mult_vec;     // μ rows can be copied 16 bytes at a time
  float scale;
};

__device__ __forceinline__ bf16 bf16_zero() { return __float2bfloat16_rn(0.f); }

// Rows [t0, t0 + 64) of one (b, h) slice → dst (64 × P.ld), zeros past T and
// in the columns [hd, hdp).
template <bool kVec>
__device__ __forceinline__ void stage_rows_h(const ViewH& v, int b, int h, int t0,
                                             const ProblemH& P, bf16* dst) {
  if (kVec) {  // hd % 8 == 0: a 16-byte chunk is all inside hd or all outside
    const int chunks = P.hdp / 8;
    for (int i = threadIdx.x; i < kTile * chunks; i += kThreads) {
      const int r = i / chunks, c = 8 * (i - r * chunks);
      const bool ok = t0 + r < P.T && c < P.hd;
      cp_async16(dst + r * P.ld + c, ok ? v.row(b, h, t0 + r) + c : v.p, ok);
    }
  } else {  // element by element, synchronous: visible after the tile's barrier
    for (int i = threadIdx.x; i < kTile * P.hdp; i += kThreads) {
      const int r = i / P.hdp, c = i - r * P.hdp;
      const bool ok = t0 + r < P.T && c < P.hd;
      dst[r * P.ld + c] = ok ? v.row(b, h, t0 + r)[c] : bf16_zero();
    }
  }
}

// μ[r0 + r][c0 + c], r, c < 64 → dst (64 × kMuLdH), zeros outside T × T.
__device__ __forceinline__ void stage_mult_h(const ProblemH& P, int r0, int c0, bf16* dst) {
  if (P.mult_vec) {  // T % 8 == 0 and c0 % 64 == 0: a chunk is all inside T or all outside
    for (int i = threadIdx.x; i < kTile * kTile / 8; i += kThreads) {
      const int r = i / (kTile / 8), c = 8 * (i % (kTile / 8));
      const bool ok = r0 + r < P.T && c0 + c < P.T;
      cp_async16(dst + r * kMuLdH + c,
                 ok ? P.mult + static_cast<long long>(r0 + r) * P.T + c0 + c : P.mult, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
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

// (lo, hi) rounded to bf16 and packed, lo in the low half (the lower k)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// p[0], p[1] (adjacent columns of a row): one 32-bit load
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// p[0], p[ld] (one column of two adjacent rows), packed
__device__ __forceinline__ uint32_t ld_col_pair(const bf16* p, int ld) {
  const uint32_t lo = *reinterpret_cast<const unsigned short*>(p);
  const uint32_t hi = *reinterpret_cast<const unsigned short*>(p + ld);
  return lo | (hi << 16);
}

struct FragH {  // an m16n8k16 bf16 A fragment
  uint32_t r[4];
};

// Rows [row0, row0 + 16), columns [16kk, 16kk + 16) of a shared-memory tile:
// (g, 2t..2t + 1), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..).
__device__ __forceinline__ FragH load_a_h(const bf16* tile, int ld, int row0, int kk, int g,
                                          int t) {
  const bf16* p = tile + (row0 + g) * ld + 16 * kk + 2 * t;
  return FragH{{ld_pair(p), ld_pair(p + 8 * ld), ld_pair(p + 8), ld_pair(p + 8 * ld + 8)}};
}

// s[n] (rows g, g + 8 of the warp; columns 8n + 2t, 2t + 1), n < kN, = the
// warp's 16 rows of A times rows [0, 8kN) of a tile, summed over hd.
template <int kK, int kN>
__device__ __forceinline__ void score_tile_h(float s[kN][4], const FragH a[kK], const bf16* tile,
                                             int ld, int g, int t) {
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kK; ++kk)
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const bf16* p = tile + (8 * n + g) * ld + 16 * kk + 2 * t;
      mma_bf16(s[n], a[kk].r, ld_pair(p), ld_pair(p + 8));
    }
}

// acc (the warp's 16 rows × hdp, 2kK 8-column steps) += w · tile, summed over
// rows [0, 16kS) of the tile: w (16 × 16kS, accumulator layout) goes in as A
// fragments, rounded to bf16, 16 rows of the tile at a time.
template <int kK, int kS>
__device__ __forceinline__ void row_product_h(float acc[2 * kK][4], const float w[2 * kS][4],
                                              const bf16* tile, int ld, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < kS; ++ks) {
    const uint32_t a[4] = {pack_bf16(w[2 * ks][0], w[2 * ks][1]),
                           pack_bf16(w[2 * ks][2], w[2 * ks][3]),
                           pack_bf16(w[2 * ks + 1][0], w[2 * ks + 1][1]),
                           pack_bf16(w[2 * ks + 1][2], w[2 * ks + 1][3])};
    const bf16* p = tile + (16 * ks + 2 * t) * ld + g;
#pragma unroll
    for (int nd = 0; nd < 2 * kK; ++nd)
      mma_bf16(acc[nd], a, ld_col_pair(p + 8 * nd, ld), ld_col_pair(p + 8 * ld + 8 * nd, ld));
  }
}

// Rows row0 + g + 8r, columns 8nd + 2t + e of an accumulator strip → dst rows
// in bf16, divided by div[r] first when given.
template <int kK>
__device__ __forceinline__ void store_strip_h(const ViewH& dst, int b, int h, int row0,
                                              const ProblemH& P, int g, int t,
                                              const float acc[2 * kK][4], const float* div) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= P.T) continue;
    bf16* out = dst.row(b, h, row);
#pragma unroll
    for (int nd = 0; nd < 2 * kK; ++nd)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * nd + 2 * t + e;
        if (d < P.hd)
          out[d] = __float2bfloat16_rn(div ? acc[nd][2 * r + e] / div[r] : acc[nd][2 * r + e]);
      }
  }
}

// A stage of the forward / dq ring: k and v (64 × ld each), μ, key mask.
struct KeyStageH {
  bf16* k;
  bf16* v;
  bf16* mu;  // 64 × kMuLdH, when P.mult
  int* km;
};

__device__ __forceinline__ int mu_elems_h(const ProblemH& P) {
  return P.mult != nullptr ? kTile * kMuLdH : 0;
}

__device__ __forceinline__ KeyStageH key_stage_h(unsigned char* smem, int s, const ProblemH& P) {
  const int bytes = 2 * (2 * kTile * P.ld + mu_elems_h(P)) + 4 * kTile;
  KeyStageH st;
  st.k = reinterpret_cast<bf16*>(smem + s * bytes);
  st.v = st.k + kTile * P.ld;
  st.mu = st.v + kTile * P.ld;
  st.km = reinterpret_cast<int*>(st.mu + mu_elems_h(P));
  return st;
}

template <bool kVec>
__device__ __forceinline__ void load_key_tile_h(const ViewH& k, const ViewH& v, int b, int h,
                                                int q0, int k0, const ProblemH& P,
                                                const KeyStageH& st) {
  stage_rows_h<kVec>(k, b, h, k0, P, st.k);
  stage_rows_h<kVec>(v, b, h, k0, P, st.v);
  if (P.mult != nullptr) stage_mult_h(P, q0, k0, st.mu);
  stage_vector(P.kmask + static_cast<long long>(b) * P.T, k0, P.T, st.km);
}

// μ at (row, columns c, c + 1) of a stage's tile, as floats
__device__ __forceinline__ float2 mu_pair(const bf16* mu, int row, int c) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(mu + row * kMuLdH + c));
}

template <bool kVec, int kK>
__global__ void __launch_bounds__(kThreads)
attn_fwd_bf16_kernel(ViewH q, ViewH k, ViewH v, ViewH out, float* __restrict__ row_max,
                     float* __restrict__ row_sum, ProblemH P) {
  extern __shared__ __align__(16) unsigned char smem_h[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int ntiles = (P.T + kTile - 1) / kTile;

  // the query tile lands in stage 1's k slot and is read into registers
  // before key tile 1 is queued there
  stage_rows_h<kVec>(q, b, h, q0, P, key_stage_h(smem_h, 1, P).k);
  load_key_tile_h<kVec>(k, v, b, h, q0, 0, P, key_stage_h(smem_h, 0, P));
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  FragH qf[kK];
#pragma unroll
  for (int kk = 0; kk < kK; ++kk)
    qf[kk] = load_a_h(key_stage_h(smem_h, 1, P).k, P.ld, 16 * warp, kk, g, t);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g, g + 8
  float o[2 * kK][4];
#pragma unroll
  for (int nd = 0; nd < 2 * kK; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait_all();
    __syncthreads();  // tile j is in for every thread; every warp is done with tile j − 1
    if (j + 1 < ntiles)
      load_key_tile_h<kVec>(k, v, b, h, q0, (j + 1) * kTile, P,
                            key_stage_h(smem_h, (j + 1) & 1, P));
    cp_async_commit();
    const KeyStageH st = key_stage_h(smem_h, j & 1, P);
    const int k0 = j * kTile;

    float s[kRowSteps][4];
    score_tile_h<kK, kRowSteps>(s, qf, st.k, P.ld, g, t);
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
#pragma unroll
    for (int nt = 0; nt < kRowSteps; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m[e >> 1]);  // 0 past T
        rs[e >> 1] += s[nt][e];
      }
      if (P.mult != nullptr) {  // μ scales p in the output sum only
        const float2 u0 = mu_pair(st.mu, 16 * warp + g, 8 * nt + 2 * t);
        const float2 u1 = mu_pair(st.mu, 16 * warp + g + 8, 8 * nt + 2 * t);
        s[nt][0] *= u0.x;
        s[nt][1] *= u0.y;
        s[nt][2] *= u1.x;
        s[nt][3] *= u1.y;
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
    row_product_h<kK, kRowSteps / 2>(o, s, st.v, P.ld, g, t);  // out += bf16(p ∘ μ) · v
  }

  store_strip_h<kK>(out, b, h, q0 + 16 * warp, P, g, t, o, l);
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

template <bool kVec, int kK>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_bf16_kernel(ViewH q, ViewH k, ViewH v, ViewH dout, ViewH dq,
                        const float* __restrict__ row_max, const float* __restrict__ row_sum,
                        float* __restrict__ delta, ProblemH P) {
  extern __shared__ __align__(16) unsigned char smem_h[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int ntiles = (P.T + kTile - 1) / kTile;
  const int row0 = q0 + 16 * warp;

  // q and do land in stage 1's k and v slots
  stage_rows_h<kVec>(q, b, h, q0, P, key_stage_h(smem_h, 1, P).k);
  stage_rows_h<kVec>(dout, b, h, q0, P, key_stage_h(smem_h, 1, P).v);
  load_key_tile_h<kVec>(k, v, b, h, q0, 0, P, key_stage_h(smem_h, 0, P));
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
  FragH qf[kK], df[kK];
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
    qf[kk] = load_a_h(key_stage_h(smem_h, 1, P).k, P.ld, 16 * warp, kk, g, t);
    df[kk] = load_a_h(key_stage_h(smem_h, 1, P).v, P.ld, 16 * warp, kk, g, t);
  }
  // sweep 1 (j < ntiles) sums D_i = Σ_j w μ dP; sweep 2 forms
  // ds = w ∘ (μ dP − D) · scale, rounds it to bf16 and sums dq = ds · k
  float D[2] = {0.f, 0.f};
  float acc[2 * kK][4];
#pragma unroll
  for (int nd = 0; nd < 2 * kK; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  const int steps = 2 * ntiles;
  for (int j = 0; j < steps; ++j) {
    cp_async_wait_all();
    __syncthreads();
    if (j + 1 < steps)
      load_key_tile_h<kVec>(k, v, b, h, q0, ((j + 1) % ntiles) * kTile, P,
                            key_stage_h(smem_h, (j + 1) & 1, P));
    cp_async_commit();
    const KeyStageH st = key_stage_h(smem_h, j & 1, P);
    const int k0 = (j % ntiles) * kTile;
    const bool second = j >= ntiles;
    if (j == ntiles) {  // D is complete: stored for the dk/dv launch
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        D[r] = quad_sum(D[r]);
        const int row = row0 + g + 8 * r;
        if (t == 0 && row < P.T) delta[(static_cast<long long>(b) * P.H + h) * P.T + row] = D[r];
      }
    }
#pragma unroll 1
    for (int c0 = 0; c0 < kRowSteps; c0 += 2) {  // 16 keys at a time
      float s[2][4], dp[2][4];
      score_tile_h<kK, 2>(s, qf, st.k + 8 * c0 * P.ld, P.ld, g, t);
      score_tile_h<kK, 2>(dp, df, st.v + 8 * c0 * P.ld, P.ld, g, t);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int c = 8 * (c0 + n) + 2 * t;
        float mu[4] = {1.f, 1.f, 1.f, 1.f};
        if (P.mult != nullptr) {
          const float2 u0 = mu_pair(st.mu, 16 * warp + g, c);
          const float2 u1 = mu_pair(st.mu, 16 * warp + g + 8, c);
          mu[0] = u0.x;
          mu[1] = u0.y;
          mu[2] = u1.x;
          mu[3] = u1.y;
        }
        const int2 km = *reinterpret_cast<const int2*>(st.km + c);
        const float kb[2] = {key_bias(k0 + c, km.x, P.T), key_bias(k0 + c + 1, km.y, P.T)};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float w = expf(fmaf(s[n][e], P.scale, kb[e & 1]) - m[r]) * rl[r];  // 0 past T
          if (second)
            s[n][e] = w * (mu[e] * dp[n][e] - D[r]) * P.scale;  // ds
          else
            D[r] += w * (mu[e] * dp[n][e]);
        }
      }
      if (second) row_product_h<kK, 1>(acc, s, st.k + 8 * c0 * P.ld, P.ld, g, t);  // dq += ds · k
    }
  }
  store_strip_h<kK>(dq, b, h, row0, P, g, t, acc, nullptr);
}

// A stage of the dk/dv ring: q and do (64 × ld each), μ (queries × keys),
// and the queries' m, l and D.
struct QueryStageH {
  bf16* q;
  bf16* dout;
  bf16* mu;  // 64 × kMuLdH, when P.mult
  float* m;
  float* l;
  float* D;
};

__device__ __forceinline__ QueryStageH query_stage_h(unsigned char* smem, int s,
                                                     const ProblemH& P) {
  const int bytes = 2 * (2 * kTile * P.ld + mu_elems_h(P)) + 3 * 4 * kTile;
  QueryStageH st;
  st.q = reinterpret_cast<bf16*>(smem + s * bytes);
  st.dout = st.q + kTile * P.ld;
  st.mu = st.dout + kTile * P.ld;
  st.m = reinterpret_cast<float*>(st.mu + mu_elems_h(P));
  st.l = st.m + kTile;
  st.D = st.l + kTile;
  return st;
}

template <bool kVec>
__device__ __forceinline__ void load_query_tile_h(const ViewH& q, const ViewH& dout, int b,
                                                  int h, int q0, int k0, const float* row_max,
                                                  const float* row_sum, const float* delta,
                                                  const ProblemH& P, const QueryStageH& st) {
  stage_rows_h<kVec>(q, b, h, q0, P, st.q);
  stage_rows_h<kVec>(dout, b, h, q0, P, st.dout);
  if (P.mult != nullptr) stage_mult_h(P, q0, k0, st.mu);
  const long long bh = (static_cast<long long>(b) * P.H + h) * P.T;
  stage_vector(row_max + bh, q0, P.T, st.m);
  stage_vector(row_sum + bh, q0, P.T, st.l);
  stage_vector(delta + bh, q0, P.T, st.D);
}

template <bool kVec, int kK>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_bf16_kernel(ViewH q, ViewH k, ViewH v, ViewH dout, ViewH dk, ViewH dv,
                          const float* __restrict__ row_max, const float* __restrict__ row_sum,
                          const float* __restrict__ delta, ProblemH P) {
  extern __shared__ __align__(16) unsigned char smem_h[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int ntiles = (P.T + kTile - 1) / kTile;
  const int key0 = k0 + 16 * warp;

  // k and v land in stage 1's q and do slots
  stage_rows_h<kVec>(k, b, h, k0, P, query_stage_h(smem_h, 1, P).q);
  stage_rows_h<kVec>(v, b, h, k0, P, query_stage_h(smem_h, 1, P).dout);
  load_query_tile_h<kVec>(q, dout, b, h, 0, k0, row_max, row_sum, delta, P,
                          query_stage_h(smem_h, 0, P));
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
    kf[kk] = load_a_h(query_stage_h(smem_h, 1, P).q, P.ld, 16 * warp, kk, g, t);
    vf[kk] = load_a_h(query_stage_h(smem_h, 1, P).dout, P.ld, 16 * warp, kk, g, t);
  }
  float dka[2 * kK][4], dva[2 * kK][4];
#pragma unroll
  for (int nd = 0; nd < 2 * kK; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nd][e] = dva[nd][e] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait_all();
    __syncthreads();
    if (j + 1 < ntiles)
      load_query_tile_h<kVec>(q, dout, b, h, (j + 1) * kTile, k0, row_max, row_sum, delta, P,
                              query_stage_h(smem_h, (j + 1) & 1, P));
    cp_async_commit();
    const QueryStageH st = query_stage_h(smem_h, j & 1, P);
    const int q0 = j * kTile;
    // transposed scores and dP: rows are the warp's keys, columns the queries
#pragma unroll 1
    for (int c0 = 0; c0 < kRowSteps; c0 += 2) {  // 16 queries at a time
      float s[2][4], dp[2][4];
      score_tile_h<kK, 2>(s, kf, st.q + 8 * c0 * P.ld, P.ld, g, t);
      score_tile_h<kK, 2>(dp, vf, st.dout + 8 * c0 * P.ld, P.ld, g, t);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int cq = 8 * (c0 + n) + 2 * t;
        const float rl[2] = {1.f / st.l[cq], 1.f / st.l[cq + 1]};  // inf past T: not used
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = cq + (e & 1), r = e >> 1;
          const float w =
              q0 + c < P.T ? expf(fmaf(s[n][e], P.scale, kb[r]) - st.m[c]) * rl[e & 1] : 0.f;
          const float mu = P.mult != nullptr
                               ? __bfloat162float(st.mu[c * kMuLdH + 16 * warp + g + 8 * r])
                               : 1.f;
          s[n][e] = w * mu;                                     // w ∘ μ
          dp[n][e] = w * (mu * dp[n][e] - st.D[c]) * P.scale;  // ds
        }
      }
      row_product_h<kK, 1>(dva, s, st.dout + 8 * c0 * P.ld, P.ld, g, t);  // dv += bf16(w ∘ μ)ᵀ · do
      row_product_h<kK, 1>(dka, dp, st.q + 8 * c0 * P.ld, P.ld, g, t);    // dk += bf16(ds)ᵀ · q
    }
  }
  store_strip_h<kK>(dk, b, h, key0, P, g, t, dka, nullptr);
  store_strip_h<kK>(dv, b, h, key0, P, g, t, dva, nullptr);
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

size_t key_stage_bytes_h(const ProblemH& P) {
  return 2 * (2 * kTile * P.ld + (P.mult != nullptr ? kTile * kMuLdH : 0)) + 4 * kTile;
}

template <bool kVec, int kK>
cudaError_t launch_fwd_h(ViewH q, ViewH k, ViewH v, ViewH o, float* rmax, float* rsum, int B,
                         const ProblemH& P, cudaStream_t stream) {
  const size_t smem = 2 * key_stage_bytes_h(P);
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_bf16_kernel<kVec, kK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((P.T + kTile - 1) / kTile, P.H, B);
  attn_fwd_bf16_kernel<kVec, kK><<<grid, kThreads, smem, stream>>>(q, k, v, o, rmax, rsum, P);
  return cudaGetLastError();
}

template <bool kVec, int kK>
cudaError_t launch_bwd_h(ViewH q, ViewH k, ViewH v, ViewH g, ViewH dq, ViewH dk, ViewH dv,
                         const float* rmax, const float* rsum, float* delta, int B,
                         const ProblemH& P, cudaStream_t stream) {
  const dim3 grid((P.T + kTile - 1) / kTile, P.H, B);
  const size_t smem_dq = 2 * key_stage_bytes_h(P);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_bf16_kernel<kVec, kK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_dq));
  if (err != cudaSuccess) return err;
  attn_bwd_dq_bf16_kernel<kVec, kK><<<grid, kThreads, smem_dq, stream>>>(q, k, v, g, dq, rmax,
                                                                          rsum, delta, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem_kv =
      2 * (2 * (2 * kTile * P.ld + (P.mult != nullptr ? kTile * kMuLdH : 0)) + 3 * 4 * kTile);
  err = cudaFuncSetAttribute(attn_bwd_dkdv_bf16_kernel<kVec, kK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return err;
  attn_bwd_dkdv_bf16_kernel<kVec, kK><<<grid, kThreads, smem_kv, stream>>>(q, k, v, g, dk, dv,
                                                                            rmax, rsum, delta, P);
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
// (T, T) bf16 or null; kmask, row_max, row_sum, delta, strides and the
// launch geometry as above.
cudaError_t ssd_attn_fwd_bf16_launch(const void* q, const void* k, const void* v,
                                     const int* kmask, const void* mult, void* o,
                                     float* row_max, float* row_sum, const long long* strides,
                                     int B, int H, int T, int hd, float scale,
                                     cudaStream_t stream) {
  if (!valid(B, H, T, hd)) return cudaErrorInvalidValue;
  const ProblemH P = problem_h(kmask, mult, H, T, hd, scale);
  const ViewH vq = view_h(q, strides), vk = view_h(k, strides + 3), vv = view_h(v, strides + 6),
              vo = view_h(o, strides + 9);
  const bool vec = hd % 8 == 0 && aligned16_h(vq) && aligned16_h(vk) && aligned16_h(vv);
  if (hd <= 48)
    return vec ? launch_fwd_h<true, 3>(vq, vk, vv, vo, row_max, row_sum, B, P, stream)
               : launch_fwd_h<false, 3>(vq, vk, vv, vo, row_max, row_sum, B, P, stream);
  return vec ? launch_fwd_h<true, 4>(vq, vk, vv, vo, row_max, row_sum, B, P, stream)
             : launch_fwd_h<false, 4>(vq, vk, vv, vo, row_max, row_sum, B, P, stream);
}

cudaError_t ssd_attn_bwd_bf16_launch(const void* q, const void* k, const void* v, const void* o,
                                     const void* dout, const int* kmask, const void* mult,
                                     const float* row_max, const float* row_sum, float* delta,
                                     void* dq, void* dk, void* dv, const long long* strides,
                                     int B, int H, int T, int hd, float scale,
                                     cudaStream_t stream) {
  if (!valid(B, H, T, hd)) return cudaErrorInvalidValue;
  const ProblemH P = problem_h(kmask, mult, H, T, hd, scale);
  const ViewH vq = view_h(q, strides), vk = view_h(k, strides + 3), vv = view_h(v, strides + 6),
              vg = view_h(dout, strides + 12), vdq = view_h(dq, strides + 15),
              vdk = view_h(dk, strides + 18), vdv = view_h(dv, strides + 21);
  const bool vec =
      hd % 8 == 0 && aligned16_h(vq) && aligned16_h(vk) && aligned16_h(vv) && aligned16_h(vg);
  if (hd <= 48)
    return vec ? launch_bwd_h<true, 3>(vq, vk, vv, vg, vdq, vdk, vdv, row_max, row_sum, delta,
                                       B, P, stream)
               : launch_bwd_h<false, 3>(vq, vk, vv, vg, vdq, vdk, vdv, row_max, row_sum, delta,
                                        B, P, stream);
  return vec ? launch_bwd_h<true, 4>(vq, vk, vv, vg, vdq, vdk, vdv, row_max, row_sum, delta, B,
                                     P, stream)
             : launch_bwd_h<false, 4>(vq, vk, vv, vg, vdq, vdk, vdv, row_max, row_sum, delta, B,
                                      P, stream);
}

}  // extern "C"
