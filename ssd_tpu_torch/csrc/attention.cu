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
// and its VJP: dv_j = Σ_i w μ · do_i, ds = w ∘ (μ ∘ (do · vᵀ) − D) · scale
// with D_i = do_i · out_i (= Σ_j (μ ∘ do · vᵀ) ∘ w, exact with dropout too),
// dq_i = Σ_j ds · k_j, dk_j = Σ_i ds · q_i. The scale multiplies after the
// dot and masked keys sit at −1e30 — the Pallas kernel's numerics, not
// flax's. A fully masked row gets uniform weights, as on the TPU.
//
// What bounds it: 4·T²·hd flops per (b, h) forward (two T × T × hd
// products; the TPU cost estimate) against 16·T·hd bytes. At T = 640,
// hd = 48 that is 160 flops a byte, so on the card's 67 TFLOP/s fp32 SIMT
// pipe (TF32 stays off: the parity contract is fp32) the op is bound by
// operations: 2.36 GFLOP at B = 5, H = 6 is 35 µs. The backward's
// 10·T²·hd flops are bound the same way.
//
// What the design does about it. The TPU kernel holds one batch element's
// whole problem — every head's q, k, v and the (T, T) scores — in VMEM. A
// CTA's 227 KB holds no (T, T) tile at T = 640, so this is flash-style:
//   * forward: one CTA per (64 queries, h, b); K and V stream through shared
//     memory in 64-key tiles (12 KB each at hd = 48); the row max and sum
//     live in registers (online softmax); μ scales the unnormalised p that
//     is accumulated into out, not the running sum. The scores never reach
//     device memory, and neither does any (T, T) tensor. It writes out and
//     the row max m and sum l (B, H, T), from which the backward recomputes
//     w = exp(s − m) / l — right for fully masked rows too, where
//     m + log l would round back to −1e30.
//   * backward (FA2-style), two launches: (1) one CTA per (64 queries, h,
//     b) computes D for its rows, stores it, and loops over the key tiles
//     accumulating dq; (2) one CTA per (64 keys, h, b) loops over the query
//     tiles accumulating dk and dv. Every output element is owned by one
//     thread: no atomics, so the gradients are bit-reproducible.
//   * 256 threads in a 16 × 16 grid; a thread owns rows ty + 16a and
//     columns tx + 16b (a, b < 4) of each 64 × 64 product, so a row's 16
//     threads sit in one half-warp (shuffle reductions) and shared-memory
//     rows are padded to an odd stride (no bank conflicts).
//   * q, k, v, out and the gradients are strided (B, H, T, hd) views with a
//     unit hd stride — the (B, T, H, hd) projections are read in place.
//   * hd ≤ 64 (every config: 48 at tpu_fast_plus, 64 at tpu_scaled_large);
//     a thread's output columns tx + 16c, c < 4, cover it.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileRows = 64;  // queries or keys per tile
constexpr int kThreads = 256;  // 16 × 16
constexpr int kPadRow = kTileRows + 1;  // stride of a 64 × 64 tile in shared memory
constexpr float kMasked = -1.0e30f;
constexpr int kMaxHeadDim = 64;
constexpr int NC = kMaxHeadDim / 16;  // output columns tx + 16c of a thread

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
  int H, T, hd, ld;   // ld: odd shared-memory row stride ≥ hd
  float scale;
};

// Rows [t0, t0 + 64) of one (b, h) slice → dst (64 × ld); zeros past T.
__device__ __forceinline__ void load_tile(const View& v, int b, int h, int t0, const Problem& P,
                                          float* dst) {
  for (int i = threadIdx.x; i < kTileRows * P.hd; i += kThreads) {
    const int r = i / P.hd;
    const int d = i - r * P.hd;
    const int t = t0 + r;
    dst[r * P.ld + d] = t < P.T ? v.row(b, h, t)[d] : 0.f;
  }
}

// Key state of the tile at k0: 1 valid, 0 masked, −1 past T.
__device__ __forceinline__ void load_key_state(int b, int k0, const Problem& P, int* state) {
  if (threadIdx.x < kTileRows) {
    const int t = k0 + threadIdx.x;
    state[threadIdx.x] = t < P.T ? (P.kmask[static_cast<long long>(b) * P.T + t] != 0) : -1;
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// acc[a][b] += Σ_d A[ty + 16a][d] · Bm[tx + 16b][d] over two 64 × hd tiles.
__device__ __forceinline__ void tile_dot(const float* A, const float* Bm, int hd, int ld, int ty,
                                         int tx, float acc[4][4]) {
  for (int d = 0; d < hd; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) av[a] = A[(ty + 16 * a) * ld + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = Bm[(tx + 16 * c) * ld + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
  }
}

// acc[a][c] += Σ_j W[j][ty + 16a] (or W[ty + 16a][j] when !transposed) · M[j][tx + 16c]
template <bool kTransposed>
__device__ __forceinline__ void tile_mm(const float* W, const float* M, int hd, int ld, int ty,
                                        int tx, float acc[4][NC]) {
  for (int j = 0; j < kTileRows; ++j) {
    float mv[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) mv[c] = (tx + 16 * c < hd) ? M[j * ld + tx + 16 * c] : 0.f;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float wv = kTransposed ? W[j * kPadRow + ty + 16 * a] : W[(ty + 16 * a) * kPadRow + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[a][c] = fmaf(wv, mv[c], acc[a][c]);
    }
  }
}

__device__ __forceinline__ void store_rows(const View& out, int b, int h, int t0,
                                           const Problem& P, int ty, int tx,
                                           const float acc[4][NC], const float* row_scale) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int t = t0 + ty + 16 * a;
    if (t >= P.T) continue;
    float* dst = out.row(b, h, t);
    const float s = row_scale ? row_scale[a] : 1.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < P.hd) dst[d] = row_scale ? acc[a][c] / s : acc[a][c];
    }
  }
}

// ------------------------------------------------------------------ forward

__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(View q, View k, View v, View out, float* __restrict__ row_max,
                float* __restrict__ row_sum, Problem P) {
  extern __shared__ float smem[];
  float* qs = smem;                       // 64 × ld
  float* ks = qs + kTileRows * P.ld;      // 64 × ld
  float* vs = ks + kTileRows * P.ld;      // 64 × ld
  float* ps = vs + kTileRows * P.ld;      // 64 × 65: p ∘ μ of the tile
  int* kstate = reinterpret_cast<int*>(ps + kTileRows * kPadRow);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kTileRows, h = blockIdx.y, b = blockIdx.z;

  load_tile(q, b, h, q0, P, qs);
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = 0.f;
  }

  for (int k0 = 0; k0 < P.T; k0 += kTileRows) {
    __syncthreads();  // the previous tile's readers are done
    load_tile(k, b, h, k0, P, ks);
    load_tile(v, b, h, k0, P, vs);
    load_key_state(b, k0, P, kstate);
    __syncthreads();
    float s[4][4] = {};
    tile_dot(qs, ks, P.hd, P.ld, ty, tx, s);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qi = q0 + ty + 16 * a;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int st = kstate[tx + 16 * c];
        s[a][c] = st < 0 ? -INFINITY : (st == 0 ? kMasked : s[a][c] * P.scale);
        mx = fmaxf(mx, s[a][c]);
      }
      const float m_new = fmaxf(m[a], half_warp_max(mx));  // finite: the tile has a key < T
      const float corr = expf(m[a] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + tx + 16 * c;
        const float p = expf(s[a][c] - m_new);  // 0 past T
        rs += p;
        float pm = p;
        if (P.mult != nullptr && qi < P.T && kj < P.T)
          pm *= P.mult[static_cast<long long>(qi) * P.T + kj];
        ps[(ty + 16 * a) * kPadRow + tx + 16 * c] = pm;
      }
      l[a] = l[a] * corr + half_warp_sum(rs);
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[a][c] *= corr;
    }
    __syncthreads();
    tile_mm<false>(ps, vs, P.hd, P.ld, ty, tx, acc);
  }

  store_rows(out, b, h, q0, P, ty, tx, acc, l);
  if (tx == 0) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int t = q0 + ty + 16 * a;
      if (t < P.T) {
        const long long i = (static_cast<long long>(b) * P.H + h) * P.T + t;
        row_max[i] = m[a];
        row_sum[i] = l[a];
      }
    }
  }
}

// ----------------------------------------------------------------- backward

// The recomputed weight and the score gradient of one (query, key) pair.
struct PairGrad {
  float pm;  // w ∘ μ
  float ds;  // w ∘ (μ ∘ dP − D) · scale
};

__device__ __forceinline__ PairGrad pair_grad(float dot, float dp, int kst, int qi, int kj,
                                              float m, float l, float D, const Problem& P) {
  if (kst < 0 || qi >= P.T) return {0.f, 0.f};
  const float s = kst == 0 ? kMasked : dot * P.scale;
  const float w = expf(s - m) / l;
  const float mu = P.mult != nullptr ? P.mult[static_cast<long long>(qi) * P.T + kj] : 1.f;
  return {w * mu, w * (dp * mu - D) * P.scale};
}

// Row statistics of the query tile at q0 into shared memory: m, l, D.
__device__ __forceinline__ void load_row_stats(int b, int h, int q0, const Problem& P,
                                               const float* row_max, const float* row_sum,
                                               const float* delta, float* ms, float* ls,
                                               float* Ds) {
  if (threadIdx.x < kTileRows) {
    const int t = q0 + threadIdx.x;
    const long long i = (static_cast<long long>(b) * P.H + h) * P.T + t;
    ms[threadIdx.x] = t < P.T ? row_max[i] : 0.f;
    ls[threadIdx.x] = t < P.T ? row_sum[i] : 1.f;
    Ds[threadIdx.x] = t < P.T ? delta[i] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(View q, View k, View v, View out, View dout, View dq,
                   const float* __restrict__ row_max, const float* __restrict__ row_sum,
                   float* __restrict__ delta, Problem P) {
  extern __shared__ float smem[];
  float* qs = smem;                      // 64 × ld
  float* dos = qs + kTileRows * P.ld;    // 64 × ld
  float* ks = dos + kTileRows * P.ld;    // 64 × ld
  float* vs = ks + kTileRows * P.ld;     // 64 × ld
  float* dss = vs + kTileRows * P.ld;    // 64 × 65
  float* ms = dss + kTileRows * kPadRow;
  float* ls = ms + kTileRows;
  float* Ds = ls + kTileRows;
  int* kstate = reinterpret_cast<int*>(Ds + kTileRows);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kTileRows, h = blockIdx.y, b = blockIdx.z;

  load_tile(q, b, h, q0, P, qs);
  load_tile(dout, b, h, q0, P, dos);
  // D_i = do_i · out_i, one warp a row; stored for the dk/dv launch
  for (int r = warp; r < kTileRows; r += kThreads / 32) {
    const int t = q0 + r;
    float acc = 0.f;
    if (t < P.T) {
      const float* o = out.row(b, h, t);
      const float* g = dout.row(b, h, t);
      for (int d = lane; d < P.hd; d += 32) acc = fmaf(g[d], o[d], acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      const long long i = (static_cast<long long>(b) * P.H + h) * P.T + t;
      Ds[r] = acc;
      ms[r] = t < P.T ? row_max[i] : 0.f;
      ls[r] = t < P.T ? row_sum[i] : 1.f;
      if (t < P.T) delta[i] = acc;
    }
  }

  float acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = 0.f;

  for (int k0 = 0; k0 < P.T; k0 += kTileRows) {
    __syncthreads();
    load_tile(k, b, h, k0, P, ks);
    load_tile(v, b, h, k0, P, vs);
    load_key_state(b, k0, P, kstate);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    tile_dot(qs, ks, P.hd, P.ld, ty, tx, s);
    tile_dot(dos, vs, P.hd, P.ld, ty, tx, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kc = tx + 16 * c;
        const PairGrad pg =
            pair_grad(s[a][c], dp[a][c], kstate[kc], q0 + r, k0 + kc, ms[r], ls[r], Ds[r], P);
        dss[r * kPadRow + kc] = pg.ds;
      }
    }
    __syncthreads();
    tile_mm<false>(dss, ks, P.hd, P.ld, ty, tx, acc);
  }
  store_rows(dq, b, h, q0, P, ty, tx, acc, nullptr);
}

__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(View q, View k, View v, View dout, View dk, View dv,
                     const float* __restrict__ row_max, const float* __restrict__ row_sum,
                     const float* __restrict__ delta, Problem P) {
  extern __shared__ float smem[];
  float* ks = smem;                      // 64 × ld
  float* vs = ks + kTileRows * P.ld;     // 64 × ld
  float* qs = vs + kTileRows * P.ld;     // 64 × ld
  float* dos = qs + kTileRows * P.ld;    // 64 × ld
  float* pms = dos + kTileRows * P.ld;   // 64 × 65: w ∘ μ, (query, key)
  float* dss = pms + kTileRows * kPadRow;  // 64 × 65: ds, (query, key)
  float* ms = dss + kTileRows * kPadRow;
  float* ls = ms + kTileRows;
  float* Ds = ls + kTileRows;
  int* kstate = reinterpret_cast<int*>(Ds + kTileRows);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * kTileRows, h = blockIdx.y, b = blockIdx.z;

  load_tile(k, b, h, k0, P, ks);
  load_tile(v, b, h, k0, P, vs);
  load_key_state(b, k0, P, kstate);
  float dka[4][NC], dva[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) dka[a][c] = dva[a][c] = 0.f;

  for (int q0 = 0; q0 < P.T; q0 += kTileRows) {
    __syncthreads();
    load_tile(q, b, h, q0, P, qs);
    load_tile(dout, b, h, q0, P, dos);
    load_row_stats(b, h, q0, P, row_max, row_sum, delta, ms, ls, Ds);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    tile_dot(qs, ks, P.hd, P.ld, ty, tx, s);   // rows: queries, columns: keys
    tile_dot(dos, vs, P.hd, P.ld, ty, tx, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kc = tx + 16 * c;
        const PairGrad pg =
            pair_grad(s[a][c], dp[a][c], kstate[kc], q0 + r, k0 + kc, ms[r], ls[r], Ds[r], P);
        pms[r * kPadRow + kc] = pg.pm;
        dss[r * kPadRow + kc] = pg.ds;
      }
    }
    __syncthreads();
    // this thread's keys are rows ty + 16a of dk / dv: sum over the queries
    tile_mm<true>(pms, dos, P.hd, P.ld, ty, tx, dva);
    tile_mm<true>(dss, qs, P.hd, P.ld, ty, tx, dka);
  }
  store_rows(dk, b, h, k0, P, ty, tx, dka, nullptr);
  store_rows(dv, b, h, k0, P, ty, tx, dva, nullptr);
}

// ------------------------------------------------------------------- launch

View view(const float* p, const long long* s) {
  return View{const_cast<float*>(p), s[0], s[1], s[2]};
}

size_t tile_bytes(int ld) { return static_cast<size_t>(kTileRows) * ld * sizeof(float); }
size_t square_bytes() { return static_cast<size_t>(kTileRows) * kPadRow * sizeof(float); }
size_t stats_bytes(int n) { return static_cast<size_t>(n) * kTileRows * sizeof(float); }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

cudaError_t launch_fwd(View q, View k, View v, View o, float* rmax, float* rsum, int B,
                       const Problem& P, cudaStream_t stream) {
  const size_t smem = 3 * tile_bytes(P.ld) + square_bytes() + stats_bytes(1);
  cudaError_t err = allow_smem(attn_fwd_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((P.T + kTileRows - 1) / kTileRows, P.H, B);
  attn_fwd_kernel<<<grid, kThreads, smem, stream>>>(q, k, v, o, rmax, rsum, P);
  return cudaGetLastError();
}

cudaError_t launch_bwd(View q, View k, View v, View o, View g, View dq, View dk, View dv,
                       const float* rmax, const float* rsum, float* delta, int B,
                       const Problem& P, cudaStream_t stream) {
  const dim3 grid((P.T + kTileRows - 1) / kTileRows, P.H, B);
  const size_t smem_dq = 4 * tile_bytes(P.ld) + square_bytes() + stats_bytes(4);
  cudaError_t err = allow_smem(attn_bwd_dq_kernel, smem_dq);
  if (err != cudaSuccess) return err;
  attn_bwd_dq_kernel<<<grid, kThreads, smem_dq, stream>>>(q, k, v, o, g, dq, rmax, rsum, delta,
                                                          P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem_kv = 4 * tile_bytes(P.ld) + 2 * square_bytes() + stats_bytes(4);
  err = allow_smem(attn_bwd_dkdv_kernel, smem_kv);
  if (err != cudaSuccess) return err;
  attn_bwd_dkdv_kernel<<<grid, kThreads, smem_kv, stream>>>(q, k, v, g, dk, dv, rmax, rsum,
                                                            delta, P);
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
  const Problem P{kmask, mult, H, T, hd, hd | 1, scale};
  const View vq = view(q, strides), vk = view(k, strides + 3), vv = view(v, strides + 6),
             vo = view(o, strides + 9);
  return launch_fwd(vq, vk, vv, vo, row_max, row_sum, B, P, stream);
}

// The two backward launches. q, k, v, o, dout, dq, dk, dv: (B, H, T, hd) f32
// views as above, strides in that order (24 values); row_max, row_sum from
// the forward; delta (B, H, T) f32 scratch, written by the first launch and
// read by the second.
cudaError_t ssd_attn_bwd_launch(const float* q, const float* k, const float* v, const float* o,
                                const float* dout, const int* kmask, const float* mult,
                                const float* row_max, const float* row_sum, float* delta,
                                float* dq, float* dk, float* dv, const long long* strides, int B,
                                int H, int T, int hd, float scale, cudaStream_t stream) {
  if (!valid(B, H, T, hd)) return cudaErrorInvalidValue;
  const Problem P{kmask, mult, H, T, hd, hd | 1, scale};
  const View vq = view(q, strides), vk = view(k, strides + 3), vv = view(v, strides + 6),
             vo = view(o, strides + 9), vg = view(dout, strides + 12),
             vdq = view(dq, strides + 15), vdk = view(dk, strides + 18),
             vdv = view(dv, strides + 21);
  return launch_bwd(vq, vk, vv, vo, vg, vdq, vdk, vdv, row_max, row_sum, delta, B, P, stream);
}

}  // extern "C"
