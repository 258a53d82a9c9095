// CTC forward (α) and backward (β) recursions for Hopper (sm_90a).
//
// Replace the Pallas kernels ssd_tpu/ops/ctc_loss.py:_alpha_kernel (called
// through _forward_alphas_pallas) and ssd_tpu/ops/ctc_loss.py:_beta_kernel
// (called through _betas_pallas). Over the 2S+1 blank-interleaved states of
// each batch row, in the log semiring, clamped at NEG_INF = -1e30:
//
//   α_0(s)  = lp_0(s) for s ≤ 1, NEG_INF elsewhere
//   α_t(s)  = max(lp_t(s) + lae(lae(α(s), α(s−1)), skip(s) ? α(s−2) : NEG), NEG)
//   β_{T−1} = (len−1 == T−1) ? β_final : NEG
//   u       = β_{t+1} + lp_{t+1}
//   β_t(s)  = (t == len−1) ? β_final(s)
//           : max(lae(lae(u(s), u(s+1)), skip_from(s) ? u(s+2) : NEG), NEG)
//
// with lae(a, b) = max(a, b) + log1pf(expf(min(a, b) − max(a, b))), the
// order of operations of jnp.logaddexp. Every t < T is computed, as on the
// TPU; all of α and all of β, (T, B, S2) fp32, are written. The arithmetic
// is bit-equal to the plain recursions of ops/ctc_loss.py on the card: this
// file is built without fast-math, so expf / log1pf stay the full-accuracy
// library functions.
//
// What bounds it: the bytes are 8·T·B·S2 (lp_ext read, α or β written) plus
// the small (B, S2) inputs — at B = 5, T = 640, S2 = 321 that is 8.2 MB, about
// 2.5 µs at 3.35 TB/s, a bound no sequential recursion reaches. In practice
// the bound is the recursion: T dependent steps, each the chain of two
// nested logaddexps (an expf and a log1pf each) plus whatever the step
// spends exchanging neighbours, which no parallelism over rows can shorten.
//
// What the α design does about it: one CTA of 1–16 warps takes one batch
// row, and the time loop runs inside it. Each thread keeps J states in
// registers, interleaved (s = j·threads + tid), so each step's output row is
// stored coalesced straight from registers. A row gets ⌈S2/32⌉ warps and a
// thread one state (J > 1 only past 512 states): the chains of
// the SM's warps overlap better than several chains in one thread, because
// the step's latency, not its instruction count, sets the pace
// (scripts/bench_ctc_variants.py times other widths). α(s−1) and α(s−2) come
// from the lane below by __shfl_sync; at a warp boundary from a two-slot
// (step-parity) shared-memory handoff of lanes 30 and 31, read by every
// lane of the warp above (a broadcast, so no warp diverges), under one
// barrier a step; with one warp there is no barrier at all. The
// emissions come through a cp.async ring a chunk of time steps ahead: each
// thread copies exactly the elements it will read, so the ring needs no
// barrier either, only the thread's own cp.async.wait_group. It takes the
// S2 that β takes (S2 ≤ 14 528, β's shared memory): past 8 192 states a
// thread holds 24 or 32, and spills.
//
// The β kernel: one CTA a row of ⌈S2/32⌉ warps, the previous row in shared
// memory ping-ponged under one __syncthreads() a step, the emissions staged
// into shared memory a chunk of time steps at a time.

#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1.0e30f;
constexpr int kMaxThreads = 1024;
constexpr int kMaxTimeChunk = 32;             // time steps of lp_ext staged at once
constexpr int kSmemBudget = 96 * 1024;        // what the chunk is sized against
constexpr int kSmemMax = 227 * 1024;          // Hopper's per-block limit

// out[j] = lae(a[j], b[j]) for J pairs: max + log1pf(expf(−|a − b|)), and
// a + b for a NaN delta (jnp.logaddexp's branch). out may alias a or b.
template <int J>
__device__ __forceinline__ void lae(const float* a, const float* b, float* out) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const float d = a[j] - b[j];
    out[j] = d != d ? a[j] + b[j] : fmaxf(a[j], b[j]) + log1pf(expf(-fabsf(d)));
  }
}

__device__ __forceinline__ float lae1(float a, float b) {
  float out;
  lae<1>(&a, &b, &out);
  return out;
}

inline int threads_for(int S2) {
  int t = (S2 + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

// Time steps staged per chunk: as many as fit the budget beside the two
// state rows and the skip row, at least one.
inline int time_chunk(int S2) {
  int fit = kSmemBudget / (4 * S2) - 3;
  if (fit > kMaxTimeChunk) fit = kMaxTimeChunk;
  return fit < 1 ? 1 : fit;
}

inline size_t smem_bytes(int S2, int tchunk) {
  return static_cast<size_t>(3 + tchunk) * S2 * sizeof(float);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int kRing = 3;                // emission ring stages: two chunks in flight
constexpr int kMaxRingChunk = 16;       // time steps a ring stage
constexpr int kRingBudget = 96 * 1024;  // what the chunk is sized against
constexpr int kMaxAlphaWarps = 16;      // the α kernels' launch bounds: 512 threads
constexpr int kMaxStates = 32;          // states a thread (the largest J instance)

// α with J states a thread. blockDim.x = 32·W threads; chunk time steps a
// ring stage; shared memory: the ring (kRing · chunk · J · threads floats)
// and the handoff slots (2 parities × W warps × J × lanes 30, 31).
template <int J>
__global__ void __launch_bounds__(32 * kMaxAlphaWarps, 1)
ctc_alpha_kernel(const float* __restrict__ lp,    // (T, B, S2)
                 const float* __restrict__ skip,  // (B, S2), > 0 allows the skip into s
                 float* __restrict__ alpha,       // (T, B, S2)
                 int T, int B, int S2, int chunk) {
  extern __shared__ float smem[];
  const int threads = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = threads >> 5;
  const int stage = J * threads;  // floats of one time step in the ring
  float* ring = smem;
  float* slots = smem + kRing * chunk * stage;

  const int b = blockIdx.x;
  const long long tstride = static_cast<long long>(B) * S2;
  const float* lpb = lp + static_cast<long long>(b) * S2;
  float* outb = alpha + static_cast<long long>(b) * S2;

  bool can_skip[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int s = j * threads + tid;
    can_skip[j] = s >= 2 && s < S2 && skip[static_cast<long long>(b) * S2 + s] > 0.f;
  }

  // chunk c of the emissions into ring stage c mod kRing; each thread copies
  // the elements it reads itself. Always one commit group a chunk (empty
  // past T), so wait_group<kRing − 1> means "chunk c has landed".
  const int n_chunks = (T + chunk - 1) / chunk;
  auto issue = [&](int c) {
    if (c < n_chunks) {
      float* dst = ring + (c % kRing) * chunk * stage + tid;
      const int t0 = c * chunk;
      const int n = min(chunk, T - t0);
      for (int k = 0; k < n; ++k) {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int s = j * threads + tid;
          if (s < S2) cp_async4(dst + k * stage + j * threads, lpb + (t0 + k) * tstride + s);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < kRing - 1; ++c) issue(c);

  float a[J];
  float* dst = outb;  // row t of α, advanced by tstride each step
  for (int c = 0; c < n_chunks; ++c) {
    issue(c + kRing - 1);  // its stage was read, by this thread only, in chunk c − 1
    cp_async_wait<kRing - 1>();
    const float* ec = ring + (c % kRing) * chunk * stage + tid;
    const int n = min(chunk, T - c * chunk);
    for (int k = 0; k < n; ++k, dst += tstride) {
      const int t = c * chunk + k;
      float e[J];
#pragma unroll
      for (int j = 0; j < J; ++j) e[j] = j * threads + tid < S2 ? ec[k * stage + j * threads] : kNegInf;
      if (t == 0) {
#pragma unroll
        for (int j = 0; j < J; ++j) a[j] = j * threads + tid <= 1 ? e[j] : kNegInf;
      } else {
        float up1[J], up2[J];  // α_{t−1}(s − 1), α_{t−1}(s − 2)
        if (nwarps == 1) {
          // lane 0 (1) takes state s − 1 (s − 2) from lane 31 (30, 31) of
          // the previous j: those lanes send a[j − 1], the others a[j]
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const float prev = j > 0 ? a[j > 0 ? j - 1 : 0] : kNegInf;
            up1[j] = __shfl_sync(0xffffffffu, lane == 31 ? prev : a[j], (lane + 31) & 31);
            up2[j] = __shfl_sync(0xffffffffu, lane >= 30 ? prev : a[j], (lane + 30) & 31);
          }
        } else {
          // lanes 0 and 1 take lanes 30, 31 of the warp below (of the last
          // warp, previous j, for warp 0) from the slots written at step
          // t − 1; every lane reads them (a broadcast), so the warp never
          // diverges
          const float2* sl = reinterpret_cast<const float2*>(slots) + ((t - 1) & 1) * nwarps * J +
                             (warp > 0 ? warp - 1 : nwarps - 1) * J;
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const int jj = warp > 0 ? j : j - 1;
            const float2 l = jj >= 0 ? sl[jj >= 0 ? jj : 0] : make_float2(kNegInf, kNegInf);
            const float s1 = __shfl_sync(0xffffffffu, a[j], (lane + 31) & 31);
            const float s2 = __shfl_sync(0xffffffffu, a[j], (lane + 30) & 31);
            up1[j] = lane == 0 ? l.y : s1;
            up2[j] = lane == 0 ? l.x : (lane == 1 ? l.y : s2);
          }
        }
#pragma unroll
        for (int j = 0; j < J; ++j) {
          up1[j] = j * threads + tid >= 1 ? up1[j] : kNegInf;  // advance
          up2[j] = can_skip[j] ? up2[j] : kNegInf;             // skip
        }
        lae<J>(a, up1, up1);
        lae<J>(up1, up2, up2);
#pragma unroll
        for (int j = 0; j < J; ++j) a[j] = fmaxf(e[j] + up2[j], kNegInf);
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (j * threads + tid < S2) dst[j * threads + tid] = a[j];
      }
      if (nwarps > 1) {
        if (lane >= 30) {
          float* sl = slots + ((t & 1) * nwarps * J + warp * J) * 2 + (lane - 30);
#pragma unroll
          for (int j = 0; j < J; ++j) sl[j * 2] = a[j];
        }
        // the slots of parity t are read after this barrier at step t + 1,
        // and written again only after the next one
        __syncthreads();
      }
    }
  }
  cp_async_wait<0>();
}

// Alpha's threads and states a thread for S2 states: one state a thread
// where 16 warps hold the row (⌈S2/32⌉ warps), else 16 warps; J rounded up
// to an instance. It refuses the S2 that β refuses.
inline bool alpha_shape(int S2, int* threads, int* J) {
  if (smem_bytes(S2, time_chunk(S2)) > static_cast<size_t>(kSmemMax)) return false;
  const int warps = min((S2 + 31) / 32, kMaxAlphaWarps);
  const int need = (S2 + 32 * warps - 1) / (32 * warps);
  if (need > kMaxStates) return false;
  static const int inst[] = {1, 2, 3, 4, 6, 8, 12, 16, 24, 32};
  int j = 0;
  while (inst[j] < need) ++j;
  *threads = 32 * warps;
  *J = inst[j];
  return true;
}

__global__ void ctc_beta_kernel(const float* __restrict__ lp,         // (T, B, S2)
                                const float* __restrict__ skip_from,  // (B, S2), > 0 allows s → s+2
                                const float* __restrict__ bfinal,     // (B, S2)
                                const int* __restrict__ lengths,      // (B,)
                                float* __restrict__ beta,             // (T, B, S2)
                                int T, int B, int S2, int tchunk) {
  extern __shared__ float smem[];
  float* rows[2] = {smem, smem + S2};  // u = β + lp of the step just done
  float* skp = smem + 2 * S2;
  float* lps = smem + 3 * S2;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const long long tstride = static_cast<long long>(B) * S2;
  const float* lpb = lp + static_cast<long long>(b) * S2;
  const float* bfb = bfinal + static_cast<long long>(b) * S2;
  float* outb = beta + static_cast<long long>(b) * S2;
  const int t_last = lengths[b] - 1;

  for (int s = tid; s < S2; s += blockDim.x) skp[s] = skip_from[static_cast<long long>(b) * S2 + s];

  for (int t_hi = T - 1; t_hi >= 0; t_hi -= tchunk) {
    const int t_lo = max(0, t_hi - tchunk + 1);
    const int n = t_hi - t_lo + 1;
    for (int i = tid; i < n * S2; i += blockDim.x) {
      const int k = i / S2;
      lps[i] = lpb[(t_lo + k) * tstride + (i - k * S2)];
    }
    __syncthreads();
    for (int t = t_hi; t >= t_lo; --t) {
      const float* next = rows[(t + 1) & 1];  // u_{t+1}
      float* cur = rows[t & 1];
      const float* e = lps + (t - t_lo) * S2;
      for (int s = tid; s < S2; s += blockDim.x) {
        float v;
        if (t == t_last) {
          v = bfb[s];
        } else if (t == T - 1) {
          v = kNegInf;
        } else {
          const float stay = next[s];
          const float advance = s + 1 < S2 ? next[s + 1] : kNegInf;
          const float skipv = (s + 2 < S2 && skp[s] > 0.f) ? next[s + 2] : kNegInf;
          v = fmaxf(lae1(lae1(stay, advance), skipv), kNegInf);
        }
        outb[t * tstride + s] = v;
        cur[s] = v + e[s];
      }
      __syncthreads();
    }
  }
}

template <int J>
cudaError_t launch_alpha(const float* lp, const float* skip, float* alpha, int T, int B, int S2,
                         int threads, cudaStream_t stream) {
  const int stage = J * threads;
  int chunk = kRingBudget / (kRing * stage * static_cast<int>(sizeof(float)));
  chunk = chunk < 1 ? 1 : (chunk > kMaxRingChunk ? kMaxRingChunk : chunk);
  const size_t smem = (static_cast<size_t>(kRing) * chunk * stage + 4 * (threads / 32) * J) * sizeof(float);
  if (smem > static_cast<size_t>(kSmemMax)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ctc_alpha_kernel<J>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ctc_alpha_kernel<J><<<B, threads, smem, stream>>>(lp, skip, alpha, T, B, S2, chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ssd_ctc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// lp (T, B, S2) f32; skip (B, S2) f32; alpha (T, B, S2) f32. T, B ≥ 1,
// 1 ≤ S2 ≤ 14 528, as β.
cudaError_t ssd_ctc_alpha_launch(const float* lp, const float* skip, float* alpha,
                                 int T, int B, int S2, cudaStream_t stream) {
  int threads, J;
  if (!alpha_shape(S2, &threads, &J)) return cudaErrorInvalidValue;
  switch (J) {
    case 1: return launch_alpha<1>(lp, skip, alpha, T, B, S2, threads, stream);
    case 2: return launch_alpha<2>(lp, skip, alpha, T, B, S2, threads, stream);
    case 3: return launch_alpha<3>(lp, skip, alpha, T, B, S2, threads, stream);
    case 4: return launch_alpha<4>(lp, skip, alpha, T, B, S2, threads, stream);
    case 6: return launch_alpha<6>(lp, skip, alpha, T, B, S2, threads, stream);
    case 8: return launch_alpha<8>(lp, skip, alpha, T, B, S2, threads, stream);
    case 12: return launch_alpha<12>(lp, skip, alpha, T, B, S2, threads, stream);
    case 16: return launch_alpha<16>(lp, skip, alpha, T, B, S2, threads, stream);
    case 24: return launch_alpha<24>(lp, skip, alpha, T, B, S2, threads, stream);
    default: return launch_alpha<32>(lp, skip, alpha, T, B, S2, threads, stream);
  }
}

// lp (T, B, S2) f32; skip_from (B, S2) f32; bfinal (B, S2) f32; lengths (B,)
// i32; beta (T, B, S2) f32. T, B, S2 ≥ 1.
cudaError_t ssd_ctc_beta_launch(const float* lp, const float* skip_from, const float* bfinal,
                                const int* lengths, float* beta, int T, int B, int S2,
                                cudaStream_t stream) {
  const int tchunk = time_chunk(S2);
  const size_t smem = smem_bytes(S2, tchunk);
  if (smem > static_cast<size_t>(kSmemMax)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ctc_beta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ctc_beta_kernel<<<B, threads_for(S2), smem, stream>>>(
      lp, skip_from, bfinal, lengths, beta, T, B, S2, tchunk);
  return cudaGetLastError();
}

}  // extern "C"
