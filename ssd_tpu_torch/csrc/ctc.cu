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
// What the design does about it, for both directions: one CTA of 1–16 warps
// takes one batch row, and the time loop runs inside it. Each thread keeps J
// states in registers, interleaved by index (i = j·threads + tid), so each
// step's output row is stored coalesced straight from registers. A row gets
// ⌈S2/32⌉ warps and a thread one state (J > 1 only past 512 states): the
// chains of the SM's warps overlap better than several chains in one
// thread, because the step's latency, not its instruction count, sets the
// pace (scripts/bench_ctc_variants.py times other widths). β is α mirrored:
// its index runs down the states (s = S2 − 1 − i) and its steps down time
// (t = T − 1 − k), so in both the neighbours a state merges come from the
// two indices below it. Those come from the lane below by __shfl_sync; at a
// warp boundary from a two-slot (step-parity) shared-memory handoff of
// lanes 30 and 31, read by every lane of the warp above (a broadcast, so no
// warp diverges), under one barrier a step; with one warp there is no
// barrier at all. The emissions come through a cp.async ring a chunk of
// steps ahead: each thread copies exactly the elements it will read, so
// the ring needs no barrier either, only the thread's own
// cp.async.wait_group. Both take 1 ≤ S2 ≤ 14 528 (kMaxStates2): past 8 192
// states a thread holds 24 or 32, and spills.

#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1.0e30f;

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
constexpr int kSmemMax = 227 * 1024;    // Hopper's per-block limit
constexpr int kMaxWarps = 16;           // the kernels' launch bounds: 512 threads
constexpr int kMaxStates = 32;          // states a thread (the largest J instance)
constexpr int kMaxStates2 = 14528;      // the S2 both directions take

// One direction of the recursion with J states a thread (kBeta: β, else α).
// blockDim.x = 32·W threads; chunk steps a ring stage; shared memory: the
// ring (kRing · chunk · J · threads floats) and the handoff slots (2
// parities × W warps × J × lanes 30, 31). mask is α's skip INTO s or β's
// skip FROM s; bfinal and lengths are β's (null for α).
template <int J, bool kBeta>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
ctc_kernel(const float* __restrict__ lp,      // (T, B, S2)
           const float* __restrict__ mask,    // (B, S2), > 0 allows the skip
           const float* __restrict__ bfinal,  // (B, S2)
           const int* __restrict__ lengths,   // (B,)
           float* __restrict__ out,           // (T, B, S2)
           int T, int B, int S2, int chunk) {
  extern __shared__ float smem[];
  const int threads = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = threads >> 5;
  const int stage = J * threads;  // floats of one step in the ring
  float* ring = smem;
  float* slots = smem + kRing * chunk * stage;

  const int b = blockIdx.x;
  const long long row = static_cast<long long>(b) * S2;
  // β runs down the states and down time: step k is time T − 1 − k, and
  // index i is state S2 − 1 − i, so a state's neighbours s + 1, s + 2 are
  // the indices i − 1, i − 2, as α's s − 1, s − 2 are
  const long long tstride = kBeta ? -static_cast<long long>(B) * S2 : static_cast<long long>(B) * S2;
  const float* lpb = lp + row + (kBeta ? static_cast<long long>(T - 1) * B * S2 : 0);
  float* outb = out + row + (kBeta ? static_cast<long long>(T - 1) * B * S2 : 0);
  auto state = [&](int i) { return kBeta ? S2 - 1 - i : i; };
  const int k_last = kBeta ? T - lengths[b] : -1;  // the step of t = len − 1

  bool can_skip[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = j * threads + tid;
    can_skip[j] = i >= 2 && i < S2 && mask[row + state(i)] > 0.f;
  }

  // chunk c of the emissions into ring stage c mod kRing; each thread copies
  // the elements it reads itself. Always one commit group a chunk (empty
  // past T), so wait_group<kRing − 1> means "chunk c has landed".
  const int n_chunks = (T + chunk - 1) / chunk;
  auto issue = [&](int c) {
    if (c < n_chunks) {
      float* dst = ring + (c % kRing) * chunk * stage + tid;
      const int k0 = c * chunk;
      const int n = min(chunk, T - k0);
      for (int k = 0; k < n; ++k) {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int i = j * threads + tid;
          if (i < S2) cp_async4(dst + k * stage + j * threads, lpb + (k0 + k) * tstride + state(i));
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < kRing - 1; ++c) issue(c);

  // v: what the next step merges — α_{t} itself, or u_t = β_t + lp_t
  float v[J];
  float* dst = outb;  // the output row of step k, advanced by tstride each step
  for (int c = 0; c < n_chunks; ++c) {
    issue(c + kRing - 1);  // its stage was read, by this thread only, in chunk c − 1
    cp_async_wait<kRing - 1>();
    const float* ec = ring + (c % kRing) * chunk * stage + tid;
    const int n = min(chunk, T - c * chunk);
    for (int kk = 0; kk < n; ++kk, dst += tstride) {
      const int k = c * chunk + kk;
      float e[J], a[J];
#pragma unroll
      for (int j = 0; j < J; ++j) e[j] = j * threads + tid < S2 ? ec[kk * stage + j * threads] : kNegInf;
      if (k == 0) {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int i = j * threads + tid;
          if constexpr (kBeta) {
            a[j] = k_last == 0 && i < S2 ? bfinal[row + state(i)] : kNegInf;
          } else {
            a[j] = i <= 1 ? e[j] : kNegInf;
          }
        }
      } else {
        float up1[J], up2[J];  // v at indices i − 1, i − 2 of the step before
        if (nwarps == 1) {
          // lane 0 (1) takes index i − 1 (i − 2) from lane 31 (30, 31) of
          // the previous j: those lanes send v[j − 1], the others v[j]
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const float prev = j > 0 ? v[j > 0 ? j - 1 : 0] : kNegInf;
            up1[j] = __shfl_sync(0xffffffffu, lane == 31 ? prev : v[j], (lane + 31) & 31);
            up2[j] = __shfl_sync(0xffffffffu, lane >= 30 ? prev : v[j], (lane + 30) & 31);
          }
        } else {
          // lanes 0 and 1 take lanes 30, 31 of the warp below (of the last
          // warp, previous j, for warp 0) from the slots written at step
          // k − 1; every lane reads them (a broadcast), so the warp never
          // diverges
          const float2* sl = reinterpret_cast<const float2*>(slots) + ((k - 1) & 1) * nwarps * J +
                             (warp > 0 ? warp - 1 : nwarps - 1) * J;
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const int jj = warp > 0 ? j : j - 1;
            const float2 l = jj >= 0 ? sl[jj >= 0 ? jj : 0] : make_float2(kNegInf, kNegInf);
            const float s1 = __shfl_sync(0xffffffffu, v[j], (lane + 31) & 31);
            const float s2 = __shfl_sync(0xffffffffu, v[j], (lane + 30) & 31);
            up1[j] = lane == 0 ? l.y : s1;
            up2[j] = lane == 0 ? l.x : (lane == 1 ? l.y : s2);
          }
        }
#pragma unroll
        for (int j = 0; j < J; ++j) {
          up1[j] = j * threads + tid >= 1 ? up1[j] : kNegInf;  // advance
          up2[j] = can_skip[j] ? up2[j] : kNegInf;             // skip
        }
        lae<J>(v, up1, up1);
        lae<J>(up1, up2, up2);
        if constexpr (kBeta) {
          if (k == k_last) {
#pragma unroll
            for (int j = 0; j < J; ++j) {
              const int i = j * threads + tid;
              a[j] = i < S2 ? bfinal[row + state(i)] : kNegInf;
            }
          } else {
#pragma unroll
            for (int j = 0; j < J; ++j) a[j] = fmaxf(up2[j], kNegInf);
          }
        } else {
#pragma unroll
          for (int j = 0; j < J; ++j) a[j] = fmaxf(e[j] + up2[j], kNegInf);
        }
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int i = j * threads + tid;
        if (i < S2) dst[state(i)] = a[j];
        v[j] = kBeta ? a[j] + e[j] : a[j];
      }
      if (nwarps > 1) {
        if (lane >= 30) {
          float* sl = slots + ((k & 1) * nwarps * J + warp * J) * 2 + (lane - 30);
#pragma unroll
          for (int j = 0; j < J; ++j) sl[j * 2] = v[j];
        }
        // the slots of parity k are read after this barrier at step k + 1,
        // and written again only after the next one
        __syncthreads();
      }
    }
  }
  cp_async_wait<0>();
}

// Threads and states a thread for S2 states, both directions: one state a
// thread where 16 warps hold the row (⌈S2/32⌉ warps), else 16 warps; J
// rounded up to an instance.
inline bool ctc_shape(int S2, int* threads, int* J) {
  if (S2 < 1 || S2 > kMaxStates2) return false;
  const int warps = min((S2 + 31) / 32, kMaxWarps);
  const int need = (S2 + 32 * warps - 1) / (32 * warps);
  if (need > kMaxStates) return false;
  static const int inst[] = {1, 2, 3, 4, 6, 8, 12, 16, 24, 32};
  int j = 0;
  while (inst[j] < need) ++j;
  *threads = 32 * warps;
  *J = inst[j];
  return true;
}

template <int J, bool kBeta>
cudaError_t launch_j(const float* lp, const float* mask, const float* bfinal, const int* lengths,
                     float* out, int T, int B, int S2, int threads, cudaStream_t stream) {
  const int stage = J * threads;
  int chunk = kRingBudget / (kRing * stage * static_cast<int>(sizeof(float)));
  chunk = chunk < 1 ? 1 : (chunk > kMaxRingChunk ? kMaxRingChunk : chunk);
  const size_t smem = (static_cast<size_t>(kRing) * chunk * stage + 4 * (threads / 32) * J) * sizeof(float);
  if (smem > static_cast<size_t>(kSmemMax)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ctc_kernel<J, kBeta>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ctc_kernel<J, kBeta><<<B, threads, smem, stream>>>(lp, mask, bfinal, lengths, out, T, B, S2, chunk);
  return cudaGetLastError();
}

template <bool kBeta>
cudaError_t launch(const float* lp, const float* mask, const float* bfinal, const int* lengths,
                   float* out, int T, int B, int S2, cudaStream_t stream) {
  int threads, J;
  if (T < 1 || B < 1 || !ctc_shape(S2, &threads, &J)) return cudaErrorInvalidValue;
  switch (J) {
    case 1: return launch_j<1, kBeta>(lp, mask, bfinal, lengths, out, T, B, S2, threads, stream);
    case 2: return launch_j<2, kBeta>(lp, mask, bfinal, lengths, out, T, B, S2, threads, stream);
    case 3: return launch_j<3, kBeta>(lp, mask, bfinal, lengths, out, T, B, S2, threads, stream);
    case 4: return launch_j<4, kBeta>(lp, mask, bfinal, lengths, out, T, B, S2, threads, stream);
    case 6: return launch_j<6, kBeta>(lp, mask, bfinal, lengths, out, T, B, S2, threads, stream);
    case 8: return launch_j<8, kBeta>(lp, mask, bfinal, lengths, out, T, B, S2, threads, stream);
    case 12: return launch_j<12, kBeta>(lp, mask, bfinal, lengths, out, T, B, S2, threads, stream);
    case 16: return launch_j<16, kBeta>(lp, mask, bfinal, lengths, out, T, B, S2, threads, stream);
    case 24: return launch_j<24, kBeta>(lp, mask, bfinal, lengths, out, T, B, S2, threads, stream);
    default: return launch_j<32, kBeta>(lp, mask, bfinal, lengths, out, T, B, S2, threads, stream);
  }
}

}  // namespace

extern "C" {

const char* ssd_ctc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// lp (T, B, S2) f32; skip (B, S2) f32; alpha (T, B, S2) f32. T, B ≥ 1,
// 1 ≤ S2 ≤ 14 528.
cudaError_t ssd_ctc_alpha_launch(const float* lp, const float* skip, float* alpha,
                                 int T, int B, int S2, cudaStream_t stream) {
  return launch<false>(lp, skip, nullptr, nullptr, alpha, T, B, S2, stream);
}

// lp (T, B, S2) f32; skip_from (B, S2) f32; bfinal (B, S2) f32; lengths (B,)
// i32; beta (T, B, S2) f32. T, B ≥ 1, 1 ≤ S2 ≤ 14 528.
cudaError_t ssd_ctc_beta_launch(const float* lp, const float* skip_from, const float* bfinal,
                                const int* lengths, float* beta, int T, int B, int S2,
                                cudaStream_t stream) {
  return launch<true>(lp, skip_from, bfinal, lengths, beta, T, B, S2, stream);
}

}  // extern "C"
