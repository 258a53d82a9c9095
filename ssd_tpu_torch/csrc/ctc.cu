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
// TPU; all of α and all of β, (T, B, S2) fp32, are written.
//
// What bounds it: the bytes are 8·T·B·S2 (lp_ext read, α or β written) plus
// the small (B, S2) inputs — at B = 5, T = 640, S2 = 321 that is 8.2 MB, about
// 2.5 µs at 3.35 TB/s. In practice the bound is the recursion: T dependent
// steps, each a block-wide barrier plus two expf and two log1pf per state,
// which no parallelism over rows can shorten.
//
// What the design does about it: the TPU's sequential time grid becomes a
// loop inside the block. One CTA takes one batch row, so no grid-wide sync
// is ever needed; its threads stride over the states (blockDim a multiple of
// 32, at most 1024). The previous row (α, or β + lp for the backward) lives
// in shared memory, ping-ponged, with one __syncthreads() per time step. The
// emissions are staged into shared memory a chunk of time steps at a time
// (coalesced, many loads in flight), so the per-step critical path touches
// only shared memory; each step writes its output row coalesced.

#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1.0e30f;
constexpr int kMaxThreads = 1024;
constexpr int kMaxTimeChunk = 32;             // time steps of lp_ext staged at once
constexpr int kSmemBudget = 96 * 1024;        // what the chunk is sized against
constexpr int kSmemMax = 227 * 1024;          // Hopper's per-block limit

__device__ __forceinline__ float lae(float a, float b) {
  const float d = a - b;
  if (d != d) return a + b;  // NaN delta: jnp.logaddexp's branch
  return fmaxf(a, b) + log1pf(expf(-fabsf(d)));
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

__global__ void ctc_alpha_kernel(const float* __restrict__ lp,    // (T, B, S2)
                                 const float* __restrict__ skip,  // (B, S2), > 0 allows the skip into s
                                 float* __restrict__ alpha,       // (T, B, S2)
                                 int T, int B, int S2, int tchunk) {
  extern __shared__ float smem[];
  float* rows[2] = {smem, smem + S2};
  float* skp = smem + 2 * S2;
  float* lps = smem + 3 * S2;  // tchunk × S2

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const long long tstride = static_cast<long long>(B) * S2;
  const float* lpb = lp + static_cast<long long>(b) * S2;
  float* outb = alpha + static_cast<long long>(b) * S2;

  for (int s = tid; s < S2; s += blockDim.x) skp[s] = skip[static_cast<long long>(b) * S2 + s];

  for (int t0 = 0; t0 < T; t0 += tchunk) {
    const int n = min(tchunk, T - t0);
    // the barrier that closed the previous step also closed the previous
    // chunk, so the staging area is free
    for (int i = tid; i < n * S2; i += blockDim.x) {
      const int k = i / S2;
      lps[i] = lpb[(t0 + k) * tstride + (i - k * S2)];
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const int t = t0 + k;
      const float* prev = rows[(t + 1) & 1];
      float* cur = rows[t & 1];
      for (int s = tid; s < S2; s += blockDim.x) {
        const float e = lps[k * S2 + s];
        float v;
        if (t == 0) {
          v = s <= 1 ? e : kNegInf;
        } else {
          const float stay = prev[s];
          const float advance = s >= 1 ? prev[s - 1] : kNegInf;
          const float skipv = (s >= 2 && skp[s] > 0.f) ? prev[s - 2] : kNegInf;
          v = fmaxf(e + lae(lae(stay, advance), skipv), kNegInf);
        }
        cur[s] = v;
        outb[t * tstride + s] = v;
      }
      __syncthreads();
    }
  }
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
          v = fmaxf(lae(lae(stay, advance), skipv), kNegInf);
        }
        outb[t * tstride + s] = v;
        cur[s] = v + e[s];
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" {

const char* ssd_ctc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// lp (T, B, S2) f32; skip (B, S2) f32; alpha (T, B, S2) f32. T, B, S2 ≥ 1.
cudaError_t ssd_ctc_alpha_launch(const float* lp, const float* skip, float* alpha,
                                 int T, int B, int S2, cudaStream_t stream) {
  const int tchunk = time_chunk(S2);
  const size_t smem = smem_bytes(S2, tchunk);
  if (smem > static_cast<size_t>(kSmemMax)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ctc_alpha_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ctc_alpha_kernel<<<B, threads_for(S2), smem, stream>>>(lp, skip, alpha, T, B, S2, tchunk);
  return cudaGetLastError();
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
