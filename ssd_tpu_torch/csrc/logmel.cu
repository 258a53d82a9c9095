// Fused log-mel featurizer for Hopper (sm_90a): a shared-memory FFT.
//
// Replaces the Pallas kernel ssd_tpu/ops/featurizer.py:_fused_kernel (called
// through _logmel_core_fused). Per (batch·channel row, frame) it computes
//
//   frame  = signal[f·hop : f·hop + n_fft]
//   power  = |rFFT(frame · Hann)|²                 (bins 0 … n_fft/2)
//   out    = 10·log10(max(Σ_band mel · power, 1e-10))
//
// in fp32 throughout (no TF32 or tensor cores: the feature contract is 1e-4
// on normalised features, and the work is small).
//
// What bounds it: the TPU kernel's dense DFT products (232 kFLOP a frame at
// n_fft 320) suit a matrix unit, not this card. An FFT needs ~2.5·N·log2 N
// flops a complex transform, and one transform serves two real frames; the
// Slaney filterbank has at most a few non-zero bins a filter. Fused, a frame
// costs ~9 kFLOP against 4·n_mels bytes written and 4·hop bytes read, so
// flops and bytes bound it about equally (~0.01 ms at B = 8 × 8 channels).
// On the card it runs at ~15× that: each CTA's stages (signal load, four
// passes, split, mel) take 2–6 k cycles apiece at five CTAs an SM, the
// latency of their shared-memory and L1 round trips (PERF.md §6).
//
// What the design does about it:
//   * One CTA takes one (row, block of `frames` frames). It copies the
//     block's signal span, (frames−1)·hop + n_fft samples read strided
//     straight from the (B, L, C) input, into shared memory, masking the
//     ragged end; any hop works, dividing n_fft or not.
//   * Two real frames make one complex input, z = w·x_a + i·w·x_b, with the
//     Hann window applied on the load. One N-point complex FFT, then
//     X_a[k] = (Z[k] + conj Z[N−k]) / 2, X_b[k] = (Z[k] − conj Z[N−k]) / 2i.
//   * The FFT is a mixed-radix Stockham (autosort) FFT in two ping-pong
//     shared-memory buffers, one barrier a pass; the first pass reads the
//     windowed frames straight from the staged signal. Index splits are
//     multiply-highs, not integer divisions. The host factors N into the
//     passes (radix 4, 2, 5, 3 butterflies written out; any other prime p a
//     generic pass that sums a direct p-point DFT) and tabulates the N roots
//     of unity in float64, stored as fp32: every twiddle is a table read.
//   * The mel projection is banded: the host packs each filter's non-zero
//     bins (its first bin and up to max_band weights); the kernel sums each
//     band in ascending bin order and stores the dB values coalesced along
//     the (frames, n_mels) block, which is contiguous in the output.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kC5a = 0.309016994374947424f;   // cos(2π/5)
constexpr float kC5b = -0.809016994374947424f;  // cos(4π/5)
constexpr float kS5a = 0.951056516295153572f;   // sin(2π/5)
constexpr float kS5b = 0.587785252292473129f;   // sin(4π/5)
constexpr float kS3 = 0.866025403784438647f;    // sin(π/3)

__host__ __device__ inline int span_floats(int frames, int hop, int n_fft) {
  const int span = (frames - 1) * hop + n_fft;
  return (span + 3) & ~3;  // keep the FFT buffers 16-byte aligned
}

inline size_t smem_bytes(int frames, int hop, int n_fft) {
  // signal span + two ping-pong buffers of frames/2 complex transforms
  return (static_cast<size_t>(span_floats(frames, hop, n_fft)) +
          2 * static_cast<size_t>(frames) * n_fft) * sizeof(float);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 mul_neg_i(float2 a) { return make_float2(a.y, -a.x); }  // −i·a

// v ← DFT_R(v), forward (e^{−2πi/R}) sign
__device__ __forceinline__ void dft2(float2* v) {
  const float2 a = v[0], b = v[1];
  v[0] = cadd(a, b);
  v[1] = csub(a, b);
}

__device__ __forceinline__ void dft3(float2* v) {
  const float2 t = cadd(v[1], v[2]);
  const float2 d = mul_neg_i(csub(v[1], v[2]));  // −i·(v1 − v2)
  const float2 m = make_float2(v[0].x - 0.5f * t.x, v[0].y - 0.5f * t.y);
  v[0] = cadd(v[0], t);
  v[1] = make_float2(m.x + kS3 * d.x, m.y + kS3 * d.y);
  v[2] = make_float2(m.x - kS3 * d.x, m.y - kS3 * d.y);
}

__device__ __forceinline__ void dft4(float2* v) {
  const float2 t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
  const float2 t2 = cadd(v[1], v[3]), t3 = mul_neg_i(csub(v[1], v[3]));
  v[0] = cadd(t0, t2);
  v[1] = cadd(t1, t3);
  v[2] = csub(t0, t2);
  v[3] = csub(t1, t3);
}

__device__ __forceinline__ void dft5(float2* v) {
  const float2 a1 = cadd(v[1], v[4]), b1 = csub(v[1], v[4]);
  const float2 a2 = cadd(v[2], v[3]), b2 = csub(v[2], v[3]);
  const float2 x0 = v[0];
  const float2 m1 = make_float2(x0.x + kC5a * a1.x + kC5b * a2.x, x0.y + kC5a * a1.y + kC5b * a2.y);
  const float2 m2 = make_float2(x0.x + kC5b * a1.x + kC5a * a2.x, x0.y + kC5b * a1.y + kC5a * a2.y);
  // −i·(s1·b1 + s2·b2) and −i·(s2·b1 − s1·b2)
  const float2 n1 = mul_neg_i(make_float2(kS5a * b1.x + kS5b * b2.x, kS5a * b1.y + kS5b * b2.y));
  const float2 n2 = mul_neg_i(make_float2(kS5b * b1.x - kS5a * b2.x, kS5b * b1.y - kS5a * b2.y));
  v[0] = make_float2(x0.x + a1.x + a2.x, x0.y + a1.y + a2.y);
  v[1] = cadd(m1, n1);
  v[4] = csub(m1, n1);
  v[2] = cadd(m2, n2);
  v[3] = csub(m2, n2);
}

// x / d for 0 ≤ x < 2^16 and 1 ≤ d < 2^16 by a multiply-high: m =
// ⌈2^32 / d⌉ = ⌊(2^32 − 1) / d⌋ + 1 (one 32-bit division a pass) makes
// ⌊x·m / 2^32⌋ exact while x·(m·d − 2^32) < 2^32. Every index split of the
// kernel (transform, butterfly, bin, mel) goes through one, instead of a
// runtime integer division.
struct FastDiv {
  int d;
  unsigned m;
  __device__ explicit FastDiv(int d_)
      : d(d_), m(d_ > 1 ? 0xffffffffu / static_cast<unsigned>(d_) + 1u : 0u) {}
  __device__ __forceinline__ int div(int x) const {
    return d > 1 ? static_cast<int>(__umulhi(static_cast<unsigned>(x), m)) : x;
  }
};

// Input n of transform p: from the previous pass's buffer, or — for the
// first pass — straight from the staged signal, two windowed real frames
// (2p real, 2p + 1 imaginary).
struct Source {
  const float2* buf;  // nullptr: read the signal
  const float* sig;
  const float* win;
  int hop;
  __device__ __forceinline__ float2 operator()(int p, int N, int n) const {
    if (buf != nullptr) return buf[p * N + n];
    const float w = __ldg(win + n);
    const float* x = sig + 2 * p * hop + n;
    return make_float2(w * x[0], w * x[hop]);
  }
};

// One Stockham pass of radix R over `pairs` transforms of length N:
// Ns = product of the earlier radices, m = N / R, stride = N / (Ns·R).
// Butterfly j of a transform reads input j + r·m, multiplies it by the
// twiddle W_N^{r·k·stride} (k = j mod Ns) and writes out[(j − k)·R + k + r·Ns].
template <int R>
__device__ __forceinline__ void pass_radix(const Source in, float2* __restrict__ out,
                                           const float2* __restrict__ tw, int pairs, int N, int Ns) {
  const int m = N / R;
  const int stride = N / (Ns * R);
  const FastDiv by_m(m), by_ns(Ns);
  for (int i = threadIdx.x; i < pairs * m; i += kThreads) {
    const int p = by_m.div(i);
    const int j = i - p * m;
    const int k = j - by_ns.div(j) * Ns;
    float2 v[R];
    v[0] = in(p, N, j);
#pragma unroll
    for (int r = 1; r < R; ++r) v[r] = cmul(in(p, N, j + r * m), __ldg(tw + r * k * stride));
    if constexpr (R == 2) dft2(v);
    if constexpr (R == 3) dft3(v);
    if constexpr (R == 4) dft4(v);
    if constexpr (R == 5) dft5(v);
    float2* y = out + p * N + (j - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) y[r * Ns] = v[r];
  }
}

// A pass of any radix R: output r' of butterfly j is the direct sum
// Σ_r in[j + r·m] · W_N^{r·(k + r'·Ns)·stride}, the inter-pass twiddle and
// the R-point DFT's root folded into one table read, accumulated in fp32.
__device__ void pass_generic(const Source in, float2* __restrict__ out,
                             const float2* __restrict__ tw, int pairs, int N, int Ns, int R) {
  const int m = N / R;
  const int stride = N / (Ns * R);
  const FastDiv by_n(N), by_m(m), by_ns(Ns);
  for (int i = threadIdx.x; i < pairs * N; i += kThreads) {
    const int p = by_n.div(i);
    const int rem = i - p * N;
    const int ro = by_m.div(rem);  // r'
    const int j = rem - ro * m;
    const int k = j - by_ns.div(j) * Ns;
    const int step = ((k + ro * Ns) * stride) % N;
    float2 acc = make_float2(0.f, 0.f);
    int idx = 0;
    for (int r = 0; r < R; ++r) {
      const float2 a = in(p, N, j + r * m), w = __ldg(tw + idx);
      acc.x = fmaf(a.x, w.x, fmaf(-a.y, w.y, acc.x));
      acc.y = fmaf(a.x, w.y, fmaf(a.y, w.x, acc.y));
      idx += step;
      if (idx >= N) idx -= N;
    }
    out[p * N + (j - k) * R + k + ro * Ns] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
logmel_kernel(const float* __restrict__ emg,      // (B, L, C)
              const int* __restrict__ radix,      // (n_passes,) the FFT's radices, in pass order
              const float2* __restrict__ tw,      // (N,) W_N^m = e^{−2πi m/N}
              const float* __restrict__ win,      // (N,) periodic Hann
              const int* __restrict__ band_lo,    // (n_mels,) first bin of each band
              const float* __restrict__ band_w,   // (n_mels, max_band) band weights
              float* __restrict__ out,            // (B·C, T, n_mels)
              int L, int C, int T, int hop, int N, int n_passes, int n_bins, int n_mels,
              int max_band, int frames) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int pairs = frames / 2;
  const int span = (frames - 1) * hop + N;
  float* sig = smem;
  float2* buf0 = reinterpret_cast<float2*>(smem + span_floats(frames, hop, N));
  float2* buf1 = buf0 + pairs * N;

  const int row = blockIdx.y;  // b·C + c
  const int b = row / C;
  const int c = row - b * C;
  const int f0 = blockIdx.x * frames;
  const int tid = threadIdx.x;

  // signal span of this frame block; samples past L read as zeros, and
  // frames past T are computed but never stored
  const long long s0 = static_cast<long long>(f0) * hop;
  const float* src = emg + static_cast<long long>(b) * L * C + c;
  for (int i = tid; i < span; i += kThreads) {
    const long long s = s0 + i;
    sig[i] = s < L ? src[s * C] : 0.f;
  }
  __syncthreads();

  // the first pass reads the windowed frames from the signal; a length-1
  // transform (no pass) is its own input
  const Source from_sig{nullptr, sig, win, hop};
  float2* cur = buf0;
  float2* nxt = buf1;
  if (n_passes == 0) {
    for (int i = tid; i < pairs; i += kThreads) buf0[i] = from_sig(i, 1, 0);
    __syncthreads();
  }
  int Ns = 1;
  for (int q = 0; q < n_passes; ++q) {
    const int R = __ldg(radix + q);
    const Source in = q == 0 ? from_sig : Source{cur, sig, win, hop};
    float2* dst = q == 0 ? cur : nxt;
    switch (R) {
      case 4: pass_radix<4>(in, dst, tw, pairs, N, Ns); break;
      case 2: pass_radix<2>(in, dst, tw, pairs, N, Ns); break;
      case 5: pass_radix<5>(in, dst, tw, pairs, N, Ns); break;
      case 3: pass_radix<3>(in, dst, tw, pairs, N, Ns); break;
      default: pass_generic(in, dst, tw, pairs, N, Ns, R); break;
    }
    __syncthreads();
    if (q > 0) {
      float2* t = cur;
      cur = nxt;
      nxt = t;
    }
    Ns *= R;
  }

  // split the two spectra; power of bins 0 … n_bins−1 of every frame into
  // the free buffer. Z[N−0] is Z[0]; at an even N's Nyquist bin N−k = k.
  float* pw = reinterpret_cast<float*>(nxt);  // (frames, n_bins)
  const FastDiv by_bins(n_bins), by_mels(n_mels);
  for (int i = tid; i < pairs * n_bins; i += kThreads) {
    const int p = by_bins.div(i);
    const int k = i - p * n_bins;
    const float2 z = cur[p * N + k];
    const float2 zm = cur[p * N + (k == 0 ? 0 : N - k)];
    const float sr = z.x + zm.x, si = z.y - zm.y;  // 2·X_a
    const float dr = z.x - zm.x, di = z.y + zm.y;  // 2i·X_b, up to a unit factor
    pw[(2 * p) * n_bins + k] = 0.25f * (sr * sr + si * si);
    pw[(2 * p + 1) * n_bins + k] = 0.25f * (dr * dr + di * di);
  }
  __syncthreads();

  // banded mel + dB, stored along the contiguous (frames, n_mels) block
  const int n_out = min(frames, T - f0) * n_mels;
  float* dst = out + (static_cast<long long>(row) * T + f0) * n_mels;
  for (int i = tid; i < n_out; i += kThreads) {
    const int f = by_mels.div(i);
    const int m = i - f * n_mels;
    const float* p = pw + f * n_bins + __ldg(band_lo + m);
    const float* w = band_w + m * max_band;
    float acc = 0.f;
    for (int j = 0; j < max_band; ++j) acc = fmaf(__ldg(w + j), p[j], acc);
    dst[i] = 10.f * log10f(fmaxf(acc, 1e-10f));
  }
}

}  // namespace

extern "C" {

const char* ssd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// emg (B, L, C) f32; radix (n_passes,) i32 with Π radix = n_fft; tw (n_fft, 2)
// f32; win (n_fft,) f32; band_lo (n_mels,) i32 with band_lo + max_band ≤
// n_bins; band_w (n_mels, max_band) f32; out (B·C, T, n_mels) f32. frames even.
cudaError_t ssd_logmel_launch(const float* emg, const int* radix, const float* tw, const float* win,
                              const int* band_lo, const float* band_w, float* out, int B, int L,
                              int C, int T, int hop, int n_fft, int n_passes, int n_mels,
                              int max_band, int frames, cudaStream_t stream) {
  if (frames < 2 || frames % 2 != 0) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(frames, hop, n_fft);
  cudaError_t err = cudaFuncSetAttribute(
      logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((T + frames - 1) / frames, B * C);
  logmel_kernel<<<grid, kThreads, smem, stream>>>(
      emg, radix, reinterpret_cast<const float2*>(tw), win, band_lo, band_w, out, L, C, T, hop,
      n_fft, n_passes, 1 + n_fft / 2, n_mels, max_band, frames);
  return cudaGetLastError();
}

}  // extern "C"
