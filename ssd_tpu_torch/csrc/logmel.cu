// Fused log-mel featurizer for Hopper (sm_90a).
//
// Replaces the Pallas kernel ssd_tpu/ops/featurizer.py:_fused_kernel (called
// through _logmel_core_fused). Per (batch·channel row, frame) it computes
//
//   frame  = signal[f·hop : f·hop + n_fft]
//   power  = |frame·Hann · DFT|²            (rDFT as products with cos / sin)
//   out    = 10·log10(max(power · melᵀ, 1e-10))
//
// in full fp32 FMA (no TF32: the feature contract is 2e-4).
//
// What bounds it: per frame the DFT costs 2·n_fft·n_bins·2 FLOP and the mel
// projection 2·n_bins·n_mels (≈ 232 kFLOP at 320/161/80), against 4·n_mels
// bytes written and 4·hop bytes read. At a serving bucket that is ~640
// FLOP per byte, so the kernel is bound by fp32 FMA throughput, not memory.
//
// What the design does about it:
//   * One CTA takes one (row, 64-frame block). It copies the block's signal
//     span, (64−1)·hop + n_fft samples read strided straight from the
//     (B, L, C) input, into shared memory. The framed matrix (a 32× blow-up
//     at hop 10) never exists in device memory, and there is no transpose,
//     padding or signal copy in HBM: the ragged last block is masked here.
//   * The Hann window is folded into the DFT matrix on the host, so the
//     inner loop is pure FMA: each thread keeps a 4-frame × 11-bin register
//     tile of (re, im) accumulators, 88 FMAs for 4 + 11 shared loads.
//   * The windowed (cos, sin) matrix, n_fft × 176 float2 (450 KB), does not
//     fit in shared memory; it is staged in 32-row chunks (45 KB) and read
//     from L2 by every CTA.
//   * Power goes to shared memory, the mel matrix (176 × 80) is staged
//     beside it, and a second register-tiled product (4 frames × 5 mels a
//     thread) finishes with the log. Bins are padded 161 → 176 and mels to
//     80 with zeros, so padded lanes add exact zeros.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = 64;                                  // frames per CTA
constexpr int kLanes = 16;                                   // frame lanes = bin lanes = mel lanes
constexpr int kFramesPerThread = kFrames / kLanes;           // 4
constexpr int kBinsPad = 176;                                // n_bins padded to 16·11
constexpr int kBinsPerThread = kBinsPad / kLanes;            // 11
constexpr int kMelsPad = 80;
constexpr int kMelsPerThread = kMelsPad / kLanes;            // 5
constexpr int kChunk = 32;                                   // DFT rows staged per step

static_assert(kThreads == kLanes * kLanes, "thread tile layout");

__host__ __device__ inline int span_floats(int hop, int n_fft_pad) {
  int span = (kFrames - 1) * hop + n_fft_pad;
  return (span + 3) & ~3;  // keep the work area 16-byte aligned
}

constexpr int kWorkFloats =
    (kChunk * kBinsPad * 2 > kFrames * kBinsPad + kBinsPad * kMelsPad)
        ? kChunk * kBinsPad * 2
        : kFrames * kBinsPad + kBinsPad * kMelsPad;

inline int smem_bytes(int hop, int n_fft_pad) {
  return (span_floats(hop, n_fft_pad) + kWorkFloats) * static_cast<int>(sizeof(float));
}

__global__ void __launch_bounds__(kThreads, 2)
logmel_kernel(const float* __restrict__ emg,    // (B, L, C)
              const float2* __restrict__ dft,   // (n_fft_pad, kBinsPad): (w·cos, w·sin)
              const float* __restrict__ mel,    // (kBinsPad, kMelsPad)
              float* __restrict__ out,          // (B·C, T, n_mels)
              int L, int C, int T, int hop, int n_fft_pad, int n_mels) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int span = (kFrames - 1) * hop + n_fft_pad;
  float* sig = smem;
  float* work = smem + span_floats(hop, n_fft_pad);
  float2* dft_s = reinterpret_cast<float2*>(work);  // phase 1: kChunk × kBinsPad
  float* pow_s = work;                              // phase 2: kFrames × kBinsPad
  float* mel_s = work + kFrames * kBinsPad;         // phase 2: kBinsPad × kMelsPad

  const int row = blockIdx.y;  // b·C + c
  const int b = row / C;
  const int c = row - b * C;
  const int f0 = blockIdx.x * kFrames;
  const int tid = threadIdx.x;
  const int lane = tid % kLanes;  // bin lane (phase 1), mel lane (phase 2)
  const int fl = tid / kLanes;    // frame lane: frames fl + 16·i

  // signal span of this frame block; samples past L (and past the last
  // frame) only ever meet zero DFT rows or masked frames
  const long long s0 = static_cast<long long>(f0) * hop;
  const float* src = emg + static_cast<long long>(b) * L * C + c;
  for (int i = tid; i < span; i += kThreads) {
    const long long s = s0 + i;
    sig[i] = s < L ? src[s * C] : 0.f;
  }

  float re[kFramesPerThread][kBinsPerThread];
  float im[kFramesPerThread][kBinsPerThread];
#pragma unroll
  for (int i = 0; i < kFramesPerThread; ++i) {
#pragma unroll
    for (int j = 0; j < kBinsPerThread; ++j) {
      re[i][j] = 0.f;
      im[i][j] = 0.f;
    }
  }

  for (int n0 = 0; n0 < n_fft_pad; n0 += kChunk) {
    __syncthreads();  // signal staged (first pass) / previous chunk consumed
    const float4* g = reinterpret_cast<const float4*>(dft + static_cast<long long>(n0) * kBinsPad);
    float4* s = reinterpret_cast<float4*>(dft_s);
    for (int i = tid; i < kChunk * kBinsPad / 2; i += kThreads) s[i] = g[i];
    __syncthreads();
#pragma unroll 1  // unrolling the n-loop spilled at the 128-register cap (PERF.md)
    for (int n = 0; n < kChunk; ++n) {
      float x[kFramesPerThread];
#pragma unroll
      for (int i = 0; i < kFramesPerThread; ++i) x[i] = sig[(fl + kLanes * i) * hop + n0 + n];
#pragma unroll
      for (int j = 0; j < kBinsPerThread; ++j) {
        const float2 w = dft_s[n * kBinsPad + lane + kLanes * j];
#pragma unroll
        for (int i = 0; i < kFramesPerThread; ++i) {
          re[i][j] = fmaf(x[i], w.x, re[i][j]);
          im[i][j] = fmaf(x[i], w.y, im[i][j]);
        }
      }
    }
  }
  __syncthreads();  // every thread is done with dft_s before pow_s reuses it

#pragma unroll
  for (int i = 0; i < kFramesPerThread; ++i) {
#pragma unroll
    for (int j = 0; j < kBinsPerThread; ++j) {
      pow_s[(fl + kLanes * i) * kBinsPad + lane + kLanes * j] =
          re[i][j] * re[i][j] + im[i][j] * im[i][j];
    }
  }
  {
    const float4* g = reinterpret_cast<const float4*>(mel);
    float4* s = reinterpret_cast<float4*>(mel_s);
    for (int i = tid; i < kBinsPad * kMelsPad / 4; i += kThreads) s[i] = g[i];
  }
  __syncthreads();

  float acc[kFramesPerThread][kMelsPerThread];
#pragma unroll
  for (int i = 0; i < kFramesPerThread; ++i) {
#pragma unroll
    for (int j = 0; j < kMelsPerThread; ++j) acc[i][j] = 0.f;
  }
#pragma unroll 4
  for (int k = 0; k < kBinsPad; ++k) {
    float p[kFramesPerThread];
#pragma unroll
    for (int i = 0; i < kFramesPerThread; ++i) p[i] = pow_s[(fl + kLanes * i) * kBinsPad + k];
#pragma unroll
    for (int j = 0; j < kMelsPerThread; ++j) {
      const float m = mel_s[k * kMelsPad + lane + kLanes * j];
#pragma unroll
      for (int i = 0; i < kFramesPerThread; ++i) acc[i][j] = fmaf(p[i], m, acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kFramesPerThread; ++i) {
    const int f = f0 + fl + kLanes * i;
    if (f >= T) continue;
    float* dst = out + (static_cast<long long>(row) * T + f) * n_mels;
#pragma unroll
    for (int j = 0; j < kMelsPerThread; ++j) {
      const int m = lane + kLanes * j;
      if (m < n_mels) dst[m] = 10.f * log10f(fmaxf(acc[i][j], 1e-10f));
    }
  }
}

}  // namespace

extern "C" {

// Shape limits the wrapper checks before launching.
int ssd_logmel_bins_pad() { return kBinsPad; }
int ssd_logmel_mels_pad() { return kMelsPad; }
int ssd_logmel_chunk() { return kChunk; }

const char* ssd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// emg (B, L, C) f32; dft (n_fft_pad, 176, 2) f32 with the Hann window folded
// in and zero rows / columns past n_fft / n_bins; mel (176, 80) f32 = the
// filterbank transposed, zero-padded; out (B·C, T, n_mels) f32.
cudaError_t ssd_logmel_launch(const float* emg, const float* dft, const float* mel, float* out,
                              int B, int L, int C, int T, int hop, int n_fft_pad, int n_mels,
                              cudaStream_t stream) {
  const int smem = smem_bytes(hop, n_fft_pad);
  cudaError_t err = cudaFuncSetAttribute(
      logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kFrames - 1) / kFrames, B * C);
  logmel_kernel<<<grid, kThreads, smem, stream>>>(
      emg, reinterpret_cast<const float2*>(dft), mel, out, L, C, T, hop, n_fft_pad, n_mels);
  return cudaGetLastError();
}

}  // extern "C"
