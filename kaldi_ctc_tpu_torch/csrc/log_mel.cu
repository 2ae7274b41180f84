// K4: fused frame processing -> power spectrum -> mel -> log.
//
// Replaces kaldi_ctc_tpu/features/stft_pallas.py::log_mel_pallas (kernel
// body _kernel).  Per frame of L raw samples: DC removal, the raw log
// energy (after DC removal, before preemphasis), preemphasis with
// x[-1] = x[0], the analysis window, the real DFT of the zero-padded
// frame as two sums against the cos/sin tables of dft_tables (passed in,
// so the kernel and its plain version use the same numbers), power (or
// magnitude), the mel projection, and log floored at float epsilon.
// Everything is IEEE f32 FMA on the CUDA cores: no TF32, no tensor
// cores, because the DFT cancels heavily (hazard F2).
//
// What bounds it on the H100: the DFT, 2 x L x K MACs per frame
// (204,800 at L = 400, K = 256), and reading the two 400 KB tables.
// 8 s of audio is 798 frames, 0.33 GFLOP in all: microseconds of
// arithmetic, so the kernel is bounded by table traffic from L2 and by
// launch latency, not by the card's f32 rate.
//
// Design: one block of 256 threads per kFrames frames.  The frames sit
// in shared memory; the block reduces the mean and the energy with warp
// shuffles; then each thread owns DFT bins k (one per thread at K = 256)
// and keeps kFrames real and imaginary accumulators, so each table entry
// read from L2 serves kFrames frames.  The power spectrum goes back to
// shared memory, and threads over (frame, mel bin) finish the mel
// projection and the log.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = 4;

// sum over the block; every thread gets the total
__device__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // earlier readers of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += red[w];
  return total;
}

__global__ void __launch_bounds__(kThreads)
log_mel_kernel(const float* __restrict__ frames,
               const float* __restrict__ window,
               const float* __restrict__ cos_t,
               const float* __restrict__ sin_t,
               const float* __restrict__ mel, float* __restrict__ out,
               float* __restrict__ energy, int F, int L, int K, int M,
               int remove_dc, float preemph, int use_power, int use_log) {
  extern __shared__ float smem[];
  __shared__ float red[kThreads / 32];
  float* x = smem;                  // [kFrames][L] raw frames
  float* xw = x + kFrames * L;      // [kFrames][L] processed, windowed
  float* p = xw + kFrames * L;      // [kFrames][K] power spectrum
  const int f0 = blockIdx.x * kFrames;
  const int nf = min(kFrames, F - f0);

  for (int i = threadIdx.x; i < kFrames * L; i += blockDim.x) {
    const int f = i / L;
    x[i] = f < nf ? frames[(size_t)(f0 + f) * L + (i - f * L)] : 0.0f;
    xw[i] = 0.0f;
  }
  __syncthreads();

  for (int f = 0; f < nf; ++f) {
    float* xf = x + f * L;
    if (remove_dc) {
      float s = 0.0f;
      for (int i = threadIdx.x; i < L; i += blockDim.x) s += xf[i];
      const float mean = block_sum(s, red) / (float)L;
      for (int i = threadIdx.x; i < L; i += blockDim.x) xf[i] -= mean;
      __syncthreads();
    }
    float s2 = 0.0f;
    for (int i = threadIdx.x; i < L; i += blockDim.x) s2 += xf[i] * xf[i];
    const float e = block_sum(s2, red);
    if (threadIdx.x == 0) energy[f0 + f] = logf(fmaxf(e, FLT_EPSILON));
    for (int i = threadIdx.x; i < L; i += blockDim.x) {
      const float prev = xf[i > 0 ? i - 1 : 0];
      xw[f * L + i] = (xf[i] - preemph * prev) * window[i];
    }
  }
  __syncthreads();

  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float re[kFrames], im[kFrames];
#pragma unroll
    for (int f = 0; f < kFrames; ++f) re[f] = im[f] = 0.0f;
    for (int n = 0; n < L; ++n) {
      const float c = __ldg(cos_t + (size_t)n * K + k);
      const float s = __ldg(sin_t + (size_t)n * K + k);
#pragma unroll
      for (int f = 0; f < kFrames; ++f) {
        re[f] = fmaf(xw[f * L + n], c, re[f]);
        im[f] = fmaf(xw[f * L + n], s, im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < kFrames; ++f) {
      const float pw = re[f] * re[f] + im[f] * im[f];
      p[f * K + k] = use_power ? pw : sqrtf(pw);
    }
  }
  __syncthreads();

  for (int o = threadIdx.x; o < nf * M; o += blockDim.x) {
    const int f = o / M, m = o % M;
    const float* pf = p + f * K;
    const float* mr = mel + (size_t)m * K;
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) acc = fmaf(pf[k], __ldg(mr + k), acc);
    out[(size_t)(f0 + f) * M + m] =
        use_log ? logf(fmaxf(acc, FLT_EPSILON)) : acc;
  }
}

}  // namespace

extern "C" {

// frames [F, L], window [L], cos/sin [L, K], mel [M, K] -> out [F, M],
// energy [F]; all f32, contiguous
int log_mel_f32(const void* frames, const void* window, const void* cos_t,
                const void* sin_t, const void* mel, void* out, void* energy,
                int F, int L, int K, int M, int remove_dc, float preemph,
                int use_power, int use_log, void* stream) {
  if (F <= 0) return cudaGetLastError();
  const size_t smem = sizeof(float) * ((size_t)2 * kFrames * L +
                                       (size_t)kFrames * K);
  cudaError_t e = cudaFuncSetAttribute(
      log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const int grid = (F + kFrames - 1) / kFrames;
  log_mel_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames), static_cast<const float*>(window),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<const float*>(mel), static_cast<float*>(out),
      static_cast<float*>(energy), F, L, K, M, remove_dc, preemph, use_power,
      use_log);
  return cudaGetLastError();
}

const char* kctpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
