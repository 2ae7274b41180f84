// K4: fused frame processing -> power spectrum -> mel -> log.
//
// Replaces kaldi_ctc_tpu/features/stft_pallas.py::log_mel_pallas (kernel
// body _kernel).  Per frame of L raw samples: DC removal, the raw log
// energy (after DC removal, before preemphasis), preemphasis with
// x[-1] = x[0], the analysis window, the power (or magnitude) spectrum of
// the frame zero-padded to N points, bins 0..K-1, the mel projection, and
// log floored at float epsilon.  Everything is IEEE f32 on the CUDA
// cores (fmaf where a sum is written out, logf/sqrtf, no fast math): no
// TF32, no tensor cores, because the transform cancels heavily (hazard
// F2).  Two routes, chosen from the shapes by stft_cuda.k4_plan:
//
// fft (log_mel_fft_kernel), where N is a power of two up to
// kFftMaxPoints.  What bounds it on the H100: reading the frames and
// writing mel and energy (1.4 MB at 798 frames, ~0.4 us at 3.35 TB/s);
// a 512-point real FFT is ~1.5e4 flops a frame.  So the work a block
// does before its first store, and the launch, set its time.  Design:
// one warp per frame, kFftFrames frames a block (20 frames of a stream
// chunk are 5 blocks, 798 frames 200).  The block copies the twiddles,
// the window, the mel rows and its frames into shared memory (cp.async,
// one wait, one block barrier; none after it).  The mel rows come as
// their nonzero spans, packed, which the wrapper finds once per mel
// matrix (stft_cuda._mel_rows: ~470 floats for the 40 x 256 hires bank,
// not 40 KB).  Each warp reduces its frame's mean and energy with
// shuffles, writes the preemphasized, windowed frame as N/2 complex
// values x[2n] + i x[2n+1], runs an N/2-point Stockham FFT (radix 4, one
// radix-2 pass first where log2(N/2) is odd) between two shared-memory
// rows padded by one complex every 16 (bank conflicts), and a real-split
// pass gives bins 0..K-1.  No branch inside a butterfly (the twiddle's
// sign is a select), so the compiler overlaps a lane's butterflies.  The
// twiddles e^{-2 pi i t / N}, t = 0..N/2, are computed in float64 on the
// host and rounded to f32 (stft_cuda.fft_twiddles).  Lane m sums mel row
// m over its span in order, as the dft route sums the whole row (the
// skipped terms are exact zeros).
//
// dft (log_mel_kernel), every other padded size (round_to_power_of_two
// off gives a 400-point transform): the direct DFT, 2 x L x K MACs per
// frame against the cos/sin tables of dft_tables.  One block of 256
// threads per kFrames frames: the frames sit in shared memory, the block
// reduces the mean and the energy with warp shuffles, each thread owns
// DFT bins k and keeps kFrames real and imaginary accumulators, so each
// table entry read from L2 serves kFrames frames; threads over (frame,
// mel bin) finish the mel projection and the log.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = 4;

// the dft route's dynamic shared memory: kFrames raw and windowed frames
// and their power spectra
__host__ __device__ inline size_t dft_smem_bytes(int L, int K) {
  return sizeof(float) * ((size_t)2 * kFrames * L + (size_t)kFrames * K);
}

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

// ---------------------------------------------------------------------------
// The fft route
// ---------------------------------------------------------------------------

constexpr int kFftFrames = 4;         // frames (warps) a block takes at most
constexpr int kFftMaxPoints = 4096;   // the largest padded size it takes
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// The shared-memory layout of the fft route, in floats; every part starts
// on 16 bytes.  The one formula of the launch, its query
// (log_mel_fft_smem) and stft_cuda._fft_smem_bytes.
struct FftLayout {
  int win;     // the window, L floats (twiddles first: N/2 + 1 complex)
  int rows;    // [M][3] ints: a mel row's first bin, one past its last
               // nonzero bin, its offset in the packed rows
  int packed;  // the rows' spans, packed: nnz floats
  int frame;   // the first frame's part
  int raw;     // floats of a frame's raw samples
  int cb;      // floats of one padded complex row
  int per_frame;
  __host__ __device__ FftLayout(int L, int N, int M, int nnz) {
    const int nh = N / 2;
    win = round4(2 * (nh + 1));
    rows = win + round4(L);
    packed = rows + round4(3 * M);
    frame = packed + round4(nnz);
    raw = round4(L);
    cb = round4(2 * (nh + ((nh - 1) >> 4)));
    per_frame = raw + 2 * cb;
  }
  __host__ __device__ size_t bytes(int frames) const {
    return sizeof(float) * ((size_t)frame + (size_t)frames * per_frame);
  }
};

// complex index j of a padded row: one complex of padding every 16
__device__ __forceinline__ int cpad(int j) { return j + (j >> 4); }

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(fmaf(a.x, w.x, -(a.y * w.y)), fmaf(a.x, w.y, a.y * w.x));
}

// e^{-2 pi i t / N} for 0 <= t < N: the table holds t <= N/2, and
// W^t = -W^(t - N/2) (a select, not a branch: a branch would make each
// butterfly a divergent region of its own)
__device__ __forceinline__ float2 twiddle(const float2* tw, int t, int nh) {
  const bool up = t > nh;
  const float2 w = tw[up ? t - nh : t];
  return up ? make_float2(-w.x, -w.y) : w;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The N/2-point forward FFT of the warp's padded row z0 (z1 the other
// row), Stockham order, radix 4 after one radix-2 pass where log2(N/2) is
// odd → the row holding the transform.
__device__ float2* warp_fft(float2* z0, float2* z1, const float2* tw,
                            int nh, int lane) {
  float2* src = z0;
  float2* dst = z1;
  int ns = 1;
  if (nh > 1 && (__ffs(nh) - 1) % 2 == 1) {
    const int half = nh >> 1;
    for (int j = lane; j < half; j += 32) {
      const float2 a = src[cpad(j)], b = src[cpad(j + half)];
      dst[cpad(2 * j)] = make_float2(a.x + b.x, a.y + b.y);
      dst[cpad(2 * j + 1)] = make_float2(a.x - b.x, a.y - b.y);
    }
    __syncwarp();
    float2* t = src; src = dst; dst = t;
    ns = 2;
  }
  const int q = nh >> 2;
  for (; ns < nh; ns *= 4) {
    const int tstep = nh / (2 * ns);   // W_N^(r k tstep) = e^{-2 pi i r k / 4ns}
    for (int j = lane; j < q; j += 32) {
      const int k = j & (ns - 1);
      // at k = 0 the twiddles are 1 + 0i: the products are exact
      const float2 v0 = src[cpad(j)];
      const float2 v1 = cmul(src[cpad(j + q)], twiddle(tw, k * tstep, nh));
      const float2 v2 =
          cmul(src[cpad(j + 2 * q)], twiddle(tw, 2 * k * tstep, nh));
      const float2 v3 =
          cmul(src[cpad(j + 3 * q)], twiddle(tw, 3 * k * tstep, nh));
      const float2 a0 = make_float2(v0.x + v2.x, v0.y + v2.y);
      const float2 a1 = make_float2(v0.x - v2.x, v0.y - v2.y);
      const float2 a2 = make_float2(v1.x + v3.x, v1.y + v3.y);
      const float2 a3 = make_float2(v1.y - v3.y, v3.x - v1.x);  // (v1-v3)(-i)
      const int d = (j - k) * 4 + k;
      dst[cpad(d)] = make_float2(a0.x + a2.x, a0.y + a2.y);
      dst[cpad(d + ns)] = make_float2(a1.x + a3.x, a1.y + a3.y);
      dst[cpad(d + 2 * ns)] = make_float2(a0.x - a2.x, a0.y - a2.y);
      dst[cpad(d + 3 * ns)] = make_float2(a1.x - a3.x, a1.y - a3.y);
    }
    __syncwarp();
    float2* t = src; src = dst; dst = t;
  }
  return src;
}

__global__ void __launch_bounds__(32 * kFftFrames)
log_mel_fft_kernel(const float* __restrict__ frames,
                   const float* __restrict__ window,
                   const float* __restrict__ twiddles,
                   const int* __restrict__ mel_rows,
                   const float* __restrict__ mel_packed,
                   float* __restrict__ out, float* __restrict__ energy,
                   int F, int L, int N, int K, int M, int nnz, int remove_dc,
                   float preemph, int use_power, int use_log) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const FftLayout lay(L, N, M, nnz);
  const int nh = N / 2;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int f = blockIdx.x * warps + warp;
  const bool live = f < F;
  const float2* tw = reinterpret_cast<const float2*>(smem);
  const float* win = smem + lay.win;
  const int* rows = reinterpret_cast<const int*>(smem + lay.rows);
  const float* packed = smem + lay.packed;
  float* raw = smem + lay.frame + warp * lay.per_frame;
  float2* z0 = reinterpret_cast<float2*>(raw + lay.raw);
  float2* z1 = z0 + lay.cb / 2;

  // the block's tables (twiddles, window, mel rows) and each warp's frame
  for (int i = threadIdx.x; i < 2 * (nh + 1); i += blockDim.x)
    cp_async4(smem + i, twiddles + i);
  for (int i = threadIdx.x; i < L; i += blockDim.x)
    cp_async4(smem + lay.win + i, window + i);
  for (int i = threadIdx.x; i < 3 * M; i += blockDim.x)
    cp_async4(smem + lay.rows + i, mel_rows + i);
  for (int i = threadIdx.x; i < nnz; i += blockDim.x)
    cp_async4(smem + lay.packed + i, mel_packed + i);
  if (live)
    for (int i = lane; i < L; i += 32)
      cp_async4(raw + i, frames + (size_t)f * L + i);
  cp_async_wait_all();
  __syncthreads();   // every thread's copies are in
  if (!live) return;   // no block barrier follows

  float mean = 0.0f;
  if (remove_dc) {
    float s = 0.0f;
#pragma unroll 4
    for (int i = lane; i < L; i += 32) s += raw[i];
    mean = warp_sum(s) / (float)L;
  }
  float s2 = 0.0f;
#pragma unroll 4
  for (int i = lane; i < L; i += 32) {
    const float x = raw[i] - mean;
    s2 = fmaf(x, x, s2);
  }
  s2 = warp_sum(s2);
  if (lane == 0) energy[f] = logf(fmaxf(s2, FLT_EPSILON));
  // x[2n] + i x[2n+1], zero past L
  float* zf = reinterpret_cast<float*>(z0);
#pragma unroll 4
  for (int i = lane; i < N; i += 32) {
    float v = 0.0f;
    if (i < L) {
      const float x = raw[i] - mean;
      const float prev = raw[i > 0 ? i - 1 : 0] - mean;
      v = fmaf(-preemph, prev, x) * win[i];
    }
    zf[2 * cpad(i >> 1) + (i & 1)] = v;
  }
  __syncwarp();
  const float2* z = warp_fft(z0, z1, tw, nh, lane);
  float* p = reinterpret_cast<float*>(z == z0 ? z1 : z0);   // K floats
  // real split: X[k] = E[k] + W^k O[k] from Z[k] and conj(Z[N/2-k])
  for (int k = lane; k < K; k += 32) {
    const float2 za = z[cpad(k & (nh - 1))];
    const float2 zb = z[cpad((nh - k) & (nh - 1))];
    const float er = 0.5f * (za.x + zb.x), ei = 0.5f * (za.y - zb.y);
    const float dr = 0.5f * (za.x - zb.x), di = 0.5f * (za.y + zb.y);
    const float2 w = tw[k];
    const float xr = er + fmaf(w.x, di, w.y * dr);
    const float xi = ei + fmaf(w.y, di, -(w.x * dr));
    const float pw = fmaf(xr, xr, xi * xi);
    p[k] = use_power ? pw : sqrtf(pw);
  }
  __syncwarp();
  // lane m sums mel row m over its span in order (four loads at a time)
  for (int m = lane; m < M; m += 32) {
    const int lo = rows[3 * m], hi = rows[3 * m + 1];
    const float* r = packed + rows[3 * m + 2] - lo;
    float acc = 0.0f;
    int k = lo;
    for (; k + 4 <= hi; k += 4) {
      const float p0 = p[k], p1 = p[k + 1], p2 = p[k + 2], p3 = p[k + 3];
      const float r0 = r[k], r1 = r[k + 1], r2 = r[k + 2], r3 = r[k + 3];
      acc = fmaf(p0, r0, acc);
      acc = fmaf(p1, r1, acc);
      acc = fmaf(p2, r2, acc);
      acc = fmaf(p3, r3, acc);
    }
    for (; k < hi; ++k) acc = fmaf(p[k], r[k], acc);
    out[(size_t)f * M + m] = use_log ? logf(fmaxf(acc, FLT_EPSILON)) : acc;
  }
}

__global__ void null_kernel() {}

}  // namespace

extern "C" {

// the dft route's dynamic shared memory (bytes; the launch's formula)
int log_mel_dft_smem(int L, int K) {
  return (int)dft_smem_bytes(L, K);
}

// frames [F, L], window [L], cos/sin [L, K], mel [M, K] -> out [F, M],
// energy [F]; all f32, contiguous
int log_mel_f32(const void* frames, const void* window, const void* cos_t,
                const void* sin_t, const void* mel, void* out, void* energy,
                int F, int L, int K, int M, int remove_dc, float preemph,
                int use_power, int use_log, void* stream) {
  if (F <= 0) return cudaGetLastError();
  const size_t smem = dft_smem_bytes(L, K);
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

// the fft route's shared memory for frames_per_block frames and nnz
// packed mel floats (bytes)
int log_mel_fft_smem(int L, int N, int M, int nnz, int frames_per_block) {
  return (int)FftLayout(L, N, M, nnz).bytes(frames_per_block);
}

// frames [F, L], window [L], twiddles [N/2 + 1, 2] (e^{-2 pi i t / N}),
// the mel matrix [M, K] as its rows' spans (mel_rows [M, 3]: first bin,
// one past the last nonzero bin, offset in mel_packed) and mel_packed
// [nnz] -> out [F, M], energy [F]; all f32 (the rows int32), contiguous;
// N a power of two, at most kFftMaxPoints, K <= N/2 + 1, L <= N
int log_mel_fft_f32(const void* frames, const void* window,
                    const void* twiddles, const void* mel_rows,
                    const void* mel_packed, void* out, void* energy, int F,
                    int L, int N, int K, int M, int nnz, int remove_dc,
                    float preemph, int use_power, int use_log,
                    int frames_per_block, void* stream) {
  if (F <= 0) return cudaGetLastError();
  if (N < 2 || (N & (N - 1)) != 0 || N > kFftMaxPoints || L > N ||
      K > N / 2 + 1 || nnz < 0 || nnz > M * K || frames_per_block < 1 ||
      frames_per_block > kFftFrames)
    return cudaErrorInvalidValue;
  const size_t smem = FftLayout(L, N, M, nnz).bytes(frames_per_block);
  cudaError_t e = cudaFuncSetAttribute(
      log_mel_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const int grid = (F + frames_per_block - 1) / frames_per_block;
  log_mel_fft_kernel<<<grid, 32 * frames_per_block, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames), static_cast<const float*>(window),
      static_cast<const float*>(twiddles), static_cast<const int*>(mel_rows),
      static_cast<const float*>(mel_packed), static_cast<float*>(out),
      static_cast<float*>(energy), F, L, N, K, M, nnz, remove_dc, preemph,
      use_power, use_log);
  return cudaGetLastError();
}

// one launch of an empty kernel: the floor under every launch's time
int kctpu_null_launch(void* stream) {
  null_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

const char* kctpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
