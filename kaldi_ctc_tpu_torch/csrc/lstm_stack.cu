// K7: the wavefront forward of an L-layer unidirectional LSTM stack.
//
// Replaces kaldi_ctc_tpu/ops/rnn_pallas.py::lstm_stack_fwd (kernel body
// _stack_kernel).  Inputs: layer 0's hoisted projection xp0 [T, B, 4H]
// in the compute dtype (gate order i, f, g, o); the recurrent weights
// w_h[l] [H, 4H] of the L layers and the input weights w_x[l] [H, 4H] of
// layers 1..L-1, in the compute dtype; the biases b[l] [4H] f32 of
// layers 1..L-1; the lengths [B]; the initial carries h0, c0 [L, B, H]
// f32.  Outputs: y [T, B, H] of the top layer in the compute dtype and
// the final carries h_fin, c_fin [L, B, H] f32.  Inference only.
//
// Step s of T + L - 1 advances layer l at t = s - l.  For l >= 1 the
// layer first projects its input in-step, y_{l-1}[t] . W_x[l] + b[l] with
// f32 accumulation, rounded to the compute dtype and widened to f32
// again: exactly how the per-layer path stores x_proj.  Then
// gates = x_proj + h . W_h[l] with h rounded to the compute dtype; gate
// math, h and c are f32.  A frame t >= lens[b] carries h and c and
// writes y = 0 (an idle slot, lens = 0, keeps its state).  The output a
// layer hands to the next is held in the compute dtype.
//
// What bounds it on the H100: T + L - 1 serial steps, each a few
// microseconds of latency (read h and the layer input, reduce, gate
// math, barrier).  At the streaming flagship (5 x 320, a chunk of T = 20
// frames, B = 8 slots) the work is 9 matrices of 320 x 1280 against 8
// rows per step, and the weights are 14.7 MB in f32: far more than one
// block's shared memory.
//
// Design: K5's layout spread over the L*H hidden units of the whole
// stack.  One cooperative launch: each block owns hs units of one layer
// (hs = ceil(L*H / SMs), 13 at 5 x 320: 125 blocks in one wave) and keeps
// those units' four gate columns of W_h[l] and of W_x[l] in shared memory
// for the whole chunk, with their cell state.  Each step an active block
// reads its layer's h and its input y_{l-1}[t] from double-buffered f32
// exchanges in L2 (ld.global.cg), computes both products for its columns
// with warp-split dot products, does the gate math and writes its slice
// of the next h and of its output; an idle block (t outside the chunk)
// copies its units' h forward.  Step s reads parity s&1 and writes parity
// (s+1)&1, so one grid.sync() per step keeps the wavefront in order: the
// layer above reads last step's output while this step's is written to
// the other buffer.  Every row stays in shared memory, so a launch takes
// at most lstm_stack_max_rows(L, H) rows, decided from shapes before any
// launch: the streaming server runs the whole stack in one launch up to
// that many slots (32 at 5 x 320), the per-layer route above it, and the
// wrapper runs a larger batch as row slices (above 162 slots at H = 320).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_ceiling.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxLayers = 16;

struct StackWeights {
  const void* wh[kMaxLayers];   // L recurrent weights [H, 4H]
  const void* wx[kMaxLayers];   // L-1 input weights [H, 4H], layers 1..L-1
  const float* b[kMaxLayers];   // L-1 biases [4H], layers 1..L-1
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype does
}

template <typename T>
__device__ __forceinline__ float round_f32(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

int units_per_block(int L, int H, int sms) {
  return (L * H + sms - 1) / sms;
}

size_t smem_bytes(int L, int B, int H, int hs) {
  const size_t m = L > 1 ? 2 : 1;   // W_x columns and input rows for L > 1
  return sizeof(float) * (m * 4 * hs * H + m * B * H + m * B * 4 * hs +
                          (size_t)B * hs);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lstm_stack_kernel(const T* __restrict__ xp0, StackWeights w,
                  const int32_t* __restrict__ lens,
                  const float* __restrict__ c0, T* __restrict__ y,
                  float* __restrict__ hfin, float* __restrict__ cfin,
                  float* hbuf, float* ybuf, int T_, int L, int B, int H,
                  int hs) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int nbl = (H + hs - 1) / hs;        // blocks per layer
  const int l = blockIdx.x / nbl;
  const int j0 = (blockIdx.x % nbl) * hs;
  const int n = min(hs, H - j0);            // hidden units this block owns
  const int n4 = 4 * n;
  const int G = 4 * H;
  const bool proj = l > 0;                  // in-step input projection
  const T* wh = static_cast<const T*>(w.wh[l]);
  const T* wx = proj ? static_cast<const T*>(w.wx[l - 1]) : nullptr;
  const float* bias = proj ? w.b[l - 1] : nullptr;

  const int m = L > 1 ? 2 : 1;
  float* wh_s = smem;                       // [4n][H]: c = gate * n + jj
  float* wx_s = wh_s + 4 * hs * H;          // [4n][H] (L > 1)
  float* h_s = wh_s + m * 4 * hs * H;       // [B][H]: h as the operand
  float* x_s = h_s + B * H;                 // [B][H]: y_{l-1}[t] (L > 1)
  float* g_s = h_s + m * B * H;             // [B][4n]: recurrent sums
  float* p_s = g_s + B * 4 * hs;            // [B][4n]: projection (L > 1)
  float* c_s = g_s + m * B * 4 * hs;        // [B][n]: cell state

  for (int i = threadIdx.x; i < n4 * H; i += blockDim.x) {
    const int c = i / H, k = i % H;
    const int gate = c / n, jj = c % n;
    const size_t src = (size_t)k * G + gate * H + j0 + jj;
    wh_s[i] = to_f32(wh[src]);
    if (proj) wx_s[i] = to_f32(wx[src]);
  }
  for (int e = threadIdx.x; e < B * n; e += blockDim.x) {
    const int b = e / n, jj = e % n;
    c_s[e] = c0[((size_t)l * B + b) * H + j0 + jj];
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t hsize = (size_t)B * H;
  const int steps = T_ + L - 1;
  for (int s = 0; s < steps; ++s) {
    const int t = s - l;
    const float* h_cur = hbuf + ((size_t)(s & 1) * L + l) * hsize;
    float* h_next = hbuf + ((size_t)((s + 1) & 1) * L + l) * hsize;
    const bool last = s == steps - 1;
    if (t < 0 || t >= T_) {
      // idle: carry the owned units' h into the next parity
      for (int e = threadIdx.x; e < B * n; e += blockDim.x) {
        const int b = e / n, j = j0 + e % n;
        const float h = __ldcg(h_cur + b * H + j);
        __stcg(h_next + b * H + j, h);
        if (last) {
          hfin[((size_t)l * B + b) * H + j] = h;
          cfin[((size_t)l * B + b) * H + j] = c_s[e];
        }
      }
      grid.sync();
      continue;
    }
    const float* x_cur =
        proj ? ybuf + ((size_t)(s & 1) * L + l - 1) * hsize : nullptr;
    for (int i = threadIdx.x; i < B * H; i += blockDim.x) {
      h_s[i] = round_f32<T>(__ldcg(h_cur + i));
      if (proj) x_s[i] = __ldcg(x_cur + i);
    }
    __syncthreads();
    for (int o = warp; o < B * n4; o += nwarps) {
      const int b = o / n4, c = o % n4;
      const float* hb = h_s + b * H;
      const float* wc = wh_s + c * H;
      float acc = 0.0f, accx = 0.0f;
      if (proj) {
        const float* xb = x_s + b * H;
        const float* xc = wx_s + c * H;
        for (int k = lane; k < H; k += 32) {
          acc = fmaf(hb[k], wc[k], acc);
          accx = fmaf(xb[k], xc[k], accx);
        }
      } else {
        for (int k = lane; k < H; k += 32) acc = fmaf(hb[k], wc[k], acc);
      }
      for (int off = 16; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
        accx += __shfl_xor_sync(0xffffffffu, accx, off);
      }
      if (lane == 0) {
        g_s[o] = acc;
        if (proj) p_s[o] = accx;
      }
    }
    __syncthreads();
    float* y_next = l + 1 < L
        ? ybuf + ((size_t)((s + 1) & 1) * L + l) * hsize : nullptr;
    for (int e = threadIdx.x; e < B * n; e += blockDim.x) {
      const int b = e / n, jj = e % n, j = j0 + jj;
      const float* g = g_s + b * n4;
      float pre[4];
      for (int q = 0; q < 4; ++q) {
        float xq;
        if (proj)   // the projection stored in the compute dtype
          xq = round_f32<T>(p_s[b * n4 + q * n + jj] + bias[q * H + j]);
        else
          xq = to_f32(xp0[((size_t)t * B + b) * G + q * H + j]);
        pre[q] = xq + g[q * n + jj];
      }
      const float gi = sigmoid(pre[0]);
      const float gf = sigmoid(pre[1]);
      const float gg = tanhf(pre[2]);
      const float go = sigmoid(pre[3]);
      const float c_prev = c_s[e];
      const float c_new = gf * c_prev + gi * gg;
      const float h_new = go * tanhf(c_new);
      const bool valid = t < lens[b];
      const float h_out = valid ? h_new : __ldcg(h_cur + b * H + j);
      const float c_out = valid ? c_new : c_prev;
      c_s[e] = c_out;
      __stcg(h_next + b * H + j, h_out);
      const float yv = valid ? h_new : 0.0f;
      if (y_next)
        __stcg(y_next + b * H + j, round_f32<T>(yv));
      else
        y[((size_t)t * B + b) * H + j] = from_f32<T>(yv);
      if (last) {
        hfin[((size_t)l * B + b) * H + j] = h_out;
        cfin[((size_t)l * B + b) * H + j] = c_out;
      }
    }
    grid.sync();
  }
}

template <typename T>
cudaError_t prepare(int L, int B, int H, int* hs_out, int* blocks_out,
                    size_t* smem_out) {
  if (L < 1 || L > kMaxLayers || B <= 0 || H <= 0)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0, coop = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (!coop) return cudaErrorNotSupported;
  const int hs = units_per_block(L, H, sms);
  const int blocks = L * ((H + hs - 1) / hs);
  const size_t smem = smem_bytes(L, B, H, hs);
  if (smem > (size_t)optin) return cudaErrorCooperativeLaunchTooLarge;
  auto kern = lstm_stack_kernel<T>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (per_sm * sms < blocks) return cudaErrorCooperativeLaunchTooLarge;
  *hs_out = hs;
  *blocks_out = blocks;
  *smem_out = smem;
  return cudaSuccess;
}

template <typename T>
int max_rows_of(int L, int H) {
  if (L < 1 || L > kMaxLayers || H <= 0) return 0;   // no grid at all
  return max_rows([L, H](int B) {
    int hs = 0, blocks = 0;
    size_t smem = 0;
    return prepare<T>(L, B, H, &hs, &blocks, &smem);
  });
}

template <typename T>
int launch(const void* xp0, const void* const* wh, const void* const* wx,
           const void* const* b, const void* lens, const void* c0, void* y,
           void* hfin, void* cfin, void* hbuf, void* ybuf, int T_, int L,
           int B, int H, void* stream) {
  int hs = 0, blocks = 0;
  size_t smem = 0;
  cudaError_t e = prepare<T>(L, B, H, &hs, &blocks, &smem);
  if (e != cudaSuccess) return e;
  if (T_ <= 0) return cudaGetLastError();
  StackWeights w = {};
  for (int l = 0; l < L; ++l) w.wh[l] = wh[l];
  for (int l = 0; l + 1 < L; ++l) {
    w.wx[l] = wx[l];
    w.b[l] = static_cast<const float*>(b[l]);
  }
  const T* a_xp = static_cast<const T*>(xp0);
  const int32_t* a_lens = static_cast<const int32_t*>(lens);
  const float* a_c0 = static_cast<const float*>(c0);
  T* a_y = static_cast<T*>(y);
  float* a_hfin = static_cast<float*>(hfin);
  float* a_cfin = static_cast<float*>(cfin);
  float* a_h = static_cast<float*>(hbuf);
  float* a_yb = static_cast<float*>(ybuf);
  int a_t = T_, a_l = L, a_b = B, a_hd = H, a_hs = hs;
  void* args[] = {&a_xp, &w,    &a_lens, &a_c0, &a_y, &a_hfin, &a_cfin,
                  &a_h,  &a_yb, &a_t,    &a_l,  &a_b, &a_hd,   &a_hs};
  e = cudaLaunchCooperativeKernel((void*)lstm_stack_kernel<T>, dim3(blocks),
                                  dim3(kThreads), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// the most batch rows one launch takes at L layers, H units on the
// current device (shared memory and co-residency of the cooperative
// grid; 0: not one, or L or H out of range), or a negative CUDA error
// code; nothing is launched
int lstm_stack_max_rows_f32(int L, int H) { return max_rows_of<float>(L, H); }
int lstm_stack_max_rows_bf16(int L, int H) {
  return max_rows_of<__nv_bfloat16>(L, H);
}

// wh: L device pointers, wx and b: L-1 device pointers (host arrays);
// hbuf: [2 parities][L][B][H] f32 with parity 0 = h0; ybuf: the same
// shape, scratch; c0: [L][B][H] f32
int lstm_stack_f32(const void* xp0, const void* const* wh,
                   const void* const* wx, const void* const* b,
                   const void* lens, const void* c0, void* y, void* hfin,
                   void* cfin, void* hbuf, void* ybuf, int T, int L, int B,
                   int H, void* stream) {
  return launch<float>(xp0, wh, wx, b, lens, c0, y, hfin, cfin, hbuf, ybuf,
                       T, L, B, H, stream);
}

int lstm_stack_bf16(const void* xp0, const void* const* wh,
                    const void* const* wx, const void* const* b,
                    const void* lens, const void* c0, void* y, void* hfin,
                    void* cfin, void* hbuf, void* ybuf, int T, int L, int B,
                    int H, void* stream) {
  return launch<__nv_bfloat16>(xp0, wh, wx, b, lens, c0, y, hfin, cfin, hbuf,
                               ybuf, T, L, B, H, stream);
}

const char* kctpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
