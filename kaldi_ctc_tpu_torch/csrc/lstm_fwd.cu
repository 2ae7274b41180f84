// K5: the forward recurrence of one unidirectional LSTM direction.
//
// Replaces kaldi_ctc_tpu/ops/rnn_pallas.py::lstm_seq_fwd (kernel bodies
// _fwd_kernel and the time-blocked _fwd_kernel_tb, which exists only to
// move larger DMA blocks on the TPU; one kernel covers both here).
// Input is the hoisted projection x_proj [T, B, 4H] in the compute dtype
// (gate order i, f, g, o), the recurrent weights w_h [H, 4H] in the
// compute dtype, the lengths [B] and the direction: reverse = 0 walks
// t = 0 .. T-1, reverse = 1 walks t = T-1 .. 0.
// gates = x_proj[t] + h . W_h with the operand h rounded to the compute
// dtype and f32 accumulation; gate math and the cell state are f32.
// A frame t >= lens[b] carries h and c and writes y = 0.  Outputs: y
// [T, B, H] in the compute dtype and c [T, B, H] f32 (the cell states
// the backward kernel K6 reads).
//
// What bounds it on the H100: the T serial steps.  A step is B GEMVs of
// H x 4H = 409,600 MACs at H = 320: a few microseconds of latency (read
// h, reduce, gate math, barrier) and almost no work for 132 SMs.  W_h is
// 320 x 1280 (1.6 MB in f32), far more than one block's 227 KB of shared
// memory.
//
// Two routes, chosen by the wrapper's plan from the shapes
// (ops/rnn_cuda.py::fwd_chain_plan):
//   - the cluster route, wherever W_h fits a cluster of at most 16 CTAs
//     (H up to ~470 in f32, ~670 in bf16): lstm_fwd_chain_kernel, the
//     forward chain of csrc/fwd_chain.cuh with one direction, reading
//     x_proj directly.  Rows never meet, so each cluster of C CTAs walks a
//     group of R rows with W_h in distributed shared memory and one
//     cluster barrier a step: no grid barrier, any B;
//   - the cooperative route above that: lstm_fwd_kernel, K2's design
//     (csrc/bilstm_fwd.cu) with one direction.  One cooperative launch:
//     each block owns hs hidden units and keeps those units' four gate
//     columns of W_h in shared memory for the whole sequence (as f32,
//     transposed so the lanes of a warp read consecutive k), and their
//     cell state too.  Each step a block reads h from a double-buffered
//     f32 exchange in global memory (L2-resident, ld.global.cg so a stale
//     L1 line is never seen), computes its 4*hs gate sums with warp-split
//     dot products, does the gate math, writes y, c and its slice of the
//     next h, and the grid meets at one grid.sync() per step: step s
//     reads parity s&1 and writes parity (s+1)&1.  hs = ceil(H / SMs)
//     puts the grid in one wave; the host checks co-residency before
//     launching and refuses a grid that cannot be.  Every row's h stays in
//     shared memory, so a launch takes at most lstm_fwd_max_rows(H) rows;
//     the wrapper runs a larger batch as row slices.
// Both sum in warp_dot's order (csrc/bilstm_cell.cuh), the order K6
// recomputes the gates in.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bilstm_cell.cuh"
#include "fwd_chain.cuh"
#include "row_ceiling.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
lstm_fwd_kernel(const T* __restrict__ xp, const T* __restrict__ wh,
                const int32_t* __restrict__ lens, T* __restrict__ y,
                float* __restrict__ cst, float* hbuf, int steps, int B,
                int H, int hs, int reverse) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int j0 = blockIdx.x * hs;
  const int n = min(hs, H - j0);            // hidden units this block owns
  const int G = 4 * H;

  float* w_s = smem;                 // [4n][H]: column c = gate * n + jj
  float* h_s = w_s + 4 * hs * H;     // [B][H]: h as the matmul operand
  float* g_s = h_s + B * H;          // [B][4n]: recurrent gate sums
  float* c_s = g_s + B * 4 * hs;     // [B][n]: cell state of the owned units

  for (int i = threadIdx.x; i < 4 * n * H; i += blockDim.x) {
    const int c = i / H, k = i % H;
    const int gate = c / n, jj = c % n;
    w_s[i] = to_f32(wh[(size_t)k * G + gate * H + j0 + jj]);
  }
  for (int i = threadIdx.x; i < B * n; i += blockDim.x) c_s[i] = 0.0f;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t hsize = (size_t)B * H;
  for (int s = 0; s < steps; ++s) {
    const int t = reverse ? steps - 1 - s : s;
    const float* h_cur = hbuf + (size_t)(s & 1) * hsize;
    float* h_next = hbuf + (size_t)((s + 1) & 1) * hsize;
    for (int i = threadIdx.x; i < B * H; i += blockDim.x)
      h_s[i] = to_f32(from_f32<T>(__ldcg(h_cur + i)));
    __syncthreads();
    for (int o = warp; o < B * 4 * n; o += nwarps) {
      const int b = o / (4 * n), c = o % (4 * n);
      const float* hb = h_s + b * H;
      const float* wc = w_s + c * H;
      float acc = 0.0f;
      for (int k = lane; k < H; k += 32) acc = fmaf(hb[k], wc[k], acc);
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) g_s[o] = acc;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < B * n; e += blockDim.x) {
      const int b = e / n, jj = e % n, j = j0 + jj;
      const T* x = xp + ((size_t)t * B + b) * G;
      const float* g = g_s + b * 4 * n;
      const float gi = sigmoid(to_f32(x[j]) + g[jj]);
      const float gf = sigmoid(to_f32(x[H + j]) + g[n + jj]);
      const float gg = tanhf(to_f32(x[2 * H + j]) + g[2 * n + jj]);
      const float go = sigmoid(to_f32(x[3 * H + j]) + g[3 * n + jj]);
      const float c_prev = c_s[e];
      const float c_new = gf * c_prev + gi * gg;
      const float h_new = go * tanhf(c_new);
      const bool valid = t < lens[b];
      const float h_prev = __ldcg(h_cur + b * H + j);
      const float c_out = valid ? c_new : c_prev;
      c_s[e] = c_out;
      __stcg(h_next + b * H + j, valid ? h_new : h_prev);
      const size_t o = ((size_t)t * B + b) * H + j;
      y[o] = from_f32<T>(valid ? h_new : 0.0f);
      cst[o] = c_out;
    }
    grid.sync();
  }
}

// The launch's geometry at B rows: hs hidden units per block (the grid in
// one wave of the SMs), nb blocks and the shared memory in bytes; refuses
// rows that do not fit one block and a grid that is not co-resident.
// The launch and lstm_fwd_max_rows share it.
template <typename T>
cudaError_t plan(int B, int H, int* hs, int* nb, size_t* smem) {
  int dev = 0, sms = 0, coop = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (!coop) return cudaErrorNotSupported;
  *hs = (H + sms - 1) / sms;
  *nb = (H + *hs - 1) / *hs;
  *smem = sizeof(float) * ((size_t)4 * *hs * H + (size_t)B * H +
                           (size_t)B * 4 * *hs + (size_t)B * *hs);
  if (*smem > (size_t)optin) return cudaErrorLaunchOutOfResources;
  auto kern = lstm_fwd_kernel<T>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)*smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                    *smem);
  if (e != cudaSuccess) return e;
  return per_sm * sms < *nb ? cudaErrorCooperativeLaunchTooLarge
                            : cudaSuccess;
}

template <typename T>
int max_rows_of(int H) {
  if (H <= 0) return -static_cast<int>(cudaErrorInvalidValue);
  return max_rows([H](int B) {
    int hs = 0, nb = 0;
    size_t smem = 0;
    return plan<T>(B, H, &hs, &nb, &smem);
  });
}

template <typename T>
int launch(const void* xp, const void* wh, const void* lens, void* y,
           void* cst, void* hbuf, int steps, int B, int H, int reverse,
           void* stream) {
  if (steps <= 0 || B <= 0) return cudaGetLastError();
  int hs = 0, nb = 0;
  size_t smem = 0;
  cudaError_t e = plan<T>(B, H, &hs, &nb, &smem);
  if (e != cudaSuccess) return e;

  const T* a_xp = static_cast<const T*>(xp);
  const T* a_wh = static_cast<const T*>(wh);
  const int32_t* a_lens = static_cast<const int32_t*>(lens);
  T* a_y = static_cast<T*>(y);
  float* a_c = static_cast<float*>(cst);
  float* a_h = static_cast<float*>(hbuf);
  int a_steps = steps, a_b = B, a_hd = H, a_hs = hs, a_rev = reverse;
  void* args[] = {&a_xp, &a_wh,    &a_lens, &a_y,  &a_c, &a_h,
                  &a_steps, &a_b, &a_hd,  &a_hs, &a_rev};
  e = cudaLaunchCooperativeKernel((void*)lstm_fwd_kernel<T>, dim3(nb),
                                  dim3(kThreads), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// the cluster route: K5 as the forward chain with one direction
template <typename T, int RT>
__global__ void __launch_bounds__(kChainFwdThreads)
lstm_fwd_chain_kernel(const T* pre, int pre_stride, int t0f, int t0b,
                      const T* whf, const T* whb, const int32_t* lens, T* yf,
                      float* cf, T* yb, float* cb, float* state, int dirs,
                      int s0, int S, int steps, int B, int H, int R,
                      int reverse) {
  fwd_chain_body<LstmCell, T, T, RT>(pre, pre_stride, t0f, t0b, whf, whb,
                                     lens, yf, cf, yb, cb, state, dirs, s0,
                                     S, steps, B, H, R, reverse, nullptr);
}

template <typename T>
int chain_launch(const void* xp, const void* wh, const void* lens, void* y,
                 void* cst, void* state, int steps, int B, int H, int C,
                 int R, int reverse, void* stream) {
  auto kern = R >= 4 ? &lstm_fwd_chain_kernel<T, 4>
              : R >= 2 ? &lstm_fwd_chain_kernel<T, 2>
                       : &lstm_fwd_chain_kernel<T, 1>;
  return fwd_chain_launch<LstmCell, T, T>(kern, xp, 4 * H, 0, 0, wh, wh,
                                          lens, y, cst, y, cst, state, 1, 0,
                                          steps, steps, B, H, C, R, reverse,
                                          stream);
}

}  // namespace

extern "C" {

// the most batch rows one launch takes at H units on the current device
// (0: not one), or a negative CUDA error code; nothing is launched
int lstm_fwd_max_rows_f32(int H) { return max_rows_of<float>(H); }
int lstm_fwd_max_rows_bf16(int H) { return max_rows_of<__nv_bfloat16>(H); }

// the opt-in shared memory of one block on the current device, in bytes
// (K5's plan sizes its clusters by it), or a negative CUDA error code
int lstm_fwd_smem_optin(void) { return smem_optin_bytes(); }

// the cooperative route.  hbuf: [2 parities][B][H] f32, parity 0 zeroed
// by the caller
int lstm_fwd_f32(const void* xp, const void* wh, const void* lens, void* y,
                 void* cst, void* hbuf, int steps, int B, int H, int reverse,
                 void* stream) {
  return launch<float>(xp, wh, lens, y, cst, hbuf, steps, B, H, reverse,
                       stream);
}

int lstm_fwd_bf16(const void* xp, const void* wh, const void* lens, void* y,
                  void* cst, void* hbuf, int steps, int B, int H, int reverse,
                  void* stream) {
  return launch<__nv_bfloat16>(xp, wh, lens, y, cst, hbuf, steps, B, H,
                               reverse, stream);
}

// the cluster route: C CTAs per cluster (a power of two <= 16), R rows
// per cluster; state [2 (h, c)][B][H] f32 zeroed by the caller
int lstm_fwd_chain_f32(const void* xp, const void* wh, const void* lens,
                       void* y, void* cst, void* state, int steps, int B,
                       int H, int C, int R, int reverse, void* stream) {
  return chain_launch<float>(xp, wh, lens, y, cst, state, steps, B, H, C, R,
                             reverse, stream);
}

int lstm_fwd_chain_bf16(const void* xp, const void* wh, const void* lens,
                        void* y, void* cst, void* state, int steps, int B,
                        int H, int C, int R, int reverse, void* stream) {
  return chain_launch<__nv_bfloat16>(xp, wh, lens, y, cst, state, steps, B,
                                     H, C, R, reverse, stream);
}

const char* kctpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
