// K9a and K8a: the forward recurrence of a GRU, one direction (K9a) or
// both directions of a bidirectional layer in one launch (K8a).
//
// Replaces kaldi_ctc_tpu/ops/gru_pallas.py::gru_seq_fwd (kernel body
// _fwd_kernel; K9a) and ::_bigru_seq_fwd (kernel body _bifwd_kernel;
// K8a).  Input is the hoisted projection in the compute dtype, gate order
// r, z, n: x_proj [T, B, 3H] for one direction, xp [T, B, 6H] (forward
// direction's 3H first) for both; the recurrent weights w_h [H, 3H] of
// each direction in the compute dtype, and the lengths [B].  K9a walks
// t = 0 .. T-1, or T-1 .. 0 with reverse = 1; K8a's step s moves the
// forward direction at t = s and the backward direction at t = T-1-s.
// The cell is the linear-before-reset GRU of _gru_gates:
//   (hr, hz, hn) = h . W_h   (h rounded to the compute dtype, f32 sums)
//   r = sigmoid(xr + hr), z = sigmoid(xz + hz), n = tanh(xn + r * hn)
//   h' = (1 - z) * n + z * h (the carry h in f32).
// There is no recurrent bias.  A frame t >= lens[b] carries h and writes
// y = 0.  Output: y [T, B, H] of each direction in the compute dtype (and
// K8a's optional recurrent sums, below); K9b and K8b's cooperative route
// recompute the gates from y.
//
// What bounds it on the H100: the T serial steps.  A step is B GEMVs of
// H x 3H = 307,200 MACs per direction at H = 320: a few microseconds of
// latency (read h, reduce, gate math, barrier) and almost no work for 132
// SMs.  W_h is 320 x 960 (1.2 MB in f32) per direction, far more than one
// block's 227 KB of shared memory.
//
// K9a and K8a have two routes each, chosen by the wrapper's plan from the
// shapes (ops/rnn_cuda.py::fwd_chain_plan with three gates and one or two
// directions):
//   - the cluster route, wherever W_h's three gate columns fit a cluster
//     of at most 16 CTAs (H up to ~545 in f32, ~770 in bf16):
//     gru_fwd_chain_kernel (K9a) or bigru_fwd_chain_kernel (K8a, both
//     directions; its own name, so a trace tells it from K9a), the
//     forward chain of csrc/fwd_chain.cuh with the GRU cell (GruCell:
//     three sums a unit, the f32 carry h as the cell's state), reading
//     x_proj or xp directly.  Rows never meet, so each cluster of C CTAs
//     walks one direction of a group of R rows with W_h in distributed
//     shared memory and one cluster barrier a step: no grid barrier, any
//     B.  Where a backward is recorded (training) K8a also keeps the
//     recurrent sums of every step, f32, in K8b's walk order (csrc/
//     fwd_chain.cuh says how), and K8b's cluster route reads them instead
//     of recomputing them; inference passes null and stores nothing;
//   - the cooperative route above that: gru_fwd_kernel (K9a) or
//     bigru_fwd_kernel (K8a), below.
//
// The cooperative design: K2's (csrc/bilstm_fwd.cu) with three gate
// columns per unit.  One cooperative launch: each block owns hs hidden
// units of one direction and keeps those units' three gate columns of W_h
// in shared memory for the whole sequence (as f32, transposed so the
// lanes of a warp read consecutive k).  The n gate needs hn apart from
// xn, so the block keeps all three recurrent sums of its units (3*hs per
// row) rather than one fused pre-activation.  Each step a block reads h
// from a double-buffered f32 exchange in global memory (L2-resident,
// ld.global.cg so a stale L1 line is never seen), computes its 3*hs sums
// per row with warp-split dot products, does the gate math, writes y and
// its slice of the next h, and the grid meets at one grid.sync() per
// step: step s reads parity s&1 and writes parity (s+1)&1.  hs =
// ceil(dirs * H / SMs) puts the grid in one wave (107 blocks of 3 units
// at H = 320 for one direction, 128 blocks of 5 for two); the host checks
// co-residency before launching.  Every row's h stays in shared memory,
// so a launch takes at most gru_fwd_max_rows(H) rows (~167 at H = 320;
// bigru_fwd_max_rows ~159); the wrapper runs a larger batch as row
// slices.
//
// Every route sums in warp_dot's order (csrc/bilstm_cell.cuh), the order
// K9b and K8b's cooperative route recompute the sums in, and does the gate
// math of one function, gru_cell() of csrc/fwd_chain.cuh: K9a's two
// routes agree bit for bit, and so do K8a's, each direction with K9a's on
// its half of xp.

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

// The recurrence of DIRS directions; block blockIdx.x owns units
// j0 .. j0+n-1 of direction blockIdx.x / nb.  Direction d walks time
// backwards when DIRS == 2 and d == 1, or when DIRS == 1 and reverse.
template <typename T, int DIRS>
__device__ __forceinline__ void gru_fwd_body(
    const T* __restrict__ xp, const T* __restrict__ wh0,
    const T* __restrict__ wh1, const int32_t* __restrict__ lens,
    T* __restrict__ y0, T* __restrict__ y1, float* hbuf, int steps, int B,
    int H, int hs, int reverse) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int nb = (H + hs - 1) / hs;         // blocks per direction
  const int dir = blockIdx.x / nb;
  const int j0 = (blockIdx.x % nb) * hs;
  const int n = min(hs, H - j0);            // hidden units this block owns
  const int n3 = 3 * n;
  const int G = 3 * H;
  const bool rev = DIRS == 2 ? dir == 1 : reverse != 0;
  const T* wh = dir == 0 ? wh0 : wh1;
  T* y = dir == 0 ? y0 : y1;

  float* w_s = smem;                 // [3n][H]: column c = gate * n + jj
  float* h_s = w_s + 3 * hs * H;     // [B][H]: h as the matmul operand
  float* g_s = h_s + B * H;          // [B][3n]: recurrent sums hr, hz, hn

  for (int i = threadIdx.x; i < n3 * H; i += blockDim.x) {
    const int c = i / H, k = i % H;
    const int gate = c / n, jj = c % n;
    w_s[i] = to_f32(wh[(size_t)k * G + gate * H + j0 + jj]);
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t hsize = (size_t)B * H;
  for (int s = 0; s < steps; ++s) {
    const int t = rev ? steps - 1 - s : s;
    const float* h_cur = hbuf + ((size_t)(s & 1) * DIRS + dir) * hsize;
    float* h_next = hbuf + ((size_t)((s + 1) & 1) * DIRS + dir) * hsize;
    for (int i = threadIdx.x; i < B * H; i += blockDim.x)
      h_s[i] = to_f32(from_f32<T>(__ldcg(h_cur + i)));
    __syncthreads();
    for (int o = warp; o < B * n3; o += nwarps) {
      const int b = o / n3, c = o % n3;
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
      const T* x = xp + ((size_t)t * B + b) * DIRS * G + dir * G;
      const float* g = g_s + b * n3;
      const float h_prev = __ldcg(h_cur + b * H + j);
      const float h_new = gru_cell(to_f32(x[j]), to_f32(x[H + j]),
                                   to_f32(x[2 * H + j]), g[jj], g[n + jj],
                                   g[2 * n + jj], h_prev);
      const bool valid = t < lens[b];
      __stcg(h_next + b * H + j, valid ? h_new : h_prev);
      y[((size_t)t * B + b) * H + j] = from_f32<T>(valid ? h_new : 0.0f);
    }
    grid.sync();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gru_fwd_kernel(const T* __restrict__ xp, const T* __restrict__ wh0,
               const T* __restrict__ wh1, const int32_t* __restrict__ lens,
               T* __restrict__ y0, T* __restrict__ y1, float* hbuf, int steps,
               int B, int H, int hs, int reverse) {
  gru_fwd_body<T, 1>(xp, wh0, wh1, lens, y0, y1, hbuf, steps, B, H, hs,
                     reverse);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bigru_fwd_kernel(const T* __restrict__ xp, const T* __restrict__ wh0,
                 const T* __restrict__ wh1,
                 const int32_t* __restrict__ lens, T* __restrict__ y0,
                 T* __restrict__ y1, float* hbuf, int steps, int B, int H,
                 int hs, int reverse) {
  gru_fwd_body<T, 2>(xp, wh0, wh1, lens, y0, y1, hbuf, steps, B, H, hs,
                     reverse);
}

// The launch's geometry at B rows of `dirs` directions: hs hidden units
// per block (every direction's blocks in one wave), nb blocks per
// direction and the shared memory in bytes; refuses rows that do not fit
// one block and a grid that is not co-resident.  The launch and the
// *_max_rows queries share it.
template <typename T>
cudaError_t plan(int dirs, int B, int H, int* hs, int* nb, size_t* smem) {
  int dev = 0, sms = 0, coop = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (!coop) return cudaErrorNotSupported;
  *hs = (dirs * H + sms - 1) / sms;
  *nb = (H + *hs - 1) / *hs;
  *smem = sizeof(float) * ((size_t)3 * *hs * H + (size_t)B * H +
                           (size_t)B * 3 * *hs);
  if (*smem > (size_t)optin) return cudaErrorLaunchOutOfResources;
  auto kern = dirs == 2 ? &bigru_fwd_kernel<T> : &gru_fwd_kernel<T>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)*smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                    *smem);
  if (e != cudaSuccess) return e;
  return per_sm * sms < dirs * *nb ? cudaErrorCooperativeLaunchTooLarge
                                   : cudaSuccess;
}

template <typename T>
int max_rows_of(int dirs, int H) {
  if (H <= 0) return -static_cast<int>(cudaErrorInvalidValue);
  return max_rows([dirs, H](int B) {
    int hs = 0, nb = 0;
    size_t smem = 0;
    return plan<T>(dirs, B, H, &hs, &nb, &smem);
  });
}

template <typename T>
int launch(bool bidirectional, const void* xp, const void* wh0,
           const void* wh1, const void* lens, void* y0, void* y1,
           void* hbuf, int steps, int B, int H, int reverse, void* stream) {
  if (steps <= 0 || B <= 0) return cudaGetLastError();
  const int dirs = bidirectional ? 2 : 1;
  int hs = 0, nb = 0;
  size_t smem = 0;
  cudaError_t e = plan<T>(dirs, B, H, &hs, &nb, &smem);
  if (e != cudaSuccess) return e;
  auto kern = bidirectional ? &bigru_fwd_kernel<T> : &gru_fwd_kernel<T>;

  const T* a_xp = static_cast<const T*>(xp);
  const T* a_wh0 = static_cast<const T*>(wh0);
  const T* a_wh1 = static_cast<const T*>(wh1);
  const int32_t* a_lens = static_cast<const int32_t*>(lens);
  T* a_y0 = static_cast<T*>(y0);
  T* a_y1 = static_cast<T*>(y1);
  float* a_h = static_cast<float*>(hbuf);
  int a_steps = steps, a_b = B, a_hd = H, a_hs = hs, a_rev = reverse;
  void* args[] = {&a_xp,    &a_wh0, &a_wh1, &a_lens, &a_y0, &a_y1,
                  &a_h,     &a_steps, &a_b, &a_hd,   &a_hs, &a_rev};
  e = cudaLaunchCooperativeKernel((void*)kern, dim3(dirs * nb),
                                  dim3(kThreads), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// K9a's cluster route: the forward chain with the GRU cell
template <typename T, int RT>
__global__ void __launch_bounds__(kChainFwdThreads)
gru_fwd_chain_kernel(const T* pre, int pre_stride, int t0f, int t0b,
                     const T* whf, const T* whb, const int32_t* lens, T* yf,
                     float* cf, T* yb, float* cb, float* state, int dirs,
                     int s0, int S, int steps, int B, int H, int R,
                     int reverse) {
  fwd_chain_body<GruCell, T, T, RT>(pre, pre_stride, t0f, t0b, whf, whb,
                                    lens, yf, cf, yb, cb, state, dirs, s0, S,
                                    steps, B, H, R, reverse, nullptr);
}

template <typename T>
int chain_launch(const void* xp, const void* wh, const void* lens, void* y,
                 void* state, int steps, int B, int H, int C, int R,
                 int reverse, void* stream) {
  auto kern = R >= 4 ? &gru_fwd_chain_kernel<T, 4>
              : R >= 2 ? &gru_fwd_chain_kernel<T, 2>
                       : &gru_fwd_chain_kernel<T, 1>;
  return fwd_chain_launch<GruCell, T, T>(kern, xp, 3 * H, 0, 0, wh, wh, lens,
                                         y, nullptr, y, nullptr, state, 1, 0,
                                         steps, steps, B, H, C, R, reverse,
                                         stream);
}

// K8a's cluster route: the forward chain with the GRU cell, both
// directions on xp [T, B, 6H] (the forward direction's 3H first); kStore:
// keep the recurrent sums in `sums` for K8b
template <typename T, int RT, bool kStore>
__global__ void __launch_bounds__(kChainFwdThreads)
bigru_fwd_chain_kernel(const T* pre, int pre_stride, int t0f, int t0b,
                       const T* whf, const T* whb, const int32_t* lens,
                       T* yf, float* cf, T* yb, float* cb, float* state,
                       int dirs, int s0, int S, int steps, int B, int H,
                       int R, int reverse, float* sums) {
  fwd_chain_body<GruCell, T, T, RT, kStore>(
      pre, pre_stride, t0f, t0b, whf, whb, lens, yf, cf, yb, cb, state, dirs,
      s0, S, steps, B, H, R, reverse, sums);
}

template <typename T, bool kStore>
auto bichain_kernel(int R) {
  return R >= 4 ? &bigru_fwd_chain_kernel<T, 4, kStore>
         : R >= 2 ? &bigru_fwd_chain_kernel<T, 2, kStore>
                  : &bigru_fwd_chain_kernel<T, 1, kStore>;
}

template <typename T>
int bichain_launch(const void* xp, const void* whf, const void* whb,
                   const void* lens, void* yf, void* yb, void* state,
                   void* sums, int steps, int B, int H, int C, int R,
                   void* stream) {
  auto kern = sums != nullptr ? bichain_kernel<T, true>(R)
                              : bichain_kernel<T, false>(R);
  return fwd_chain_launch<GruCell, T, T>(kern, xp, 6 * H, 0, 0, whf, whb,
                                         lens, yf, nullptr, yb, nullptr,
                                         state, 2, 0, steps, steps, B, H, C,
                                         R, 0, stream,
                                         static_cast<float*>(sums));
}

}  // namespace

extern "C" {

// the most batch rows one launch of K9a (gru_*) or K8a (bigru_*) takes at
// H units on the current device (0: not one), or a negative CUDA error
// code; nothing is launched
int gru_fwd_max_rows_f32(int H) { return max_rows_of<float>(1, H); }
int gru_fwd_max_rows_bf16(int H) {
  return max_rows_of<__nv_bfloat16>(1, H);
}
int bigru_fwd_max_rows_f32(int H) { return max_rows_of<float>(2, H); }
int bigru_fwd_max_rows_bf16(int H) {
  return max_rows_of<__nv_bfloat16>(2, H);
}

// the opt-in shared memory of one block on the current device, in bytes
// (K9a's and K8a's plans size their clusters by it), or a negative CUDA
// error code
int gru_fwd_smem_optin(void) { return smem_optin_bytes(); }

// K9a's cooperative route.  hbuf: [2 parities][B][H] f32, parity 0 zeroed
// by the caller
int gru_fwd_f32(const void* xp, const void* wh, const void* lens, void* y,
                void* hbuf, int steps, int B, int H, int reverse,
                void* stream) {
  return launch<float>(false, xp, wh, wh, lens, y, y, hbuf, steps, B, H,
                       reverse, stream);
}

int gru_fwd_bf16(const void* xp, const void* wh, const void* lens, void* y,
                 void* hbuf, int steps, int B, int H, int reverse,
                 void* stream) {
  return launch<__nv_bfloat16>(false, xp, wh, wh, lens, y, y, hbuf, steps,
                               B, H, reverse, stream);
}

// K9a's cluster route: C CTAs per cluster (a power of two <= 16), R rows
// per cluster; state [2 (h, h)][B][H] f32 zeroed by the caller (the
// operand's h and the cell's f32 carry)
int gru_fwd_chain_f32(const void* xp, const void* wh, const void* lens,
                      void* y, void* state, int steps, int B, int H, int C,
                      int R, int reverse, void* stream) {
  return chain_launch<float>(xp, wh, lens, y, state, steps, B, H, C, R,
                             reverse, stream);
}

int gru_fwd_chain_bf16(const void* xp, const void* wh, const void* lens,
                       void* y, void* state, int steps, int B, int H, int C,
                       int R, int reverse, void* stream) {
  return chain_launch<__nv_bfloat16>(xp, wh, lens, y, state, steps, B, H, C,
                                     R, reverse, stream);
}

// K8a's cluster route: xp [T, B, 6H] and w_h_f, w_h_b [H, 3H] in the
// compute dtype, lens [B] int32 -> y_f, y_b [T, B, H] in the compute
// dtype; state [2 (h, h)][2 directions][B][H] f32 zeroed by the caller (the
// operand's h and the cell's f32 carry).  sums: null, or [T, B, 6H] f32
// for the recurrent sums hr, hz, hn of every step in the backward's walk
// order (row s: the forward direction's at t = T-1-s, the backward
// direction's at t = s), which K8b's cluster route reads.  C CTAs per
// cluster (a power of two <= 16), R rows per cluster.
int bigru_fwd_chain_f32(const void* xp, const void* whf, const void* whb,
                        const void* lens, void* yf, void* yb, void* state,
                        void* sums, int steps, int B, int H, int C, int R,
                        void* stream) {
  return bichain_launch<float>(xp, whf, whb, lens, yf, yb, state, sums,
                               steps, B, H, C, R, stream);
}

int bigru_fwd_chain_bf16(const void* xp, const void* whf, const void* whb,
                         const void* lens, void* yf, void* yb, void* state,
                         void* sums, int steps, int B, int H, int C, int R,
                         void* stream) {
  return bichain_launch<__nv_bfloat16>(xp, whf, whb, lens, yf, yb, state,
                                       sums, steps, B, H, C, R, stream);
}

// K8a's cooperative route.  hbuf: [2 parities][2 directions][B][H] f32,
// parity 0 zeroed by the caller
int bigru_fwd_f32(const void* xp, const void* whf, const void* whb,
                  const void* lens, void* yf, void* yb, void* hbuf,
                  int steps, int B, int H, void* stream) {
  return launch<float>(true, xp, whf, whb, lens, yf, yb, hbuf, steps, B, H,
                       0, stream);
}

int bigru_fwd_bf16(const void* xp, const void* whf, const void* whb,
                   const void* lens, void* yf, void* yb, void* hbuf,
                   int steps, int B, int H, void* stream) {
  return launch<__nv_bfloat16>(true, xp, whf, whb, lens, yf, yb, hbuf,
                               steps, B, H, 0, stream);
}

const char* kctpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
