// K2 and K10a: the forward recurrence of one bidirectional LSTM layer,
// from the hoisted projection (K2) or with the input projection computed
// inside each step (K10a).
//
// Replaces kaldi_ctc_tpu/ops/rnn_pallas.py::_bilstm_seq_fwd (kernel body
// _bifwd_kernel; K2) and ::_bilstm_seq_fwd_proj (kernel body
// _bifwd_proj_kernel; K10a).  K2's input is the hoisted projection xp
// [T, B, 8H] in the compute dtype (forward direction's 4H first, gate
// order i, f, g, o).  K10a's is the layer input x [T, B, D] with W_x
// [D, 8H] in the compute dtype and the bias [8H] in f32: the projection
// of each step is x[t] . W_x-half + bias-half with f32 sums, rounded to
// the compute dtype (project() of csrc/bilstm_cell.cuh), so it equals
// the hoisted projection K2 would have read.  Both take the recurrent
// weights w_h_f / w_h_b [H, 4H] and the lengths [B].  Both directions
// advance in one loop of T steps: step s moves the forward direction at
// t = s and the backward direction at t = T-1-s.
// gates = xp[t] + h[t-1] . W_h with the operand h rounded to the compute
// dtype and f32 accumulation; gate math and the cell state are f32.
// A frame t >= lens[b] carries h and c forward and writes y = 0.
// Outputs: y_f, y_b [T, B, H] in the compute dtype, c_f, c_b [T, B, H]
// in f32 (the cell states training will need).
//
// What bounds it on the H100: the T serial steps.  At serve batch B = 1
// a step is a GEMV of H x 4H = 409,600 MACs per direction at H = 320,
// a few microseconds of latency (read h[t-1], reduce, gate math) but
// almost no work for 132 SMs.  W_h is 320 x 1280 per direction (1.6 MB
// in f32), far above the 227 KB of shared memory one block has, where
// the TPU kernel kept it whole in VMEM.  K10a adds D x 4H MACs per row
// and direction to each step (twice the recurrent work at D = 2H), none
// of which waits on the previous step.
//
// Design: ONE cooperative launch per layer.  The grid covers both
// directions: each block owns hs hidden units of one direction and
// keeps those units' four gate columns of W_h (and, for K10a, of W_x and
// the bias) in shared memory for the whole sequence (as f32, transposed
// so the lanes of a warp read consecutive k), and their cell state c in
// shared memory too.  Each step a block reads h[t-1] of its direction
// from a double-buffered f32 exchange in global memory (L2-resident;
// read with ld.global.cg so a stale L1 line is never seen), computes its
// 4*hs gate sums with warp-split dot products (K10a: each warp's
// projection from x[t] read through L1/L2, so any B fits), does the gate
// math, writes y, c and its slice of h[t], and the grid meets at one
// grid.sync() per step.  The double buffer makes one barrier per step
// enough: step s reads parity s&1 and writes parity (s+1)&1.  h[t-1] is
// staged in tiles of bt rows (bt = B whenever B rows fit shared memory),
// so the kernel takes any batch.  hs is chosen so that the grid fits the
// card in one wave; the host checks co-residency before launching.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "bilstm_cell.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
// K10a's steps hold the projection's D-long sums besides the recurrent
// ones, so it runs twice K2's warps
constexpr int kProjThreads = 512;

template <typename T, bool kProj>
__device__ __forceinline__ void bilstm_fwd_body(
    const T* __restrict__ in, const T* __restrict__ wx,
    const float* __restrict__ bias, const T* __restrict__ whf,
    const T* __restrict__ whb, const int32_t* __restrict__ lens,
    T* __restrict__ yf, float* __restrict__ cf, T* __restrict__ yb,
    float* __restrict__ cb, float* hbuf, int steps, int B, int D, int H,
    int hs, int bt) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int nb = (H + hs - 1) / hs;        // blocks per direction
  const int dir = blockIdx.x / nb;
  const int j0 = (blockIdx.x % nb) * hs;
  const int n = min(hs, H - j0);            // hidden units this block owns
  const int n4 = 4 * n;
  const int G = 4 * H;
  const T* wh = dir == 0 ? whf : whb;
  T* y = dir == 0 ? yf : yb;
  float* cst = dir == 0 ? cf : cb;

  const int wxn = kProj ? 4 * hs * D : 0;
  float* w_s = smem;                 // [4n][H]: column c = gate * n + jj
  float* wx_s = w_s + 4 * hs * H;    // K10a: [4n][D] columns of W_x
  float* b_s = wx_s + wxn;           // K10a: [4n] bias
  float* c_s = b_s + (kProj ? 4 * hs : 0);  // [B][n]: cell state
  float* h_s = c_s + B * hs;         // [bt][H]: h[t-1] as the operand
  float* g_s = h_s + bt * H;         // [bt][4n]: gate sums

  for (int i = threadIdx.x; i < n4 * H; i += blockDim.x) {
    const int c = i / H, k = i % H;
    const int gate = c / n, jj = c % n;
    w_s[i] = to_f32(wh[(size_t)k * G + gate * H + j0 + jj]);
  }
  if constexpr (kProj) {
    for (int i = threadIdx.x; i < n4 * D; i += blockDim.x) {
      const int c = i / D, k = i % D;
      const int gate = c / n, jj = c % n;
      const int col = dir * G + gate * H + j0 + jj;
      wx_s[i] = to_f32(wx[(size_t)k * 2 * G + col]);
    }
    for (int c = threadIdx.x; c < n4; c += blockDim.x)
      b_s[c] = bias[dir * G + (c / n) * H + j0 + c % n];
  }
  for (int i = threadIdx.x; i < B * n; i += blockDim.x) c_s[i] = 0.0f;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t hsize = (size_t)B * H;
  for (int s = 0; s < steps; ++s) {
    const int t = dir == 0 ? s : steps - 1 - s;
    const float* h_cur = hbuf + ((size_t)(s & 1) * 2 + dir) * hsize;
    float* h_next = hbuf + ((size_t)((s + 1) & 1) * 2 + dir) * hsize;
    for (int r0 = 0; r0 < B; r0 += bt) {
      const int nr = min(bt, B - r0);
      const float* h_rows = h_cur + (size_t)r0 * H;
      for (int i = threadIdx.x; i < nr * H; i += blockDim.x)
        h_s[i] = to_f32(from_f32<T>(__ldcg(h_rows + i)));
      __syncthreads();
      for (int o = warp; o < nr * n4; o += nwarps) {
        const int r = o / n4, c = o % n4;
        float acc = warp_dot(h_s + r * H, w_s + c * H, H, lane);
        if constexpr (kProj)
          acc += project(in + ((size_t)t * B + r0 + r) * D, wx_s + c * D,
                         b_s[c], D, lane);
        if (lane == 0) g_s[o] = acc;
      }
      __syncthreads();
      for (int e = threadIdx.x; e < nr * n; e += blockDim.x) {
        const int r = e / n, jj = e % n, j = j0 + jj, b = r0 + r;
        const float* g = g_s + r * n4;
        // pre-activation of gate q: K10a's sums hold the projection, K2
        // adds the stored one
        auto pre = [&](int q) {
          if constexpr (kProj) {
            return g[q * n + jj];
          } else {
            const T* x = in + ((size_t)t * B + b) * 2 * G + dir * G;
            return to_f32(x[q * H + j]) + g[q * n + jj];
          }
        };
        const float gi = sigmoid(pre(0));
        const float gf = sigmoid(pre(1));
        const float gg = tanhf(pre(2));
        const float go = sigmoid(pre(3));
        const float c_prev = c_s[b * n + jj];
        const float c_new = gf * c_prev + gi * gg;
        const float h_new = go * tanhf(c_new);
        const bool valid = t < lens[b];
        const float h_prev = __ldcg(h_cur + b * H + j);
        const float c_out = valid ? c_new : c_prev;
        c_s[b * n + jj] = c_out;
        __stcg(h_next + b * H + j, valid ? h_new : h_prev);
        const size_t o = ((size_t)t * B + b) * H + j;
        y[o] = from_f32<T>(valid ? h_new : 0.0f);
        cst[o] = c_out;
      }
      if (r0 + bt < B) __syncthreads();   // the next tile refills h_s, g_s
    }
    grid.sync();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bilstm_fwd_kernel(const T* __restrict__ xp, const T* __restrict__ whf,
                  const T* __restrict__ whb, const int32_t* __restrict__ lens,
                  T* __restrict__ yf, float* __restrict__ cf,
                  T* __restrict__ yb, float* __restrict__ cb, float* hbuf,
                  int steps, int B, int H, int hs, int bt) {
  bilstm_fwd_body<T, false>(xp, nullptr, nullptr, whf, whb, lens, yf, cf, yb,
                            cb, hbuf, steps, B, 0, H, hs, bt);
}

template <typename T>
__global__ void __launch_bounds__(kProjThreads)
bilstm_proj_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wx,
                       const float* __restrict__ bias,
                       const T* __restrict__ whf, const T* __restrict__ whb,
                       const int32_t* __restrict__ lens, T* __restrict__ yf,
                       float* __restrict__ cf, T* __restrict__ yb,
                       float* __restrict__ cb, float* hbuf, int steps, int B,
                       int D, int H, int hs, int bt) {
  bilstm_fwd_body<T, true>(x, wx, bias, whf, whb, lens, yf, cf, yb, cb, hbuf,
                           steps, B, D, H, hs, bt);
}

// K2 (wx == nullptr: `in` is xp) or K10a (`in` is x, D its width)
template <typename T>
int launch(const void* in, const void* wx, const void* bias, const void* whf,
           const void* whb, const void* lens, void* yf, void* cf, void* yb,
           void* cb, void* hbuf, int steps, int B, int D, int H,
           void* stream) {
  if (steps <= 0 || B <= 0) return cudaGetLastError();
  const bool proj = wx != nullptr;
  int dev = 0, sms = 0, coop = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (!coop) return cudaErrorNotSupported;
  // hidden units per block: both directions' blocks in one wave
  const int hs = (2 * H + sms - 1) / sms;
  const int nb = (H + hs - 1) / hs;
  // the weight columns, the bias and every row's cell state stay; the
  // h operand and the gate sums take bt rows at a time
  const size_t fixed = (size_t)4 * hs * H + (size_t)B * hs +
                       (proj ? (size_t)4 * hs * (D + 1) : 0);
  const size_t per_row = (size_t)H + 4 * hs;
  const size_t room = (size_t)optin / sizeof(float);
  if (room < fixed + per_row) return cudaErrorLaunchOutOfResources;
  const int bt = (int)std::min<size_t>(B, (room - fixed) / per_row);
  const size_t smem = sizeof(float) * (fixed + (size_t)bt * per_row);
  auto k2 = bilstm_fwd_kernel<T>;
  auto k10 = bilstm_proj_fwd_kernel<T>;
  const void* kern = proj ? (const void*)k10 : (const void*)k2;
  const int threads = proj ? kProjThreads : kThreads;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (per_sm * sms < 2 * nb) return cudaErrorCooperativeLaunchTooLarge;

  const T* a_in = static_cast<const T*>(in);
  const T* a_wx = static_cast<const T*>(wx);
  const float* a_bias = static_cast<const float*>(bias);
  const T* a_whf = static_cast<const T*>(whf);
  const T* a_whb = static_cast<const T*>(whb);
  const int32_t* a_lens = static_cast<const int32_t*>(lens);
  T* a_yf = static_cast<T*>(yf);
  float* a_cf = static_cast<float*>(cf);
  T* a_yb = static_cast<T*>(yb);
  float* a_cb = static_cast<float*>(cb);
  float* a_h = static_cast<float*>(hbuf);
  int a_steps = steps, a_b = B, a_d = D, a_hd = H, a_hs = hs, a_bt = bt;
  void* k2_args[] = {&a_in, &a_whf, &a_whb, &a_lens, &a_yf, &a_cf, &a_yb,
                     &a_cb, &a_h, &a_steps, &a_b, &a_hd, &a_hs, &a_bt};
  void* k10_args[] = {&a_in,  &a_wx, &a_bias, &a_whf, &a_whb, &a_lens,
                      &a_yf,  &a_cf, &a_yb,   &a_cb,  &a_h,   &a_steps,
                      &a_b,   &a_d,  &a_hd,   &a_hs,  &a_bt};
  void** args = proj ? static_cast<void**>(k10_args)
                     : static_cast<void**>(k2_args);
  e = cudaLaunchCooperativeKernel(kern, dim3(2 * nb), dim3(threads), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// hbuf: [2 parities][2 directions][B][H] f32, parity 0 zeroed by the caller
int bilstm_fwd_f32(const void* xp, const void* whf, const void* whb,
                   const void* lens, void* yf, void* cf, void* yb, void* cb,
                   void* hbuf, int steps, int B, int H, void* stream) {
  return launch<float>(xp, nullptr, nullptr, whf, whb, lens, yf, cf, yb, cb,
                       hbuf, steps, B, 0, H, stream);
}

int bilstm_fwd_bf16(const void* xp, const void* whf, const void* whb,
                    const void* lens, void* yf, void* cf, void* yb, void* cb,
                    void* hbuf, int steps, int B, int H, void* stream) {
  return launch<__nv_bfloat16>(xp, nullptr, nullptr, whf, whb, lens, yf, cf,
                               yb, cb, hbuf, steps, B, 0, H, stream);
}

// K10a: x [T, B, D] and wx [D, 8H] in the compute dtype, bias [8H] f32;
// hbuf as above
int bilstm_proj_fwd_f32(const void* x, const void* wx, const void* bias,
                        const void* whf, const void* whb, const void* lens,
                        void* yf, void* cf, void* yb, void* cb, void* hbuf,
                        int steps, int B, int D, int H, void* stream) {
  return launch<float>(x, wx, bias, whf, whb, lens, yf, cf, yb, cb, hbuf,
                       steps, B, D, H, stream);
}

int bilstm_proj_fwd_bf16(const void* x, const void* wx, const void* bias,
                         const void* whf, const void* whb, const void* lens,
                         void* yf, void* cf, void* yb, void* cb, void* hbuf,
                         int steps, int B, int D, int H, void* stream) {
  return launch<__nv_bfloat16>(x, wx, bias, whf, whb, lens, yf, cf, yb, cb,
                               hbuf, steps, B, D, H, stream);
}

const char* kctpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
