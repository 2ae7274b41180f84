// K2 and K10a: the forward recurrence of one bidirectional LSTM layer,
// from the hoisted projection (K2) or with the input projection computed
// by the kernels (K10a).
//
// Replaces kaldi_ctc_tpu/ops/rnn_pallas.py::_bilstm_seq_fwd (kernel body
// _bifwd_kernel; K2) and ::_bilstm_seq_fwd_proj (kernel body
// _bifwd_proj_kernel; K10a).  K2's input is the hoisted projection xp
// [T, B, 8H] in the compute dtype (forward direction's 4H first, gate
// order i, f, g, o).  K10a's is the layer input x [T, B, D] with W_x
// [D, 8H] in the compute dtype and the bias [8H] in f32: the projection
// of each frame is x[t] . W_x-half + bias-half with f32 sums, rounded to
// the compute dtype (project() of csrc/bilstm_cell.cuh), so it equals
// the hoisted projection K2 would have read.  Both take the recurrent
// weights w_h_f / w_h_b [H, 4H] and the lengths [B].  Both directions
// advance together: step s moves the forward direction at t = s and the
// backward direction at t = T-1-s.
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
// the TPU kernel kept it whole in VMEM.
//
// K2's design: two routes, chosen by the wrapper's plan from the shapes
// (ops/rnn_cuda.py::fwd_chain_plan):
//   - the cluster route, wherever W_h fits a cluster of at most 16 CTAs
//     (H up to ~470 in f32, ~670 in bf16): bilstm_xp_chain_kernel, the
//     forward chain of csrc/fwd_chain.cuh with both directions, reading
//     xp directly.  Rows never meet, so each cluster of C CTAs walks one
//     direction of a group of R rows with W_h in distributed shared
//     memory and one cluster barrier a step: no grid barrier, any B.  Its
//     name is its own (not bilstm_fwd_chain_kernel, K10a's phase 2, which
//     in f32 would be the same template instance), so a trace tells K2
//     from K10a.  Where a backward is recorded (training) it also keeps
//     the recurrent sums of every step, f32, in K3's walk order
//     (fwd_chain.cuh says how), and K3's cluster route reads them instead
//     of recomputing them; inference passes null and stores nothing;
//   - the cooperative route above that: bilstm_fwd_kernel, ONE
//     cooperative launch per layer.  The grid covers both directions: each block owns hs hidden
//     units of one direction and keeps those units' four gate columns of
//     W_h in shared memory for the whole sequence (as f32, transposed so
//     the lanes of a warp read consecutive k), and their cell state c in
//     shared memory too.  Each step a block reads h[t-1] of its direction
//     from a double-buffered f32 exchange in global memory (L2-resident;
//     read with ld.global.cg so a stale L1 line is never seen), computes
//     its 4*hs gate sums with warp-split dot products, does the gate
//     math, writes y, c and its slice of h[t], and the grid meets at one
//     grid.sync() per step.  The double buffer makes one barrier per step
//     enough: step s reads parity s&1 and writes parity (s+1)&1.  h[t-1]
//     is staged in tiles of bt rows (bt = B whenever B rows fit shared
//     memory), so the kernel takes any batch.  hs is chosen so that the
//     grid fits the card in one wave; the host checks co-residency before
//     launching.
// Both sum in warp_dot's order (csrc/bilstm_cell.cuh), the order K3's
// cooperative route recomputes the gates in, and do the gate math of one
// function (LstmCell::step of csrc/fwd_chain.cuh): the two routes agree
// bit for bit.
//
// K10a's design: two kernels.  The projection does not depend on the
// recurrence, so it leaves the serial chain:
//   1. bilstm_proj_x_tiled_kernel (or, for D > 426, bilstm_proj_x_kernel)
//      computes every frame's projection at once, parallel over T, into
//      an f32 scratch [S, B, 8H] indexed by time: csrc/lstm_gates.cuh,
//      the same code as K10b's phase 1, so the projection is project()'s
//      bit for bit (the recompute invariant);
//   2. bilstm_fwd_chain_kernel walks both directions' recurrences in
//      thread-block clusters (csrc/fwd_chain.cuh), no grid barrier, any
//      B, reading each step's projection from the scratch.
// A scratch above 256 MiB runs in chunks of S frames a direction (the
// forward direction's chunk k holds t = kS .., the backward direction's
// t = T - (k+1)S ..), h and c carried between them in an f32 state.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "bilstm_cell.cuh"
#include "fwd_chain.cuh"
#include "lstm_gates.cuh"
#include "lstm_wide.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
bilstm_fwd_kernel(const T* __restrict__ xp, const T* __restrict__ whf,
                  const T* __restrict__ whb, const int32_t* __restrict__ lens,
                  T* __restrict__ yf, float* __restrict__ cf,
                  T* __restrict__ yb, float* __restrict__ cb, float* hbuf,
                  int steps, int B, int H, int hs, int bt) {
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

  float* w_s = smem;                 // [4n][H]: column c = gate * n + jj
  float* c_s = w_s + 4 * hs * H;     // [B][n]: cell state
  float* h_s = c_s + B * hs;         // [bt][H]: h[t-1] as the operand
  float* g_s = h_s + bt * H;         // [bt][4n]: gate sums

  for (int i = threadIdx.x; i < n4 * H; i += blockDim.x) {
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
        const float acc = warp_dot(h_s + r * H, w_s + c * H, H, lane);
        if (lane == 0) g_s[o] = acc;
      }
      __syncthreads();
      for (int e = threadIdx.x; e < nr * n; e += blockDim.x) {
        const int r = e / n, jj = e % n, j = j0 + jj, b = r0 + r;
        const float* g = g_s + r * n4;
        const T* x = xp + ((size_t)t * B + b) * 2 * G + dir * G;
        // gate q: the sums and the stored projection, the chain's cell
        float sums[4], xs[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          sums[q] = g[q * n + jj];
          xs[q] = to_f32(x[q * H + j]);
        }
        const float c_prev = c_s[b * n + jj];
        float c_new = c_prev;
        const float h_new = LstmCell::step(sums, xs, c_new);
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

// K2
template <typename T>
int launch(const void* xp, const void* whf, const void* whb,
           const void* lens, void* yf, void* cf, void* yb, void* cb,
           void* hbuf, int steps, int B, int H, void* stream) {
  if (steps <= 0 || B <= 0) return cudaGetLastError();
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
  // the weight columns and every row's cell state stay; the h operand
  // and the gate sums take bt rows at a time
  const size_t fixed = (size_t)4 * hs * H + (size_t)B * hs;
  const size_t per_row = (size_t)H + 4 * hs;
  const size_t room = (size_t)optin / sizeof(float);
  if (room < fixed + per_row) return cudaErrorLaunchOutOfResources;
  const int bt = (int)std::min<size_t>(B, (room - fixed) / per_row);
  const size_t smem = sizeof(float) * (fixed + (size_t)bt * per_row);
  auto kern = bilstm_fwd_kernel<T>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (per_sm * sms < 2 * nb) return cudaErrorCooperativeLaunchTooLarge;

  const T* a_xp = static_cast<const T*>(xp);
  const T* a_whf = static_cast<const T*>(whf);
  const T* a_whb = static_cast<const T*>(whb);
  const int32_t* a_lens = static_cast<const int32_t*>(lens);
  T* a_yf = static_cast<T*>(yf);
  float* a_cf = static_cast<float*>(cf);
  T* a_yb = static_cast<T*>(yb);
  float* a_cb = static_cast<float*>(cb);
  float* a_h = static_cast<float*>(hbuf);
  int a_steps = steps, a_b = B, a_hd = H, a_hs = hs, a_bt = bt;
  void* args[] = {&a_xp, &a_whf, &a_whb, &a_lens, &a_yf, &a_cf, &a_yb,
                  &a_cb, &a_h,   &a_steps, &a_b, &a_hd, &a_hs, &a_bt};
  e = cudaLaunchCooperativeKernel((void*)kern, dim3(2 * nb), dim3(kThreads),
                                  args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K10a phase 1: every frame's projection at once, parallel over T
// ---------------------------------------------------------------------------

// K10a's rows: row r of a chunk is frame t0 + r / B of the direction
// (t0f forward, t0b backward), batch row r % B
template <typename T>
struct FrameRows {
  const T* x;
  int t0f, t0b, B, D;
  __device__ __forceinline__ void operator()(int dir, int r, const T*& xr,
                                             const T*&) const {
    const int t = (dir == 0 ? t0f : t0b) + r / B;
    xr = x + ((size_t)t * B + r % B) * D;
  }
};

template <typename T>
__global__ void __launch_bounds__(kGateThreads)
bilstm_proj_x_kernel(const T* __restrict__ x, const T* __restrict__ wx,
                     const float* __restrict__ bias, float* __restrict__ pre,
                     int t0f, int t0b, int S, int B, int D, int H,
                     int cols) {
  gates_warp_body<T, Sums::kProj>(wx, bias, static_cast<const T*>(nullptr),
                                  static_cast<const T*>(nullptr), pre, S * B,
                                  D, H, 4, 2, cols,
                                  FrameRows<T>{x, t0f, t0b, B, D});
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads, 1)
bilstm_proj_x_tiled_kernel(const T* __restrict__ x,
                           const T* __restrict__ wx,
                           const float* __restrict__ bias,
                           float* __restrict__ pre, int t0f, int t0b, int S,
                           int B, int D, int H) {
  gates_tiled_body<T, Sums::kProj>(wx, bias, static_cast<const T*>(nullptr),
                                   static_cast<const T*>(nullptr), pre,
                                   S * B, D, H, 4, 2,
                                   FrameRows<T>{x, t0f, t0b, B, D});
}

// cols 0: the tiled kernel; 1..32: the warp kernel with that many gate
// columns a block
template <typename T>
int proj_x_launch(const void* x, const void* wx, const void* bias,
                  void* pre, int t0f, int t0b, int S, int steps, int B,
                  int D, int H, int cols, void* stream) {
  if (S <= 0 || B <= 0) return cudaGetLastError();
  if (t0f < 0 || t0b < 0 || t0f + S > steps || t0b + S > steps || D <= 0 ||
      H <= 0 || cols < 0 || cols > kMaxGateCols)
    return cudaErrorInvalidValue;
  const long long rows = (long long)S * B;
  const T* a_x = static_cast<const T*>(x);
  const T* a_wx = static_cast<const T*>(wx);
  const float* a_bias = static_cast<const float*>(bias);
  float* a_pre = static_cast<float*>(pre);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int sms = 0;
  if (cols == 0) {
    auto kern = bilstm_proj_x_tiled_kernel<T>;
    const size_t smem = gates_tiled_smem(D, 0);
    cudaError_t e = gates_prepare((const void*)kern, smem, &sms);
    if (e != cudaSuccess) return e;
    kern<<<gates_tiled_grid(rows, 4 * H, 2, sms), kTileThreads, smem, st>>>(
        a_x, a_wx, a_bias, a_pre, t0f, t0b, S, B, D, H);
  } else {
    auto kern = bilstm_proj_x_kernel<T>;
    const size_t smem = gates_smem(cols, D, 0);
    cudaError_t e = gates_prepare((const void*)kern, smem, &sms);
    if (e != cudaSuccess) return e;
    kern<<<gates_warp_grid(rows, 4 * H, 2, cols), kGateThreads, smem, st>>>(
        a_x, a_wx, a_bias, a_pre, t0f, t0b, S, B, D, H, cols);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K10a phase 2: both directions' recurrences in thread-block clusters
// ---------------------------------------------------------------------------

template <typename T, int RT>
__global__ void __launch_bounds__(kChainFwdThreads)
bilstm_fwd_chain_kernel(const float* pre, int pre_stride, int t0f, int t0b,
                        const T* whf, const T* whb, const int32_t* lens,
                        T* yf, float* cf, T* yb, float* cb, float* state,
                        int dirs, int s0, int S, int steps, int B, int H,
                        int R, int reverse) {
  fwd_chain_body<LstmCell, T, float, RT>(pre, pre_stride, t0f, t0b, whf,
                                         whb, lens, yf, cf, yb, cb, state,
                                         dirs, s0, S, steps, B, H, R,
                                         reverse, nullptr);
}

template <typename T>
int chain_launch(const void* pre, const void* whf, const void* whb,
                 const void* lens, void* yf, void* cf, void* yb, void* cb,
                 void* state, int s0, int S, int steps, int B, int H, int C,
                 int R, void* stream) {
  // the forward direction's chunk starts at t = s0, the backward's ends
  // at t = T-1-s0; the scratch holds both directions' S frames in order
  const int t0f = s0, t0b = steps - s0 - S;
  auto kern = R >= 4 ? &bilstm_fwd_chain_kernel<T, 4>
              : R >= 2 ? &bilstm_fwd_chain_kernel<T, 2>
                       : &bilstm_fwd_chain_kernel<T, 1>;
  return fwd_chain_launch<LstmCell, T, float>(kern, pre, 8 * H, t0f, t0b,
                                              whf, whb, lens, yf, cf, yb, cb,
                                              state, 2, s0, S, steps, B, H,
                                              C, R, 0, stream);
}

// ---------------------------------------------------------------------------
// K2's cluster route: both directions' recurrences on xp
// ---------------------------------------------------------------------------

// kStore: keep the recurrent sums in `sums` for K3
template <typename T, int RT, bool kStore>
__global__ void __launch_bounds__(kChainFwdThreads)
bilstm_xp_chain_kernel(const T* pre, int pre_stride, int t0f, int t0b,
                       const T* whf, const T* whb, const int32_t* lens, T* yf,
                       float* cf, T* yb, float* cb, float* state, int dirs,
                       int s0, int S, int steps, int B, int H, int R,
                       int reverse, float* sums) {
  fwd_chain_body<LstmCell, T, T, RT, kStore>(
      pre, pre_stride, t0f, t0b, whf, whb, lens, yf, cf, yb, cb, state, dirs,
      s0, S, steps, B, H, R, reverse, sums);
}

template <typename T, bool kStore>
auto xp_chain_kernel(int R) {
  return R >= 4 ? &bilstm_xp_chain_kernel<T, 4, kStore>
         : R >= 2 ? &bilstm_xp_chain_kernel<T, 2, kStore>
                  : &bilstm_xp_chain_kernel<T, 1, kStore>;
}

template <typename T>
int xp_chain_launch(const void* xp, const void* whf, const void* whb,
                    const void* lens, void* yf, void* cf, void* yb, void* cb,
                    void* state, void* sums, int steps, int B, int H, int C,
                    int R, void* stream) {
  auto kern = sums != nullptr ? xp_chain_kernel<T, true>(R)
                              : xp_chain_kernel<T, false>(R);
  return fwd_chain_launch<LstmCell, T, T>(kern, xp, 8 * H, 0, 0, whf, whb,
                                          lens, yf, cf, yb, cb, state, 2, 0,
                                          steps, steps, B, H, C, R, 0,
                                          stream, static_cast<float*>(sums));
}

// ---------------------------------------------------------------------------
// K2's wide route: W_h from L2 every step (csrc/lstm_wide.cuh)
// ---------------------------------------------------------------------------

// bytes of a wide forward block's shared memory at H units: per half, two
// buffers of one leaf's h rows and W_h columns (ceil(H/32) terms of 64
// floats each), and the right half's sums handed to the left
inline size_t wide_fwd_bytes(int H) {
  const size_t terms = (H + 31) / 32;
  return sizeof(float) * (2 * 2 * 2 * terms * 64 + kWideHalf * 16);
}

// One block per (direction, kWideUnits units); both directions in one
// cooperative grid, one grid.sync() a step.  Inputs as K2's other routes,
// and
//   wp: W_h of both directions as f32, [2][nb][32 lanes][J][64]: block
//       blk's column 4 jj + q is gate q of unit blk * 16 + jj, term j of
//       lane l is row k = l + 32 j (zeros past H);
//   hx: h as the next step's operand, f32 rounded to T, [2 parities][2
//       directions][32 lanes][J][Bp] (unit k at lane k % 32, term k / 32;
//       Bp = B rounded up to kWideRows), zeroed by the caller; it is also
//       the carry of h over pad frames.
// Each step, for each tile of 64 rows, the block's two halves stream the
// 16 leaves of their half of warp_dot's tree, double-buffered by
// cp.async; the left half adds the right half's sums and does the gate
// math of its 4 rows x 1 unit a thread (LstmCell::step, c carried in the
// c output itself), writes y, c and the next h, and with kStore the
// recurrent sums in K3's walk order (row steps-1-s), as the cluster route.
template <typename T, bool kStore>
__global__ void __launch_bounds__(kWideThreads, 1)
bilstm_wide_chain_fwd_kernel(const T* __restrict__ xp,
                             const float* __restrict__ wp,
                             const int32_t* __restrict__ lens,
                             T* __restrict__ yf, float* __restrict__ cf,
                             T* __restrict__ yb, float* __restrict__ cb,
                             float* hx, float* __restrict__ sums, int steps,
                             int B, int H) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 wide_smem[];
  float* smem = reinterpret_cast<float*>(wide_smem);
  const int J = (H + 31) / 32;
  const int nb = (H + kWideUnits - 1) / kWideUnits;
  const int dir = blockIdx.x / nb, blk = blockIdx.x % nb;
  const int Bp = (B + kWideRows - 1) / kWideRows * kWideRows;
  const int G = 4 * H;
  const int half = threadIdx.x / kWideHalf;
  const int tid = threadIdx.x % kWideHalf;
  const int lane = tid & 31, warp = tid >> 5;
  // a warp: 4 row groups x 8 units (its h loads 64 bytes, its W_h 128)
  const int tr = (warp >> 1) * 4 + (lane >> 3);   // rows 4 tr .. 4 tr + 3
  const int tc = (warp & 1) * 8 + (lane & 7);     // unit tc, columns 4 tc + q
  const int j = blk * kWideUnits + tc;
  const size_t chunk = (size_t)J * 64;
  float* buf = smem + half * 2 * 2 * chunk;       // [2 buffers][h | W_h]
  float* right = smem + 2 * 2 * 2 * chunk;        // [256][16]
  const float* wblk = wp + ((size_t)dir * nb + blk) * 32 * chunk;
  const size_t hsize = (size_t)32 * J * Bp;       // one parity, direction
  const size_t hslot = ((size_t)(j & 31) * J + (j >> 5)) * Bp;
  T* y = dir == 0 ? yf : yb;
  float* cst = dir == 0 ? cf : cb;

  for (int s = 0; s < steps; ++s) {
    const int t = dir == 0 ? s : steps - 1 - s;
    const int tp = dir == 0 ? t - 1 : t + 1;
    const float* h_cur = hx + ((size_t)(s & 1) * 2 + dir) * hsize;
    float* h_next = hx + ((size_t)((s + 1) & 1) * 2 + dir) * hsize;
    for (int r0 = 0; r0 < B; r0 += kWideRows) {
      // leaf i of this half into buffer i & 1
      auto fetch = [&](int i) {
        const int l = leaf_lane(half * 16 + i);
        float* a = buf + (i & 1) * 2 * chunk;
        const float* ha = h_cur + (size_t)l * J * Bp + r0;
        const float* wb = wblk + (size_t)l * chunk;
        for (int q = tid; q < J * 16; q += kWideHalf) {
          const int k = q >> 4, o = (q & 15) * 4;
          cp_async16(a + k * 64 + o, ha + (size_t)k * Bp + o);
          cp_async16(a + chunk + k * 64 + o, wb + k * 64 + o);
        }
        cp_async_commit();
      };
      LeafTree4x4 tree;
      fetch(0);
      for (int i = 0; i < 16; ++i) {
        if (i + 1 < 16) {
          fetch(i + 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        half_sync(half);
        const float* a = buf + (i & 1) * 2 * chunk;
        tree.leaf(a + 4 * tr, a + chunk + 4 * tc, 64,
                  leaf_terms(leaf_lane(half * 16 + i), H));
        tree.close(i);
        half_sync(half);   // the buffer is refilled two leaves on
      }
      if (half == 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) right[tid * 16 + i * 4 + q] = tree.v[i][q];
      }
      __syncthreads();
      if (half == 0 && j < H) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int b = r0 + 4 * tr + i;
          if (b >= B) break;
          // the root: the left half plus the right
          float sums4[4], xs[4];
          const T* x = xp + ((size_t)t * B + b) * 2 * G + dir * G;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            sums4[q] = tree.v[i][q] + right[tid * 16 + i * 4 + q];
            xs[q] = to_f32(x[q * H + j]);
          }
          const size_t o = ((size_t)t * B + b) * H + j;
          const float c_prev =
              s == 0 ? 0.0f : cst[((size_t)tp * B + b) * H + j];
          float c_new = c_prev;
          const float h_new = LstmCell::step(sums4, xs, c_new);
          const bool valid = t < lens[b];
          const float h_prev = __ldcg(h_cur + hslot + b);
          __stcg(h_next + hslot + b,
                 valid ? to_f32(from_f32<T>(h_new)) : h_prev);
          y[o] = from_f32<T>(valid ? h_new : 0.0f);
          cst[o] = valid ? c_new : c_prev;
          if (kStore) {
            float* row = sums + ((size_t)(steps - 1 - s) * B + b) * 2 * G +
                         dir * G;
#pragma unroll
            for (int q = 0; q < 4; ++q) __stcs(row + q * H + j, sums4[q]);
          }
        }
      }
      __syncthreads();   // `right` and the buffers serve the next tile
    }
    grid.sync();
  }
}

template <typename T>
int wide_launch(const void* xp, const void* wp, const void* lens, void* yf,
                void* cf, void* yb, void* cb, void* hx, void* sums,
                int steps, int B, int H, void* stream) {
  if (steps <= 0 || B <= 0) return cudaGetLastError();
  if (H <= 0) return cudaErrorInvalidValue;
  int dev = 0, sms = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return cudaErrorNotSupported;
  const int nb = (H + kWideUnits - 1) / kWideUnits;
  const size_t smem = wide_fwd_bytes(H);
  auto kern = sums != nullptr ? bilstm_wide_chain_fwd_kernel<T, true>
                              : bilstm_wide_chain_fwd_kernel<T, false>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                    kWideThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm * sms < 2 * nb) return cudaErrorCooperativeLaunchTooLarge;
  const T* a_xp = static_cast<const T*>(xp);
  const float* a_wp = static_cast<const float*>(wp);
  const int32_t* a_lens = static_cast<const int32_t*>(lens);
  T* a_yf = static_cast<T*>(yf);
  float* a_cf = static_cast<float*>(cf);
  T* a_yb = static_cast<T*>(yb);
  float* a_cb = static_cast<float*>(cb);
  float* a_hx = static_cast<float*>(hx);
  float* a_sums = static_cast<float*>(sums);
  int a_steps = steps, a_b = B, a_h = H;
  void* args[] = {&a_xp, &a_wp, &a_lens, &a_yf, &a_cf, &a_yb,
                  &a_cb, &a_hx, &a_sums, &a_steps, &a_b, &a_h};
  e = cudaLaunchCooperativeKernel((void*)kern, dim3(2 * nb),
                                  dim3(kWideThreads), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K2's cooperative route.  hbuf: [2 parities][2 directions][B][H] f32,
// parity 0 zeroed by the caller
int bilstm_fwd_f32(const void* xp, const void* whf, const void* whb,
                   const void* lens, void* yf, void* cf, void* yb, void* cb,
                   void* hbuf, int steps, int B, int H, void* stream) {
  return launch<float>(xp, whf, whb, lens, yf, cf, yb, cb, hbuf, steps, B,
                       H, stream);
}

int bilstm_fwd_bf16(const void* xp, const void* whf, const void* whb,
                    const void* lens, void* yf, void* cf, void* yb, void* cb,
                    void* hbuf, int steps, int B, int H, void* stream) {
  return launch<__nv_bfloat16>(xp, whf, whb, lens, yf, cf, yb, cb, hbuf,
                               steps, B, H, stream);
}

// K2's cluster route: xp [T, B, 8H] and w_h_f, w_h_b [H, 4H] in the
// compute dtype, lens [B] int32 -> y_f, y_b [T, B, H] in the compute dtype
// and c_f, c_b [T, B, H] f32; state [2][2][B][H] f32 zeroed by the caller.
// sums: null, or [T, B, 8H] f32 for the recurrent sums of every step in
// the backward's walk order (row s: the forward direction's at t = T-1-s,
// the backward direction's at t = s), which K3's cluster route reads.
// C CTAs per cluster (a power of two <= 16), R rows per cluster.
int bilstm_xp_chain_f32(const void* xp, const void* whf, const void* whb,
                        const void* lens, void* yf, void* cf, void* yb,
                        void* cb, void* state, void* sums, int steps, int B,
                        int H, int C, int R, void* stream) {
  return xp_chain_launch<float>(xp, whf, whb, lens, yf, cf, yb, cb, state,
                                sums, steps, B, H, C, R, stream);
}

int bilstm_xp_chain_bf16(const void* xp, const void* whf, const void* whb,
                         const void* lens, void* yf, void* cf, void* yb,
                         void* cb, void* state, void* sums, int steps, int B,
                         int H, int C, int R, void* stream) {
  return xp_chain_launch<__nv_bfloat16>(xp, whf, whb, lens, yf, cf, yb, cb,
                                        state, sums, steps, B, H, C, R,
                                        stream);
}

// the opt-in shared memory of one block on the current device, in bytes
// (K2's and K10a's plans size their kernels by it), or a negative CUDA
// error code
int bilstm_fwd_smem_optin(void) { return smem_optin_bytes(); }

// K10a phase 1 over S frames a direction of `steps`: x [T, B, D] and wx
// [D, 8H] in the compute dtype, bias [8H] f32 -> pre [S, B, 8H] f32, row
// i holding the forward direction's projection at t = t0f + i and the
// backward direction's at t = t0b + i; `cols` 0 for the tiled kernel
// (D <= 426), else gate columns a block of the warp kernel (at most 32)
int bilstm_proj_x_f32(const void* x, const void* wx, const void* bias,
                      void* pre, int t0f, int t0b, int S, int steps, int B,
                      int D, int H, int cols, void* stream) {
  return proj_x_launch<float>(x, wx, bias, pre, t0f, t0b, S, steps, B, D, H,
                              cols, stream);
}

int bilstm_proj_x_bf16(const void* x, const void* wx, const void* bias,
                       void* pre, int t0f, int t0b, int S, int steps, int B,
                       int D, int H, int cols, void* stream) {
  return proj_x_launch<__nv_bfloat16>(x, wx, bias, pre, t0f, t0b, S, steps,
                                      B, D, H, cols, stream);
}

// K10a phase 2 over walk steps s0 .. s0+S-1 of `steps`: pre from phase 1
// (t0f = s0, t0b = steps - s0 - S), w_h_f, w_h_b [H, 4H] in the compute
// dtype, lens [B] int32 -> y_f, y_b [T, B, H] in the compute dtype and
// c_f, c_b [T, B, H] f32 at those steps' frames; state [2][2][B][H] f32
// holds h and c (per direction) on entry and, unless the walk ends here,
// on exit.  C CTAs per cluster (a power of two <= 16), R rows per cluster.
int bilstm_fwd_chain_f32(const void* pre, const void* whf, const void* whb,
                         const void* lens, void* yf, void* cf, void* yb,
                         void* cb, void* state, int s0, int S, int steps,
                         int B, int H, int C, int R, void* stream) {
  return chain_launch<float>(pre, whf, whb, lens, yf, cf, yb, cb, state, s0,
                             S, steps, B, H, C, R, stream);
}

int bilstm_fwd_chain_bf16(const void* pre, const void* whf, const void* whb,
                          const void* lens, void* yf, void* cf, void* yb,
                          void* cb, void* state, int s0, int S, int steps,
                          int B, int H, int C, int R, void* stream) {
  return chain_launch<__nv_bfloat16>(pre, whf, whb, lens, yf, cf, yb, cb,
                                     state, s0, S, steps, B, H, C, R,
                                     stream);
}

// K2's wide route (csrc/lstm_wide.cuh), where W_h fits neither route
// above: xp [T, B, 8H] in the compute dtype, wp [2][nb][32][J][64] f32
// (W_h of both directions in the wide layout: ops/rnn_cuda.py::
// _wide_weights), lens [B] int32 -> y_f, y_b [T, B, H] in the compute
// dtype and c_f, c_b [T, B, H] f32; hx [2][2][32][J][Bp] f32 zeroed by
// the caller (J = ceil(H/32), Bp = B rounded up to 64); sums as the
// cluster route's (null: nothing stored).  One launch for any B.
int bilstm_wide_fwd_f32(const void* xp, const void* wp, const void* lens,
                        void* yf, void* cf, void* yb, void* cb, void* hx,
                        void* sums, int steps, int B, int H, void* stream) {
  return wide_launch<float>(xp, wp, lens, yf, cf, yb, cb, hx, sums, steps,
                            B, H, stream);
}

int bilstm_wide_fwd_bf16(const void* xp, const void* wp, const void* lens,
                         void* yf, void* cf, void* yb, void* cb, void* hx,
                         void* sums, int steps, int B, int H, void* stream) {
  return wide_launch<__nv_bfloat16>(xp, wp, lens, yf, cf, yb, cb, hx, sums,
                                    steps, B, H, stream);
}

// the wide route's shared memory a block at H units, in bytes
int bilstm_wide_fwd_smem(int H) { return (int)wide_fwd_bytes(H); }

const char* kctpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
