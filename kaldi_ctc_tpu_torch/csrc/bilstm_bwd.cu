// K3 and K10b: the backward recurrence of one bidirectional LSTM layer
// (dgates), with the gates from the hoisted projection (K3: plus the
// forward's stored recurrent sums on its cluster route, recomputed on its
// cooperative one) or recomputed from the layer input through the
// in-kernel projection (K10b).
//
// Replaces kaldi_ctc_tpu/ops/rnn_pallas.py::_bilstm_seq_bwd_dgates
// (kernel body _bibwd_kernel with _dgates_update and _lstm_gates; K3) and
// ::_bilstm_seq_bwd_dgates_proj (kernel body _bibwd_proj_kernel; K10b).
// Inputs: the output cotangents dy_f, dy_b [T, B, H] and the forward's
// residuals, all as K2 or K10a wrote or read them: K3 the projection xp
// [T, B, 8H] (forward direction's 4H first, gate order i, f, g, o),
// K10b the layer input x [T, B, D], W_x [D, 8H] and the bias [8H] f32;
// y_f, y_b [T, B, H] in the compute dtype, c_f, c_b [T, B, H] f32, the
// recurrent weights w_h_f, w_h_b [H, 4H] and the lengths [B].  Outputs:
// dg_f, dg_b [T, B, 4H] in the compute dtype, the cotangents of the gate
// pre-activations (i, f, g, o), zero at pad frames.
//
// The walk runs each direction's forward order in reverse: step s
// handles the forward direction at t = T-1-s and the backward direction
// at t = s.  At each step it
//   - forms the gates xp[t] + y[t-+1] . W_h: K3's cluster route reads the
//     sums y[t-+1] . W_h that K2 stored while it ran (K2 with the store:
//     ops/rnn_cuda.py::bilstm_layer asks for it where a backward is
//     recorded; an inference forward stores nothing), the very values K2
//     formed the gates from; the
//     cooperative route recomputes them with y[t-+1] as stored (the
//     compute dtype) and zero at the direction's first forward step, f32
//     accumulation in K2's order, so its gates equal the forward's too.
//     K10b takes xp[t] from project() of csrc/bilstm_cell.cuh, K10a's own
//     definition, and recomputes the sums, so its gates equal K10a's bit
//     for bit;
//   - reads c[t] and c[t-+1] (zero at the first forward step);
//   - forms dh_total = dy + dh and dc_total, writes the dgates;
//   - at valid frames carries dh = dgates . W_h^T (dgates rounded to the
//     compute dtype, f32 accumulation) and dc = dc_total * f.
// Gate math, dh, dc and c are f32.
//
// K3.  What bounds it on the H100: the same serial chain as K2, T steps,
// and each step needs the whole previous dgates row [B, 4H] of its
// direction to form dh.  At the training batch B = 48, H = 320 that row
// is 245 KB in f32: more than one block's shared memory.
//
// K3 has two routes, chosen by the wrapper's plan from the shapes
// (ops/rnn_cuda.py::k3_plan, the backward chain's plan with both
// directions):
//   - the cluster route, wherever W_h's four gate columns as f32 fit a
//     cluster of at most 16 CTAs (H up to ~465, either dtype; K2 takes its
//     cluster route there too, to ~470): one kernel,
//     bilstm_bwd_chain_kernel, on the recurrent sums K2's cluster route
//     stored, [T, B, 8H] f32 in this walk's order (row s: the forward
//     direction's sums at t = T-1-s, the backward one's at t = s; csrc/
//     fwd_chain.cuh), read whole in one launch.  It walks the dh/dc chain
//     of both directions in thread-block clusters (the backward chain of
//     csrc/bwd_chain.cuh with LstmBwdCell), adding xp[t] to each sum as
//     the forward chain does, so the gates are K2's bit for bit.  Rows
//     never meet: one cluster of C CTAs per (direction, group of R rows),
//     W_h's gate columns as f32 in distributed shared memory, the partial
//     dh rows exchanged through DSMEM, one cluster barrier a step, no grid
//     barrier, any B.  Its name is its own (not bilstm_proj_chain_kernel,
//     K10b's phase 2, which reads the pre-activation), so a trace tells K3
//     from K10b;
//   - the cooperative route above that: bilstm_bwd_kernel, below.  One
//     cooperative launch per layer, K2's cooperative layout.  Each block
//     owns hs hidden units of one direction and keeps those units' four
//     gate columns of W_h (4*hs x H) in shared memory for the whole walk,
//     with its dh and dc.  The W_h columns serve both products: the gate
//     recompute sums y[b, k] * W_h[k, c] over k for the block's columns
//     c, and the block's share of dh sums dgates[b, c] * W_h[k, c] over
//     its own columns c, for every k.  Blocks exchange those partial dh
//     rows, not dgates: each block writes a [B, H] partial (f32, through
//     L2 with st.global.cg) into a double-buffered array laid out so that
//     the hs units of one owner are contiguous across the writing blocks;
//     after the step's one grid.sync() each block sums the nb partials of
//     its own units (ld.global.cg), in a fixed order.  The rows of
//     y[t-+1], the gate sums and the dgates of all B rows stay in shared
//     memory, so a launch takes at most bilstm_bwd_max_rows(H) rows; the
//     wrapper runs a larger batch as row slices.
// Both routes form the gates from warp_dot's sums (K2's stored ones, or
// recomputed); they carry dh in another order (partials per CTA of a
// cluster, then over the ranks), so they agree bit for bit where dh and dc
// are still zero (each row's first valid walk step) and within tolerance
// elsewhere.
//
// K10b.  The gate recompute depends only on x and the stored y, never on
// the dh/dc recurrence; the only serial chain is dh -> dgates ->
// dgates . W_h^T -> dh.  So K10b is two kernels:
//   1. bilstm_proj_gates_kernel, the gate pre-activations of every step
//      at once, parallel over T: for each (step, row, gate column) the
//      projection through project() of csrc/bilstm_cell.cuh plus the
//      recurrent sum over the stored y[t-+1] through warp_dot, the two
//      calls and the order K10a makes, so the pre-activations are K10a's
//      bit for bit (the recompute invariant).  Where a row of D + H f32
//      and 64 columns of W_x | W_h fit a block (D + H <= 426: the
//      3x128's D=256, H=128), a tiled kernel keeps 64 columns and walks
//      tiles of 64 rows, and each thread sums 4 x 4 of them with
//      tile_dot4x4, which walks warp_dot's lanes in the order of its
//      shuffle tree; wider rows take one warp per (row, column), calling
//      warp_dot and project() themselves over up to 32 columns of W_x
//      and W_h held as f32, x[t] and y[t-+1] read through L1/L2 as K10a
//      reads x.  The card tests hold the two to each other bit for bit.
//      The result goes to an f32 scratch [S, B, 8H] the wrapper
//      allocates per chunk of S steps; nothing of the forward is kept
//      for the backward (the K10 route's point).
//   2. bilstm_proj_chain_kernel, the dh/dc chain, serial over the steps,
//      in thread-block clusters: the backward chain of csrc/bwd_chain.cuh
//      with the LSTM cell (LstmBwdCell), both directions, on the
//      pre-activations of phase 1 (K6 and K9b run the same chain on
//      their phase 1's recurrent sums, K3 and K8b on the ones their
//      forward stored).  One cluster of C CTAs per
//      (direction, group of R rows); each CTA keeps its ceil(H/C) units'
//      four gate columns of W_h in shared memory as f32 (64 KB at H =
//      128, C = 4) with their dh and dc carries; one cluster barrier a
//      step, the partial dh rows exchanged through DSMEM; any B.  C and R
//      come from the wrapper (rnn_cuda.k10b_plan); the launcher checks
//      them and returns the CUDA error when they do not fit.
// Between chunks of steps (a scratch above 256 MiB) the chain carries dh
// and dc in an f32 state [2][2][B][H] (dh, dc; direction).

#include <algorithm>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bilstm_cell.cuh"
#include "bwd_chain.cuh"
#include "lstm_gates.cuh"
#include "lstm_wide.cuh"
#include "row_ceiling.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;

template <typename T>
__device__ __forceinline__ void bilstm_bwd_body(
    const T* __restrict__ dyf, const T* __restrict__ dyb,
    const T* __restrict__ xp, const T* __restrict__ yf,
    const float* __restrict__ cf, const T* __restrict__ yb,
    const float* __restrict__ cb, const T* __restrict__ whf,
    const T* __restrict__ whb, const int32_t* __restrict__ lens,
    T* __restrict__ dgf, T* __restrict__ dgb, float* part, int steps, int B,
    int H, int hs) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int nb = (H + hs - 1) / hs;        // blocks per direction
  const int dir = blockIdx.x / nb;
  const int own = blockIdx.x % nb;          // this block's unit group
  const int j0 = own * hs;
  const int n = min(hs, H - j0);            // hidden units this block owns
  const int G = 4 * H;
  const int n4 = 4 * n;
  const T* wh = dir == 0 ? whf : whb;
  const T* dy = dir == 0 ? dyf : dyb;
  const T* y = dir == 0 ? yf : yb;
  const float* cst = dir == 0 ? cf : cb;
  T* dg = dir == 0 ? dgf : dgb;
  // partial dh: [parity][direction][B][owner group][writer][hs]
  const size_t psize = (size_t)B * nb * nb * hs;

  float* w_s = smem;                  // [4n][H]: column c = gate * n + jj
  float* y_s = w_s + 4 * hs * H;      // [B][H]: y[t-+1], the operand
  float* g_s = y_s + B * H;           // [B][4n]: gate sums
  float* dg_s = g_s + B * 4 * hs;     // [B][4n]: dgates as the dh operand
  float* dh_s = dg_s + B * 4 * hs;    // [B][n]: dh carry of owned units
  float* dc_s = dh_s + B * hs;        // [B][n]: dc carry of owned units

  for (int i = threadIdx.x; i < n4 * H; i += blockDim.x) {
    const int c = i / H, k = i % H;
    const int gate = c / n, jj = c % n;
    w_s[i] = to_f32(wh[(size_t)k * G + gate * H + j0 + jj]);
  }
  for (int i = threadIdx.x; i < B * n; i += blockDim.x) {
    dh_s[i] = 0.0f;
    dc_s[i] = 0.0f;
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  auto time_of = [&](int s) { return dir == 0 ? steps - 1 - s : s; };

  // recurrent gate sums of walk step s into g_s: K2's dot products
  auto gate_sums = [&](int s) {
    const bool first = s == steps - 1;  // the direction's first fwd step
    const int t = time_of(s);
    if (!first) {
      const int tp = dir == 0 ? t - 1 : t + 1;
      const T* yp = y + (size_t)tp * B * H;
      for (int i = threadIdx.x; i < B * H; i += blockDim.x)
        y_s[i] = to_f32(yp[i]);
    }
    __syncthreads();
    for (int o = warp; o < B * n4; o += nwarps) {
      const int b = o / n4, c = o % n4;
      float acc = first ? 0.0f : warp_dot(y_s + b * H, w_s + c * H, H, lane);
      if (lane == 0) g_s[o] = acc;
    }
  };

  gate_sums(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int t = time_of(s);
    const bool first = s == steps - 1;
    const int tp = dir == 0 ? t - 1 : t + 1;
    if (s > 0) {
      // dh = dgates[s-1] . W_h^T: the sum of every block's partial,
      // carried only where step s-1 was a valid frame
      const int t1 = time_of(s - 1);
      const float* p = part + ((size_t)((s - 1) & 1) * 2 + dir) * psize;
      for (int e = threadIdx.x; e < B * n; e += blockDim.x) {
        const int b = e / n, jj = e % n;
        if (t1 >= lens[b]) continue;
        const float* q = p + ((size_t)b * nb + own) * nb * hs + jj;
        float acc = 0.0f;
        for (int w = 0; w < nb; ++w) acc += __ldcg(q + (size_t)w * hs);
        dh_s[e] = acc;
      }
    }
    for (int e = threadIdx.x; e < B * n; e += blockDim.x) {
      const int b = e / n, jj = e % n, j = j0 + jj;
      const float* g = g_s + b * n4;
      const T* x = xp + ((size_t)t * B + b) * 2 * G + dir * G;
      // pre-activation of gate q: the stored projection plus the sums
      auto pre = [&](int q) { return to_f32(x[q * H + j]) + g[q * n + jj]; };
      const float gi = sigmoid(pre(0));
      const float gf = sigmoid(pre(1));
      const float gg = tanhf(pre(2));
      const float go = sigmoid(pre(3));
      const size_t o = ((size_t)t * B + b) * H + j;
      const float c = cst[o];
      const float cp = first ? 0.0f : cst[((size_t)tp * B + b) * H + j];
      const float tc = tanhf(c);
      const float dht = to_f32(dy[o]) + dh_s[e];
      const float dct = dc_s[e] + dht * go * (1.0f - tc * tc);
      const bool valid = t < lens[b];
      const float d_i = valid ? dct * gg * gi * (1.0f - gi) : 0.0f;
      const float d_f = valid ? dct * cp * gf * (1.0f - gf) : 0.0f;
      const float d_g = valid ? dct * gi * (1.0f - gg * gg) : 0.0f;
      const float d_o = valid ? dht * tc * go * (1.0f - go) : 0.0f;
      const T r_i = from_f32<T>(d_i), r_f = from_f32<T>(d_f);
      const T r_g = from_f32<T>(d_g), r_o = from_f32<T>(d_o);
      T* out = dg + ((size_t)t * B + b) * G;
      out[j] = r_i;
      out[H + j] = r_f;
      out[2 * H + j] = r_g;
      out[3 * H + j] = r_o;
      float* d = dg_s + b * n4;
      d[jj] = to_f32(r_i);
      d[n + jj] = to_f32(r_f);
      d[2 * n + jj] = to_f32(r_g);
      d[3 * n + jj] = to_f32(r_o);
      if (valid) dc_s[e] = dct * gf;
    }
    __syncthreads();
    if (s + 1 == steps) break;
    // this block's share of the next dh: its own columns, every unit k
    float* p = part + ((size_t)(s & 1) * 2 + dir) * psize;
    for (int i = threadIdx.x; i < B * H; i += blockDim.x) {
      const int b = i / H, k = i % H;
      const float* d = dg_s + b * n4;
      float acc = 0.0f;
      for (int c = 0; c < n4; ++c) acc = fmaf(d[c], w_s[c * H + k], acc);
      __stcg(p + (((size_t)b * nb + k / hs) * nb + own) * hs + k % hs, acc);
    }
    gate_sums(s + 1);
    grid.sync();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bilstm_bwd_kernel(const T* __restrict__ dyf, const T* __restrict__ dyb,
                  const T* __restrict__ xp, const T* __restrict__ yf,
                  const float* __restrict__ cf, const T* __restrict__ yb,
                  const float* __restrict__ cb, const T* __restrict__ whf,
                  const T* __restrict__ whb, const int32_t* __restrict__ lens,
                  T* __restrict__ dgf, T* __restrict__ dgb, float* part,
                  int steps, int B, int H, int hs) {
  bilstm_bwd_body<T>(dyf, dyb, xp, yf, cf, yb, cb, whf, whb, lens, dgf, dgb,
                     part, steps, B, H, hs);
}

// hidden units per block: both directions' blocks in one wave of the SMs
int units_per_block(int H, int sms) { return (2 * H + sms - 1) / sms; }

// K3's geometry at B rows: hs hidden units per block, nb blocks per
// direction and the shared memory in bytes; refuses rows that do not fit
// one block and a grid that is not co-resident.  The launch and
// bilstm_bwd_max_rows share it.
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
  *hs = units_per_block(H, sms);
  *nb = (H + *hs - 1) / *hs;
  *smem = sizeof(float) * ((size_t)4 * *hs * H + (size_t)B * H +
                           (size_t)2 * B * 4 * *hs + (size_t)2 * B * *hs);
  if (*smem > (size_t)optin) return cudaErrorLaunchOutOfResources;
  auto kern = bilstm_bwd_kernel<T>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)*smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                    *smem);
  if (e != cudaSuccess) return e;
  return per_sm * sms < 2 * *nb ? cudaErrorCooperativeLaunchTooLarge
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
int launch(const void* dyf, const void* dyb, const void* xp, const void* yf,
           const void* cf, const void* yb, const void* cb, const void* whf,
           const void* whb, const void* lens, void* dgf, void* dgb,
           void* part, int steps, int B, int H, void* stream) {
  if (steps <= 0 || B <= 0) return cudaGetLastError();
  int hs = 0, nb = 0;
  size_t smem = 0;
  cudaError_t e = plan<T>(B, H, &hs, &nb, &smem);
  if (e != cudaSuccess) return e;

  const T* a_dyf = static_cast<const T*>(dyf);
  const T* a_dyb = static_cast<const T*>(dyb);
  const T* a_xp = static_cast<const T*>(xp);
  const T* a_yf = static_cast<const T*>(yf);
  const float* a_cf = static_cast<const float*>(cf);
  const T* a_yb = static_cast<const T*>(yb);
  const float* a_cb = static_cast<const float*>(cb);
  const T* a_whf = static_cast<const T*>(whf);
  const T* a_whb = static_cast<const T*>(whb);
  const int32_t* a_lens = static_cast<const int32_t*>(lens);
  T* a_dgf = static_cast<T*>(dgf);
  T* a_dgb = static_cast<T*>(dgb);
  float* a_part = static_cast<float*>(part);
  int a_steps = steps, a_b = B, a_hd = H, a_hs = hs;
  void* args[] = {&a_dyf,  &a_dyb, &a_xp,   &a_yf,    &a_cf,  &a_yb,
                  &a_cb,   &a_whf, &a_whb,  &a_lens,  &a_dgf, &a_dgb,
                  &a_part, &a_steps, &a_b,  &a_hd,    &a_hs};
  e = cudaLaunchCooperativeKernel((void*)bilstm_bwd_kernel<T>, dim3(2 * nb),
                                  dim3(kThreads), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K10b phase 1: the gate pre-activations of every step, parallel over T
// (the bodies of csrc/lstm_gates.cuh, which K10a's phase 1 runs too)
// ---------------------------------------------------------------------------

// K10b's rows: row r of a chunk is walk step s0 + r / B, batch row r % B;
// the forward direction is at t = T-1-s, the backward at t = s, and
// y[t-+1] is zero (null) at the direction's first forward step
template <typename T>
struct WalkRows {
  const T* x;
  const T* yf;
  const T* yb;
  int s0, steps, B, D, H;
  __device__ __forceinline__ void operator()(int dir, int r, const T*& xr,
                                             const T*& yr) const {
    const int s = s0 + r / B, b = r % B;
    const int t = dir == 0 ? steps - 1 - s : s;
    xr = x + ((size_t)t * B + b) * D;
    if (s != steps - 1)
      yr = (dir == 0 ? yf : yb) +
           ((size_t)(dir == 0 ? t - 1 : t + 1) * B + b) * H;
  }
};

template <typename T>
__global__ void __launch_bounds__(kGateThreads)
bilstm_proj_gates_kernel(const T* __restrict__ x, const T* __restrict__ yf,
                         const T* __restrict__ yb, const T* __restrict__ wx,
                         const float* __restrict__ bias,
                         const T* __restrict__ whf, const T* __restrict__ whb,
                         float* __restrict__ pre, int s0, int S, int steps,
                         int B, int D, int H, int cols) {
  gates_warp_body<T, Sums::kProjRec>(
      wx, bias, whf, whb, pre, S * B, D, H, 4, 2, cols,
      WalkRows<T>{x, yf, yb, s0, steps, B, D, H});
}

template <typename T>
int gates_launch(const void* x, const void* yf, const void* yb,
                 const void* wx, const void* bias, const void* whf,
                 const void* whb, void* pre, int s0, int S, int steps, int B,
                 int D, int H, int cols, void* stream) {
  if (S <= 0 || B <= 0) return cudaGetLastError();
  if (s0 < 0 || s0 + S > steps || D <= 0 || H <= 0 || cols < 1 ||
      cols > kMaxGateCols)
    return cudaErrorInvalidValue;
  auto kern = bilstm_proj_gates_kernel<T>;
  const size_t smem = gates_smem(cols, D, H);
  int sms = 0;
  cudaError_t e = gates_prepare((const void*)kern, smem, &sms);
  if (e != cudaSuccess) return e;
  kern<<<gates_warp_grid((long long)S * B, 4 * H, 2, cols), kGateThreads,
         smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(yf),
      static_cast<const T*>(yb), static_cast<const T*>(wx),
      static_cast<const float*>(bias), static_cast<const T*>(whf),
      static_cast<const T*>(whb), static_cast<float*>(pre), s0, S, steps, B,
      D, H, cols);
  return cudaGetLastError();
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads, 1)
bilstm_proj_gates_tiled_kernel(
    const T* __restrict__ x, const T* __restrict__ yf,
    const T* __restrict__ yb, const T* __restrict__ wx,
    const float* __restrict__ bias, const T* __restrict__ whf,
    const T* __restrict__ whb, float* __restrict__ pre, int s0, int S,
    int steps, int B, int D, int H) {
  gates_tiled_body<T, Sums::kProjRec>(
      wx, bias, whf, whb, pre, S * B, D, H, 4, 2,
      WalkRows<T>{x, yf, yb, s0, steps, B, D, H});
}

template <typename T>
int gates_tiled_launch(const void* x, const void* yf, const void* yb,
                       const void* wx, const void* bias, const void* whf,
                       const void* whb, void* pre, int s0, int S, int steps,
                       int B, int D, int H, void* stream) {
  if (S <= 0 || B <= 0) return cudaGetLastError();
  if (s0 < 0 || s0 + S > steps || D <= 0 || H <= 0)
    return cudaErrorInvalidValue;
  auto kern = bilstm_proj_gates_tiled_kernel<T>;
  const size_t smem = gates_tiled_smem(D, H);
  int sms = 0;
  cudaError_t e = gates_prepare((const void*)kern, smem, &sms);
  if (e != cudaSuccess) return e;
  kern<<<gates_tiled_grid((long long)S * B, 4 * H, 2, sms), kTileThreads,
         smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(yf),
      static_cast<const T*>(yb), static_cast<const T*>(wx),
      static_cast<const float*>(bias), static_cast<const T*>(whf),
      static_cast<const T*>(whb), static_cast<float*>(pre), s0, S, steps, B,
      D, H);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K10b phase 2: the dh/dc chain, serial over the steps, in clusters
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kBwdChainThreads)
bilstm_proj_chain_kernel(const T* __restrict__ dyf, const T* __restrict__ dyb,
                         const float* __restrict__ cf,
                         const float* __restrict__ cb,
                         const T* __restrict__ whf, const T* __restrict__ whb,
                         const int32_t* __restrict__ lens,
                         const float* __restrict__ pre, T* __restrict__ dgf,
                         T* __restrict__ dgb, float* __restrict__ state,
                         int s0, int S, int steps, int B, int H, int R) {
  bwd_chain_body<LstmBwdCell, true, T>(
      pre, static_cast<const T*>(nullptr), dyf, dyb, cf, cb, whf, whb, lens,
      dgf, static_cast<T*>(nullptr), dgb, static_cast<T*>(nullptr), state,
      2, s0, S, steps, B, H, R, 0);
}

template <typename T>
int chain_launch(const void* dyf, const void* dyb, const void* cf,
                 const void* cb, const void* whf, const void* whb,
                 const void* lens, const void* pre, void* dgf, void* dgb,
                 void* state, int s0, int S, int steps, int B, int H, int C,
                 int R, void* stream) {
  return bwd_chain_launch<LstmBwdCell, true>(
      bilstm_proj_chain_kernel<T>, C, 2, s0, S, steps, B, H, R, stream,
      static_cast<const T*>(dyf), static_cast<const T*>(dyb),
      static_cast<const float*>(cf), static_cast<const float*>(cb),
      static_cast<const T*>(whf), static_cast<const T*>(whb),
      static_cast<const int32_t*>(lens), static_cast<const float*>(pre),
      static_cast<T*>(dgf), static_cast<T*>(dgb), static_cast<float*>(state),
      s0, S, steps, B, H, R);
}

// ---------------------------------------------------------------------------
// K3's cluster route: the backward chain with both directions on K2's
// stored recurrent sums
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kBwdChainThreads)
bilstm_bwd_chain_kernel(const T* __restrict__ dyf, const T* __restrict__ dyb,
                        const T* __restrict__ xp, const float* __restrict__ cf,
                        const float* __restrict__ cb,
                        const T* __restrict__ whf, const T* __restrict__ whb,
                        const int32_t* __restrict__ lens,
                        const float* __restrict__ pre, T* __restrict__ dgf,
                        T* __restrict__ dgb, float* __restrict__ state,
                        int s0, int S, int steps, int B, int H, int R) {
  bwd_chain_body<LstmBwdCell, false, T>(
      pre, xp, dyf, dyb, cf, cb, whf, whb, lens, dgf,
      static_cast<T*>(nullptr), dgb, static_cast<T*>(nullptr), state, 2, s0,
      S, steps, B, H, R, 0);
}

template <typename T>
int rec_chain_launch(const void* dyf, const void* dyb, const void* xp,
                     const void* cf, const void* cb, const void* whf,
                     const void* whb, const void* lens, const void* pre,
                     void* dgf, void* dgb, void* state, int steps, int B,
                     int H, int C, int R, void* stream) {
  return bwd_chain_launch<LstmBwdCell, false>(
      bilstm_bwd_chain_kernel<T>, C, 2, 0, steps, steps, B, H, R, stream,
      static_cast<const T*>(dyf), static_cast<const T*>(dyb),
      static_cast<const T*>(xp), static_cast<const float*>(cf),
      static_cast<const float*>(cb), static_cast<const T*>(whf),
      static_cast<const T*>(whb), static_cast<const int32_t*>(lens),
      static_cast<const float*>(pre), static_cast<T*>(dgf),
      static_cast<T*>(dgb), static_cast<float*>(state), 0, steps, steps, B,
      H, R);
}

// ---------------------------------------------------------------------------
// K3's wide route: W_h from L2 every step (csrc/lstm_wide.cuh)
// ---------------------------------------------------------------------------

constexpr int kWideSlices = 8;     // the dh product's column slices
constexpr int kWideCols = 16;      // columns a staged chunk

// gate columns each slice of the dh product takes at H units: 4H over
// the slices, rounded up to whole chunks (the dgates exchange and the
// weights hold kWideSlices times as many rows, zeros past 4H; the
// wrapper sizes them by bilstm_wide_bwd_cols)
__host__ __device__ inline int wide_slice_cols(int H) {
  const int per = kWideSlices * kWideCols;
  return (4 * H + per - 1) / per * kWideCols;
}

// bytes of a wide backward block's shared memory: per slice, two buffers
// of a chunk's dgates rows (64) and W_h rows (16), and every slice's
// partial dh tile (ops/rnn_cuda.py::_wide_bwd_bytes is the same sum)
inline size_t wide_bwd_bytes() {
  return sizeof(float) *
         ((size_t)kWideSlices * 2 * kWideCols * (kWideRows + kWideUnits) +
          (size_t)kWideSlices * kWideRows * kWideUnits);
}

// One block per (direction, kWideUnits units), both directions in one
// cooperative grid.  Inputs as K3's cluster route (sums: K2's stored
// recurrent sums, [T, B, 8H] f32 in this walk's order), and
//   wq: W_h of both directions as f32, [2][nb][8 cs][16]: block blk's
//       row c holds W_h[blk * 16 + kk][c] at kk (zeros past H and 4H);
//   dgx: the dgates of the step as the dh product's operand, f32 rounded
//       to T, [2 parities][2 directions][8 cs][Bp], zeroed by the caller;
//   state: [2][2][B][H] f32 zeros, the dh and dc carries.
// Walk step s: each thread forms the dgates of its cells (the cooperative
// route's arithmetic on the stored sums: gates, c, dh and dc are f32) and
// writes them out and into dgx; one grid.sync(); then for each tile of
// 64 rows the block's 8 slices of 64 threads each sum dgates . W_h^T over
// their columns for 4 rows x 4 units a thread, double-buffered by
// cp.async, and the slices' partials are added in slice order into dh
// where the step's frame was valid.
template <typename T>
__global__ void __launch_bounds__(kWideThreads, 1)
bilstm_wide_chain_bwd_kernel(const T* __restrict__ dyf,
                             const T* __restrict__ dyb,
                             const T* __restrict__ xp,
                             const float* __restrict__ cf,
                             const float* __restrict__ cb,
                             const float* __restrict__ wq,
                             const int32_t* __restrict__ lens,
                             const float* __restrict__ sums,
                             T* __restrict__ dgf, T* __restrict__ dgb,
                             float* dgx, float* state, int steps, int B,
                             int H) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 wide_smem[];
  float* smem = reinterpret_cast<float*>(wide_smem);
  const int nb = (H + kWideUnits - 1) / kWideUnits;
  const int dir = blockIdx.x / nb, blk = blockIdx.x % nb;
  const int j0 = blk * kWideUnits;
  const int Bp = (B + kWideRows - 1) / kWideRows * kWideRows;
  const int G = 4 * H;
  const int cs = wide_slice_cols(H);
  const T* dy = dir == 0 ? dyf : dyb;
  const float* cst = dir == 0 ? cf : cb;
  T* dg = dir == 0 ? dgf : dgb;
  float* dh = state + (size_t)dir * B * H;
  float* dc = state + (size_t)(2 + dir) * B * H;
  const size_t xsize = (size_t)kWideSlices * cs * Bp;  // a parity, direction
  const float* wblk = wq + ((size_t)dir * nb + blk) * kWideSlices * cs *
                               kWideUnits;
  // the product: slice `slice` of 64 threads; a warp 8 row groups x 4
  // unit groups (its dgates loads 128 bytes, its W_h 64)
  const int slice = threadIdx.x / 64;
  const int u = threadIdx.x % 64;
  const int tr = (u >> 5) * 8 + ((u & 31) >> 2);   // rows 4 tr .. 4 tr + 3
  const int tu = u & 3;                            // units 4 tu .. 4 tu + 3
  constexpr int kChunk = kWideCols * (kWideRows + kWideUnits);
  float* buf = smem + (size_t)slice * 2 * kChunk;
  float* part = smem + (size_t)kWideSlices * 2 * kChunk;   // [8][64][16]
  auto time_of = [&](int s) { return dir == 0 ? steps - 1 - s : s; };

  for (int s = 0; s < steps; ++s) {
    const int t = time_of(s);
    const bool first = s == steps - 1;   // the direction's first fwd step
    const int tp = dir == 0 ? t - 1 : t + 1;
    float* dg_x = dgx + ((size_t)(s & 1) * 2 + dir) * xsize;
    for (int e = threadIdx.x; e < B * kWideUnits; e += kWideThreads) {
      const int b = e / kWideUnits, j = j0 + e % kWideUnits;
      if (j >= H) continue;
      const T* x = xp + ((size_t)t * B + b) * 2 * G + dir * G;
      const float* g = sums + ((size_t)s * B + b) * 2 * G + dir * G;
      // pre-activation of gate q: the stored projection plus the sums
      auto pre = [&](int q) { return to_f32(x[q * H + j]) + g[q * H + j]; };
      const float gi = sigmoid(pre(0));
      const float gf = sigmoid(pre(1));
      const float gg = tanhf(pre(2));
      const float go = sigmoid(pre(3));
      const size_t o = ((size_t)t * B + b) * H + j;
      const float c = cst[o];
      const float cp = first ? 0.0f : cst[((size_t)tp * B + b) * H + j];
      const float tc = tanhf(c);
      const size_t sj = (size_t)b * H + j;
      const float dht = to_f32(dy[o]) + dh[sj];
      const float dct = dc[sj] + dht * go * (1.0f - tc * tc);
      const bool valid = t < lens[b];
      const float d[4] = {valid ? dct * gg * gi * (1.0f - gi) : 0.0f,
                          valid ? dct * cp * gf * (1.0f - gf) : 0.0f,
                          valid ? dct * gi * (1.0f - gg * gg) : 0.0f,
                          valid ? dht * tc * go * (1.0f - go) : 0.0f};
      T* out = dg + ((size_t)t * B + b) * G;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const T r = from_f32<T>(d[q]);
        out[q * H + j] = r;
        __stcg(dg_x + (size_t)(q * H + j) * Bp + b, to_f32(r));
      }
      if (valid) dc[sj] = dct * gf;
    }
    grid.sync();
    if (s + 1 == steps) break;
    for (int r0 = 0; r0 < B; r0 += kWideRows) {
      // chunk i of this slice's columns into buffer i & 1
      auto fetch = [&](int i) {
        const int c0 = slice * cs + i * kWideCols;
        float* a = buf + (i & 1) * kChunk;          // [16][64] dgates
        float* w = a + kWideCols * kWideRows;       // [16][16] W_h
        for (int q = u; q < kWideCols * (kWideRows + kWideUnits) / 4;
             q += 64) {
          if (q < kWideCols * kWideRows / 4) {
            const int k = q / (kWideRows / 4), o = q % (kWideRows / 4) * 4;
            cp_async16(a + k * kWideRows + o,
                       dg_x + (size_t)(c0 + k) * Bp + r0 + o);
          } else {
            const int o = (q - kWideCols * kWideRows / 4) * 4;
            cp_async16(w + o, wblk + (size_t)c0 * kWideUnits + o);
          }
        }
        cp_async_commit();
      };
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;
      const int chunks = cs / kWideCols;
      fetch(0);
      for (int i = 0; i < chunks; ++i) {
        if (i + 1 < chunks) {
          fetch(i + 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        const float* a = buf + (i & 1) * kChunk;
        const float* w = a + kWideCols * kWideRows;
#pragma unroll 4
        for (int k = 0; k < kWideCols; ++k) {
          const float4 a4 =
              *reinterpret_cast<const float4*>(a + k * kWideRows + 4 * tr);
          const float4 b4 =
              *reinterpret_cast<const float4*>(w + k * kWideUnits + 4 * tu);
          const float av[4] = {a4.x, a4.y, a4.z, a4.w};
          const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
        }
        __syncthreads();   // the buffer is refilled two chunks on
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          part[((size_t)slice * kWideRows + 4 * tr + r) * kWideUnits +
               4 * tu + q] = acc[r][q];
      __syncthreads();
      // dh = the slices' partials in slice order, where step s was valid
      for (int o = threadIdx.x; o < kWideRows * kWideUnits;
           o += kWideThreads) {
        const int b = r0 + o / kWideUnits, j = j0 + o % kWideUnits;
        if (b >= B || j >= H || t >= lens[b]) continue;
        float sum = part[o];
        for (int k = 1; k < kWideSlices; ++k)
          sum += part[(size_t)k * kWideRows * kWideUnits + o];
        dh[(size_t)b * H + j] = sum;
      }
      __syncthreads();   // `part` serves the next tile, dh the next step
    }
  }
}

template <typename T>
int wide_launch(const void* dyf, const void* dyb, const void* xp,
                const void* cf, const void* cb, const void* wq,
                const void* lens, const void* sums, void* dgf, void* dgb,
                void* dgx, void* state, int steps, int B, int H,
                void* stream) {
  if (steps <= 0 || B <= 0) return cudaGetLastError();
  if (H <= 0) return cudaErrorInvalidValue;
  int dev = 0, sms = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return cudaErrorNotSupported;
  const int nb = (H + kWideUnits - 1) / kWideUnits;
  const size_t smem = wide_bwd_bytes();
  auto kern = bilstm_wide_chain_bwd_kernel<T>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                    kWideThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm * sms < 2 * nb) return cudaErrorCooperativeLaunchTooLarge;
  const T* a_dyf = static_cast<const T*>(dyf);
  const T* a_dyb = static_cast<const T*>(dyb);
  const T* a_xp = static_cast<const T*>(xp);
  const float* a_cf = static_cast<const float*>(cf);
  const float* a_cb = static_cast<const float*>(cb);
  const float* a_wq = static_cast<const float*>(wq);
  const int32_t* a_lens = static_cast<const int32_t*>(lens);
  const float* a_sums = static_cast<const float*>(sums);
  T* a_dgf = static_cast<T*>(dgf);
  T* a_dgb = static_cast<T*>(dgb);
  float* a_dgx = static_cast<float*>(dgx);
  float* a_state = static_cast<float*>(state);
  int a_steps = steps, a_b = B, a_h = H;
  void* args[] = {&a_dyf, &a_dyb,  &a_xp,   &a_cf,    &a_cb,
                  &a_wq,  &a_lens, &a_sums, &a_dgf,   &a_dgb,
                  &a_dgx, &a_state, &a_steps, &a_b, &a_h};
  e = cudaLaunchCooperativeKernel((void*)kern, dim3(2 * nb),
                                  dim3(kWideThreads), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// floats of the partial-dh exchange the caller allocates for a K3 launch
// at B, H on the current device: [2 parities][2 directions][B][nb][nb][hs]
// (hs hidden units per block, nb blocks per direction); -1 on error
int bilstm_bwd_exchange_floats(int B, int H) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms <= 0 || H <= 0)
    return -1;
  const long long hs = units_per_block(H, sms), nb = (H + hs - 1) / hs;
  const long long n = 4LL * B * nb * nb * hs;
  return n > 0x7fffffffLL ? -1 : (int)n;
}

// the most batch rows one K3 launch takes at H units on the current
// device (0: not one), or a negative CUDA error code; nothing is launched
int bilstm_bwd_max_rows_f32(int H) { return max_rows_of<float>(H); }
int bilstm_bwd_max_rows_bf16(int H) {
  return max_rows_of<__nv_bfloat16>(H);
}

// K3's cooperative route.  part: the partial-dh exchange,
// bilstm_bwd_exchange_floats(B, H) f32
int bilstm_bwd_f32(const void* dyf, const void* dyb, const void* xp,
                   const void* yf, const void* cf, const void* yb,
                   const void* cb, const void* whf, const void* whb,
                   const void* lens, void* dgf, void* dgb, void* part,
                   int steps, int B, int H, void* stream) {
  return launch<float>(dyf, dyb, xp, yf, cf, yb, cb, whf, whb, lens, dgf,
                       dgb, part, steps, B, H, stream);
}

int bilstm_bwd_bf16(const void* dyf, const void* dyb, const void* xp,
                    const void* yf, const void* cf, const void* yb,
                    const void* cb, const void* whf, const void* whb,
                    const void* lens, void* dgf, void* dgb, void* part,
                    int steps, int B, int H, void* stream) {
  return launch<__nv_bfloat16>(dyf, dyb, xp, yf, cf, yb, cb, whf, whb, lens,
                               dgf, dgb, part, steps, B, H, stream);
}

// the opt-in shared memory of one block on the current device, in bytes
// (the plans of K3's cluster route and of K10b size their clusters by
// it), or a negative CUDA error code
int bilstm_bwd_smem_optin(void) { return smem_optin_bytes(); }

// K3's cluster route, the whole walk of `steps` steps: dy_f, dy_b
// [T, B, H], xp [T, B, 8H] and w_h_f, w_h_b in the compute dtype, c_f, c_b
// [T, B, H] f32, lens [B] int32, pre: the recurrent sums K2 stored
// ([T, B, 8H] f32, row s the sums of walk step s) -> dg_f, dg_b
// [T, B, 4H]; state [2][2][B][H] f32, zeros: the dh and dc carries (per
// direction).  C CTAs per cluster (a power of two <= 16), R rows per
// cluster.
int bilstm_bwd_chain_f32(const void* dyf, const void* dyb, const void* xp,
                         const void* cf, const void* cb, const void* whf,
                         const void* whb, const void* lens, const void* pre,
                         void* dgf, void* dgb, void* state, int steps, int B,
                         int H, int C, int R, void* stream) {
  return rec_chain_launch<float>(dyf, dyb, xp, cf, cb, whf, whb, lens, pre,
                                 dgf, dgb, state, steps, B, H, C, R, stream);
}

int bilstm_bwd_chain_bf16(const void* dyf, const void* dyb, const void* xp,
                          const void* cf, const void* cb, const void* whf,
                          const void* whb, const void* lens, const void* pre,
                          void* dgf, void* dgb, void* state, int steps,
                          int B, int H, int C, int R, void* stream) {
  return rec_chain_launch<__nv_bfloat16>(dyf, dyb, xp, cf, cb, whf, whb, lens,
                                         pre, dgf, dgb, state, steps, B, H, C,
                                         R, stream);
}

// K10b phase 1 over walk steps s0 .. s0+S-1 of `steps`: x [T, B, D], y_f,
// y_b [T, B, H], wx [D, 8H], w_h_f, w_h_b [H, 4H] in the compute dtype,
// bias [8H] f32 -> pre [S, B, 8H] f32 (row i holds step s0+i: the
// forward direction's gates at t = T-1-s, the backward's at t = s);
// `cols` gate columns per block (at most 32)
int bilstm_proj_gates_f32(const void* x, const void* yf, const void* yb,
                          const void* wx, const void* bias, const void* whf,
                          const void* whb, void* pre, int s0, int S,
                          int steps, int B, int D, int H, int cols,
                          void* stream) {
  return gates_launch<float>(x, yf, yb, wx, bias, whf, whb, pre, s0, S,
                             steps, B, D, H, cols, stream);
}

int bilstm_proj_gates_bf16(const void* x, const void* yf, const void* yb,
                           const void* wx, const void* bias, const void* whf,
                           const void* whb, void* pre, int s0, int S,
                           int steps, int B, int D, int H, int cols,
                           void* stream) {
  return gates_launch<__nv_bfloat16>(x, yf, yb, wx, bias, whf, whb, pre, s0,
                                     S, steps, B, D, H, cols, stream);
}

// the same with the tiled kernel (64 columns a block, tiles of 64 rows,
// D + H up to gates_tiled_smem's fit): the same sums, bit for bit
int bilstm_proj_gates_tiled_f32(const void* x, const void* yf,
                                const void* yb, const void* wx,
                                const void* bias, const void* whf,
                                const void* whb, void* pre, int s0, int S,
                                int steps, int B, int D, int H,
                                void* stream) {
  return gates_tiled_launch<float>(x, yf, yb, wx, bias, whf, whb, pre, s0,
                                   S, steps, B, D, H, stream);
}

int bilstm_proj_gates_tiled_bf16(const void* x, const void* yf,
                                 const void* yb, const void* wx,
                                 const void* bias, const void* whf,
                                 const void* whb, void* pre, int s0, int S,
                                 int steps, int B, int D, int H,
                                 void* stream) {
  return gates_tiled_launch<__nv_bfloat16>(x, yf, yb, wx, bias, whf, whb,
                                           pre, s0, S, steps, B, D, H,
                                           stream);
}

// K10b phase 2 over the same steps: dy_f, dy_b [T, B, H] and w_h_f, w_h_b
// in the compute dtype, c_f, c_b [T, B, H] f32, lens [B] int32, pre from
// phase 1 -> dg_f, dg_b [T, B, 4H] at those steps' frames; state [2][2][B]
// [H] f32 holds dh and dc (per direction) on entry and, unless the walk
// ends here, on exit.  C CTAs per cluster (a power of two <= 16), R rows
// per cluster.
int bilstm_proj_chain_f32(const void* dyf, const void* dyb, const void* cf,
                          const void* cb, const void* whf, const void* whb,
                          const void* lens, const void* pre, void* dgf,
                          void* dgb, void* state, int s0, int S, int steps,
                          int B, int H, int C, int R, void* stream) {
  return chain_launch<float>(dyf, dyb, cf, cb, whf, whb, lens, pre, dgf, dgb,
                             state, s0, S, steps, B, H, C, R, stream);
}

int bilstm_proj_chain_bf16(const void* dyf, const void* dyb, const void* cf,
                           const void* cb, const void* whf, const void* whb,
                           const void* lens, const void* pre, void* dgf,
                           void* dgb, void* state, int s0, int S, int steps,
                           int B, int H, int C, int R, void* stream) {
  return chain_launch<__nv_bfloat16>(dyf, dyb, cf, cb, whf, whb, lens, pre,
                                     dgf, dgb, state, s0, S, steps, B, H, C,
                                     R, stream);
}

// K3's wide route (csrc/lstm_wide.cuh), where W_h fits neither route
// above: dy_f, dy_b [T, B, H], xp [T, B, 8H] in the compute dtype, c_f,
// c_b [T, B, H] f32, wq [2][nb][8 cs][16] f32 (W_h of both directions in
// the wide layout: ops/rnn_cuda.py::_wide_rows), lens [B] int32, sums:
// the recurrent sums K2's wide route stored -> dg_f, dg_b [T, B, 4H];
// dgx [2][2][8 cs][Bp] f32 and state [2][2][B][H] f32, both zeroed by the
// caller (8 cs = bilstm_wide_bwd_cols(H), Bp = B rounded up to 64).  One
// launch for any B.
int bilstm_wide_bwd_f32(const void* dyf, const void* dyb, const void* xp,
                        const void* cf, const void* cb, const void* wq,
                        const void* lens, const void* sums, void* dgf,
                        void* dgb, void* dgx, void* state, int steps, int B,
                        int H, void* stream) {
  return wide_launch<float>(dyf, dyb, xp, cf, cb, wq, lens, sums, dgf, dgb,
                            dgx, state, steps, B, H, stream);
}

int bilstm_wide_bwd_bf16(const void* dyf, const void* dyb, const void* xp,
                         const void* cf, const void* cb, const void* wq,
                         const void* lens, const void* sums, void* dgf,
                         void* dgb, void* dgx, void* state, int steps,
                         int B, int H, void* stream) {
  return wide_launch<__nv_bfloat16>(dyf, dyb, xp, cf, cb, wq, lens, sums,
                                    dgf, dgb, dgx, state, steps, B, H,
                                    stream);
}

// rows of the wide route's weights and dgates exchange at H units (the
// dh product's column slices together), and its shared memory a block
int bilstm_wide_bwd_cols(int H) { return kWideSlices * wide_slice_cols(H); }
int bilstm_wide_bwd_smem(void) { return (int)wide_bwd_bytes(); }

const char* kctpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
