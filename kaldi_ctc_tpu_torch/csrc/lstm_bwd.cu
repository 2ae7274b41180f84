// K6: the backward recurrence of one unidirectional LSTM direction
// (dgates).
//
// Replaces kaldi_ctc_tpu/ops/rnn_pallas.py::_lstm_seq_bwd_dgates (kernel
// body _bwd_kernel with _dgates_update and _lstm_gates).  Inputs: the
// output cotangent dy [T, B, H] and the forward's residuals as K5 wrote
// or read them: the projection x_proj [T, B, 4H] (gate order i, f, g,
// o), y [T, B, H] in the compute dtype, c [T, B, H] f32, the recurrent
// weights w_h [H, 4H], the lengths [B] and the forward's direction.
// Output: dgates [T, B, 4H] in the compute dtype, the cotangents of the
// gate pre-activations, zero at pad frames.
//
// The walk runs the forward order in reverse: t = T-1-s for a forward
// direction (its previous frame is t-1), t = s for a reverse one (its
// previous frame is t+1).  At each step it
//   - recomputes the gates from x_proj[t] + y[prev] . W_h, with y[prev]
//     as stored (the compute dtype) and zero at the forward's first
//     step, f32 accumulation: the same sums, in the same order, as K5's,
//     so the gates equal the forward's;
//   - reads c[t] (at the walk's first step the forward's last cell
//     state) and c[prev] (zero at the forward's first step);
//   - forms dh_total = dy + dh and dc_total, writes the dgates;
//   - at valid frames carries dh = dgates . W_h^T (dgates rounded to the
//     compute dtype, f32 accumulation) and dc = dc_total * f.
// Gate math, dh, dc and c are f32.
//
// What bounds it on the H100: the same serial chain as K5, T steps, and
// each step needs the whole previous dgates row [B, 4H] to form dh.  At
// the training batch B = 48, H = 320 that row is 245 KB in f32: more
// than one block's shared memory.
//
// Two routes, chosen by the wrapper's plan from the shapes
// (ops/rnn_cuda.py::bwd_chain_plan with four gates):
//   - the cluster route, wherever W_h's four gate columns fit a cluster
//     of at most 16 CTAs as f32 (H up to ~465): two kernels, K10b's
//     split.  The gate recompute depends only on the stored y,
//     never on the dh/dc recurrence, so
//       1. lstm_bwd_gates_tiled_kernel (H <= 426) or lstm_bwd_gates_kernel
//          (one warp per row over 32 gate columns a block) computes the
//          recurrent sums y[prev] . W_h of every step at once, parallel
//          over T, into an f32 scratch [S, B, 4H] (the bodies of
//          csrc/lstm_gates.cuh with the projection left out; y[prev] is
//          zero at the forward's first step): warp_dot's sums, in its
//          order, so the gates equal K5's chain gates bit for bit;
//       2. lstm_bwd_chain_kernel walks the dh/dc chain: the backward chain
//          of csrc/bwd_chain.cuh with the LSTM cell and one direction,
//          which adds x_proj[t] to each sum as the forward chain does.
//     Any B in waves of clusters, no row slices; a scratch above 256 MiB
//     runs in chunks of steps, dh and dc carried between them;
//   - the cooperative route above that: lstm_bwd_kernel, below.
//
// The cooperative design: K3's (csrc/bilstm_bwd.cu) with one direction.
// One cooperative launch; each block owns hs hidden units and keeps those
// units' four gate columns of W_h (4*hs x H) in shared memory for the
// whole walk, with its dh and dc.  The columns serve both products: the
// gate recompute sums y[b, k] * W_h[k, c] over k for the block's columns
// c, and the block's share of dh sums dgates[b, c] * W_h[k, c] over its
// own columns c, for every k.  Blocks exchange those partial dh rows, not
// dgates: each block writes a [B, H] partial (f32, st.global.cg) into a
// double-buffered array laid out so that the hs units of one owner are
// contiguous across the writing blocks; after the step's one grid.sync()
// each block sums the nb partials of its own units (ld.global.cg) in a
// fixed order, so the sums stay f32 and deterministic.  The next step's
// gate recompute needs no exchange (y is in device memory) and runs
// before the barrier.  Every row's y, gate sums and dgates stay in shared
// memory, so a launch takes at most lstm_bwd_max_rows(H) rows (~90 at
// H = 512); the wrapper runs a larger batch as row slices.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bilstm_cell.cuh"
#include "bwd_chain.cuh"
#include "lstm_gates.cuh"
#include "row_ceiling.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;

template <typename T>
__global__ void __launch_bounds__(kThreads)
lstm_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ xp,
                const T* __restrict__ y, const float* __restrict__ cst,
                const T* __restrict__ wh, const int32_t* __restrict__ lens,
                T* __restrict__ dg, float* part, int steps, int B, int H,
                int hs, int reverse) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int nb = gridDim.x;
  const int own = blockIdx.x;               // this block's unit group
  const int j0 = own * hs;
  const int n = min(hs, H - j0);            // hidden units this block owns
  const int G = 4 * H;
  const int n4 = 4 * n;
  // partial dh: [parity][B][owner group][writer][hs]
  const size_t psize = (size_t)B * nb * nb * hs;

  float* w_s = smem;                  // [4n][H]: column c = gate * n + jj
  float* y_s = w_s + 4 * hs * H;      // [B][H]: y[prev], the gate operand
  float* g_s = y_s + B * H;           // [B][4n]: recurrent gate sums
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
  auto time_of = [&](int s) { return reverse ? s : steps - 1 - s; };
  auto prev_of = [&](int t) { return reverse ? t + 1 : t - 1; };

  // recurrent gate sums of walk step s into g_s (K5's dot products)
  auto gate_sums = [&](int s) {
    const bool first = s == steps - 1;  // the forward's first step
    if (!first) {
      const T* yp = y + (size_t)prev_of(time_of(s)) * B * H;
      for (int i = threadIdx.x; i < B * H; i += blockDim.x)
        y_s[i] = to_f32(yp[i]);
    }
    __syncthreads();
    for (int o = warp; o < B * n4; o += nwarps) {
      const int b = o / n4, c = o % n4;
      float acc = 0.0f;
      if (!first) {
        const float* hb = y_s + b * H;
        const float* wc = w_s + c * H;
        for (int k = lane; k < H; k += 32) acc = fmaf(hb[k], wc[k], acc);
        for (int off = 16; off > 0; off >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      if (lane == 0) g_s[o] = acc;
    }
  };

  gate_sums(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int t = time_of(s);
    const bool first = s == steps - 1;
    const int tp = prev_of(t);
    if (s > 0) {
      // dh = dgates[s-1] . W_h^T: the sum of every block's partial,
      // carried only where step s-1 was a valid frame
      const int t1 = time_of(s - 1);
      const float* p = part + (size_t)((s - 1) & 1) * psize;
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
      const T* x = xp + ((size_t)t * B + b) * G;
      const float* g = g_s + b * n4;
      const float gi = sigmoid(to_f32(x[j]) + g[jj]);
      const float gf = sigmoid(to_f32(x[H + j]) + g[n + jj]);
      const float gg = tanhf(to_f32(x[2 * H + j]) + g[2 * n + jj]);
      const float go = sigmoid(to_f32(x[3 * H + j]) + g[3 * n + jj]);
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
    float* p = part + (size_t)(s & 1) * psize;
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

// hidden units per block: the grid in one wave of the SMs
int units_per_block(int H, int sms) { return (H + sms - 1) / sms; }

// The launch's geometry at B rows: hs hidden units per block, nb blocks
// and the shared memory in bytes; refuses rows that do not fit one block
// and a grid that is not co-resident.  The launch and lstm_bwd_max_rows
// share it.
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
  auto kern = lstm_bwd_kernel<T>;
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
int launch(const void* dy, const void* xp, const void* y, const void* cst,
           const void* wh, const void* lens, void* dg, void* part, int steps,
           int B, int H, int reverse, void* stream) {
  if (steps <= 0 || B <= 0) return cudaGetLastError();
  int hs = 0, nb = 0;
  size_t smem = 0;
  cudaError_t e = plan<T>(B, H, &hs, &nb, &smem);
  if (e != cudaSuccess) return e;

  const T* a_dy = static_cast<const T*>(dy);
  const T* a_xp = static_cast<const T*>(xp);
  const T* a_y = static_cast<const T*>(y);
  const float* a_c = static_cast<const float*>(cst);
  const T* a_wh = static_cast<const T*>(wh);
  const int32_t* a_lens = static_cast<const int32_t*>(lens);
  T* a_dg = static_cast<T*>(dg);
  float* a_part = static_cast<float*>(part);
  int a_steps = steps, a_b = B, a_hd = H, a_hs = hs, a_rev = reverse;
  void* args[] = {&a_dy,   &a_xp,    &a_y, &a_c,  &a_wh, &a_lens, &a_dg,
                  &a_part, &a_steps, &a_b, &a_hd, &a_hs, &a_rev};
  e = cudaLaunchCooperativeKernel((void*)lstm_bwd_kernel<T>, dim3(nb),
                                  dim3(kThreads), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The cluster route: phase 1, every step's recurrent sums at once, then
// the backward chain
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kGateThreads)
lstm_bwd_gates_kernel(const T* __restrict__ y, const T* __restrict__ wh,
                      float* __restrict__ pre, int s0, int S, int steps,
                      int B, int H, int cols, int reverse) {
  gates_warp_body<T, Sums::kRec>(nullptr, nullptr, wh, wh, pre, S * B, 0, H,
                                 4, 1, cols,
                                 UniWalkRows<T>{y, s0, steps, B, H, reverse});
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads, 1)
lstm_bwd_gates_tiled_kernel(const T* __restrict__ y,
                            const T* __restrict__ wh,
                            float* __restrict__ pre, int s0, int S,
                            int steps, int B, int H, int reverse) {
  gates_tiled_body<T, Sums::kRec>(nullptr, nullptr, wh, wh, pre, S * B, 0,
                                  H, 4, 1,
                                  UniWalkRows<T>{y, s0, steps, B, H, reverse});
}

template <typename T>
__global__ void __launch_bounds__(kBwdChainThreads)
lstm_bwd_chain_kernel(const T* __restrict__ dy, const T* __restrict__ xp,
                      const float* __restrict__ cst,
                      const T* __restrict__ wh,
                      const int32_t* __restrict__ lens,
                      const float* __restrict__ pre, T* __restrict__ dg,
                      float* __restrict__ state, int s0, int S, int steps,
                      int B, int H, int R, int reverse) {
  bwd_chain_body<LstmBwdCell, false, T>(
      pre, xp, dy, static_cast<const T*>(nullptr), cst, nullptr, wh,
      static_cast<const T*>(nullptr), lens, dg, static_cast<T*>(nullptr),
      static_cast<T*>(nullptr), static_cast<T*>(nullptr), state, 1, s0, S,
      steps, B, H, R, reverse);
}

template <typename T>
int chain_launch(const void* dy, const void* xp, const void* cst,
                 const void* wh, const void* lens, const void* pre, void* dg,
                 void* state, int s0, int S, int steps, int B, int H, int C,
                 int R, int reverse, void* stream) {
  return bwd_chain_launch<LstmBwdCell, false>(
      lstm_bwd_chain_kernel<T>, C, 1, s0, S, steps, B, H, R, stream,
      static_cast<const T*>(dy), static_cast<const T*>(xp),
      static_cast<const float*>(cst), static_cast<const T*>(wh),
      static_cast<const int32_t*>(lens), static_cast<const float*>(pre),
      static_cast<T*>(dg), static_cast<float*>(state), s0, S, steps, B, H, R,
      reverse);
}

}  // namespace

extern "C" {

// the most batch rows one launch takes at H units on the current device
// (0: not one), or a negative CUDA error code; nothing is launched
int lstm_bwd_max_rows_f32(int H) { return max_rows_of<float>(H); }
int lstm_bwd_max_rows_bf16(int H) { return max_rows_of<__nv_bfloat16>(H); }

// floats of the partial-dh exchange the caller allocates for a launch at
// B, H on the current device: [2 parities][B][nb][nb][hs] (hs hidden
// units per block, nb blocks); -1 on error
int lstm_bwd_exchange_floats(int B, int H) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms <= 0 || H <= 0)
    return -1;
  const long long hs = units_per_block(H, sms), nb = (H + hs - 1) / hs;
  const long long n = 2LL * B * nb * nb * hs;
  return n > 0x7fffffffLL ? -1 : (int)n;
}

// part: the partial-dh exchange, lstm_bwd_exchange_floats(B, H) f32
int lstm_bwd_f32(const void* dy, const void* xp, const void* y,
                 const void* cst, const void* wh, const void* lens, void* dg,
                 void* part, int steps, int B, int H, int reverse,
                 void* stream) {
  return launch<float>(dy, xp, y, cst, wh, lens, dg, part, steps, B, H,
                       reverse, stream);
}

int lstm_bwd_bf16(const void* dy, const void* xp, const void* y,
                  const void* cst, const void* wh, const void* lens, void* dg,
                  void* part, int steps, int B, int H, int reverse,
                  void* stream) {
  return launch<__nv_bfloat16>(dy, xp, y, cst, wh, lens, dg, part, steps, B,
                               H, reverse, stream);
}

// the opt-in shared memory of one block on the current device, in bytes
// (the cluster route's plan sizes its clusters by it), or a negative CUDA
// error code
int lstm_bwd_smem_optin(void) { return smem_optin_bytes(); }

// The cluster route's phase 1 over walk steps s0 .. s0+S-1 of `steps`: y
// [T, B, H] and w_h [H, 4H] in the compute dtype -> pre [S, B, 4H] f32,
// row i the recurrent sums y[prev] . W_h of step s0 + i (t = T-1-s, or
// t = s with reverse).  cols 0: the tiled kernel (H <= 426); 1..32: the
// warp kernel with that many gate columns a block.
int lstm_bwd_gates_f32(const void* y, const void* wh, void* pre, int s0,
                       int S, int steps, int B, int H, int cols, int reverse,
                       void* stream) {
  return rec_gates_launch<float>(lstm_bwd_gates_tiled_kernel<float>,
                                 lstm_bwd_gates_kernel<float>, y, wh, pre,
                                 s0, S, steps, B, H, 4, cols, reverse,
                                 stream);
}

int lstm_bwd_gates_bf16(const void* y, const void* wh, void* pre, int s0,
                        int S, int steps, int B, int H, int cols,
                        int reverse, void* stream) {
  return rec_gates_launch<__nv_bfloat16>(
      lstm_bwd_gates_tiled_kernel<__nv_bfloat16>,
      lstm_bwd_gates_kernel<__nv_bfloat16>, y, wh, pre, s0, S, steps, B, H,
      4, cols, reverse, stream);
}

// The cluster route's phase 2 over the same steps: dy, x_proj, w_h in the
// compute dtype, c [T, B, H] f32, lens [B] int32, pre from phase 1 ->
// dgates [T, B, 4H] at those steps' frames; state [2][1][B][H] f32 holds
// dh and dc on entry and, unless the walk ends here, on exit.  C CTAs per
// cluster (a power of two <= 16), R rows per cluster.
int lstm_bwd_chain_f32(const void* dy, const void* xp, const void* cst,
                       const void* wh, const void* lens, const void* pre,
                       void* dg, void* state, int s0, int S, int steps,
                       int B, int H, int C, int R, int reverse,
                       void* stream) {
  return chain_launch<float>(dy, xp, cst, wh, lens, pre, dg, state, s0, S,
                             steps, B, H, C, R, reverse, stream);
}

int lstm_bwd_chain_bf16(const void* dy, const void* xp, const void* cst,
                        const void* wh, const void* lens, const void* pre,
                        void* dg, void* state, int s0, int S, int steps,
                        int B, int H, int C, int R, int reverse,
                        void* stream) {
  return chain_launch<__nv_bfloat16>(dy, xp, cst, wh, lens, pre, dg, state,
                                     s0, S, steps, B, H, C, R, reverse,
                                     stream);
}

const char* kctpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
