// K9b and K8b: the backward recurrence of a GRU (dgates), one direction
// (K9b) or both directions of a bidirectional layer in one launch (K8b).
//
// Replaces kaldi_ctc_tpu/ops/gru_pallas.py::_gru_seq_bwd_dgates (kernel
// body _bwd_kernel; K9b) and ::_bigru_seq_bwd_dgates (_bibwd_kernel;
// K8b), both with _dgru_update and _gru_gates.  Inputs: the output
// cotangents dy [T, B, H] and the forward's residuals as K9a / K8a wrote
// or read them: the projection (x_proj [T, B, 3H], or xp [T, B, 6H] with
// the forward direction's 3H first; gate order r, z, n), y [T, B, H] of
// each direction in the compute dtype, the recurrent weights w_h [H, 3H],
// the lengths [B] and, for K9b, the forward's direction.  Outputs, both
// [T, B, 3H] in the compute dtype and zero at pad frames:
//   dgx = [dr, dz, dn], the cotangent of the projection;
//   dgh = [dr, dz, dn * r], the cotangent of h . W_h (dW_h and dh).
//
// The walk runs each direction's forward order in reverse: t = T-1-s for
// a forward direction (its previous frame is t-1), t = s for a reverse
// one (its previous frame is t+1); both directions of K8b reach their
// forward-first step at s = T-1.  At each step it
//   - forms r, z, n and hn from x_proj[t] and the recurrent sums
//     y[prev] . W_h: K8b's cluster route reads the sums K8a stored while
//     it ran (ops/gru_cuda.py::bigru_layer asks for them where a backward
//     is recorded; an inference forward stores nothing), the values K8a
//     formed its gates from; K9b and the
//     cooperative routes recompute them with y[prev] as stored (the
//     compute dtype, not the forward's f32 carry) and zero at the
//     forward's first step, f32 sums in K9a's order, so the gates equal
//     the forward's;
//   - forms dh_total = dy + dh, dn = dh_total (1-z)(1-n^2),
//     dz = dh_total (y[prev] - n) z (1-z), dr = dn hn r (1-r);
//   - at valid frames carries dh = dgh . W_h^T + dh_total * z, with dgh
//     rounded to the compute dtype as the operand and f32 sums.
// Gate math and dh are f32.
//
// What bounds it on the H100: the same serial chain as K9a, T steps, and
// each step needs the whole previous dgh row [B, 3H] of its direction to
// form dh.  At the training batch B = 48, H = 320 that row is 184 KB in
// f32: more than a block can hold beside its weights.
//
// K9b has two routes, chosen by the wrapper's plan from the shapes
// (ops/rnn_cuda.py::bwd_chain_plan with three gates), K6's
// (csrc/lstm_bwd.cu):
//   - the cluster route, wherever W_h's three gate columns fit a cluster
//     of at most 16 CTAs as f32 (H up to ~545): gru_bwd_gates_tiled_kernel
//     (H <= 426) or gru_bwd_gates_kernel computes the recurrent sums hr,
//     hz, hn = y[prev] . W_h of every step at once into an f32 scratch
//     [S, B, 3H] (csrc/lstm_gates.cuh, warp_dot's order: K9a's sums), then
//     gru_bwd_chain_kernel walks the dh chain, the backward chain of
//     csrc/bwd_chain.cuh with the GRU cell (GruBwdCell: r, z and n formed
//     by gru_rzn() from x_proj[t] and the sums, as K9a's gru_cell() forms
//     them; the residual y[prev]; dh_total z added to the summed
//     partials).  Any B, no row slices; a scratch above 256 MiB runs in
//     chunks of steps, dh carried between them;
//   - the cooperative route above that: gru_bwd_kernel, below.
// K8b has the same two routes with both directions (ops/gru_cuda.py::
// k8b_plan, the same plan with dirs 2), K3's (csrc/bilstm_bwd.cu) with the
// GRU cell:
//   - the cluster route, to the same H (K8a takes its cluster route there
//     too): bigru_bwd_chain_kernel (its own name, so a trace tells it from
//     K9b's chain) on the sums hr, hz, hn that K8a's cluster route stored,
//     [T, B, 6H] f32 in this walk's order (row s: the forward direction's
//     at t = T-1-s, the backward one's at t = s; csrc/fwd_chain.cuh), read
//     whole in one launch.  It walks both directions' dh chains, one
//     cluster per (direction, R rows), reading xp at stride 6H and each
//     direction's y[prev] residual.  The sums are K8a's, which K9b's phase
//     1 recomputes bit for bit from y (the recompute invariant), and the
//     cell is K9b's, so each direction equals K9b's chain on its operands
//     bit for bit at every valid frame (rows never meet: R does not change a row's
//     sums).  Any B; state [1][2][B][H] holds each direction's dh;
//   - the cooperative route (bigru_bwd_kernel) above that H.
//
// The cooperative design: K6's and K3's (csrc/lstm_bwd.cu,
// csrc/bilstm_bwd.cu) with three gate columns per unit.  One cooperative
// launch; each block owns hs hidden units of one direction and keeps
// those units' three gate columns of W_h (3*hs x H) in shared memory for
// the whole walk, with their dh and dh_total * z.  The columns serve both
// products: the gate recompute sums y[b, k] * W_h[k, c] over k for the
// block's columns c, and the block's share of dh sums dgh[b, c] * W_h[k,
// c] over its own columns c, for every k.  Blocks exchange those partial
// dh rows, not dgh: each block writes a [B, H] partial (f32,
// st.global.cg) into a double-buffered array laid out so that the hs
// units of one owner are contiguous across the writing blocks; after the
// step's one grid.sync() each block sums the nb partials of its own units
// (ld.global.cg) in a fixed order and adds dh_total * z, so the sums stay
// f32 and deterministic.  The next step's gate recompute needs no
// exchange (y is in device memory) and runs before the barrier.  Every
// row's y, sums and dgh stay in shared memory, so a launch takes at most
// gru_bwd_max_rows(H) rows (~80 at H = 576; bigru_bwd_max_rows ~148 at
// H = 320); the wrapper runs a larger batch as row slices.

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

// The backward walk of DIRS directions; block blockIdx.x owns units
// j0 .. j0+n-1 of direction blockIdx.x / nb.  Direction d's forward ran
// backwards in time when DIRS == 2 and d == 1, or when DIRS == 1 and
// reverse.
template <typename T, int DIRS>
__device__ __forceinline__ void gru_bwd_body(
    const T* __restrict__ dy0, const T* __restrict__ dy1,
    const T* __restrict__ xp, const T* __restrict__ y0,
    const T* __restrict__ y1, const T* __restrict__ wh0,
    const T* __restrict__ wh1, const int32_t* __restrict__ lens,
    T* __restrict__ dgx0, T* __restrict__ dgh0, T* __restrict__ dgx1,
    T* __restrict__ dgh1, float* part, int steps, int B, int H, int hs,
    int reverse) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int nb = (H + hs - 1) / hs;         // blocks per direction
  const int dir = blockIdx.x / nb;
  const int own = blockIdx.x % nb;          // this block's unit group
  const int j0 = own * hs;
  const int n = min(hs, H - j0);            // hidden units this block owns
  const int n3 = 3 * n;
  const int G = 3 * H;
  const bool rev = DIRS == 2 ? dir == 1 : reverse != 0;
  const T* wh = dir == 0 ? wh0 : wh1;
  const T* dy = dir == 0 ? dy0 : dy1;
  const T* y = dir == 0 ? y0 : y1;
  T* dgx = dir == 0 ? dgx0 : dgx1;
  T* dgh = dir == 0 ? dgh0 : dgh1;
  // partial dh: [parity][direction][B][owner group][writer][hs]
  const size_t psize = (size_t)B * nb * nb * hs;

  float* w_s = smem;                  // [3n][H]: column c = gate * n + jj
  float* y_s = w_s + 3 * hs * H;      // [B][H]: y[prev], the gate operand
  float* g_s = y_s + B * H;           // [B][3n]: recurrent sums hr, hz, hn
  float* dg_s = g_s + B * 3 * hs;     // [B][3n]: dgh as the dh operand
  float* dh_s = dg_s + B * 3 * hs;    // [B][n]: dh carry of owned units
  float* dz_s = dh_s + B * hs;        // [B][n]: dh_total * z of owned units

  for (int i = threadIdx.x; i < n3 * H; i += blockDim.x) {
    const int c = i / H, k = i % H;
    const int gate = c / n, jj = c % n;
    w_s[i] = to_f32(wh[(size_t)k * G + gate * H + j0 + jj]);
  }
  for (int i = threadIdx.x; i < B * n; i += blockDim.x) dh_s[i] = 0.0f;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  auto time_of = [&](int s) { return rev ? s : steps - 1 - s; };
  auto prev_of = [&](int t) { return rev ? t + 1 : t - 1; };

  // recurrent sums of walk step s into g_s (K9a's dot products)
  auto gate_sums = [&](int s) {
    const bool first = s == steps - 1;  // the forward's first step
    if (!first) {
      const T* yp = y + (size_t)prev_of(time_of(s)) * B * H;
      for (int i = threadIdx.x; i < B * H; i += blockDim.x)
        y_s[i] = to_f32(yp[i]);
    }
    __syncthreads();
    for (int o = warp; o < B * n3; o += nwarps) {
      const int b = o / n3, c = o % n3;
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
      // dh = dgh[s-1] . W_h^T + dh_total[s-1] * z[s-1]: the sum of every
      // block's partial, carried only where step s-1 was a valid frame
      const int t1 = time_of(s - 1);
      const float* p = part + ((size_t)((s - 1) & 1) * DIRS + dir) * psize;
      for (int e = threadIdx.x; e < B * n; e += blockDim.x) {
        const int b = e / n, jj = e % n;
        if (t1 >= lens[b]) continue;
        const float* q = p + ((size_t)b * nb + own) * nb * hs + jj;
        float acc = 0.0f;
        for (int w = 0; w < nb; ++w) acc += __ldcg(q + (size_t)w * hs);
        dh_s[e] = acc + dz_s[e];
      }
    }
    for (int e = threadIdx.x; e < B * n; e += blockDim.x) {
      const int b = e / n, jj = e % n, j = j0 + jj;
      const T* x = xp + ((size_t)t * B + b) * DIRS * G + dir * G;
      const float* g = g_s + b * n3;
      const float r = sigmoid(to_f32(x[j]) + g[jj]);
      const float z = sigmoid(to_f32(x[H + j]) + g[n + jj]);
      const float hn = g[2 * n + jj];
      const float nn = tanhf(to_f32(x[2 * H + j]) + r * hn);
      const float hp = first ? 0.0f : to_f32(y[((size_t)tp * B + b) * H + j]);
      const size_t o = ((size_t)t * B + b) * H + j;
      const float dht = to_f32(dy[o]) + dh_s[e];
      const bool valid = t < lens[b];
      const float d_n = valid ? dht * (1.0f - z) * (1.0f - nn * nn) : 0.0f;
      const float d_z = valid ? dht * (hp - nn) * z * (1.0f - z) : 0.0f;
      const float d_r = valid ? d_n * hn * r * (1.0f - r) : 0.0f;
      const T r_r = from_f32<T>(d_r), r_z = from_f32<T>(d_z);
      const T r_nh = from_f32<T>(d_n * r);
      const size_t og = ((size_t)t * B + b) * G;
      dgx[og + j] = r_r;
      dgx[og + H + j] = r_z;
      dgx[og + 2 * H + j] = from_f32<T>(d_n);
      dgh[og + j] = r_r;
      dgh[og + H + j] = r_z;
      dgh[og + 2 * H + j] = r_nh;
      float* d = dg_s + b * n3;
      d[jj] = to_f32(r_r);
      d[n + jj] = to_f32(r_z);
      d[2 * n + jj] = to_f32(r_nh);
      dz_s[e] = dht * z;
    }
    __syncthreads();
    if (s + 1 == steps) break;
    // this block's share of the next dh: its own columns, every unit k
    float* p = part + ((size_t)(s & 1) * DIRS + dir) * psize;
    for (int i = threadIdx.x; i < B * H; i += blockDim.x) {
      const int b = i / H, k = i % H;
      const float* d = dg_s + b * n3;
      float acc = 0.0f;
      for (int c = 0; c < n3; ++c) acc = fmaf(d[c], w_s[c * H + k], acc);
      __stcg(p + (((size_t)b * nb + k / hs) * nb + own) * hs + k % hs, acc);
    }
    gate_sums(s + 1);
    grid.sync();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gru_bwd_kernel(const T* __restrict__ dy0, const T* __restrict__ dy1,
               const T* __restrict__ xp, const T* __restrict__ y0,
               const T* __restrict__ y1, const T* __restrict__ wh0,
               const T* __restrict__ wh1, const int32_t* __restrict__ lens,
               T* __restrict__ dgx0, T* __restrict__ dgh0,
               T* __restrict__ dgx1, T* __restrict__ dgh1, float* part,
               int steps, int B, int H, int hs, int reverse) {
  gru_bwd_body<T, 1>(dy0, dy1, xp, y0, y1, wh0, wh1, lens, dgx0, dgh0, dgx1,
                     dgh1, part, steps, B, H, hs, reverse);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bigru_bwd_kernel(const T* __restrict__ dy0, const T* __restrict__ dy1,
                 const T* __restrict__ xp, const T* __restrict__ y0,
                 const T* __restrict__ y1, const T* __restrict__ wh0,
                 const T* __restrict__ wh1,
                 const int32_t* __restrict__ lens, T* __restrict__ dgx0,
                 T* __restrict__ dgh0, T* __restrict__ dgx1,
                 T* __restrict__ dgh1, float* part, int steps, int B, int H,
                 int hs, int reverse) {
  gru_bwd_body<T, 2>(dy0, dy1, xp, y0, y1, wh0, wh1, lens, dgx0, dgh0, dgx1,
                     dgh1, part, steps, B, H, hs, reverse);
}

// hidden units per block: every direction's blocks in one wave of the SMs
int units_per_block(int dirs, int H, int sms) {
  return (dirs * H + sms - 1) / sms;
}

// The launch's geometry at B rows of `dirs` directions: hs hidden units
// per block, nb blocks per direction and the shared memory in bytes;
// refuses rows that do not fit one block and a grid that is not
// co-resident.  The launch and the *_max_rows queries share it.
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
  *hs = units_per_block(dirs, H, sms);
  *nb = (H + *hs - 1) / *hs;
  *smem = sizeof(float) * ((size_t)3 * *hs * H + (size_t)B * H +
                           (size_t)2 * B * 3 * *hs + (size_t)2 * B * *hs);
  if (*smem > (size_t)optin) return cudaErrorLaunchOutOfResources;
  auto kern = dirs == 2 ? &bigru_bwd_kernel<T> : &gru_bwd_kernel<T>;
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
int launch(bool bidirectional, const void* dy0, const void* dy1,
           const void* xp, const void* y0, const void* y1, const void* wh0,
           const void* wh1, const void* lens, void* dgx0, void* dgh0,
           void* dgx1, void* dgh1, void* part, int steps, int B, int H,
           int reverse, void* stream) {
  if (steps <= 0 || B <= 0) return cudaGetLastError();
  const int dirs = bidirectional ? 2 : 1;
  int hs = 0, nb = 0;
  size_t smem = 0;
  cudaError_t e = plan<T>(dirs, B, H, &hs, &nb, &smem);
  if (e != cudaSuccess) return e;
  auto kern = bidirectional ? &bigru_bwd_kernel<T> : &gru_bwd_kernel<T>;

  const T* a_dy0 = static_cast<const T*>(dy0);
  const T* a_dy1 = static_cast<const T*>(dy1);
  const T* a_xp = static_cast<const T*>(xp);
  const T* a_y0 = static_cast<const T*>(y0);
  const T* a_y1 = static_cast<const T*>(y1);
  const T* a_wh0 = static_cast<const T*>(wh0);
  const T* a_wh1 = static_cast<const T*>(wh1);
  const int32_t* a_lens = static_cast<const int32_t*>(lens);
  T* a_dgx0 = static_cast<T*>(dgx0);
  T* a_dgh0 = static_cast<T*>(dgh0);
  T* a_dgx1 = static_cast<T*>(dgx1);
  T* a_dgh1 = static_cast<T*>(dgh1);
  float* a_part = static_cast<float*>(part);
  int a_steps = steps, a_b = B, a_hd = H, a_hs = hs, a_rev = reverse;
  void* args[] = {&a_dy0,  &a_dy1,  &a_xp,   &a_y0,   &a_y1,    &a_wh0,
                  &a_wh1,  &a_lens, &a_dgx0, &a_dgh0, &a_dgx1,  &a_dgh1,
                  &a_part, &a_steps, &a_b,   &a_hd,   &a_hs,    &a_rev};
  e = cudaLaunchCooperativeKernel((void*)kern, dim3(dirs * nb),
                                  dim3(kThreads), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K9b's cluster route: phase 1, every step's recurrent sums at once, then
// the backward chain
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kGateThreads)
gru_bwd_gates_kernel(const T* __restrict__ y, const T* __restrict__ wh,
                     float* __restrict__ pre, int s0, int S, int steps,
                     int B, int H, int cols, int reverse) {
  gates_warp_body<T, Sums::kRec>(nullptr, nullptr, wh, wh, pre, S * B, 0, H,
                                 3, 1, cols,
                                 UniWalkRows<T>{y, s0, steps, B, H, reverse});
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads, 1)
gru_bwd_gates_tiled_kernel(const T* __restrict__ y,
                           const T* __restrict__ wh,
                           float* __restrict__ pre, int s0, int S, int steps,
                           int B, int H, int reverse) {
  gates_tiled_body<T, Sums::kRec>(nullptr, nullptr, wh, wh, pre, S * B, 0,
                                  H, 3, 1,
                                  UniWalkRows<T>{y, s0, steps, B, H, reverse});
}

template <typename T>
__global__ void __launch_bounds__(kBwdChainThreads)
gru_bwd_chain_kernel(const T* __restrict__ dy, const T* __restrict__ xp,
                     const T* __restrict__ y, const T* __restrict__ wh,
                     const int32_t* __restrict__ lens,
                     const float* __restrict__ pre, T* __restrict__ dgx,
                     T* __restrict__ dgh, float* __restrict__ state, int s0,
                     int S, int steps, int B, int H, int R, int reverse) {
  bwd_chain_body<GruBwdCell, false, T>(
      pre, xp, dy, static_cast<const T*>(nullptr), y, nullptr, wh,
      static_cast<const T*>(nullptr), lens, dgx, dgh,
      static_cast<T*>(nullptr), static_cast<T*>(nullptr), state, 1, s0, S,
      steps, B, H, R, reverse);
}

template <typename T>
int chain_launch(const void* dy, const void* xp, const void* y,
                 const void* wh, const void* lens, const void* pre,
                 void* dgx, void* dgh, void* state, int s0, int S, int steps,
                 int B, int H, int C, int R, int reverse, void* stream) {
  return bwd_chain_launch<GruBwdCell, false>(
      gru_bwd_chain_kernel<T>, C, 1, s0, S, steps, B, H, R, stream,
      static_cast<const T*>(dy), static_cast<const T*>(xp),
      static_cast<const T*>(y), static_cast<const T*>(wh),
      static_cast<const int32_t*>(lens), static_cast<const float*>(pre),
      static_cast<T*>(dgx), static_cast<T*>(dgh), static_cast<float*>(state),
      s0, S, steps, B, H, R, reverse);
}

// ---------------------------------------------------------------------------
// K8b's cluster route: the backward chain with both directions on K8a's
// stored recurrent sums
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kBwdChainThreads)
bigru_bwd_chain_kernel(const T* __restrict__ dyf, const T* __restrict__ dyb,
                       const T* __restrict__ xp, const T* __restrict__ yf,
                       const T* __restrict__ yb, const T* __restrict__ whf,
                       const T* __restrict__ whb,
                       const int32_t* __restrict__ lens,
                       const float* __restrict__ pre, T* __restrict__ dgxf,
                       T* __restrict__ dghf, T* __restrict__ dgxb,
                       T* __restrict__ dghb, float* __restrict__ state,
                       int s0, int S, int steps, int B, int H, int R) {
  bwd_chain_body<GruBwdCell, false, T>(
      pre, xp, dyf, dyb, yf, yb, whf, whb, lens, dgxf, dghf, dgxb, dghb,
      state, 2, s0, S, steps, B, H, R, 0);
}

template <typename T>
int bi_chain_launch(const void* dyf, const void* dyb, const void* xp,
                    const void* yf, const void* yb, const void* whf,
                    const void* whb, const void* lens, const void* pre,
                    void* dgxf, void* dghf, void* dgxb, void* dghb,
                    void* state, int steps, int B, int H, int C, int R,
                    void* stream) {
  return bwd_chain_launch<GruBwdCell, false>(
      bigru_bwd_chain_kernel<T>, C, 2, 0, steps, steps, B, H, R, stream,
      static_cast<const T*>(dyf), static_cast<const T*>(dyb),
      static_cast<const T*>(xp), static_cast<const T*>(yf),
      static_cast<const T*>(yb), static_cast<const T*>(whf),
      static_cast<const T*>(whb), static_cast<const int32_t*>(lens),
      static_cast<const float*>(pre), static_cast<T*>(dgxf),
      static_cast<T*>(dghf), static_cast<T*>(dgxb), static_cast<T*>(dghb),
      static_cast<float*>(state), 0, steps, steps, B, H, R);
}

}  // namespace

extern "C" {

// the most batch rows one launch of K9b (gru_*) or K8b (bigru_*) takes at
// H units on the current device (0: not one), or a negative CUDA error
// code; nothing is launched
int gru_bwd_max_rows_f32(int H) { return max_rows_of<float>(1, H); }
int gru_bwd_max_rows_bf16(int H) {
  return max_rows_of<__nv_bfloat16>(1, H);
}
int bigru_bwd_max_rows_f32(int H) { return max_rows_of<float>(2, H); }
int bigru_bwd_max_rows_bf16(int H) {
  return max_rows_of<__nv_bfloat16>(2, H);
}

// floats of the partial-dh exchange the caller allocates for a launch of
// `dirs` directions at B, H on the current device:
// [2 parities][dirs][B][nb][nb][hs] (hs hidden units per block, nb
// blocks per direction); -1 on error
int gru_bwd_exchange_floats(int dirs, int B, int H) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms <= 0 || H <= 0 || (dirs != 1 && dirs != 2))
    return -1;
  const long long hs = units_per_block(dirs, H, sms), nb = (H + hs - 1) / hs;
  const long long n = 2LL * dirs * B * nb * nb * hs;
  return n > 0x7fffffffLL ? -1 : (int)n;
}

// K9b.  part: the partial-dh exchange, gru_bwd_exchange_floats(1, B, H)
int gru_bwd_f32(const void* dy, const void* xp, const void* y,
                const void* wh, const void* lens, void* dgx, void* dgh,
                void* part, int steps, int B, int H, int reverse,
                void* stream) {
  return launch<float>(false, dy, dy, xp, y, y, wh, wh, lens, dgx, dgh, dgx,
                       dgh, part, steps, B, H, reverse, stream);
}

int gru_bwd_bf16(const void* dy, const void* xp, const void* y,
                 const void* wh, const void* lens, void* dgx, void* dgh,
                 void* part, int steps, int B, int H, int reverse,
                 void* stream) {
  return launch<__nv_bfloat16>(false, dy, dy, xp, y, y, wh, wh, lens, dgx,
                               dgh, dgx, dgh, part, steps, B, H, reverse,
                               stream);
}

// the opt-in shared memory of one block on the current device, in bytes
// (K9b's cluster route sizes its clusters by it), or a negative CUDA
// error code
int gru_bwd_smem_optin(void) { return smem_optin_bytes(); }

// K9b's cluster route, phase 1 over walk steps s0 .. s0+S-1 of `steps`: y
// [T, B, H] and w_h [H, 3H] in the compute dtype -> pre [S, B, 3H] f32,
// row i the recurrent sums hr, hz, hn of step s0 + i (t = T-1-s, or t = s
// with reverse).  cols 0: the tiled kernel (H <= 426); 1..32: the warp
// kernel with that many gate columns a block.
int gru_bwd_gates_f32(const void* y, const void* wh, void* pre, int s0,
                      int S, int steps, int B, int H, int cols, int reverse,
                      void* stream) {
  return rec_gates_launch<float>(gru_bwd_gates_tiled_kernel<float>,
                                 gru_bwd_gates_kernel<float>, y, wh, pre,
                                 s0, S, steps, B, H, 3, cols, reverse,
                                 stream);
}

int gru_bwd_gates_bf16(const void* y, const void* wh, void* pre, int s0,
                       int S, int steps, int B, int H, int cols, int reverse,
                       void* stream) {
  return rec_gates_launch<__nv_bfloat16>(
      gru_bwd_gates_tiled_kernel<__nv_bfloat16>,
      gru_bwd_gates_kernel<__nv_bfloat16>, y, wh, pre, s0, S, steps, B, H,
      3, cols, reverse, stream);
}

// K9b's cluster route, phase 2 over the same steps: dy, x_proj, y, w_h in
// the compute dtype, lens [B] int32, pre from phase 1 -> dgx, dgh
// [T, B, 3H] at those steps' frames; state [1][1][B][H] f32 holds dh on
// entry and, unless the walk ends here, on exit.  C CTAs per cluster (a
// power of two <= 16), R rows per cluster.
int gru_bwd_chain_f32(const void* dy, const void* xp, const void* y,
                      const void* wh, const void* lens, const void* pre,
                      void* dgx, void* dgh, void* state, int s0, int S,
                      int steps, int B, int H, int C, int R, int reverse,
                      void* stream) {
  return chain_launch<float>(dy, xp, y, wh, lens, pre, dgx, dgh, state, s0,
                             S, steps, B, H, C, R, reverse, stream);
}

int gru_bwd_chain_bf16(const void* dy, const void* xp, const void* y,
                       const void* wh, const void* lens, const void* pre,
                       void* dgx, void* dgh, void* state, int s0, int S,
                       int steps, int B, int H, int C, int R, int reverse,
                       void* stream) {
  return chain_launch<__nv_bfloat16>(dy, xp, y, wh, lens, pre, dgx, dgh,
                                     state, s0, S, steps, B, H, C, R,
                                     reverse, stream);
}

// K8b's cooperative route.  part: gru_bwd_exchange_floats(2, B, H)
int bigru_bwd_f32(const void* dyf, const void* dyb, const void* xp,
                  const void* yf, const void* yb, const void* whf,
                  const void* whb, const void* lens, void* dgxf, void* dghf,
                  void* dgxb, void* dghb, void* part, int steps, int B, int H,
                  void* stream) {
  return launch<float>(true, dyf, dyb, xp, yf, yb, whf, whb, lens, dgxf,
                       dghf, dgxb, dghb, part, steps, B, H, 0, stream);
}

int bigru_bwd_bf16(const void* dyf, const void* dyb, const void* xp,
                   const void* yf, const void* yb, const void* whf,
                   const void* whb, const void* lens, void* dgxf, void* dghf,
                   void* dgxb, void* dghb, void* part, int steps, int B,
                   int H, void* stream) {
  return launch<__nv_bfloat16>(true, dyf, dyb, xp, yf, yb, whf, whb, lens,
                               dgxf, dghf, dgxb, dghb, part, steps, B, H, 0,
                               stream);
}

// K8b's cluster route, the whole walk of `steps` steps: dy_f, dy_b, xp
// [T, B, 6H], y_f, y_b, w_h_f, w_h_b in the compute dtype, lens [B] int32,
// pre: the recurrent sums K8a stored ([T, B, 6H] f32, row s the sums of
// walk step s) -> dgx_f, dgh_f, dgx_b, dgh_b [T, B, 3H]; state
// [1][2][B][H] f32, zeros: each direction's dh carry.  C CTAs per cluster
// (a power of two <= 16), R rows per cluster.
int bigru_bwd_chain_f32(const void* dyf, const void* dyb, const void* xp,
                        const void* yf, const void* yb, const void* whf,
                        const void* whb, const void* lens, const void* pre,
                        void* dgxf, void* dghf, void* dgxb, void* dghb,
                        void* state, int steps, int B, int H, int C, int R,
                        void* stream) {
  return bi_chain_launch<float>(dyf, dyb, xp, yf, yb, whf, whb, lens, pre,
                                dgxf, dghf, dgxb, dghb, state, steps, B, H, C,
                                R, stream);
}

int bigru_bwd_chain_bf16(const void* dyf, const void* dyb, const void* xp,
                         const void* yf, const void* yb, const void* whf,
                         const void* whb, const void* lens, const void* pre,
                         void* dgxf, void* dghf, void* dgxb, void* dghb,
                         void* state, int steps, int B, int H, int C, int R,
                         void* stream) {
  return bi_chain_launch<__nv_bfloat16>(dyf, dyb, xp, yf, yb, whf, whb, lens,
                                        pre, dgxf, dghf, dgxb, dghb, state,
                                        steps, B, H, C, R, stream);
}

const char* kctpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
