// The forward recurrence of an LSTM or a GRU in thread-block clusters:
// K2 (csrc/bilstm_fwd.cu: both LSTM directions from the hoisted projection
// xp), phase 2 of K10a (csrc/bilstm_fwd.cu: both directions, the
// projection from phase 1's f32 scratch), K5 (csrc/lstm_fwd.cu: one LSTM
// direction from x_proj), K9a (csrc/gru_fwd.cu: one GRU direction from
// x_proj) and K8a (csrc/gru_fwd.cu: both GRU directions from xp).  The
// cell is a policy (LstmCell, GruCell below): its number of
// gate columns per unit, its one f32 state per (row, unit) and its gate
// math.
//
// gates = pre[t] + h[t-1] . W_h with the operand h rounded to the compute
// dtype and f32 accumulation; gate math and the state are f32.  A frame t
// >= lens[b] carries h and the state and writes y = 0.  Outputs: y [T, B,
// H] in the compute dtype per direction and, for the LSTM, c [T, B, H] f32
// (the GRU's state is its f32 carry h, which it does not store).
//
// What bounds it on the H100: the serial chain, T steps of a [R, H] x
// [H, gates H] product per group of rows.  The product is no work for the
// card (~20 M MACs a step at B = 48, H = 320); what a step costs is its
// latency: reading h[t-1], the sums, the gate math and one exchange.
//
// Design: rows never meet, so one cluster of C CTAs (cudaLaunchKernelEx
// with a cluster dimension, no cooperative launch and no grid barrier)
// walks the steps of each (direction, group of R rows).  Each CTA keeps
// the gate columns of W_h of its ceil(H / C) units in shared memory for
// the whole walk, in the compute dtype (exact; it halves bf16's
// footprint), with its units' state and a double-buffered receive area
// for h[t-1] of its R rows.  A step:
//   1. the CTA's gate sums over h[t-1], R rows x gates ceil(H / C)
//      columns, in tiles of 32 outputs a warp: each lane sums its k =
//      lane, lane + 32, ... for all 32 with fmaf in order and warp_sum32
//      folds them, so every sum is warp_dot's bit for bit: the recompute
//      invariant of K3, K6, K9b and K10b, which recompute these gates with
//      warp_dot or tile_dot4x4 (no tensor-core mma here: it would break
//      it);
//   2. plus the step's pre-activation, prefetched (cp.async) into a
//      double buffer at the top of the step before;
//   3. the cell's gate math; y[t] (and the LSTM's c[t]) of its units
//      written;
//   4. its slice of h[t], rounded to the compute dtype as the next
//      operand, stored into every CTA's receive buffer of the other
//      parity through DSMEM (cluster.map_shared_rank);
//   5. one cluster barrier, split into arrive and wait (a training
//      forward stores step 1's sums between the two: below).
// A buffer read at step s is written at step s + 1 only after the
// barrier of step s, which every CTA reaches after its reads: one
// barrier a step is enough.  ceil(B / R) x dirs clusters run in as many
// waves as the card needs, so every B runs.  C and R come from the
// wrapper's plan (ops/rnn_cuda.py::fwd_chain_plan); the launcher checks
// them and returns the CUDA error when they do not fit.
//
// A walk may run in chunks of steps (K10a's scratch above 256 MiB): h and
// the state are read from and, unless the walk ends, written to an f32
// array [2 (h, state)][dirs][B][H] (zeros before the first step).
//
// The recurrent sums as a training residual (K2 and K8a, the two kernels
// whose backward runs on the backward chain of csrc/bwd_chain.cuh): with
// a non-null `sums` the launcher takes the kernel's kStore instance,
// which also stores the g_s values of every step, the sums of step s at
// row steps-1-s of an f32 array [steps, B, dirs G] (direction dir at dir
// G, gate q of unit j at q H + j).  That is the walk order of the
// backward chain, whose step s' handles the forward direction at t =
// T-1-s' and the backward one at t = s', so K3's and K8b's chain reads
// it as K6's and K9b's reads its phase 1's scratch.  These are the sums
// the gates were formed from, bit for bit, equal at every valid frame to
// a recompute from the stored y in warp_dot's order.  At a pad frame of
// the forward direction past its first (t > lens[b]) they are the sums
// over the carried h, where a recompute would sum the stored y = 0; the
// backward chain writes zero dgates there and carries nothing, so no
// output depends on them.  The stores go out between the cluster
// barrier's arrive and wait, from g_s, with one CTA barrier after the
// wait before the next step writes g_s (on the H100 at T = 240, B = 48,
// H = 320 in f32 K2 took 3% longer so, 5% with the stores in step 2-3,
// 4% with them before the arrive; K8a 0.3%).  The wrappers pass the
// pointer only where a backward is recorded (ops/rnn_cuda.py::
// bilstm_layer, ops/gru_cuda.py::bigru_layer).  With null (inference;
// every other kernel here has no kStore instance) the chain is the code
// it was: a runtime branch in one instance instead cost K2 8% a step in
// f32 with the pointer null.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bilstm_cell.cuh"

namespace {

namespace cgc = cooperative_groups;

constexpr int kChainFwdThreads = 256;
constexpr int kMaxChainCluster = 16;

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// The linear-before-reset GRU cell of ops/gru_pallas.py::_gru_gates: the
// projection parts xr, xz, xn, the recurrent sums hr, hz, hn and the f32
// carry h -> h' = (1 - z) n + z h, with r, z and n from gru_rzn() of
// csrc/bilstm_cell.cuh.  Every route of K8a and K9a calls it (the fmaf are
// explicit so that no route contracts otherwise).
__device__ __forceinline__ float gru_cell(float xr, float xz, float xn,
                                          float hr, float hz, float hn,
                                          float h) {
  float r, z, n;
  gru_rzn(xr, xz, xn, hr, hz, hn, r, z, n);
  return fmaf(z, h, (1.0f - z) * n);
}

// The cells of the chain.  step(): the gate sums s and the step's
// pre-activations x of one (row, unit), and its f32 state → h_new, the
// state updated.  kStoresState: the state is an output ([T, B, H] f32).

// gates i, f, g, o; the state is the cell state c.  c' = gi gg + gf c
// with the fmaf explicit: nvcc may contract either product, and every
// LSTM forward must agree bit for bit (K2's two routes call this; K5's
// cooperative kernel contracts its own expression the same way).
struct LstmCell {
  static constexpr int kGates = 4;
  static constexpr bool kStoresState = true;
  __device__ __forceinline__ static float step(const float (&s)[4],
                                               const float (&x)[4],
                                               float& c) {
    const float gi = sigmoid(s[0] + x[0]);
    const float gf = sigmoid(s[1] + x[1]);
    const float gg = tanhf(s[2] + x[2]);
    const float go = sigmoid(s[3] + x[3]);
    c = fmaf(gi, gg, gf * c);
    return go * tanhf(c);
  }
};

// gates r, z, n; the state is the carry h in f32
struct GruCell {
  static constexpr int kGates = 3;
  static constexpr bool kStoresState = false;
  __device__ __forceinline__ static float step(const float (&s)[3],
                                               const float (&x)[3],
                                               float& h) {
    h = gru_cell(x[0], x[1], x[2], s[0], s[1], s[2], h);
    return h;
  }
};

// bytes of a chain CTA's shared memory at cluster size C, R rows per
// cluster, H units, `gates` gate columns per unit, W_h and h in a type of
// `tsize` bytes (the layout of fwd_chain_body; ops/rnn_cuda.py::
// _fwd_chain_bytes sizes R by the same sum)
inline size_t fwd_chain_bytes(int C, int R, int H, int tsize, int gates) {
  const size_t hsz = (H + C - 1) / C;
  return align16(gates * hsz * H * tsize)       // W_h columns
         + align16((size_t)2 * R * H * tsize)   // receive, two parities
         + align16((size_t)R * hsz * tsize)     // this CTA's h slice
         // sums, state, prefetched pre-activations (two buffers)
         + sizeof(float) * (size_t)R * hsz * (gates + 1 + 2 * gates)
         + sizeof(int) * (size_t)R;             // lengths
}

// Cell: LstmCell or GruCell; T: the compute dtype; P: the
// pre-activation's type; RT rows by 32 / RT columns a warp tile.  pre row
// of (t, b): pre + ((t - t0) * B + b) * pre_stride + dir * gates H, gate q
// of unit j at q * H + j.  cf, cb: the LSTM's c outputs (unused by a
// cell that stores no state).  kStore: `sums` is the recurrent sums'
// residual [steps, B, dirs gates H] f32 in the backward's walk order (an
// instance of its own, so the chain without it is the code it was).
template <typename Cell, typename T, typename P, int RT, bool kStore = false>
__device__ __forceinline__ void fwd_chain_body(
    const P* __restrict__ pre, int pre_stride, int t0f, int t0b,
    const T* __restrict__ whf, const T* __restrict__ whb,
    const int32_t* __restrict__ lens, T* __restrict__ yf,
    float* __restrict__ cf, T* __restrict__ yb, float* __restrict__ cb,
    float* __restrict__ state, int dirs, int s0, int S, int steps, int B,
    int H, int R, int reverse, float* __restrict__ sums) {
  constexpr int kG = Cell::kGates;
  constexpr int CT = 32 / RT;
  extern __shared__ __align__(16) unsigned char fwd_chain_smem[];
  cgc::cluster_group cluster = cgc::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int groups = (B + R - 1) / R;
  const int cid = blockIdx.x / C;           // this cluster
  const int dir = cid / groups;
  const int r0 = (cid % groups) * R;        // its first row
  const int nr = min(R, B - r0);
  const int hsz = (H + C - 1) / C;          // units per rank
  const int j0 = rank * hsz;
  const int n = max(0, min(hsz, H - j0));   // units this CTA owns
  const int ng = kG * n;
  const int G = kG * H;
  const bool rev = (dir != 0) != (reverse != 0);
  const int t0 = dir == 0 ? t0f : t0b;
  const T* wh = dir == 0 ? whf : whb;
  T* y = dir == 0 ? yf : yb;
  float* cst = dir == 0 ? cf : cb;
  float* h_state = state + (size_t)dir * B * H;           // state[0][dir]
  float* s_state = state + (size_t)(dirs + dir) * B * H;  // state[1][dir]

  unsigned char* p = fwd_chain_smem;
  T* w_s = reinterpret_cast<T*>(p);         // [kG n][H]: column gate n + jj
  p += align16((size_t)kG * hsz * H * sizeof(T));
  T* recv = reinterpret_cast<T*>(p);        // [2][R][H]: h[t-1], operand
  p += align16((size_t)2 * R * H * sizeof(T));
  T* hl = reinterpret_cast<T*>(p);          // [R][hsz]: this CTA's h[t]
  p += align16((size_t)R * hsz * sizeof(T));
  float* g_s = reinterpret_cast<float*>(p);  // [R][kG n]: recurrent sums
  float* c_s = g_s + (size_t)kG * R * hsz;   // [nr][n]: the cell's state
  uint32_t* pf = reinterpret_cast<uint32_t*>(c_s + (size_t)R * hsz);
  int* lens_s = reinterpret_cast<int*>(pf + (size_t)2 * kG * R * hsz);

  for (int i = threadIdx.x; i < ng * H; i += blockDim.x) {
    const int k = i / ng, c = i % ng;
    const int gate = c / n, jj = c % n;
    w_s[(size_t)c * H + k] = wh[(size_t)k * G + gate * H + j0 + jj];
  }
  const int ne = nr * n;                    // (row, unit) elements
  for (int e = threadIdx.x; e < ne; e += blockDim.x)
    c_s[e] = s_state[(size_t)(r0 + e / n) * H + j0 + e % n];
  for (int i = threadIdx.x; i < nr * H; i += blockDim.x)
    recv[i] = from_f32<T>(h_state[(size_t)r0 * H + i]);
  for (int r = threadIdx.x; r < nr; r += blockDim.x) lens_s[r] = lens[r0 + r];

  auto time_of = [&](int s) { return rev ? steps - 1 - s : s; };
  auto pre_of = [&](int t, int b) {
    return pre + ((size_t)(t - t0) * B + b) * pre_stride + dir * G;
  };
  // step s's pre-activations of this thread's elements into buffer `buf`
  // (kG words an element, the words holding the gates' values): they
  // depend on nothing the chain computes
  auto prefetch = [&](int s, int buf) {
    const int t = time_of(s);
    uint32_t* q0 = pf + (size_t)buf * kG * R * hsz;
    for (int e = threadIdx.x; e < ne; e += blockDim.x) {
      const P* g = pre_of(t, r0 + e / n) + j0 + e % n;
      uint32_t* q = q0 + (size_t)e * kG;
#pragma unroll
      for (int gate = 0; gate < kG; ++gate)
        cp_async4(q + gate, word_of(g + gate * H));
    }
  };

  // kStore: step s's sums of this CTA, from g_s, at the backward's walk
  // row steps-1-s; streamed, as only the backward reads them
  auto store_sums = [&](int s) {
    float* row = sums + (size_t)(steps - 1 - s) * B * dirs * G +
                 (size_t)dir * G;
    for (int e = threadIdx.x; e < ne; e += blockDim.x) {
      const int r = e / n, jj = e % n;
      float* o = row + (size_t)(r0 + r) * dirs * G + j0 + jj;
      const float* g = g_s + r * ng + jj;
#pragma unroll
      for (int k = 0; k < kG; ++k) __stcs(o + k * H, g[k * n]);
    }
  };

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int col_tiles = (ng + CT - 1) / CT;
  const int tiles = n > 0 ? ((nr + RT - 1) / RT) * col_tiles : 0;

  prefetch(s0, 0);
  cp_async_wait_all();
  __syncthreads();
  cluster.sync();   // every CTA runs before any DSMEM store reaches it
  for (int i = 0; i < S; ++i) {
    const int s = s0 + i;
    const int t = time_of(s);
    // the next step's pre-activations load while this step runs (the
    // buffer they fill was read by the step before)
    if (i + 1 < S) prefetch(s + 1, (i + 1) & 1);
    const T* h_cur = recv + (size_t)(i & 1) * R * H;

    // 1. the recurrent sums, 32 outputs a warp tile (rows and columns
    // past the edge repeat the last one and are not stored)
    for (int tile = warp; tile < tiles; tile += nwarps) {
      const int ra = (tile / col_tiles) * RT, ca = (tile % col_tiles) * CT;
      const T* hr[RT];
      const T* wc[CT];
#pragma unroll
      for (int a = 0; a < RT; ++a) hr[a] = h_cur + min(ra + a, nr - 1) * H;
#pragma unroll
      for (int c = 0; c < CT; ++c) wc[c] = w_s + min(ca + c, ng - 1) * H;
      float v[32];
#pragma unroll
      for (int o = 0; o < 32; ++o) v[o] = 0.0f;
      for (int k = lane; k < H; k += 32) {
        float hv[RT], wv[CT];
#pragma unroll
        for (int a = 0; a < RT; ++a) hv[a] = to_f32(hr[a][k]);
#pragma unroll
        for (int c = 0; c < CT; ++c) wv[c] = to_f32(wc[c][k]);
#pragma unroll
        for (int a = 0; a < RT; ++a)
#pragma unroll
          for (int c = 0; c < CT; ++c)
            v[a * CT + c] = fmaf(hv[a], wv[c], v[a * CT + c]);
      }
      const float sum = warp_sum32(v, lane);
      const int r = ra + lane / CT, c = ca + lane % CT;
      if (r < nr && c < ng) g_s[r * ng + c] = sum;
    }
    __syncthreads();

    // 2-3. the gate math of this thread's elements
    const uint32_t* pq = pf + (size_t)(i & 1) * kG * R * hsz;
    for (int e = threadIdx.x; e < ne; e += blockDim.x) {
      const int r = e / n, jj = e % n, b = r0 + r, j = j0 + jj;
      const uint32_t* q = pq + (size_t)e * kG;
      const float* g = g_s + r * ng;
      const P* src = pre_of(t, b) + j;
      // gate k: the recurrent sum and the step's projection
      float s_k[kG], xs[kG];
#pragma unroll
      for (int k = 0; k < kG; ++k) {
        s_k[k] = g[k * n + jj];
        xs[k] = from_word(q[k], src + k * H);
      }
      const float s_prev = c_s[e];
      float s_new = s_prev;
      const float h_new = Cell::step(s_k, xs, s_new);
      const bool valid = t < lens_s[r];
      const float s_out = valid ? s_new : s_prev;
      c_s[e] = s_out;
      T h_out = h_cur[r * H + j];         // the carry, already rounded
      if (valid) h_out = from_f32<T>(h_new);
      hl[r * hsz + jj] = h_out;
      const size_t o = ((size_t)t * B + b) * H + j;
      y[o] = from_f32<T>(valid ? h_new : 0.0f);
      if constexpr (Cell::kStoresState) cst[o] = s_out;
    }
    if (i + 1 == S) {
      if constexpr (kStore) store_sums(s);
      break;
    }
    __syncthreads();

    // 4. this CTA's slice of h[t] into every CTA's next receive buffer
    T* next = recv + (size_t)((i + 1) & 1) * R * H;
    for (int idx = threadIdx.x; idx < C * ne; idx += blockDim.x) {
      const int to = idx / ne, e = idx % ne;
      const int r = e / n, jj = e % n;
      cluster.map_shared_rank(next, to)[r * H + j0 + jj] = hl[r * hsz + jj];
    }
    // 5. one barrier; the next step's pre-activations are in after it
    // (and, for a backward, the sums go out while the other CTAs arrive)
    cluster_arrive();
    if constexpr (kStore) store_sums(s);
    cluster_wait();
    // (the next step's tile loop writes g_s only after every thread's
    // store_sums has read it)
    if constexpr (kStore) __syncthreads();
    cp_async_wait_all();
  }
  if (s0 + S < steps) {   // the next chunk of steps takes the carries
    for (int e = threadIdx.x; e < ne; e += blockDim.x) {
      const int r = e / n, jj = e % n;
      const size_t o = (size_t)(r0 + r) * H + j0 + jj;
      h_state[o] = to_f32(hl[r * hsz + jj]);
      s_state[o] = c_s[e];
    }
  }
}

// Launch `kern` (a __global__ wrapper of fwd_chain_body with Cell) over
// dirs x ceil(B / R) clusters of C CTAs: C a power of two <= 16, R >= 1,
// the CTA's shared memory within the card's opt-in limit.  `extra`: the
// kernel's parameters after `reverse` (K2's and K8a's sums, or none).
template <typename Cell, typename T, typename P, typename... Extra>
cudaError_t fwd_chain_launch(
    void (*kern)(const P*, int, int, int, const T*, const T*, const int32_t*,
                 T*, float*, T*, float*, float*, int, int, int, int, int,
                 int, int, int, Extra...),
    const void* pre, int pre_stride, int t0f, int t0b, const void* whf,
    const void* whb, const void* lens, void* yf, void* cf, void* yb,
    void* cb, void* state, int dirs, int s0, int S, int steps, int B, int H,
    int C, int R, int reverse, void* stream, Extra... extra) {
  if (S <= 0 || B <= 0) return cudaGetLastError();
  if (C < 1 || C > kMaxChainCluster || (C & (C - 1)) != 0 || R < 1 ||
      H <= 0 || dirs < 1 || dirs > 2 || s0 < 0 || s0 + S > steps)
    return cudaErrorInvalidValue;
  const int optin = smem_optin_bytes();
  if (optin < 0) return static_cast<cudaError_t>(-optin);
  const size_t smem = fwd_chain_bytes(C, R, H, sizeof(T), Cell::kGates);
  if (smem > (size_t)optin) return cudaErrorLaunchOutOfResources;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  if (C > 8) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  const int groups = (B + R - 1) / R;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(dirs * groups * C);
  cfg.blockDim = dim3(kChainFwdThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kern, &cfg);
  if (e != cudaSuccess) return e;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const P*>(pre), pre_stride, t0f, t0b,
      static_cast<const T*>(whf), static_cast<const T*>(whb),
      static_cast<const int32_t*>(lens), static_cast<T*>(yf),
      static_cast<float*>(cf), static_cast<T*>(yb), static_cast<float*>(cb),
      static_cast<float*>(state), dirs, s0, S, steps, B, H, R, reverse,
      extra...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace
