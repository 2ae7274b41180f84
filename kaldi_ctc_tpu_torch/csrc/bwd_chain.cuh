// The backward recurrence of an LSTM or a GRU in thread-block clusters:
// phase 2 of K10b (csrc/bilstm_bwd.cu: both LSTM directions, the gate
// pre-activations from its phase 1), K6 (csrc/lstm_bwd.cu: one LSTM
// direction) and K9b (csrc/gru_bwd.cu: one GRU direction) on their phase
// 1's recurrent sums, and K3 (csrc/bilstm_bwd.cu: both LSTM directions)
// and K8b (csrc/gru_bwd.cu: both GRU directions) on the recurrent sums
// their forward (K2, K8a) stored; all but K10b add the stored projection
// (xp or x_proj).  The cell is a policy (LstmBwdCell, GruBwdCell below):
// its gate columns per unit, the residuals it reads, its carries and its
// gate math.
//
// The sums depend only on the stored y, never on the dh recurrence, so
// phase 1 (csrc/lstm_gates.cuh) computes every step's at once, or the
// forward chain keeps the ones it formed (csrc/fwd_chain.cuh, K2 and K8a
// where a backward is recorded); what is left serial is dh -> dgates ->
// dgates . W_h^T -> dh.  Either way the array is [steps, B, dirs gates H]
// f32 in this walk's order, row s holding walk step s.  The walk runs each
// direction's forward order in reverse (step s at t = T-1-s for a
// forward direction, whose previous frame is t-1; at t = s for a reverse
// one, previous frame t+1).  At each step, for each (row, unit):
//   - the gates, from the scratch (K10b: the pre-activation; K3, K6,
//     K8b, K9b: the recurrent sum, to which the chain adds x_proj[t], the
//     one addition the forward chain makes, so the gates equal the
//     forward's bit for bit: the forward's own sums for K3 and K8b, the
//     recompute invariant for the others);
//   - dh_total = dy[t] + dh and the cell's gate math: the dgates written
//     in the compute dtype, zero at pad frames;
//   - the CTA's partial dh = dgates_own . W_h_own^T for every unit k, the
//     dgates rounded to the compute dtype, f32 sums; each CTA sums the C
//     partials of its own units, and the cell adds its own term (the
//     GRU's dh_total z); dh is carried only where the frame was valid.
//
// What bounds it on the H100: the T serial steps.  A step is a [R, gates
// H] x [gates H, H] product per group of R rows (205 K MACs a CTA at H =
// 320, R = 8, 16 CTAs): what it costs is its latency, the gate math, the
// product and one exchange.
//
// Design (K10b's phase 2, made generic): rows never meet, so one cluster of C CTAs
// (cudaLaunchKernelEx with a cluster dimension, no cooperative launch
// and no grid barrier) walks the steps of each (direction, group of R
// rows).  Each CTA keeps its ceil(H/C) units' gate columns of W_h in
// shared memory as f32 with their carries.  A step: the gate math from
// the prefetched operands; the dgates written; the CTA's partial dh for
// every unit k stored into k's owner's shared memory through DSMEM
// (cluster.map_shared_rank); one cluster barrier, split into
// barrier.cluster.arrive and wait; then each CTA sums the C partials of
// its own units in rank order.  The next step's scratch, x_proj and
// residuals do not depend on dh: cp.async loads them into a double
// buffer from the top of the step, and the step waits for them after the
// barrier.  The partial sums run four interleaved accumulators per row
// (short dependent chains, column c into accumulator c mod 4), added in a
// fixed order, so the sums are deterministic.  ceil(B / R) x dirs
// clusters run in as many waves as the card needs: any B.  C and R come
// from the wrapper's plan (ops/rnn_cuda.py::k10b_plan, ::bwd_chain_plan);
// the launcher checks them and returns the CUDA error when they do not
// fit.
//
// A walk may run in chunks of steps (a phase-1 scratch above 256 MiB;
// K3 and K8b read the forward's whole array in one walk):
// the carries (dh, and the LSTM's dc) are read from and, unless the walk
// ends, written to an f32 array [carries][dirs][B][H] (zeros before the
// first step).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bilstm_cell.cuh"

namespace {

namespace cgb = cooperative_groups;

constexpr int kBwdChainThreads = 256;
constexpr int kMaxBwdCluster = 16;

// The cells.  kRes: the residual's words prefetched per (row, unit) (the
// residual res: the LSTM's c [T, B, H] f32, the GRU's y [T, B, H] in the
// compute dtype); kCarries: the carries kept across chunks of steps;
// kUnroll: the unrolling of the dh product's column loop.
// step(): one (row, unit) at one valid or pad frame, from the gate sums s
// and projection parts x (kPre: s holds the pre-activation, x is unused),
// the prefetched residual words q, dh_total, and the cell's second per-
// element value c2 → the outputs written at og + gate H + j (the LSTM's
// dgates in out0; the GRU's dgx in out0, dgh in out1), the dgates of the
// dh product in dg (the stored values, back in f32), c2 updated.  dh():
// the next dh from the summed partials and c2.

// gates i, f, g, o; the residual is c; c2 is the carry dc
struct LstmBwdCell {
  static constexpr int kGates = 4;
  static constexpr int kRes = 2;      // c[t], c[prev]
  static constexpr int kCarries = 2;  // dh, dc
  static constexpr int kUnroll = 4;   // the dh product's column loop

  template <typename T>
  __device__ __forceinline__ static void prefetch(uint32_t* q,
                                                  const void* res, size_t o,
                                                  size_t op, bool first) {
    const float* c = static_cast<const float*>(res);
    cp_async4(q, c + o);
    if (!first) cp_async4(q + 1, c + op);
  }

  template <bool kPre, typename T>
  __device__ __forceinline__ static void step(
      const float (&s)[4], const float (&x)[4], const uint32_t* q,
      const void*, size_t, T* __restrict__ out0, T*, size_t og, int H,
      int j, bool first, bool valid, float dht, float& dc,
      float (&dg)[4]) {
    // pre-activation of gate k: the recurrent sum plus the projection,
    // the forward chain's LstmCell sum (a + b = b + a exactly)
    auto pre = [&](int k) { return kPre ? s[k] : s[k] + x[k]; };
    const float gi = sigmoid(pre(0));
    const float gf = sigmoid(pre(1));
    const float gg = tanhf(pre(2));
    const float go = sigmoid(pre(3));
    const float c = __uint_as_float(q[0]);
    const float cp = first ? 0.0f : __uint_as_float(q[1]);
    const float tc = tanhf(c);
    const float dct = dc + dht * go * (1.0f - tc * tc);
    const float d_i = valid ? dct * gg * gi * (1.0f - gi) : 0.0f;
    const float d_f = valid ? dct * cp * gf * (1.0f - gf) : 0.0f;
    const float d_g = valid ? dct * gi * (1.0f - gg * gg) : 0.0f;
    const float d_o = valid ? dht * tc * go * (1.0f - go) : 0.0f;
    const T r[4] = {from_f32<T>(d_i), from_f32<T>(d_f), from_f32<T>(d_g),
                    from_f32<T>(d_o)};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      out0[og + k * H + j] = r[k];
      dg[k] = to_f32(r[k]);
    }
    if (valid) dc = dct * gf;
  }

  __device__ __forceinline__ static float dh(float sum, float) {
    return sum;
  }
};

// gates r, z, n (the linear-before-reset cell, r, z and n formed by
// gru_rzn(), as the forward's gru_cell() forms them); the residual is
// y[prev] as stored; c2 is dh_total z of the step, added to the next dh
struct GruBwdCell {
  static constexpr int kGates = 3;
  static constexpr int kRes = 1;      // y[prev]
  static constexpr int kCarries = 1;  // dh
  static constexpr int kUnroll = 1;

  template <typename T>
  __device__ __forceinline__ static void prefetch(uint32_t* q,
                                                  const void* res, size_t,
                                                  size_t op, bool first) {
    if (!first) cp_async4(q, word_of(static_cast<const T*>(res) + op));
  }

  template <bool kPre, typename T>
  __device__ __forceinline__ static void step(
      const float (&s)[3], const float (&x)[3], const uint32_t* q,
      const void* res, size_t op, T* __restrict__ out0,
      T* __restrict__ out1, size_t og, int H, int j, bool first,
      bool valid, float dht, float& c2, float (&dg)[3]) {
    static_assert(!kPre, "the GRU's n gate needs hn apart from xn");
    float r, z, n;
    gru_rzn(x[0], x[1], x[2], s[0], s[1], s[2], r, z, n);
    const float hn = s[2];
    const float hp =
        first ? 0.0f
              : from_word(q[0], static_cast<const T*>(res) + op);
    const float d_n = valid ? dht * (1.0f - z) * (1.0f - n * n) : 0.0f;
    const float d_z = valid ? dht * (hp - n) * z * (1.0f - z) : 0.0f;
    const float d_r = valid ? d_n * hn * r * (1.0f - r) : 0.0f;
    const T r_r = from_f32<T>(d_r), r_z = from_f32<T>(d_z);
    const T r_nh = from_f32<T>(d_n * r);
    out0[og + j] = r_r;                   // dgx = [dr, dz, dn]
    out0[og + H + j] = r_z;
    out0[og + 2 * H + j] = from_f32<T>(d_n);
    out1[og + j] = r_r;                   // dgh = [dr, dz, dn r]
    out1[og + H + j] = r_z;
    out1[og + 2 * H + j] = r_nh;
    dg[0] = to_f32(r_r);
    dg[1] = to_f32(r_z);
    dg[2] = to_f32(r_nh);
    c2 = dht * z;
  }

  __device__ __forceinline__ static float dh(float sum, float c2) {
    return sum + c2;
  }
};

// words prefetched per (row, unit) and step: the gates' scratch values,
// (without kPre) the gates' projection words, the cell's residual words
// and the word holding dy[t], rounded up to 4
__host__ __device__ constexpr int bwd_chain_words(int gates, int res,
                                                  bool pre) {
  return (gates * (pre ? 1 : 2) + res + 1 + 3) & ~3;
}

__host__ __device__ constexpr size_t round4(size_t n) {
  return (n + 3) & ~(size_t)3;
}

// floats of a chain CTA's shared memory at cluster size C, R rows per
// cluster, H units of `gates` gate columns, `words` prefetched words per
// (row, unit) (the layout of bwd_chain_body; ops/rnn_cuda.py::
// _bwd_chain_bytes sizes R by the same sum)
inline size_t bwd_chain_floats(int C, int R, int H, int gates, int words) {
  const size_t hsz = (H + C - 1) / C;
  const size_t rp = (R + 3) & ~3;
  return round4(gates * hsz * H)                // W_h columns
         + round4(2 * (size_t)C * R * hsz)      // received partials
         + gates * hsz * rp                     // rounded dgates
         + 2 * (size_t)R * hsz                  // dh, c2
         + 2 * (size_t)words * R * hsz          // prefetch, two buffers
         + R;                                   // lengths
}

// Cell: LstmBwdCell or GruBwdCell; kPre: the scratch holds the
// pre-activation; T: the compute dtype.  pre: phase 1's scratch [S, B,
// dirs G] f32 (G = gates H; row s - s0 holds walk step s), or the sums
// the forward stored (K3, K8b: the whole walk, s0 = 0); xp: the
// stored projection [T, B, dirs G] (unused with kPre); per direction (f,
// b) the output cotangent dy [T, B, H], the cell's residual res, W_h [H,
// G] and the outputs out, out2 [T, B, G]; state: the carries
// [carries][dirs][B][H] f32.  The pointers are the kernel's own
// parameters (global memory), so the stores never wait on shared loads.
template <typename Cell, bool kPre, typename T>
__device__ __forceinline__ void bwd_chain_body(
    const float* __restrict__ pre, const T* __restrict__ xp,
    const T* __restrict__ dyf, const T* __restrict__ dyb, const void* resf,
    const void* resb, const T* __restrict__ whf, const T* __restrict__ whb,
    const int32_t* __restrict__ lens, T* __restrict__ outf,
    T* __restrict__ outf2, T* __restrict__ outb, T* __restrict__ outb2,
    float* __restrict__ state, int dirs, int s0, int S, int steps, int B,
    int H, int R, int reverse) {
  constexpr int kG = Cell::kGates;
  constexpr int kW = bwd_chain_words(kG, Cell::kRes, kPre);
  constexpr int kResAt = kPre ? kG : 2 * kG;   // the residual's words
  constexpr int kDyAt = kResAt + Cell::kRes;   // dy[t]'s word
  extern __shared__ __align__(16) unsigned char bwd_chain_smem[];
  cgb::cluster_group cluster = cgb::this_cluster();
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
  const int stride = dirs * G;              // a pre or x_proj row
  const int rp = (R + 3) & ~3;
  const bool rev = (dir != 0) != (reverse != 0);
  const T* dy = dir == 0 ? dyf : dyb;
  const void* res = dir == 0 ? resf : resb;
  const T* wh = dir == 0 ? whf : whb;
  T* out0 = dir == 0 ? outf : outb;
  T* out1 = dir == 0 ? outf2 : outb2;
  // the carries: state[0][dir] dh, state[1][dir] the LSTM's dc
  float* dh_state = state + (size_t)dir * B * H;
  float* c2_state = state + (size_t)(dirs + dir) * B * H;

  float* w_s = reinterpret_cast<float*>(bwd_chain_smem);  // [kG n][H]
  float* recv = w_s + round4((size_t)kG * hsz * H);  // [2][rank][R][hsz]
  float* dg_s = recv + round4(2 * (size_t)C * R * hsz);  // [kG n][rp]
  float* dh_s = dg_s + (size_t)kG * hsz * rp;  // [nr][n]: dh carry
  float* c2_s = dh_s + (size_t)R * hsz;        // [nr][n]: the cell's c2
  uint32_t* pf = reinterpret_cast<uint32_t*>(c2_s + (size_t)R * hsz);
  int* lens_s = reinterpret_cast<int*>(pf + (size_t)2 * kW * R * hsz);

  for (int i = threadIdx.x; i < ng * H; i += blockDim.x) {
    const int k = i / ng, c = i % ng;
    const int gate = c / n, jj = c % n;
    w_s[c * H + k] = to_f32(wh[(size_t)k * G + gate * H + j0 + jj]);
  }
  for (int i = threadIdx.x; i < kG * hsz * rp; i += blockDim.x)
    dg_s[i] = 0.0f;
  const int ne = nr * n;                    // (row, unit) elements
  for (int e = threadIdx.x; e < ne; e += blockDim.x) {
    const size_t o = (size_t)(r0 + e / n) * H + j0 + e % n;
    dh_s[e] = dh_state[o];
    if constexpr (Cell::kCarries > 1)
      c2_s[e] = c2_state[o];
    else
      c2_s[e] = 0.0f;
  }
  for (int r = threadIdx.x; r < nr; r += blockDim.x)
    lens_s[r] = lens[r0 + r];

  auto time_of = [&](int s) { return rev ? s : steps - 1 - s; };
  // step s's operands of this thread's elements into buffer `buf`: they
  // depend on nothing the chain computes
  auto prefetch = [&](int s, int buf) {
    const int t = time_of(s);
    const bool first = s == steps - 1;      // the forward's first step
    const int tp = rev ? t + 1 : t - 1;
    uint32_t* p = pf + (size_t)buf * kW * R * hsz;
    for (int e = threadIdx.x; e < ne; e += blockDim.x) {
      const int b = r0 + e / n, j = j0 + e % n;
      uint32_t* q = p + (size_t)e * kW;
      const float* g = pre + ((size_t)(s - s0) * B + b) * stride +
                       dir * G + j;
#pragma unroll
      for (int gate = 0; gate < kG; ++gate) cp_async4(q + gate, g + gate * H);
      if constexpr (!kPre) {
        const T* x = xp + ((size_t)t * B + b) * stride + dir * G + j;
#pragma unroll
        for (int gate = 0; gate < kG; ++gate)
          cp_async4(q + kG + gate, word_of(x + gate * H));
      }
      const size_t o = ((size_t)t * B + b) * H + j;
      Cell::template prefetch<T>(q + kResAt, res, o,
                                 first ? 0 : ((size_t)tp * B + b) * H + j,
                                 first);
      cp_async4(q + kDyAt, word_of(dy + o));
    }
  };

  prefetch(s0, 0);
  cp_async_wait_all();
  __syncthreads();
  cluster.sync();   // every CTA runs before any DSMEM store reaches it
  for (int i = 0; i < S; ++i) {
    const int s = s0 + i;
    const int t = time_of(s);
    const bool first = s == steps - 1;
    const int tp = rev ? t + 1 : t - 1;
    // the next step's operands load while this step runs (the buffer
    // they fill was read by the step before)
    if (i + 1 < S) prefetch(s + 1, (i + 1) & 1);
    const uint32_t* p = pf + (size_t)(i & 1) * kW * R * hsz;
    for (int e = threadIdx.x; e < ne; e += blockDim.x) {
      const int r = e / n, jj = e % n, b = r0 + r, j = j0 + jj;
      const uint32_t* q = p + (size_t)e * kW;
      float sums[kG], xs[kG] = {};
#pragma unroll
      for (int gate = 0; gate < kG; ++gate)
        sums[gate] = __uint_as_float(q[gate]);
      if constexpr (!kPre) {
        const T* x = xp + ((size_t)t * B + b) * stride + dir * G + j;
#pragma unroll
        for (int gate = 0; gate < kG; ++gate)
          xs[gate] = from_word(q[kG + gate], x + gate * H);
      }
      const size_t o = ((size_t)t * B + b) * H + j;
      const float dht = from_word(q[kDyAt], dy + o) + dh_s[e];
      float dg[kG];
      Cell::template step<kPre, T>(
          sums, xs, q + kResAt, res,
          first ? 0 : ((size_t)tp * B + b) * H + j, out0, out1,
          ((size_t)t * B + b) * G, H, j, first, t < lens_s[r], dht, c2_s[e],
          dg);
#pragma unroll
      for (int gate = 0; gate < kG; ++gate)
        dg_s[(size_t)(gate * n + jj) * rp + r] = dg[gate];
    }
    if (s + 1 == steps) break;
    __syncthreads();
    // this CTA's partial dh for every unit k over its own columns, into
    // k's owner's slot for this rank
    float* slot =
        recv + ((size_t)(i & 1) * C + rank) * R * hsz;  // [parity][rank]
    const int row_tiles = (nr + 3) >> 2;
    const int ng4 = ng & ~3;
    for (int item = threadIdx.x; item < H * row_tiles; item += blockDim.x) {
      const int k = item % H, r4 = (item / H) * 4;
      // four rows, each summed over its columns c = q, q + 4, ... in
      // four sums (short dependent chains), added in a fixed order
      float acc[4][4] = {};
      auto add = [&](int c, int q) {
        const float w = w_s[(c + q) * H + k];
        const float4 v =
            *reinterpret_cast<const float4*>(dg_s + (c + q) * rp + r4);
        acc[q][0] = fmaf(v.x, w, acc[q][0]);
        acc[q][1] = fmaf(v.y, w, acc[q][1]);
        acc[q][2] = fmaf(v.z, w, acc[q][2]);
        acc[q][3] = fmaf(v.w, w, acc[q][3]);
      };
      // the column loop's unrolling is the cell's (kUnroll): on the H100
      // the same instruction mix ran 15-25% slower a step laid out
      // otherwise (the GRU at nvcc's default of 8, the LSTM at 1)
      if constexpr (Cell::kUnroll == 1) {
#pragma unroll 1
        for (int c = 0; c < ng4; c += 4) {
#pragma unroll
          for (int q = 0; q < 4; ++q) add(c, q);
        }
      } else {
#pragma unroll 4
        for (int c = 0; c < ng4; c += 4) {
#pragma unroll
          for (int q = 0; q < 4; ++q) add(c, q);
        }
      }
#pragma unroll
      for (int q = 0; q < 3; ++q)           // the GRU's 3n may leave 1-3
        if (ng4 + q < ng) add(ng4, q);
      float* dst = cluster.map_shared_rank(slot, k / hsz) +
                   (size_t)r4 * hsz + k % hsz;
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
        if (r4 + rr < nr)
          dst[rr * hsz] =
              (acc[0][rr] + acc[1][rr]) + (acc[2][rr] + acc[3][rr]);
    }
    cluster_arrive();
    cluster_wait();
    cp_async_wait_all();
    // dh for the next step: the C partials of this CTA's units in rank
    // order (and the cell's term), carried only where this step was a
    // valid frame
    const float* in = recv + (size_t)(i & 1) * C * R * hsz;
    for (int e = threadIdx.x; e < ne; e += blockDim.x) {
      const int r = e / n, jj = e % n;
      if (t >= lens_s[r]) continue;
      float acc = 0.0f;
      for (int w = 0; w < C; ++w) acc += in[((size_t)w * R + r) * hsz + jj];
      dh_s[e] = Cell::dh(acc, c2_s[e]);
    }
  }
  if (s0 + S < steps) {   // the next chunk of steps takes the carries
    for (int e = threadIdx.x; e < ne; e += blockDim.x) {
      const size_t o = (size_t)(r0 + e / n) * H + j0 + e % n;
      dh_state[o] = dh_s[e];
      if constexpr (Cell::kCarries > 1) c2_state[o] = c2_s[e];
    }
  }
}

// Launch `kern` (a __global__ wrapper of bwd_chain_body with Cell and
// kPre) with `args` over dirs x ceil(B / R) clusters of C CTAs: C a power
// of two <= 16, R >= 1, the CTA's shared memory within the card's opt-in
// limit.
template <typename Cell, bool kPre, typename... Params, typename... Args>
cudaError_t bwd_chain_launch(void (*kern)(Params...), int C, int dirs,
                             int s0, int S, int steps, int B, int H, int R,
                             void* stream, Args... args) {
  if (S <= 0 || B <= 0) return cudaGetLastError();
  if (C < 1 || C > kMaxBwdCluster || (C & (C - 1)) != 0 || R < 1 ||
      H <= 0 || dirs < 1 || dirs > 2 || s0 < 0 || s0 + S > steps)
    return cudaErrorInvalidValue;
  const int optin = smem_optin_bytes();
  if (optin < 0) return static_cast<cudaError_t>(-optin);
  const size_t smem =
      sizeof(float) * bwd_chain_floats(
                          C, R, H, Cell::kGates,
                          bwd_chain_words(Cell::kGates, Cell::kRes, kPre));
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
  cfg.blockDim = dim3(kBwdChainThreads);
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
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace
