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
// Layer l advances at t = 0 .. T-1 once layer l-1 has produced its
// output at t.  For l >= 1 the layer first projects its input, y_{l-1}[t]
// . W_x[l] + b[l] with f32 sums in warp_dot's order, rounded to the
// compute dtype and widened to f32 again: exactly how the per-layer path
// stores x_proj.  Then gates = x_proj + h . W_h[l] with h rounded to the
// compute dtype; gate math, h and c are f32.  The cluster route writes
// c' = fmaf(gi, gg, gf c) out (the forward chain's LstmCell); the
// cooperative kernel's gf c + gi gg is the contraction nvcc makes of it
// (the routes agree bit for bit), and written out there it compiled to
// another schedule, fewer registers and a slower kernel.  A frame t >=
// lens[b] carries h and c and writes y = 0 (an idle slot, lens = 0,
// keeps its state).  The output a layer hands to the next is held in the
// compute dtype; h_fin is the f32 carry, never the rounded operand.
//
// What bounds it on the H100: the serial steps, each a few microseconds
// of latency (read h and the layer input, sum, gate math, exchange).  At
// the streaming flagship (5 x 320, a chunk of T = 20 frames, B = 8
// slots) the work is 9 matrices of 320 x 1280 against 8 rows a step.
//
// Two routes, chosen by the wrapper's plan from the shapes
// (ops/rnn_cuda.py::stack_chain_plan):
//
// The cluster route, lstm_stack_chain_kernel: a wavefront of per-layer
// clusters.  One cluster of C CTAs per (layer, group of R rows), built
// from the forward chain's pieces (csrc/fwd_chain.cuh): each CTA keeps
// its ceil(H / C) units' four gate columns of W_h[l] (and, for l >= 1, of
// W_x[l]) in shared memory in the compute dtype for the whole chunk, with
// its units' c and f32 h; the gate sums run in warp tiles of 32 outputs
// (warp_sum32, warp_dot's sums bit for bit); h[t] goes to every CTA of
// the layer's cluster through DSMEM; one split cluster barrier a step.
// 512 threads a CTA (16 warps: the 20 warp tiles of a product at R = 8
// take two rounds, not three).  Layer 0 prefetches xp0[t+1] (cp.async)
// while it works on t.  Layer l >= 1 sums its recurrent part first, then
// waits for its input: layer l-1's CTAs each write their slice of
// y_{l-1}[t] to a global buffer [L-1][T][B][H] (compute dtype), and
// after the CTA's barrier one thread publishes t + 1 behind
// fence.acq_rel.gpu (the cluster barrier's scope is the cluster, so it
// does not order these stores for another cluster); layer l polls the C
// flags of its group with ld.acquire.gpu, reads the rows through L2
// (ld.global.cg) and sums its projection.  (Words that carry their own
// step's tag, one 8-byte store each and no fence, were no faster at B =
// 8 and slower at B = 32: the consumer then reads 4x the bytes of bf16.)
// Layers run pipelined, so a chunk takes about T steps of the slowest
// layer plus L - 1 hand-offs, where the cooperative route takes T + L - 1
// grid barriers.  Producers never wait on consumers (the buffer holds
// every t), so the only wait is on the layer below.
//
// Residency.  A layer's cluster spins on the cluster of the layer below,
// so every cluster of a launch must be co-resident.  With L > 1 the
// launcher asks for a cooperative launch with the cluster dimension
// (cudaLaunchAttributeCooperative with cudaLaunchAttributeClusterDimension),
// which makes residency a guarantee; where the driver refuses that pair,
// it checks that cudaOccupancyMaxActiveClusters >= the launch's clusters
// and returns cudaErrorCooperativeLaunchTooLarge otherwise; it never
// launches a spinning grid without one of the two.
// lstm_stack_chain_residency() reports which one held at the last launch.
// One launch takes the rows of at most max-active-clusters / L groups
// (lstm_stack_chain_clusters, the wrapper's plan); the wrapper runs a
// larger batch as row slices.  A one-layer stack (the streaming server's
// per-layer route) waits on nothing: any B in one launch, in waves.
//
// Shared memory (stack_chain_bytes; ops/rnn_cuda.py::_stack_chain_bytes
// sizes R by the same sum): holding W_h and W_x of a layer in 16 CTAs
// takes 2 x 51,200 B a CTA in bf16 at H = 320, room for ~42 rows; in f32
// 2 x 102,400 B, room for 5 rows.  So f32 at the 8-slot streaming shape
// keeps the cooperative route (the plan takes the cluster route where it
// runs the batch in one launch, else the cooperative kernel where that
// does); f32 at B <= 5 and bf16 to ~42 rows take the chain.
//
// The cooperative route, lstm_stack_kernel: K5's first layout spread over
// the L*H hidden units of the whole stack.  One cooperative launch: each
// block owns hs units of one layer (hs = ceil(L*H / SMs), 13 at 5 x 320:
// 125 blocks in one wave) and keeps those units' four gate columns of
// W_h[l] and of W_x[l] in shared memory as f32 for the whole chunk, with
// their cell state.  Each step an active block reads its layer's h and
// its input y_{l-1}[t] from double-buffered f32 exchanges in L2
// (ld.global.cg), computes both products for its columns with warp-split
// dot products, does the gate math and writes its slice of the next h and
// of its output; an idle block (t outside the chunk) copies its units' h
// forward.  Step s of T + L - 1 advances layer l at t = s - l and reads
// parity s&1, writes parity (s+1)&1, so one grid.sync() per step keeps
// the wavefront in order.  Every row stays in shared memory, so a launch
// takes at most lstm_stack_max_rows(L, H) rows (32 at 5 x 320); the
// wrapper runs a larger batch as row slices.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bilstm_cell.cuh"
#include "fwd_chain.cuh"
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

template <typename T>
__device__ __forceinline__ float round_f32(float v) {
  return to_f32(from_f32<T>(v));
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

// ---------------------------------------------------------------------------
// The cluster route: a wavefront of per-layer clusters
// ---------------------------------------------------------------------------

// bytes of a chain CTA's shared memory for L layers at cluster size C, R
// rows per cluster, H units, W and h in a type of `tsize` bytes (the
// layout of lstm_stack_chain_kernel; ops/rnn_cuda.py::_stack_chain_bytes
// sizes R by the same sum)
inline size_t stack_chain_bytes(int L, int C, int R, int H, int tsize) {
  const size_t hsz = (H + C - 1) / C;
  const size_t m = L > 1 ? 1 : 0;         // W_x, input rows and bias
  return (1 + m) * align16(4 * hsz * H * tsize)   // W_h (and W_x) columns
         + align16((size_t)2 * R * H * tsize)     // receive, two parities
         + m * align16((size_t)R * H * tsize)     // the layer below's rows
         + align16((size_t)R * hsz * tsize)       // this CTA's h slice
         // recurrent sums, c, f32 h, layer 0's prefetched xp0 (two
         // buffers; the projection's sums in the layers above)
         + sizeof(float) * (size_t)R * hsz * (4 + 1 + 1 + 8)
         + sizeof(float) * m * 4 * hsz            // bias
         + sizeof(int) * (size_t)R;               // lengths
}

// The gate sums of one chain step: rows 0 .. nr-1 of `rows` (row r at
// rows + r H) against columns 0 .. ng-1 of `cols` (column c at cols + c
// H), both in the compute dtype in shared memory, into out[r ng + c]: the
// forward chain's step 1 (csrc/fwd_chain.cuh), tiles of 32 outputs a
// warp, each lane summing k = lane, lane + 32, ... with fmaf in order and
// warp_sum32 folding them, so every sum is warp_dot's bit for bit.
template <typename T, int RT>
__device__ __forceinline__ void tile_sums(const T* rows, const T* cols,
                                          float* out, int nr, int ng,
                                          int H) {
  constexpr int CT = 32 / RT;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int col_tiles = (ng + CT - 1) / CT;
  const int tiles = ng > 0 ? ((nr + RT - 1) / RT) * col_tiles : 0;
  for (int tile = warp; tile < tiles; tile += nwarps) {
    const int ra = (tile / col_tiles) * RT, ca = (tile % col_tiles) * CT;
    const T* hr[RT];
    const T* wc[CT];
#pragma unroll
    for (int a = 0; a < RT; ++a) hr[a] = rows + min(ra + a, nr - 1) * H;
#pragma unroll
    for (int c = 0; c < CT; ++c) wc[c] = cols + min(ca + c, ng - 1) * H;
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
    if (r < nr && c < ng) out[r * ng + c] = sum;
  }
}

constexpr int kStackThreads = 512;

// the hand-off flag of one producer CTA: the fence releases at GPU scope
// what the CTA's threads stored before its last barrier, then the flag is
// stored; what the consumer reads after seeing the flag follows it
// (acquire)
__device__ __forceinline__ void flag_release(int* flag, int v) {
  asm volatile(
      "fence.acq_rel.gpu;\n"
      "st.relaxed.gpu.global.b32 [%0], %1;\n" ::"l"(flag),
      "r"(v)
      : "memory");
}

__device__ __forceinline__ int flag_acquire(const int* flag) {
  int v;
  asm volatile("ld.global.acquire.gpu.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(flag)
               : "memory");
  return v;
}

// T: the compute dtype; RT rows by 32 / RT columns a warp tile.  Cluster
// blockIdx.x / C is layer (cluster % L) of row group (cluster / L), so a
// group's layers are neighbours in launch order.  ybuf: the outputs of
// layers 0 .. L-2 [L-1][T][B][H]; flags: [L-1][groups][C] int, zero at
// launch, producer CTA (l, g, rank) sets its own to t + 1 once its slice
// of y_l[t] is in ybuf.
template <typename T, int RT>
__global__ void __launch_bounds__(kStackThreads)
lstm_stack_chain_kernel(const T* __restrict__ xp0, StackWeights w,
                        const int32_t* __restrict__ lens,
                        const float* __restrict__ h0,
                        const float* __restrict__ c0, T* __restrict__ y,
                        float* __restrict__ hfin, float* __restrict__ cfin,
                        T* __restrict__ ybuf, int* __restrict__ flags,
                        int T_, int L, int B, int H, int R) {
  extern __shared__ __align__(16) unsigned char stack_chain_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int cid = blockIdx.x / C;            // this cluster
  const int groups = gridDim.x / (C * L);
  const int group = cid / L, l = cid % L;
  const int r0 = group * R;                  // its first row
  const int nr = min(R, B - r0);
  const int hsz = (H + C - 1) / C;           // units per rank
  const int j0 = rank * hsz;
  const int n = max(0, min(hsz, H - j0));    // units this CTA owns
  const int ng = 4 * n;
  const int G = 4 * H;
  const bool proj = l > 0;                   // in-step input projection
  const bool top = l == L - 1;
  const T* wh = static_cast<const T*>(w.wh[l]);
  const T* wx = proj ? static_cast<const T*>(w.wx[l - 1]) : nullptr;
  const float* bias = proj ? w.b[l - 1] : nullptr;

  unsigned char* p = stack_chain_smem;
  T* wh_s = reinterpret_cast<T*>(p);         // [4 n][H]: column gate n + jj
  p += align16((size_t)4 * hsz * H * sizeof(T));
  T* wx_s = reinterpret_cast<T*>(p);         // [4 n][H] (L > 1)
  if (L > 1) p += align16((size_t)4 * hsz * H * sizeof(T));
  T* recv = reinterpret_cast<T*>(p);         // [2][R][H]: h[t-1], operand
  p += align16((size_t)2 * R * H * sizeof(T));
  T* x_s = reinterpret_cast<T*>(p);          // [R][H]: y_{l-1}[t] (L > 1)
  if (L > 1) p += align16((size_t)R * H * sizeof(T));
  T* hl = reinterpret_cast<T*>(p);           // [R][hsz]: this CTA's h[t]
  p += align16((size_t)R * hsz * sizeof(T));
  float* g_s = reinterpret_cast<float*>(p);  // [R][4 n]: recurrent sums
  float* c_s = g_s + (size_t)4 * R * hsz;    // [nr][n]: c
  float* hf_s = c_s + (size_t)R * hsz;       // [nr][n]: h in f32
  // layer 0: xp0 of two steps [2][nr n][4] words; above: the projection's
  // sums [R][4 n]
  uint32_t* pf = reinterpret_cast<uint32_t*>(hf_s + (size_t)R * hsz);
  float* p_s = reinterpret_cast<float*>(pf);
  float* b_s = reinterpret_cast<float*>(pf + (size_t)8 * R * hsz);  // [4 n]
  int* lens_s = reinterpret_cast<int*>(b_s + (L > 1 ? 4 * hsz : 0));

  for (int i = threadIdx.x; i < ng * H; i += blockDim.x) {
    const int k = i / ng, c = i % ng;
    const int gate = c / n, jj = c % n;
    const size_t src = (size_t)k * G + gate * H + j0 + jj;
    wh_s[(size_t)c * H + k] = wh[src];
    if (proj) wx_s[(size_t)c * H + k] = wx[src];
  }
  if (proj)
    for (int i = threadIdx.x; i < ng; i += blockDim.x)
      b_s[i] = bias[(i / n) * H + j0 + i % n];
  const int ne = nr * n;                     // (row, unit) elements
  const size_t lrow = ((size_t)l * B + r0) * H;   // row r0 of layer l
  for (int e = threadIdx.x; e < ne; e += blockDim.x) {
    const size_t o = lrow + (size_t)(e / n) * H + j0 + e % n;
    c_s[e] = c0[o];
    hf_s[e] = h0[o];
  }
  for (int i = threadIdx.x; i < nr * H; i += blockDim.x)
    recv[i] = from_f32<T>(h0[lrow + i]);
  for (int r = threadIdx.x; r < nr; r += blockDim.x) lens_s[r] = lens[r0 + r];

  // layer 0: step t's xp0 words of this thread's elements into buffer buf
  auto prefetch = [&](int t, int buf) {
    uint32_t* q0 = pf + (size_t)buf * 4 * R * hsz;
    for (int e = threadIdx.x; e < ne; e += blockDim.x) {
      const T* g = xp0 + ((size_t)t * B + r0 + e / n) * G + j0 + e % n;
      uint32_t* q = q0 + (size_t)e * 4;
#pragma unroll
      for (int gate = 0; gate < 4; ++gate)
        cp_async4(q + gate, word_of(g + gate * H));
    }
  };
  const size_t lsize = (size_t)T_ * B * H;        // one layer's outputs
  int* my_flag =
      top ? nullptr : flags + ((size_t)l * groups + group) * C + rank;
  const int* in_flags =
      proj ? flags + ((size_t)(l - 1) * groups + group) * C : nullptr;

  if (!proj) prefetch(0, 0);
  cp_async_wait_all();
  __syncthreads();
  cluster.sync();   // every CTA runs before any DSMEM store reaches it
  for (int t = 0; t < T_; ++t) {
    if (!proj && t + 1 < T_) prefetch(t + 1, (t + 1) & 1);
    const T* h_cur = recv + (size_t)(t & 1) * R * H;
    tile_sums<T, RT>(h_cur, wh_s, g_s, nr, ng, H);
    if (proj) {
      // the layer below's y[t]: each of its C CTAs has published t + 1
      if (threadIdx.x < C)
        while (flag_acquire(in_flags + threadIdx.x) <= t) {
        }
      __syncthreads();
      const T* src =
          ybuf + (size_t)(l - 1) * lsize + ((size_t)t * B + r0) * H;
      if ((H * sizeof(T)) % 16 == 0) {   // 16-byte rows, 16-byte aligned
        const int4* s4 = reinterpret_cast<const int4*>(src);
        int4* d4 = reinterpret_cast<int4*>(x_s);
        const int nv = nr * H * static_cast<int>(sizeof(T)) / 16;
        for (int i = threadIdx.x; i < nv; i += blockDim.x)
          d4[i] = __ldcg(s4 + i);
      } else {
        for (int i = threadIdx.x; i < nr * H; i += blockDim.x)
          x_s[i] = __ldcg(src + i);
      }
      __syncthreads();
      tile_sums<T, RT>(x_s, wx_s, p_s, nr, ng, H);
    }
    __syncthreads();

    // the gate math of this thread's elements
    const uint32_t* pq = pf + (size_t)(t & 1) * 4 * R * hsz;
    for (int e = threadIdx.x; e < ne; e += blockDim.x) {
      const int r = e / n, jj = e % n, b = r0 + r, j = j0 + jj;
      const T* src = xp0 + ((size_t)t * B + b) * G + j;
      float sums[4], xs[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        sums[k] = g_s[r * ng + k * n + jj];
        // layer 0's stored projection, or the projection stored in the
        // compute dtype, as the per-layer path stores it
        xs[k] = proj
            ? round_f32<T>(p_s[r * ng + k * n + jj] + b_s[k * n + jj])
            : from_word(pq[(size_t)e * 4 + k], src + k * H);
      }
      float c_new = c_s[e];
      const float h_new = LstmCell::step(sums, xs, c_new);
      const bool valid = t < lens_s[r];
      if (valid) {
        c_s[e] = c_new;
        hf_s[e] = h_new;
      }
      hl[r * hsz + jj] = from_f32<T>(hf_s[e]);   // the next operand
      const T yv = from_f32<T>(valid ? h_new : 0.0f);
      const size_t o = ((size_t)t * B + b) * H + j;
      if (top)
        y[o] = yv;
      else
        ybuf[(size_t)l * lsize + o] = yv;
    }
    __syncthreads();
    if (t + 1 == T_) {
      if (!top && threadIdx.x == 0) flag_release(my_flag, t + 1);
      break;
    }

    // this CTA's slice of h[t] into every CTA's next receive buffer
    T* next = recv + (size_t)((t + 1) & 1) * R * H;
    for (int idx = threadIdx.x; idx < C * ne; idx += blockDim.x) {
      const int to = idx / ne, e = idx % ne;
      const int r = e / n, jj = e % n;
      cluster.map_shared_rank(next, to)[r * H + j0 + jj] = hl[r * hsz + jj];
    }
    cluster_arrive();
    // publish y[t] to the layer above while the barrier completes
    if (!top && threadIdx.x == 0) flag_release(my_flag, t + 1);
    cluster_wait();
    cp_async_wait_all();
  }
  for (int e = threadIdx.x; e < ne; e += blockDim.x) {
    const size_t o = lrow + (size_t)(e / n) * H + j0 + e % n;
    hfin[o] = hf_s[e];
    cfin[o] = c_s[e];
  }
}

// which guarantee the last launch of more than one layer held: 1 the
// cooperative launch, 2 the checked count of co-resident clusters
int g_chain_residency = 0;

template <typename T>
using ChainKernel = void (*)(const T*, StackWeights, const int32_t*,
                             const float*, const float*, T*, float*, float*,
                             T*, int*, int, int, int, int, int);

template <typename T>
ChainKernel<T> chain_kernel(int R) {
  return R >= 4 ? &lstm_stack_chain_kernel<T, 4>
         : R >= 2 ? &lstm_stack_chain_kernel<T, 2>
                  : &lstm_stack_chain_kernel<T, 1>;
}

// the launch configuration of `groups` groups of L clusters of C CTAs, R
// rows a cluster (attr[0]: the cluster dimension); refuses a shape that
// does not fit a CTA's shared memory
template <typename T>
cudaError_t chain_config(ChainKernel<T> kern, int L, int C, int R, int H,
                         int groups, cudaLaunchConfig_t* cfg,
                         cudaLaunchAttribute* attr) {
  if (L < 1 || L > kMaxLayers || C < 1 || C > kMaxChainCluster ||
      (C & (C - 1)) != 0 || R < 1 || H <= 0 || groups < 1)
    return cudaErrorInvalidValue;
  const int optin = smem_optin_bytes();
  if (optin < 0) return static_cast<cudaError_t>(-optin);
  const size_t smem = stack_chain_bytes(L, C, R, H, sizeof(T));
  if (smem > (size_t)optin) return cudaErrorLaunchOutOfResources;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  if (C > 8) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(groups * L * C);
  cfg->blockDim = dim3(kStackThreads);
  cfg->dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// clusters of the chain (L layers, C CTAs, R rows) the card holds at once
template <typename T>
int chain_clusters(int L, int H, int C, int R) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  ChainKernel<T> kern = chain_kernel<T>(R);
  cudaError_t e = chain_config<T>(kern, L, C, R, H, 1, &cfg, attr);
  int clusters = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kern, &cfg);
  cudaGetLastError();
  return e == cudaSuccess ? clusters : -static_cast<int>(e);
}

template <typename T>
int chain_launch(const void* xp0, const void* const* wh,
                 const void* const* wx, const void* const* b,
                 const void* lens, const void* h0, const void* c0, void* y,
                 void* hfin, void* cfin, void* ybuf, void* flags, int T_,
                 int L, int B, int H, int C, int R, void* stream) {
  if (T_ <= 0 || B <= 0) return cudaGetLastError();
  const int groups = R > 0 ? (B + R - 1) / R : 0;
  ChainKernel<T> kern = chain_kernel<T>(R);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  cudaError_t e = chain_config<T>(kern, L, C, R, H, groups, &cfg, attr);
  if (e != cudaSuccess) return e;
  cfg.stream = static_cast<cudaStream_t>(stream);
  StackWeights w = {};
  for (int l = 0; l < L; ++l) w.wh[l] = wh[l];
  for (int l = 0; l + 1 < L; ++l) {
    w.wx[l] = wx[l];
    w.b[l] = static_cast<const float*>(b[l]);
  }
  auto go = [&]() {
    return cudaLaunchKernelEx(
        &cfg, kern, static_cast<const T*>(xp0), w,
        static_cast<const int32_t*>(lens), static_cast<const float*>(h0),
        static_cast<const float*>(c0), static_cast<T*>(y),
        static_cast<float*>(hfin), static_cast<float*>(cfin),
        static_cast<T*>(ybuf), static_cast<int*>(flags), T_, L, B, H, R);
  };
  if (L > 1) {
    // the layers' clusters wait on each other: residency first
    attr[1].id = cudaLaunchAttributeCooperative;
    attr[1].val.cooperative = 1;
    cfg.numAttrs = 2;
    e = go();
    if (e == cudaSuccess) {
      g_chain_residency = 1;
      return cudaGetLastError();
    }
    cudaGetLastError();   // the driver refused the pair: count instead
    cfg.numAttrs = 1;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kern, &cfg);
    if (e != cudaSuccess) return e;
    if (clusters < groups * L) return cudaErrorCooperativeLaunchTooLarge;
    g_chain_residency = 2;
  }
  e = go();
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

// the opt-in shared memory of one block on the current device, in bytes
// (the cluster route's plan sizes its clusters by it), or a negative CUDA
// error code
int lstm_stack_smem_optin(void) { return smem_optin_bytes(); }

// the cluster route's clusters (L layers, C CTAs, R rows each) the
// current device holds at once, or a negative CUDA error code; nothing is
// launched
int lstm_stack_chain_clusters_f32(int L, int H, int C, int R) {
  return chain_clusters<float>(L, H, C, R);
}
int lstm_stack_chain_clusters_bf16(int L, int H, int C, int R) {
  return chain_clusters<__nv_bfloat16>(L, H, C, R);
}

// the guarantee of co-residency the last cluster-route launch of more
// than one layer held: 1 a cooperative launch, 2 the checked count of
// co-resident clusters, 0 none yet
int lstm_stack_chain_residency(void) { return g_chain_residency; }

// the cluster route over ceil(B / R) groups of L clusters of C CTAs: wh,
// wx, b as for lstm_stack_*; h0, c0 [L][B][H] f32; ybuf [L-1][T][B][H] in
// the compute dtype (scratch; unused for L = 1); flags [L-1][groups][C]
// int32, zeroed by the caller
int lstm_stack_chain_f32(const void* xp0, const void* const* wh,
                         const void* const* wx, const void* const* b,
                         const void* lens, const void* h0, const void* c0,
                         void* y, void* hfin, void* cfin, void* ybuf,
                         void* flags, int T, int L, int B, int H, int C,
                         int R, void* stream) {
  return chain_launch<float>(xp0, wh, wx, b, lens, h0, c0, y, hfin, cfin,
                             ybuf, flags, T, L, B, H, C, R, stream);
}

int lstm_stack_chain_bf16(const void* xp0, const void* const* wh,
                          const void* const* wx, const void* const* b,
                          const void* lens, const void* h0, const void* c0,
                          void* y, void* hfin, void* cfin, void* ybuf,
                          void* flags, int T, int L, int B, int H, int C,
                          int R, void* stream) {
  return chain_launch<__nv_bfloat16>(xp0, wh, wx, b, lens, h0, c0, y, hfin,
                                     cfin, ybuf, flags, T, L, B, H, C, R,
                                     stream);
}

const char* kctpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
