// Gate sums of many (step, batch row) pairs at once, parallel over the
// steps: phase 1 of K10b (csrc/bilstm_bwd.cu), of K10a
// (csrc/bilstm_fwd.cu) and of K6 and K9b (csrc/lstm_bwd.cu,
// csrc/gru_bwd.cu).  (K3 and K8b have no phase 1: their backward chain
// reads the sums K2 and K8a stored, csrc/fwd_chain.cuh.)
//
// What a kernel sums per (row, gate column) is a template argument
// (Sums): K10b's phase 1 recomputes the forward's gate pre-activations,
// the projection of x[t] plus the recurrent sum over the stored y[t-+1]
// (kProjRec); K10a's phase 1 computes the projection alone (kProj), which
// its forward chain (csrc/fwd_chain.cuh) adds to the recurrent sum; K6's
// and K9b's phase 1 the recurrent sum alone (kRec), to which their
// backward chain (csrc/bwd_chain.cuh) adds the stored projection x_proj,
// as the forward chain does.  All run the bodies below, so the
// projection K10a's chain reads is the one K10b recomputes, bit for bit
// (project() of csrc/bilstm_cell.cuh, x . W_x with warp_dot's order, plus
// the bias, rounded to the compute dtype), and every recurrent sum is
// warp_dot's, the forward chains' order.
//
// Two kernels of the same sums (the card tests hold them equal bit for
// bit):
//   - tiled: a block keeps 64 gate columns of one direction (their W_x
//     and W_h columns, as f32, staged once) and walks tiles of 64 rows,
//     staging each tile's x rows and y rows by cp.async, k-major, 68
//     floats a k (64 and a pad that keeps float4 loads aligned); each
//     thread sums 4 rows x 4 columns with tile_dot4x4, which walks
//     warp_dot's lanes in the order of its shuffle tree.  Rows of
//     D + H <= 426 floats fit (227 KB; D <= 426 for the projection alone,
//     H <= 426 for the recurrent sum alone);
//   - warp: one warp per row over up to 32 columns of a block, calling
//     warp_dot and project() themselves, x[t] and y[t-+1] read through
//     L1/L2: for rows too long to stage.
// The output is an f32 scratch [rows][dirs G] (G = gates H columns a
// direction, the forward direction's first): row r of the caller's rows
// at r * dirs G.  The caller maps row r to its x row and y row (null:
// zeros, the first forward step) with `row_of(dir, r, xr, yr)`; the
// projection alone never reads a y row, the recurrent sum alone never an
// x row.

#pragma once

#include <algorithm>

#include <cuda_runtime.h>

#include "bilstm_cell.cuh"

namespace {

constexpr int kGateThreads = 256;
constexpr int kMaxGateCols = 32;      // gate columns per block, one a lane
constexpr int kGateRowsPerWarp = 32;  // rows each warp walks (grid sizing)

constexpr int kTileRows = 64;         // rows a block tile
constexpr int kTileCols = 64;         // gate columns a block
constexpr int kTileThreads = 256;     // 16 x 16 threads of 4 x 4 pairs
constexpr int kTileStride = 68;       // floats a k, rows or columns

// what a phase-1 kernel sums per (row, gate column): the projection
// alone (K10a), the recurrent sum plus the projection (K10b), the
// recurrent sum alone (K6, K9b)
enum class Sums { kProj, kProjRec, kRec };

// shared memory of a warp-kernel block of `cols` gate columns: their W_x
// and W_h columns and bias as f32 (D = 0: the recurrent sum alone, H = 0:
// the projection alone)
size_t gates_smem(int cols, int D, int H) {
  return sizeof(float) * (size_t)cols * (D + H + 1);
}

// shared memory of a tiled block (D = 0, H = 0: as gates_smem)
size_t gates_tiled_smem(int D, int H) {
  return sizeof(float) * ((size_t)2 * kTileStride * (D + H) + kTileCols);
}

// one staged operand of the tiled kernel, as f32: an f32 value is copied
// by cp.async (every copy of a tile in flight at once), a bf16 value
// converted on the way; a missing one (past the rows, y before the first
// step) is zero
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src) {
  if (src == nullptr) {
    *dst = 0.0f;
  } else if constexpr (sizeof(T) == sizeof(float)) {
    cp_async4(dst, src);
  } else {
    *dst = to_f32(*src);
  }
}

// The warp kernel's block: `cols` of the G = gates H gate columns of one
// of `dirs` directions (blockIdx.x), rows blockIdx.y * warps + warp,
// + gridDim.y * warps, ...  W_x is [D, dirs G], each W_h [H, G].
template <typename T, Sums kSums, typename RowOf>
__device__ __forceinline__ void gates_warp_body(
    const T* __restrict__ wx, const float* __restrict__ bias,
    const T* __restrict__ whf, const T* __restrict__ whb,
    float* __restrict__ pre, int rows, int D, int H, int gates, int dirs,
    int cols, RowOf row_of) {
  constexpr bool kProj = kSums != Sums::kRec;
  constexpr bool kRec = kSums != Sums::kProj;
  extern __shared__ float smem[];
  const int G = gates * H;
  const int Dp = kProj ? D : 0;              // projection terms a sum
  const int Hr = kRec ? H : 0;               // recurrent terms a sum
  const int tiles = (G + cols - 1) / cols;   // per direction
  const int dir = blockIdx.x / tiles;
  const int c0 = (blockIdx.x % tiles) * cols;
  const int nc = min(cols, G - c0);
  const T* wh = dir == 0 ? whf : whb;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float* wx_s = smem;                 // [nc][Dp]: W_x column c0 + c
  float* wh_s = wx_s + nc * Dp;       // [nc][Hr]: W_h column c0 + c
  float* b_s = wh_s + nc * Hr;        // [nc]

  if constexpr (kProj) {
    for (int i = threadIdx.x; i < nc * D; i += blockDim.x) {
      const int k = i / nc, c = i % nc;
      wx_s[c * D + k] = to_f32(wx[(size_t)k * dirs * G + dir * G + c0 + c]);
    }
    for (int c = threadIdx.x; c < nc; c += blockDim.x)
      b_s[c] = bias[dir * G + c0 + c];
  }
  if constexpr (kRec) {
    for (int i = threadIdx.x; i < nc * H; i += blockDim.x) {
      const int k = i / nc, c = i % nc;
      wh_s[c * H + k] = to_f32(wh[(size_t)k * G + c0 + c]);
    }
  }
  __syncthreads();

  // one row per warp at a time; x and y rows are read through L1/L2
  // (never staged, as K10a read x), each lane its k = lane, lane + 32, ...
  for (int r = blockIdx.y * nwarps + warp; r < rows;
       r += gridDim.y * nwarps) {
    const T* xr = nullptr;
    const T* yr = nullptr;
    row_of(dir, r, xr, yr);
    // K10a's gate sum: the recurrent warp_dot, then its project()
    float mine = 0.0f;
    for (int c = 0; c < nc; ++c) {
      float acc = 0.0f;
      if constexpr (kRec)
        acc = yr == nullptr ? 0.0f : warp_dot(yr, wh_s + c * H, H, lane);
      if constexpr (kSums == Sums::kProjRec)
        acc += project(xr, wx_s + c * D, b_s[c], D, lane);
      else if constexpr (kProj)
        acc = project(xr, wx_s + c * D, b_s[c], D, lane);
      if (lane == c) mine = acc;
    }
    if (lane < nc) pre[(size_t)r * dirs * G + dir * G + c0 + lane] = mine;
  }
}

// the warp kernel's grid: every direction's column blocks by enough row
// groups that each warp walks ~kGateRowsPerWarp rows
inline dim3 gates_warp_grid(long long rows, int G, int dirs, int cols) {
  const long long per_block = (kGateThreads / 32) * kGateRowsPerWarp;
  const int tiles = (G + cols - 1) / cols;
  return dim3(dirs * tiles,
              (unsigned)std::min<long long>(
                  65535, (rows + per_block - 1) / per_block));
}

// The tiled kernel's block: 64 gate columns of one direction
// (blockIdx.x), row tiles blockIdx.y, + gridDim.y, ...
template <typename T, Sums kSums, typename RowOf>
__device__ __forceinline__ void gates_tiled_body(
    const T* __restrict__ wx, const float* __restrict__ bias,
    const T* __restrict__ whf, const T* __restrict__ whb,
    float* __restrict__ pre, int rows, int D, int H, int gates, int dirs,
    RowOf row_of) {
  constexpr bool kProj = kSums != Sums::kRec;
  constexpr bool kRec = kSums != Sums::kProj;
  extern __shared__ __align__(16) float tile_smem[];
  const int G = gates * H;
  const int Dp = kProj ? D : 0;
  const int Hr = kRec ? H : 0;
  const int K = Dp + Hr;
  const int tiles = (G + kTileCols - 1) / kTileCols;   // per direction
  const int dir = blockIdx.x / tiles;
  const int c0 = (blockIdx.x % tiles) * kTileCols;
  const int nc = min(kTileCols, G - c0);
  const T* wh = dir == 0 ? whf : whb;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float* a_s = tile_smem;                // [K][68]: x | y by row
  float* w_s = a_s + kTileStride * K;    // [K][68]: W_x | W_h by column
  float* b_s = w_s + kTileStride * K;    // [64]

  // the block's columns, once: it walks row tiles blockIdx.y, + gridDim.y
  for (int i = threadIdx.x; i < kTileCols * K; i += blockDim.x) {
    const int k = i / kTileCols, c = i % kTileCols;
    float w = 0.0f;
    if (c < nc)
      w = k < Dp ? to_f32(wx[(size_t)k * dirs * G + dir * G + c0 + c])
                 : to_f32(wh[(size_t)(k - Dp) * G + c0 + c]);
    w_s[k * kTileStride + c] = w;
  }
  if constexpr (kProj) {
    for (int c = threadIdx.x; c < kTileCols; c += blockDim.x)
      b_s[c] = c < nc ? bias[dir * G + c0 + c] : 0.0f;
  }

  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const int row_tiles = (rows + kTileRows - 1) / kTileRows;
  for (int rt = blockIdx.y; rt < row_tiles; rt += gridDim.y) {
    const int row0 = rt * kTileRows;
    const int nr = min(kTileRows, rows - row0);
    __syncthreads();                      // the last tile's sums are done
    for (int r = warp; r < kTileRows; r += nwarps) {
      const T* xr = nullptr;              // zeros past the rows
      const T* yr = nullptr;              // and at the first fwd step
      if (r < nr) row_of(dir, row0 + r, xr, yr);
      if constexpr (kProj) {
        for (int k = lane; k < D; k += 32)
          stage(a_s + k * kTileStride + r, xr == nullptr ? xr : xr + k);
      }
      if constexpr (kRec) {
        for (int k = lane; k < H; k += 32)
          stage(a_s + (Dp + k) * kTileStride + r,
                yr == nullptr ? yr : yr + k);
      }
    }
    cp_async_wait_all();
    __syncthreads();

    float proj[4][4], rec[4][4];
    if constexpr (kProj)
      tile_dot4x4(a_s + 4 * tr, w_s + 4 * tc, kTileStride, D, proj);
    if constexpr (kRec)
      tile_dot4x4(a_s + Dp * kTileStride + 4 * tr,
                  w_s + Dp * kTileStride + 4 * tc, kTileStride, H, rec);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * tr + i;
      if (r >= nr) continue;
      float* out = pre + (size_t)(row0 + r) * dirs * G + dir * G + c0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * tc + j;
        if (c >= nc) continue;
        if constexpr (kSums == Sums::kRec) {
          out[c] = rec[i][j];
        } else {
          // project()'s rounded projection; K10b adds it to the
          // recurrent sum (+0 over the zero rows of the first step, as
          // K10a's over h0), as K10a's chain does
          const float p = to_f32(from_f32<T>(proj[i][j] + b_s[c]));
          if constexpr (kSums == Sums::kProjRec)
            out[c] = rec[i][j] + p;
          else
            out[c] = p;
        }
      }
    }
  }
}

// the tiled kernel's grid: every direction's column blocks by as many
// row groups as leave one block an SM (its shared memory)
inline dim3 gates_tiled_grid(long long rows, int G, int dirs, int sms) {
  const int col_blocks = dirs * ((G + kTileCols - 1) / kTileCols);
  const long long row_tiles = (rows + kTileRows - 1) / kTileRows;
  return dim3(col_blocks,
              (unsigned)std::max<long long>(
                  1, std::min<long long>(row_tiles, sms / col_blocks)));
}

// the shared-memory check and attribute of a phase-1 launch
inline cudaError_t gates_prepare(const void* kern, size_t smem, int* sms) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (smem > (size_t)optin) return cudaErrorLaunchOutOfResources;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// K6's and K9b's rows (one direction): row r of a chunk is walk step
// s0 + r / B, batch row r % B, at t = T-1-s (t = s with reverse); y[prev]
// (t-1, or t+1) is zero (null) at the forward's first step
template <typename T>
struct UniWalkRows {
  const T* y;
  int s0, steps, B, H, reverse;
  __device__ __forceinline__ void operator()(int, int r, const T*&,
                                             const T*& yr) const {
    const int s = s0 + r / B;
    if (s == steps - 1) return;
    const int t = reverse ? s : steps - 1 - s;
    yr = y + ((size_t)(reverse ? t + 1 : t - 1) * B + r % B) * H;
  }
};

// The recurrent sums alone of walk steps s0 .. s0+S-1 of one direction
// (K6's and K9b's phase 1, `gates` gate columns a unit): the tiled
// kernel `tiled` where cols is 0, else the warp kernel `warp` with cols
// gate columns a block.  Each kernel takes y, W_h and `reverse`, the
// direction's forward order.
template <typename T>
int rec_gates_launch(void (*tiled)(const T*, const T*, float*, int, int, int,
                                   int, int, int),
                     void (*warp)(const T*, const T*, float*, int, int, int,
                                  int, int, int, int),
                     const void* y, const void* wh, void* pre, int s0, int S,
                     int steps, int B, int H, int gates, int cols,
                     int reverse, void* stream) {
  if (S <= 0 || B <= 0) return cudaGetLastError();
  if (s0 < 0 || s0 + S > steps || H <= 0 || cols < 0 || cols > kMaxGateCols)
    return cudaErrorInvalidValue;
  const long long rows = (long long)S * B;
  const T* a_y = static_cast<const T*>(y);
  const T* a_wh = static_cast<const T*>(wh);
  float* a_pre = static_cast<float*>(pre);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int sms = 0;
  if (cols == 0) {
    const size_t smem = gates_tiled_smem(0, H);
    cudaError_t e = gates_prepare((const void*)tiled, smem, &sms);
    if (e != cudaSuccess) return e;
    tiled<<<gates_tiled_grid(rows, gates * H, 1, sms), kTileThreads, smem,
            st>>>(a_y, a_wh, a_pre, s0, S, steps, B, H, reverse);
  } else {
    const size_t smem = gates_smem(cols, 0, H);
    cudaError_t e = gates_prepare((const void*)warp, smem, &sms);
    if (e != cudaSuccess) return e;
    warp<<<gates_warp_grid(rows, gates * H, 1, cols), kGateThreads, smem,
           st>>>(a_y, a_wh, a_pre, s0, S, steps, B, H, cols, reverse);
  }
  return cudaGetLastError();
}

}  // namespace
