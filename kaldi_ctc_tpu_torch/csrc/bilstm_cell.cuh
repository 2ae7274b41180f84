// What the bidirectional LSTM kernels share: K2 and K10a
// (csrc/bilstm_fwd.cu), K3 and K10b (csrc/bilstm_bwd.cu).
//
// The gate sums are warp-split dot products: lane l adds the products at
// k = l, l + 32, ... with fmaf in order, then the warp reduces the 32
// partial sums by xor shuffles.  The order is fixed by the lane, not by
// the block or the kernel, so the backward kernels, which recompute the
// forward's gates, get the same sums bit for bit from the same operands.
//
// project() is the in-kernel input projection of K10a and K10b, the
// counterpart of rnn_pallas.py::_proj: x[t, b, :] . W_x[:, col] with f32
// sums, plus the f32 bias, rounded to the compute dtype.  It is the one
// definition both passes call, so the gates K10b recomputes are the gates
// K10a computed (the recompute invariant holds for the projection too).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype does
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// sum_k a[k] * b[k] over k < n, in every lane of the calling warp
template <typename A>
__device__ __forceinline__ float warp_dot(const A* __restrict__ a,
                                         const float* __restrict__ b, int n,
                                         int lane) {
  float acc = 0.0f;
  for (int k = lane; k < n; k += 32) acc = fmaf(to_f32(a[k]), b[k], acc);
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// warp_dot's sum, computed by one thread, for each of 4 rows x 4 columns:
// row i's k-th term at a[k * stride + i], column j's at b[k * stride + j]
// (both k-major, each group of 4 16-byte aligned), n terms.  warp_dot's
// lane l sums k = l, l + 32, ... with fmaf in order; its xor-shuffle tree
// then adds lanes that differ in bit 4 first, then bit 3, ..., bit 0,
// each lane adding the other's sum to its own.  Walking the lanes in
// bit-reversed order (0, 16, 8, 24, ...) turns that tree into a
// left-to-right binary counter over the walk, so each sum here is
// warp_dot's bit for bit, for any n.  Every thread of a warp walks the
// same k at the same time.
__device__ __forceinline__ void tile_dot4x4(const float* __restrict__ a,
                                            const float* __restrict__ b,
                                            int stride, int n,
                                            float (&out)[4][4]) {
  // finished left subtrees, one per tree level (registers: every index
  // below is fixed at compile time)
  float p0[4][4], p1[4][4], p2[4][4], p3[4][4], p4[4][4];
  float v[4][4];
  auto add = [&](const float (&p)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) v[i][j] = p[i][j] + v[i][j];
  };
  auto keep = [&](float (&p)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[i][j] = v[i][j];
  };
#pragma unroll 1
  for (int m = 0; m < 32; ++m) {
    const int lane = __brev(m) >> 27;     // the lane this leaf belongs to
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) v[i][j] = 0.0f;
#pragma unroll 4
    for (int k = lane; k < n; k += 32) {
      const float4 a4 = *reinterpret_cast<const float4*>(a + k * stride);
      const float4 b4 = *reinterpret_cast<const float4*>(b + k * stride);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) v[i][j] = fmaf(av[i], bv[j], v[i][j]);
    }
    // carry v up the tree: leaf m closes one subtree per trailing one bit
    switch (__ffs(~m) - 1) {
      case 0: keep(p0); break;
      case 1: add(p0); keep(p1); break;
      case 2: add(p0); add(p1); keep(p2); break;
      case 3: add(p0); add(p1); add(p2); keep(p3); break;
      case 4: add(p0); add(p1); add(p2); add(p3); keep(p4); break;
      default:                            // m = 31: the root
        add(p0); add(p1); add(p2); add(p3); add(p4);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) out[i][j] = v[i][j];
    }
  }
}

// The projection of one gate column for one row: x_row [D] in the compute
// dtype (read through L1/L2, never staged), wx_col [D] and bias as f32
// holding the compute-dtype weights → the projection as the forward
// stores it, rounded to T, back in f32.
template <typename T>
__device__ __forceinline__ float project(const T* __restrict__ x_row,
                                        const float* __restrict__ wx_col,
                                        float bias, int D, int lane) {
  return to_f32(from_f32<T>(warp_dot(x_row, wx_col, D, lane) + bias));
}

}  // namespace
