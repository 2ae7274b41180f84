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
