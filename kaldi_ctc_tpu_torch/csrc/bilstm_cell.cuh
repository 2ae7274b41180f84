// What the recurrent kernels share: K2 and K10a (csrc/bilstm_fwd.cu), K3
// and K10b (csrc/bilstm_bwd.cu), K5 (csrc/lstm_fwd.cu), K6
// (csrc/lstm_bwd.cu), the GRU kernels (csrc/gru_fwd.cu, csrc/gru_bwd.cu),
// the phase-1 code of csrc/lstm_gates.cuh and the two chains,
// csrc/fwd_chain.cuh and csrc/bwd_chain.cuh.
//
// The gate sums are warp-split dot products: lane l adds the products at
// k = l, l + 32, ... with fmaf in order, then the warp reduces the 32
// partial sums by xor shuffles.  The order is fixed by the lane, not by
// the block or the kernel, so the backward kernels, which recompute the
// forward's gates, get the same sums bit for bit from the same operands.
// warp_dot() sums one output a warp; tile_dot4x4() the same sums, one
// thread for 4 x 4 outputs; warp_sum32() 32 outputs a warp at once.
//
// project() is the in-kernel input projection of K10a and K10b, the
// counterpart of rnn_pallas.py::_proj: x[t, b, :] . W_x[:, col] with f32
// sums, plus the f32 bias, rounded to the compute dtype.  It is the one
// definition both passes call, so the gates K10b recomputes are the gates
// K10a computed (the recompute invariant holds for the projection too).
//
// Last, the asynchronous copies (cp.async), the split cluster barrier and
// the 4-byte word access of a bf16 value that the chains use.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// r, z and n of the linear-before-reset GRU cell of
// ops/gru_pallas.py::_gru_gates from the projection parts xr, xz, xn and
// the recurrent sums hr, hz, hn: r = sigmoid(xr + hr), z = sigmoid(xz +
// hz), n = tanh(xn + r hn).  The forward's gru_cell() (csrc/fwd_chain.cuh)
// and the backward chain's GruBwdCell (csrc/bwd_chain.cuh) both form them
// here (the fmaf is explicit so that neither contracts otherwise), so the
// recomputed gates are the forward's.
__device__ __forceinline__ void gru_rzn(float xr, float xz, float xn,
                                        float hr, float hz, float hn,
                                        float& r, float& z, float& n) {
  r = sigmoid(xr + hr);
  z = sigmoid(xz + hz);
  n = tanhf(fmaf(r, hn, xn));
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

// One level of warp_sum32: `live` partial sums a lane → live / 2.  At
// xor offset live / 2 a lane keeps the half of its outputs whose offset
// bit is its own and adds its partner's partial of each (a + b = b + a
// exactly, so either lane's sum is warp_dot's at this level).
template <int kLive>
__device__ __forceinline__ void fold_half(float (&v)[32], int lane) {
  constexpr int kHalf = kLive / 2;
  const bool upper = (lane & kHalf) != 0;
#pragma unroll
  for (int q = 0; q < kHalf; ++q) {
    const float send = upper ? v[q] : v[q + kHalf];
    const float keep = upper ? v[q + kHalf] : v[q];
    v[q] = keep + __shfl_xor_sync(0xffffffffu, send, kHalf);
  }
}

// 32 outputs of a warp at once: v[o] holds lane's partial sum of output o
// (its k = lane, lane + 32, ... summed with fmaf in order, as in warp_dot)
// → lane o's return value is output o's sum, warp_dot's bit for bit (the
// same xor tree, offsets 16, 8, 4, 2, 1), in 31 shuffles where 32
// warp_dot reductions take 160.
__device__ __forceinline__ float warp_sum32(float (&v)[32], int lane) {
  fold_half<32>(v, lane);
  fold_half<16>(v, lane);
  fold_half<8>(v, lane);
  fold_half<4>(v, lane);
  fold_half<2>(v, lane);
  return v[0];
}

// a 4-byte copy from global to shared memory that does not hold up the
// thread (cp.async); cp_async_wait_all waits for the thread's own copies
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the cluster barrier in two halves: stores before arrive are seen by
// every CTA of the cluster after its wait
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the 4-byte aligned word holding *p (a bf16 value shares it with a
// neighbour of the same tensor), and *p read back from that word
template <typename T>
__device__ __forceinline__ const void* word_of(const T* p) {
  return reinterpret_cast<const void*>(reinterpret_cast<uintptr_t>(p) &
                                       ~static_cast<uintptr_t>(3));
}
__device__ __forceinline__ float from_word(uint32_t w, const float*) {
  return __uint_as_float(w);
}
__device__ __forceinline__ float from_word(uint32_t w,
                                           const __nv_bfloat16* p) {
  const bool high = (reinterpret_cast<uintptr_t>(p) & 2) != 0;
  return __bfloat162float(__ushort_as_bfloat16(
      static_cast<unsigned short>(high ? w >> 16 : w & 0xffffu)));
}

// the opt-in shared memory of one block on the current device, in bytes,
// or a negative CUDA error code
inline int smem_optin_bytes() {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return e == cudaSuccess ? optin : -static_cast<int>(e);
}

}  // namespace
