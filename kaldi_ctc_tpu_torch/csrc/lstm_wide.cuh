// What the wide route of K2 (csrc/bilstm_fwd.cu) and K3
// (csrc/bilstm_bwd.cu) shares: the block's shape, the 16-byte
// asynchronous copy, a barrier over half a block, and warp_dot's sum tree
// fed one leaf at a time.
//
// The wide route takes a bidirectional LSTM layer whose W_h fits neither
// a cluster's shared memory nor a cooperative block's (H = 1024 in f32:
// W_h of both directions is 32 MiB, more than the shared memory of all
// 132 SMs).  One cooperative grid, one block an SM: each block owns
// kWideUnits hidden units of one direction and reads its slice of W_h
// (a quarter MiB at H = 1024) from L2 every step; the 32 MiB of both
// directions stay resident in the 50 MB L2.  A block takes the batch in
// tiles of kWideRows rows, so one walk of T serves any B.
//
// The forward's gate sums are warp_dot's bit for bit: warp_dot's lane l
// sums k = l, l + 32, ... (one "leaf"), and its xor-shuffle tree adds the
// 32 leaves in the order tile_dot4x4 (csrc/bilstm_cell.cuh) walks them.
// Here the leaves arrive one at a time, each staged in shared memory as
// the k = l + 32 j rows of h and W_h, and LeafTree4x4 keeps tile_dot4x4's
// finished subtrees between them.  The 16 leaves of lanes with bit 0
// clear (0, 16, 8, 24, ...) form the tree's left half and the odd lanes
// its right half, so the block's two halves each build one (levels 0-3)
// and the root adds the two: the same additions as tile_dot4x4, and so
// as warp_dot.

#pragma once

#include <cuda_runtime.h>

#include "bilstm_cell.cuh"

namespace {

constexpr int kWideUnits = 16;       // hidden units a block owns
constexpr int kWideRows = 64;        // batch rows a tile
constexpr int kWideThreads = 512;    // two halves of 256
constexpr int kWideHalf = 256;

// a 16-byte copy from global to shared memory through L2 alone
// (cp.async.cg: no stale L1 line of another block's write is seen)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of the thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a barrier over the 256 threads of half `half` of the block (named
// barriers 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void half_sync(int half) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + half), "r"(kWideHalf)
               : "memory");
}

// leaf m of warp_dot's tree belongs to lane bit-reverse(m)
__device__ __forceinline__ int leaf_lane(int m) { return __brev(m) >> 27; }

// terms of lane l's leaf: k = l + 32 j < n
__device__ __forceinline__ int leaf_terms(int l, int n) {
  return (n - l + 31) / 32;
}

// warp_dot's sums of 4 rows x 4 columns over one half of its tree (16
// leaves), fed a leaf at a time: leaf() sums the leaf's terms with fmaf
// in order, close(i) carries it up the tree as tile_dot4x4 does for its
// leaf i (the half's leaf 15 closes the half: v then holds its sum).
struct LeafTree4x4 {
  float p0[4][4], p1[4][4], p2[4][4], p3[4][4];
  float v[4][4];

  // a: the leaf's h rows, b: its W_h columns, both k-major with `stride`
  // floats between terms, 16-byte aligned; n terms
  __device__ __forceinline__ void leaf(const float* __restrict__ a,
                                       const float* __restrict__ b,
                                       int stride, int n) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) v[i][j] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(a + k * stride);
      const float4 b4 = *reinterpret_cast<const float4*>(b + k * stride);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) v[i][j] = fmaf(av[i], bv[j], v[i][j]);
    }
  }

  __device__ __forceinline__ void add(const float (&p)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) v[i][j] = p[i][j] + v[i][j];
  }

  __device__ __forceinline__ void keep(float (&p)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[i][j] = v[i][j];
  }

  __device__ __forceinline__ void close(int i) {
    switch (__ffs(~i) - 1) {
      case 0: keep(p0); break;
      case 1: add(p0); keep(p1); break;
      case 2: add(p0); add(p1); keep(p2); break;
      case 3: add(p0); add(p1); add(p2); keep(p3); break;
      default: add(p0); add(p1); add(p2); add(p3);   // i = 15
    }
  }
};

}  // namespace
