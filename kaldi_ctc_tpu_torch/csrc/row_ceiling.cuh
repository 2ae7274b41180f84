// The batch ceiling of a kernel that keeps every batch row in one block's
// shared memory (K3, K5, K6, K7, K8a, K8b, K9a, K9b).
//
// Each such launcher checks its launch geometry at B rows in one function
// (its shared memory against the card's opt-in limit, then the
// co-residency of its cooperative grid).  The source's *_max_rows query
// runs that same function through max_rows() below, so the formula
// exists once, in the .cu, and the wrappers in ops/rnn_cuda.py and
// ops/gru_cuda.py split a larger batch into row slices under it.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMaxRowsProbe = 1 << 24;

// The largest B in [0, kMaxRowsProbe] whose geometry fit(B) accepts
// (fit(B) returns cudaSuccess; a larger batch never fits where a smaller
// one does not).  A refusal is cudaErrorLaunchOutOfResources or
// cudaErrorCooperativeLaunchTooLarge; any other error is returned as its
// negative code.  Nothing is launched.
template <typename Fit>
int max_rows(Fit fit) {
  int lo = 0, hi = kMaxRowsProbe;
  while (lo < hi) {
    const int mid = lo + (hi - lo + 1) / 2;
    const cudaError_t e = fit(mid);
    if (e == cudaSuccess) {
      lo = mid;
    } else if (e == cudaErrorLaunchOutOfResources ||
               e == cudaErrorCooperativeLaunchTooLarge) {
      hi = mid - 1;
    } else {
      return -static_cast<int>(e);
    }
  }
  cudaGetLastError();   // leave no error of a probe for the next launch
  return lo;
}

}  // namespace
