// The arrival rendezvous of the kernels that merge across blocks within one
// launch: kernels 2 and 6 (split_decode.cuh), 4 (int8_mlp.cu) and 5
// (int4_matmul.cu).
//
// Each block writes its partial first, then counts its arrival on an int32
// counter; the block that arrives last reads every partial and merges them in
// a fixed order.  The counters come from kernels/arrivals.py: one zeroed
// array per stream, which the last block of each rendezvous sets back to 0,
// so the next launch on the stream (and a graph replay) finds it clean.

#pragma once

#include <cuda_runtime.h>

namespace arrivals {

// Counts the block in on `counter`, one of `total` blocks that write partials
// first.  True, in every thread, for the block that arrives last; that block
// sets the counter back to 0 (every other block has arrived by then) and may
// read every partial after this returns.  Call from all threads of the block.
__device__ __forceinline__ bool arrive_last(int* counter, int total) {
  __shared__ int is_last;
  __threadfence();  // this block's partials are visible before its arrival
  __syncthreads();
  if (threadIdx.x == 0) {
    is_last = atomicAdd(counter, 1) == total - 1;
    if (is_last) *counter = 0;
  }
  __syncthreads();
  if (!is_last) return false;
  __threadfence();
  return true;
}

}  // namespace arrivals
