// The deterministic reduction of one launch's per-thread float64 sums
// across the grid, shared by the telemetry sums (H6, diag.cu) and the cost
// sums (H8, cost.cu): a block sums its threads by warp shuffles in a fixed
// tree and its warps in ascending order (block_sums), thread 0 writes the
// block's partial and draws a ticket (last_block), and the block that
// draws the last ticket adds every partial in block order by the same
// trees (thread_partials over L2Reads, then block_sums). So the result is
// the same bits whichever block finishes last. The ticket (atomicInc with
// gridDim.x - 1) wraps back to 0, ready for the next launch; its owner
// zeroes it once. Device code only: the host build of the tests mirrors
// the shuffles and the ticket (tests/test_torch_kernel_math.py).
#pragma once

#include <cuda_runtime.h>

#include "diag.cuh"

namespace gbp {

constexpr unsigned FULL_WARP = 0xffffffffu;

// The block's N sums into thread 0's ``acc``: each warp's lanes by the
// fixed tree (lane l adds lane l + h, h = 16 ... 1; lane 0 ends with the
// warp's sum), then the warps in ascending order (fold_warps). ``warp`` is
// the block's shared [DIAG_WARPS][N]; every thread of the block must call
// this.
template <int N>
__device__ __forceinline__ void block_sums(double acc[N],
                                           double (*warp)[N]) {
#pragma unroll
  for (int h = 16; h > 0; h >>= 1)
#pragma unroll
    for (int k = 0; k < N; ++k)
      acc[k] = acc[k] + __shfl_down_sync(FULL_WARP, acc[k], h);
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int k = 0; k < N; ++k) warp[threadIdx.x >> 5][k] = acc[k];
  __syncthreads();
  if (threadIdx.x == 0) fold_warps<N>(warp, acc);
}

// The partials read from L2, past the SM's cache, where the other blocks'
// writes are.
struct L2Reads {
  const double* p;
  __device__ __forceinline__ double operator[](long long i) const {
    return __ldcg(p + i);
  }
};

// Thread 0 writes the block's sums (its ``acc`` after block_sums) as
// column blockIdx.x of ``partial`` [N][gridDim.x] and draws a ticket;
// every thread learns through ``last`` (the block's shared flag) whether
// its block drew the last one, and if so sees every block's partial.
template <int N>
__device__ __forceinline__ bool last_block(const double acc[N],
                                           double* partial,
                                           unsigned* ticket, bool* last) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k)
      partial[(long long)k * gridDim.x + blockIdx.x] = acc[k];
    __threadfence();          // the partial is visible before the ticket
    *last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!*last) return false;
  __threadfence();            // every other block's partial is visible
  return true;
}

}  // namespace gbp
