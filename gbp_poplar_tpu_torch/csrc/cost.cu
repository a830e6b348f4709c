// The robust data term of the MAP cost at up to three sets of variable
// means in one launch (H8; bodies in cost.cuh): the K float32 sums of the
// Huber losses over the active edges not marked bad.
//
// Replaces the data term of the JAX package's core/gbp.py::_cost_parts
// (and map_cost), an XLA fusion inside the jitted chunk (no Pallas
// kernel), which the accelerator and coarse steps run on K = 2 or 3
// candidate mean sets from one stacked [9K, E] gather. Here each set's
// means are read per edge from its own [6, C] and [3, L] planes: no
// gathered planes exist.
//
// Bound on the H100: bytes. Per edge the two ids, the measurement, its
// variance and the active flag (24 B; 12 more with intrinsics, 1 with a
// bad mask), per variable and set its mean once (24 B a camera, 12 B a
// landmark). The projection's sin, cos, divisions and square roots are
// many instructions each, K times an edge.
//
// Design: H6's (diag.cu): 4 edges a thread with the ids read first, blocks
// of 256, then block_sums.cuh's fixed-order reduction with the last block
// (by ticket) adding the partials in block order, so the sums are the
// same bits from run to run. The ticket belongs to the launch's scratch
// (ops/cost_kernel.py, one per device and stream), zeroed once.
#include <cuda_runtime.h>

#include "block_sums.cuh"
#include "cost.cuh"

namespace gbp {

__global__ void __launch_bounds__(DIAG_THREADS)
cost_sums(const CostArgs a, double* partial, unsigned* ticket,
          float* __restrict__ out) {
  __shared__ double warp[DIAG_WARPS][COST_MAX_SETS];
  __shared__ bool last;
  double acc[COST_MAX_SETS];
  cost_thread_edges(a, blockIdx.x, threadIdx.x, acc);
  block_sums<COST_MAX_SETS>(acc, warp);
  if (!last_block<COST_MAX_SETS>(acc, partial, ticket, &last)) return;
  thread_partials<COST_MAX_SETS>(L2Reads{partial}, gridDim.x, threadIdx.x,
                                 acc);
  block_sums<COST_MAX_SETS>(acc, warp);
  if (threadIdx.x == 0) cost_finish(acc, a.n_sets, out);
}

}  // namespace gbp

// One launch on ``stream``: ``partial`` holds COST_MAX_SETS x
// gbp_diag_blocks(n_edges) doubles, ``ticket`` one unsigned that is 0
// before the launch and is left 0 after it, ``out`` the n_sets results
// (zeros without edges).
extern "C" int gbp_cost_launch(const gbp::CostArgs* args, double* partial,
                               unsigned* ticket, float* out, void* stream) {
  if (args->n_sets < 1 || args->n_sets > gbp::COST_MAX_SETS)
    return (int)cudaErrorInvalidValue;
  const long long blocks = gbp::diag_blocks(args->n_edges);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gbp::cost_sums<<<(unsigned)blocks, gbp::DIAG_THREADS, 0,
                   (cudaStream_t)stream>>>(*args, partial, ticket, out);
  return (int)cudaGetLastError();
}
