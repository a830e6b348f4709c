// The coarse step's per-edge system blocks (H7): the 90 terms of every
// real edge's contribution to the reduced rigid-motion system, written as
// plane-major float32 [90, n_real] (body: coarse.cuh coarse_edge).
//
// Replaces the per-edge part of the JAX package's core/coarse.py::
// coarse_increment, an XLA fusion inside the jitted chunk (no Pallas
// kernel): the gathered means, the Jacobians, the Huber weights, the
// batched 2x6 products and their sanitising. The port's plain version
// (ops/coarse_kernel.coarse_edge_blocks_reference) runs that as many small
// PyTorch operations and batched GEMMs of 2x6 blocks over [E, 6, 6].
// The group sums of the planes stay H3's (reduce.cu), by the segments
// core/coarse.group_segments builds.
//
// Bound on the H100: bytes. Per edge the two ids, the measurement, its
// variance and the active flag (24 B; 12 more with per-edge intrinsics)
// and the 90 terms written (360 B); per variable its mean once (24 B a
// camera, 12 B a landmark) and each camera's basis S (144 B). The
// projection, Jacobians and products are about 700 float32 operations an
// edge, a smaller time at the card's float32 rate.
//
// Design: one thread per edge, blocks of COARSE_THREADS; a warp's 32
// edges write each term as 128 consecutive bytes. The edges run by
// landmark, so a warp's landmark means are near each other and its few
// cameras' means and bases come from L1/L2. The terms go to device memory
// and H3 sums them; fusing the sums here is later work (the group count
// can reach the keyframe count, so G^2 pair segments rule out fixed
// shared-memory bins, and the sums must stay deterministic).
#include <cuda_runtime.h>

#include "coarse.cuh"

namespace gbp {

constexpr int COARSE_THREADS = 256;

__global__ void __launch_bounds__(COARSE_THREADS)
coarse_blocks(const CoarseArgs a) {
  const long long e = (long long)blockIdx.x * COARSE_THREADS + threadIdx.x;
  if (e < a.n_real) coarse_edge(a, e);
}

}  // namespace gbp

// One launch on ``stream`` over the first n_real edges (none: no launch).
extern "C" int gbp_coarse_launch(const gbp::CoarseArgs* args, void* stream) {
  const long long blocks =
      (args->n_real + gbp::COARSE_THREADS - 1) / gbp::COARSE_THREADS;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gbp::coarse_blocks<<<(unsigned)blocks, gbp::COARSE_THREADS, 0,
                       (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
