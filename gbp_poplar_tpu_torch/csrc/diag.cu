// The per-sweep telemetry (H6): the five sums of diagnostics over all
// edges, from the belief tables H2 builds after the sweep.
//
// Replaces what the JAX package computes in each lax.scan body of its
// solve (gbp_poplar_tpu/core/gbp.py::diagnostics and reprojection_error,
// one XLA fusion there; no Pallas kernel): the means gathered per edge,
// the projection, the residual norm, the validity mask and five sums.
// The per-edge and per-block bodies are csrc/diag.cuh's.
//
// Bound on the H100: bytes. Per edge two ids, the measurement, activity,
// damping counter and robust flag (25 B; 12 more with per-edge intrinsics,
// 1 with a bad mask), and per variable its mean and flag from the tables
// (28 B a camera, 16 B a landmark): 8.9 us at the Ladybug shape. The
// projection's float operations take a small part of that at the card's
// float32 rate.
//
// Design: two launches, no atomics, so the sums are the same from run to
// run. Pass 1: a block of 256 threads per 2,048 consecutive edges, each
// thread its 8 edges strided by 256 (every load coalesced across the
// block; the table rows by index, cached: consecutive edges share a
// landmark and a handful of cameras), a fixed tree in shared memory, one
// partial per block. Pass 2: one block adds the partials in block order.
// The plain version (ops/diag_kernel.edge_sums_reference) solves the
// means, gathers and projects in about 400 separate PyTorch operations
// (415 by torch.profiler on an H100, 375 device launches).
#include <cuda_runtime.h>

#include "diag.cuh"

namespace gbp {

__global__ void __launch_bounds__(DIAG_THREADS)
diag_pass1(const DiagArgs a, double* __restrict__ partial) {
  __shared__ double sums[DIAG_SUMS * DIAG_THREADS];
  const int t = threadIdx.x;
  double acc[DIAG_SUMS];
  diag_thread_edges(a, blockIdx.x, t, acc);
#pragma unroll
  for (int k = 0; k < DIAG_SUMS; ++k) sums[k * DIAG_THREADS + t] = acc[k];
  __syncthreads();
#pragma unroll
  for (int h = DIAG_THREADS / 2; h > 0; h >>= 1) {
    if (t < h) diag_tree_level(sums, h, t);
    __syncthreads();
  }
  if (t < DIAG_SUMS)
    partial[(long long)t * gridDim.x + blockIdx.x] = sums[t * DIAG_THREADS];
}

__global__ void __launch_bounds__(DIAG_THREADS)
diag_pass2(const double* __restrict__ partial, long long n_blocks,
           double* __restrict__ out) {
  __shared__ double sums[DIAG_SUMS * DIAG_THREADS];
  const int t = threadIdx.x;
  double acc[DIAG_SUMS];
  diag_thread_partials(partial, n_blocks, t, acc);
#pragma unroll
  for (int k = 0; k < DIAG_SUMS; ++k) sums[k * DIAG_THREADS + t] = acc[k];
  __syncthreads();
#pragma unroll
  for (int h = DIAG_THREADS / 2; h > 0; h >>= 1) {
    if (t < h) diag_tree_level(sums, h, t);
    __syncthreads();
  }
  if (t == 0) diag_finish(sums, out);
}

}  // namespace gbp

// The number of pass-1 blocks (and partials per sum) for n_edges edges.
extern "C" long long gbp_diag_blocks(long long n_edges) {
  return gbp::diag_blocks(n_edges);
}

// Both passes on ``stream``: ``partial`` holds DIAG_SUMS x
// gbp_diag_blocks(n_edges) doubles, ``out`` the DIAG_SUMS results (zeros
// without edges).
extern "C" int gbp_diag_launch(const gbp::DiagArgs* args, double* partial,
                               double* out, void* stream) {
  const long long blocks = gbp::diag_blocks(args->n_edges);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (blocks > 0) {
    gbp::diag_pass1<<<(unsigned)blocks, gbp::DIAG_THREADS, 0, s>>>(*args,
                                                                  partial);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  gbp::diag_pass2<<<1, gbp::DIAG_THREADS, 0, s>>>(partial, blocks, out);
  return (int)cudaGetLastError();
}
