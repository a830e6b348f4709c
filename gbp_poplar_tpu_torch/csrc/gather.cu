// Belief columns gathered per edge (H5): [comp, V] -> [comp, E].
//
// Replaces gbp_poplar_tpu/ops/reduce_kernel.py::_gather_kernel
// (blocked_gather: a one-hot MXU contraction against a DMA'd window of the
// variable-major source per 1,024-edge block). Here: one thread per edge,
// looping over the components (csrc/gather.cuh). Bound: bytes. The writes
// to [comp, E] are coalesced across a warp; landmark reads are nearly
// sequential because the edges are landmark-sorted; camera reads are random
// but the camera source (27 x C floats, 192 KB at 1,778 cameras) stays in
// L1/L2. No windows or padding: every lane, padding edges included, gets
// its variable's column (blocked_gather returned 0 on lanes outside a
// block's window).
#include <cuda_runtime.h>

#include "gather.cuh"

namespace gbp {

__global__ void __launch_bounds__(256)
gather_kernel(const float* __restrict__ src, long long n_var, int comp,
              const int* __restrict__ idx, float* __restrict__ out,
              long long n_edges) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_edges) return;
  gather_edge(src, n_var, comp, idx[e], out, n_edges, e);
}

}  // namespace gbp

extern "C" int gbp_gather_launch(const float* src, long long n_var, int comp,
                                 const int* idx, float* out,
                                 long long n_edges, void* stream) {
  if (n_edges <= 0) return 0;
  const int threads = 256;
  const long long blocks = (n_edges + threads - 1) / threads;
  gbp::gather_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      src, n_var, comp, idx, out, n_edges);
  return (int)cudaGetLastError();
}
