// Deterministic CSR segmented sum (H3): out[c][v] = prior[c][v] + the sum
// of planes[c][e] over variable v's edges.
//
// Replaces gbp_poplar_tpu/ops/reduce_kernel.py::_reduce_kernel with
// blocked_reduce / combine_partials, and the fused sweep kernel's
// reduction epilogue with combine_grid_any. Variable v's edges are
// perm[ptr[v]:ptr[v+1]] (perm == NULL: the contiguous range), in ascending
// edge order. Every output is summed in one fixed order, so the result is
// the same from run to run:
//   group == 1:  one thread per (component, variable), a sequential sum;
//                consecutive threads take consecutive variables.
//   group == 32: one warp per (component, variable) for long segments;
//                lane l sums the edges j = ptr[v] + l + 32k in order, and a
//                butterfly of shuffles (the same on every lane, since
//                a + b == b + a) combines the 32 lane sums.
// Bound: bytes, one pass over the message rows.
#include <cuda_runtime.h>

namespace gbp {

__global__ void reduce_seq(const float* __restrict__ planes,
                           long long stride, int comp,
                           const int* __restrict__ ptr,
                           const int* __restrict__ perm, int n_var,
                           const float* __restrict__ prior,
                           float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)comp * n_var) return;
  const int c = (int)(t / n_var);
  const int v = (int)(t % n_var);
  const float* row = planes + c * stride;
  float acc = 0.0f;
  const int end = ptr[v + 1];
  for (int j = ptr[v]; j < end; ++j) acc = acc + row[perm ? perm[j] : j];
  out[t] = prior ? prior[t] + acc : acc;
}

__global__ void reduce_warp(const float* __restrict__ planes,
                            long long stride, int comp,
                            const int* __restrict__ ptr,
                            const int* __restrict__ perm, int n_var,
                            const float* __restrict__ prior,
                            float* __restrict__ out) {
  const long long t =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (t >= (long long)comp * n_var) return;   // whole warp exits together
  const int c = (int)(t / n_var);
  const int v = (int)(t % n_var);
  const float* row = planes + c * stride;
  float acc = 0.0f;
  const int end = ptr[v + 1];
  for (int j = ptr[v] + lane; j < end; j += 32)
    acc = acc + row[perm ? perm[j] : j];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = acc + __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[t] = prior ? prior[t] + acc : acc;
}

}  // namespace gbp

extern "C" int gbp_reduce_launch(const float* planes, long long stride,
                                 int comp, const int* ptr, const int* perm,
                                 int n_var, const float* prior, float* out,
                                 int group, void* stream) {
  const long long n = (long long)comp * n_var;
  if (n <= 0) return 0;
  const int threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  if (group == 1) {
    const long long blocks = (n + threads - 1) / threads;
    gbp::reduce_seq<<<(unsigned)blocks, threads, 0, s>>>(
        planes, stride, comp, ptr, perm, n_var, prior, out);
  } else if (group == 32) {
    const long long blocks = (n * 32 + threads - 1) / threads;
    gbp::reduce_warp<<<(unsigned)blocks, threads, 0, s>>>(
        planes, stride, comp, ptr, perm, n_var, prior, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
