// Per-variable belief tables (H2): [eta | packed Lambda | mean | valid | 0].
//
// Replaces gbp_poplar_tpu/ops/table_kernel.py::_kernel (build_lmk_table)
// and the camera-side XLA glue of core/gbp.py::_make_tables. One thread
// per variable, templated on the kind: D = 6 solves the camera mean by
// Cholesky (planes.solve_sym), D = 3 the landmark mean by the adjugate
// (planes.inv_sym3), both in planes.cuh's belief_mean, which the unfused
// sweep kernel (H4) shares. A mean with any non-finite component is
// zeroed whole with valid = 0 (the JAX package's _sanitize_means:
// finiteness only).
// Bound: bytes (read 27 or 9 floats, write 36 or 16); rows are written
// with 16-byte stores so the sweep kernel reads them the same way.
#include "planes.cuh"

namespace gbp {

template <int D, int W>
__global__ void table_kernel(const float* __restrict__ bel, int n_var,
                             float* __restrict__ tbl) {
  constexpr int NS = D * (D + 1) / 2;
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n_var) return;
  float row[W];
#pragma unroll
  for (int i = 0; i < D + NS; ++i) row[i] = bel[(size_t)i * n_var + v];
  float mu[D];
  belief_mean<D>(row, row + D, mu);
  bool ok = true;
#pragma unroll
  for (int i = 0; i < D; ++i) ok = ok && isfinite(mu[i]);
#pragma unroll
  for (int i = 0; i < D; ++i) row[D + NS + i] = ok ? mu[i] : 0.0f;
  row[2 * D + NS] = ok ? 1.0f : 0.0f;
#pragma unroll
  for (int i = 2 * D + NS + 1; i < W; ++i) row[i] = 0.0f;
  float4* dst = reinterpret_cast<float4*>(tbl + (size_t)v * W);
#pragma unroll
  for (int q = 0; q < W / 4; ++q)
    dst[q] = make_float4(row[4 * q], row[4 * q + 1], row[4 * q + 2],
                         row[4 * q + 3]);
}

}  // namespace gbp

extern "C" int gbp_table_launch(int d, const float* bel, int n_var,
                                float* tbl, int width, void* stream) {
  if (n_var <= 0) return 0;
  const int threads = 128;
  const int blocks = (n_var + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 6 && width == 36) {
    gbp::table_kernel<6, 36><<<blocks, threads, 0, s>>>(bel, n_var, tbl);
  } else if (d == 3 && width == 16) {
    gbp::table_kernel<3, 16><<<blocks, threads, 0, s>>>(bel, n_var, tbl);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
