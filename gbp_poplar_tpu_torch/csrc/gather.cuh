// One edge of the belief gather (H5): out[c][e] = src[c][v] for every
// component c, where v is the edge's variable. Plain loads and stores, so
// the host build of tests/test_torch_kernel_math.py runs the same body.
#pragma once

namespace gbp {

__device__ __forceinline__ void gather_edge(const float* __restrict__ src,
                                            long long n_var, int comp, int v,
                                            float* __restrict__ out,
                                            long long n_edges, long long e) {
  for (int c = 0; c < comp; ++c)
    out[c * n_edges + e] = src[c * n_var + v];
}

}  // namespace gbp
