// One variable's belief-table row (H2): [eta | packed Lambda | mean |
// valid | 0-pad], from its column of the belief planes [D + NS, n_var].
//
// The mean is planes.cuh's belief_mean, the solve the unfused sweep (H4)
// runs per edge: D = 6 by Cholesky (planes.solve_sym), D = 3 by the
// adjugate (planes.inv_sym3). A mean with any non-finite component is
// zeroed whole with valid = 0 (the JAX package's _sanitize_means:
// finiteness only). No device intrinsics, so the body builds for the host
// too (tests/test_torch_kernel_math.py).
#pragma once

#include "planes.cuh"

namespace gbp {

// Columns of the belief tables (ops/table_kernel.py); a belief itself is
// eta | packed Lambda, CAM_COMP / LMK_COMP values.
enum : int {
  CAM_COMP = 27, CAM_WIDTH = 36, CAM_MU = 27, CAM_VALID = 33,
  LMK_COMP = 9, LMK_WIDTH = 16, LMK_MU = 9, LMK_VALID = 12,
};

template <int D, int W>
__device__ __forceinline__ void table_row(const float* bel, long long n_var,
                                          long long v, float row[W]) {
  constexpr int NS = D * (D + 1) / 2;
  static_assert(2 * D + NS + 1 <= W, "the row must hold belief, mean, flag");
#pragma unroll
  for (int i = 0; i < D + NS; ++i) row[i] = bel[i * n_var + v];
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
}

}  // namespace gbp
