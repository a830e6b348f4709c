// Small-matrix algebra for one edge or one variable per thread.
//
// The scalar counterpart of gbp_poplar_tpu_torch/ops/planes.py (and of the
// JAX package's ops/planes.py): the same formulas in the same operation
// order, term for term. The solves divide; a reciprocal is multiplied only
// where ops/planes.py multiplies by one (the Cholesky column scaling, the
// adjugate inverse). Sums run left to right, and
// min/max propagate NaN as torch.minimum / jnp.minimum do. The library is
// built with -fmad=false (ops/_cuda.py), so no multiply-add is contracted
// and every + - * / rounds as the plain PyTorch version's separate ops do.
//
// Symmetric matrices are packed row-major over the lower triangle:
// (i, j), i >= j -> slot i*(i+1)/2 + j (21 slots for 6x6, 6 for 3x3).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace gbp {

__host__ __device__ constexpr int sym_slot(int i, int j) {
  return i >= j ? i * (i + 1) / 2 + j : j * (j + 1) / 2 + i;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? nanf("") : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? nanf("") : fmaxf(a, b);
}

// packed [n_slots] -> dense symmetric D x D
template <int D>
__device__ __forceinline__ void unpack_sym(const float* p, float m[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      m[i][j] = p[sym_slot(i, j)];
      m[j][i] = m[i][j];
    }
}

// Tikhonov jitter relative to the mean diagonal; rel_over_d = rel_eps / D
// (planes.add_rel_jitter). Off-diagonal entries are unchanged.
template <int D>
__device__ __forceinline__ void add_rel_jitter(float m[D][D],
                                               float rel_over_d) {
  float mean_diag = m[0][0];
#pragma unroll
  for (int i = 1; i < D; ++i) mean_diag = mean_diag + m[i][i];
  const float jit = rel_over_d * fabsf(mean_diag);
#pragma unroll
  for (int i = 0; i < D; ++i) m[i][i] = m[i][i] + jit;
}

// Lower Cholesky factor and the minimum pre-sqrt pivot
// (planes.cholesky_with_pivot). l[i][j] for j > i is left unset.
template <int D>
__device__ __forceinline__ void cholesky_with_pivot(const float m[D][D],
                                                    float l[D][D],
                                                    float& min_pivot) {
#pragma unroll
  for (int j = 0; j < D; ++j) {
    float s = m[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - l[j][k] * l[j][k];
    min_pivot = (j == 0) ? s : nan_min(min_pivot, s);
    const float diag = sqrtf(nan_max(s, 1e-30f));
    l[j][j] = diag;
    const float inv_d = 1.0f / diag;
#pragma unroll
    for (int i = j + 1; i < D; ++i) {
      float v = m[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) v = v - l[i][k] * l[j][k];
      l[i][j] = v * inv_d;
    }
  }
}

// Solve (L L^T) x = b with true divides (planes.chol_solve).
template <int D>
__device__ __forceinline__ void chol_solve(const float l[D][D],
                                           const float rhs[D], float x[D]) {
  float y[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float s = rhs[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - l[i][k] * y[k];
    y[i] = s / l[i][i];
  }
#pragma unroll
  for (int i = D - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < D; ++k) s = s - l[k][i] * x[k];
    x[i] = s / l[i][i];
  }
}

// Adjugate inverse of a symmetric 3x3 and its Sylvester positive-definite
// test (planes.inv_sym3_posdef).
__device__ __forceinline__ bool inv_sym3_posdef(const float m[3][3],
                                                float inv[3][3]) {
  const float a = m[0][0], b = m[0][1], c = m[0][2];
  const float d = m[1][1], e = m[1][2];
  const float f = m[2][2];
  const float c00 = d * f - e * e;
  const float c01 = c * e - b * f;
  const float c02 = b * e - c * d;
  const float c11 = a * f - c * c;
  const float c12 = b * c - a * e;
  const float c22 = a * d - b * b;
  const float det = a * c00 + b * c01 + c * c02;
  const bool ok = (a > 0.0f) && (c22 > 0.0f) && (det > 0.0f);
  const float inv_det = 1.0f / det;
  inv[0][0] = c00 * inv_det;
  inv[0][1] = c01 * inv_det;
  inv[0][2] = c02 * inv_det;
  inv[1][0] = c01 * inv_det;
  inv[1][1] = c11 * inv_det;
  inv[1][2] = c12 * inv_det;
  inv[2][0] = c02 * inv_det;
  inv[2][1] = c12 * inv_det;
  inv[2][2] = c22 * inv_det;
  return ok;
}

// Mean of one belief from its eta [D] and packed Lambda
// (table_kernel.variable_means): D = 6 by Cholesky (planes.solve_sym),
// D = 3 by the adjugate inverse times eta (planes.inv_sym3, planes.matvec).
// The table build (H2) and the unfused sweep (H4) both solve here, so a
// mean solved per variable and one solved per edge agree to the bit.
template <int D>
__device__ __forceinline__ void belief_mean(const float eta[D],
                                            const float* lam, float mu[D]) {
  static_assert(D == 6 || D == 3, "cameras (6) or landmarks (3)");
  float m[D][D];
  unpack_sym<D>(lam, m);
  if constexpr (D == 6) {
    float l[6][6], min_pivot;
    cholesky_with_pivot<6>(m, l, min_pivot);
    chol_solve<6>(l, eta, mu);
  } else {
    float inv[3][3];
    inv_sym3_posdef(m, inv);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      mu[i] = inv[i][0] * eta[0] + inv[i][1] * eta[1] + inv[i][2] * eta[2];
  }
}

// Rodrigues' formula with the small-angle branch (planes.so3_exp).
__device__ __forceinline__ void so3_exp(const float w[3], float r[3][3]) {
  const float wx = w[0], wy = w[1], wz = w[2];
  const float theta_sq = wx * wx + wy * wy + wz * wz;
  const float theta = sqrtf(theta_sq);
  const bool small = theta < 1e-6f;
  const float th = small ? 1.0f : theta;
  const float th_sq = small ? 1.0f : theta_sq;
  const float a = small ? 1.0f : sinf(th) / th;
  const float b = small ? 0.5f : (1.0f - cosf(th)) / th_sq;
  const float xx = wx * wx, yy = wy * wy, zz = wz * wz;
  const float xy = wx * wy, xz = wx * wz, yz = wy * wz;
  r[0][0] = 1.0f - b * (yy + zz);
  r[0][1] = -a * wz + b * xy;
  r[0][2] = a * wy + b * xz;
  r[1][0] = a * wz + b * xy;
  r[1][1] = 1.0f - b * (xx + zz);
  r[1][2] = -a * wx + b * yz;
  r[2][0] = -a * wy + b * xz;
  r[2][1] = a * wx + b * yz;
  r[2][2] = 1.0f - b * (xx + yy);
}

// out = a @ b for R x K times K x C (planes.matmul: left-to-right sums)
template <int R, int K, int C>
__device__ __forceinline__ void matmul(const float a[R][K],
                                       const float b[K][C], float out[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) {
      float acc = a[i][0] * b[0][j];
#pragma unroll
      for (int k = 1; k < K; ++k) acc = acc + a[i][k] * b[k][j];
      out[i][j] = acc;
    }
}

__device__ __forceinline__ void hat(const float v[3], float h[3][3]) {
  h[0][0] = 0.0f;  h[0][1] = -v[2]; h[0][2] = v[1];
  h[1][0] = v[2];  h[1][1] = 0.0f;  h[1][2] = -v[0];
  h[2][0] = -v[1]; h[2][1] = v[0];  h[2][2] = 0.0f;
}

}  // namespace gbp
