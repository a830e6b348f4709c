// The coarse step's per-edge system blocks (H7): one edge's contribution
// to the reduced 6G x 6G Gauss-Newton system over per-group rigid motions,
// as a plain function on scalars with no device intrinsics, so that the
// host build of tests/test_torch_chunk_kernels.py runs the same body.
//
// The JAX package's core/coarse.py::coarse_increment (the per-edge part
// and the operands of its segment_sums) and ops/coarse_kernel.py::
// coarse_edge_blocks_reference in this package: at the sanitised means
// (non-finite components read as 0) of the edge's camera and landmark, the
// projection (planes.cuh project) and its Jacobians J_c [2x6], J_l [2x3]
// (planes.cuh reproj_jacobians), the residual r = z - h(x), the Huber
// variance, and the mask ``act``: active, r finite, |z_cf| > min_depth,
// both Jacobians finite. With w = 1 / var on ``act`` edges (0 elsewhere),
// b_c = J_c S_cam[c] and b_l = J_l [I | -hat(y)] (zero off ``act``), the
// terms, each sanitised on its own (a finite but huge Jacobian can
// overflow a product):
//   aa = w b_c^T b_c (21 symmetric slots),  rc = w b_c^T r (6),
//   bb = w b_l^T b_l (21 slots),            rl = w b_l^T r (6),
//   ab = w b_c^T b_l (36, row-major).
// Their planes are laid out so that each segmented sum over the edges
// reads one contiguous block of rows: [aa | rc] by the camera's group,
// [bb | rl] by the landmark's group, ab by the pair (core/coarse.py).
#pragma once

#include "planes.cuh"

namespace gbp {

enum : int {
  COARSE_AA = 0,         // w b_c^T b_c, symmetric slots (planes.cuh sym_slot)
  COARSE_RC = 21,        // w b_c^T r
  COARSE_BB = 27,        // w b_l^T b_l, symmetric slots
  COARSE_RL = 48,        // w b_l^T r
  COARSE_AB = 54,        // w b_c^T b_l, row-major 6 x 6
  COARSE_TERMS = 90,
  COARSE_CAM_ROWS = COARSE_BB,                  // [aa | rc]
  COARSE_LMK_ROWS = COARSE_AB - COARSE_BB,      // [bb | rl]
};

// The kernel's operands (ops/coarse_kernel.py CoarseArgs mirrors it). The
// means are the belief means in plane layout, unsanitised; s_cam is the
// per-camera rigid basis S [6 x 6] row-major, already sanitised; the edge
// fields are [n_edges] (meas [2, n_edges], intr [3, n_edges] or null);
// ``out`` is [COARSE_TERMS, n_real] for the first n_real edges.
struct CoarseArgs {
  const float* cam_mu;
  const float* lmk_mu;
  const float* s_cam;
  const int* cam_idx;
  const int* lmk_idx;
  const float* meas;
  const float* meas_var;
  const float* intr;
  const int* active;
  float* out;
  long long n_cams, n_lmks, n_edges, n_real;
  float fx, fy, cx, cy;      // pinhole intrinsics (without intr)
  float nstds;               // Huber threshold in sigmas
  float huber_c;             // 0.5 * nstds * nstds, rounded once
  float min_depth;
};

__device__ __forceinline__ float finite_or_zero(float x) {
  return isfinite(x) ? x : 0.0f;
}

// Edge e's COARSE_TERMS terms into column e of ``a.out``.
__device__ __forceinline__ void coarse_edge(const CoarseArgs& a,
                                            long long e) {
  // every load first, none behind a condition on another
  const int ci = a.cam_idx[e], li = a.lmk_idx[e];
  const int active = a.active[e];
  const float mu = a.meas[e], mv = a.meas[a.n_edges + e];
  const float var0 = a.meas_var[e];
  const bool has_intr = a.intr != nullptr;
  float in[3] = {0.0f, 0.0f, 0.0f};
  if (has_intr)
    for (int i = 0; i < 3; ++i) in[i] = a.intr[i * a.n_edges + e];
  float cam[6], lmk[3];
#pragma unroll
  for (int i = 0; i < 6; ++i)
    cam[i] = finite_or_zero(a.cam_mu[i * a.n_cams + ci]);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    lmk[i] = finite_or_zero(a.lmk_mu[i * a.n_lmks + li]);

  float r[3][3], y_cf[3], u, v;
  project(cam, lmk, a.fx, a.fy, a.cx, a.cy, has_intr, in, r, y_cf, u, v);
  float j_c[2][6], j_l[2][3];
  reproj_jacobians(r, y_cf, cam, lmk, a.fx, a.fy, has_intr, in, j_c, j_l);
  float res[2] = {mu - u, mv - v};
  // Huber variance inflation (projection.huber_meas_var)
  const float err = sqrtf(res[0] * res[0] + res[1] * res[1]);
  const float sigma = sqrtf(var0);
  const bool robust = err > a.nstds * sigma;
  float denom = 2.0f * (a.nstds * sigma * err - a.huber_c * var0);
  denom = robust ? denom : 1.0f;
  const float var = robust ? var0 * err * err / denom : var0;
  bool act = active > 0 && isfinite(res[0]) && isfinite(res[1])
             && fabsf(y_cf[2]) > a.min_depth;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) act = act && isfinite(j_c[i][j]);
#pragma unroll
    for (int j = 0; j < 3; ++j) act = act && isfinite(j_l[i][j]);
  }
  const float w = act ? 1.0f / var : 0.0f;
  res[0] = act ? res[0] : 0.0f;
  res[1] = act ? res[1] : 0.0f;

  // the reduced Jacobians: b_c = J_c S_cam[c], b_l = J_l [I | -hat(y)]
  const float* s = a.s_cam + (long long)ci * 36;
  float s_cam[6][6], s_lmk[3][6];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) s_cam[i][j] = s[i * 6 + j];
  float y_hat[3][3];
  hat(lmk, y_hat);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      s_lmk[i][j] = i == j ? 1.0f : 0.0f;
      s_lmk[i][3 + j] = -y_hat[i][j];
    }
  float b_c[2][6], b_l[2][6];
  matmul<2, 6, 6>(j_c, s_cam, b_c);
  matmul<2, 3, 6>(j_l, s_lmk, b_l);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      b_c[i][j] = act ? b_c[i][j] : 0.0f;
      b_l[i][j] = act ? b_l[i][j] : 0.0f;
    }

  float* out = a.out + e;
  const long long n = a.n_real;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      const int slot = sym_slot(i, j);
      out[(COARSE_AA + slot) * n] = finite_or_zero(
          (b_c[0][i] * b_c[0][j] + b_c[1][i] * b_c[1][j]) * w);
      out[(COARSE_BB + slot) * n] = finite_or_zero(
          (b_l[0][i] * b_l[0][j] + b_l[1][i] * b_l[1][j]) * w);
    }
    out[(COARSE_RC + i) * n] = finite_or_zero(
        (b_c[0][i] * res[0] + b_c[1][i] * res[1]) * w);
    out[(COARSE_RL + i) * n] = finite_or_zero(
        (b_l[0][i] * res[0] + b_l[1][i] * res[1]) * w);
#pragma unroll
    for (int j = 0; j < 6; ++j)
      out[(COARSE_AB + i * 6 + j) * n] = finite_or_zero(
          (b_c[0][i] * b_l[0][j] + b_c[1][i] * b_l[1][j]) * w);
  }
}

}  // namespace gbp
