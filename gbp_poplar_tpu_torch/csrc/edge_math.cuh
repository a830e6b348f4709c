// The per-edge GBP sweep body for one edge: relinearisation candidates at
// the adjacent means, the damping/relinearisation state machine, and the
// four factor-to-variable messages.
//
// The scalar counterpart of core/gbp.py::edge_math in this package and in
// the JAX package, operation for operation, with the adjacent means either
// pre-solved per variable (``premu``: edge_math_tables, the fused sweep) or
// solved per edge from the gathered beliefs (edge_math_gathered, the
// unfused sweep); see csrc/planes.cuh for the rounding rules. Selects are
// ternaries, never a multiply by a mask, so a NaN computed on an inactive
// or padding lane cannot reach an output of another lane.
#pragma once

#include <stdint.h>

#include "planes.cuh"
#include "table.cuh"

namespace gbp {

// Config block passed by value (ops/_cuda.py SweepParams mirrors it).
struct SweepParams {
  float fx, fy, cx, cy;       // shared pinhole intrinsics
  float eta_damping;
  float dmu_thr2;             // dmu_threshold^2
  float drift_thr2;           // relin_drift_threshold^2
  float min_depth;
  float nstds;                // Huber threshold in sigmas
  float huber_c;              // 0.5 * nstds * nstds
  float jit6, jit3;           // cavity_jitter / 6, cavity_jitter / 3
  int num_undamped_iters;
  int relin_count_threshold;
  int behind_camera_rescue_iters;
  int flags;                  // F_* bits below
};

enum : int {
  F_LAMBDA_DAMPING = 1 << 0,
  F_RESET_DAMPING = 1 << 1,      // reset_damping_on_relin && !every_iter
  F_RELIN_EVERY_ITER = 1 << 2,
  F_RELIN_BEHIND_CAMERA = 1 << 3,
  F_DRIFT = 1 << 4,              // relin_drift_threshold > 0
  F_MIN_DEPTH = 1 << 5,          // min_depth > 0
  F_HAS_INTR = 1 << 6,           // Snavely per-edge intrinsics
  F_JITTER = 1 << 7,             // cavity_jitter > 0
};

// Rows of the packed [109, E] edge state (factor_graph.EDGE_PACK_FIELDS).
enum : int {
  R_F_ETA_C = 0, R_F_ETA_L = 6, R_F_LAM_CC = 9, R_F_LAM_CL = 30,
  R_F_LAM_LL = 48, R_MSG_C_ETA = 54, R_MSG_C_LAM = 60, R_MSG_L_ETA = 81,
  R_MSG_L_LAM = 84, R_DAMPING = 90, R_MU = 91, R_LIN_MU = 100,
  PACK_ROWS = 109,
};

struct Potential {
  float eta_c[6], eta_l[3], lam_cc[21], lam_cl[18], lam_ll[6];
  bool robust;
  float z;                    // landmark depth in the camera frame
};

// Reprojection-factor relinearisation at (cam, lmk) (planes.linearise).
__device__ __forceinline__ void linearise(const SweepParams& p,
                                          const float cam[6],
                                          const float lmk[3], float meas_u,
                                          float meas_v, float meas_var,
                                          const float intr[3],
                                          Potential& out) {
  const bool has_intr = p.flags & F_HAS_INTR;
  float r[3][3], y_cf[3], u, v;
  project(cam, lmk, p.fx, p.fy, p.cx, p.cy, has_intr, intr, r, y_cf, u, v);
  float j_kf[2][6], j_lmk[2][3];
  reproj_jacobians(r, y_cf, cam, lmk, p.fx, p.fy, has_intr, intr, j_kf,
                   j_lmk);
  // residual-side vector b = J x0 + z - h(x0)
  float jx0[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    float s1 = j_kf[a][0] * cam[0];
#pragma unroll
    for (int i = 1; i < 6; ++i) s1 = s1 + j_kf[a][i] * cam[i];
    float s2 = j_lmk[a][0] * lmk[0];
#pragma unroll
    for (int i = 1; i < 3; ++i) s2 = s2 + j_lmk[a][i] * lmk[i];
    jx0[a] = s1 + s2;
  }
  const float b_u = jx0[0] + meas_u - u;
  const float b_v = jx0[1] + meas_v - v;
  // Huber variance inflation
  const float ru = meas_u - u;
  const float rv = meas_v - v;
  const float err = sqrtf(ru * ru + rv * rv);
  const float sigma = sqrtf(meas_var);
  const bool robust = err > p.nstds * sigma;
  float denom_h = 2.0f * (p.nstds * sigma * err - p.huber_c * meas_var);
  denom_h = robust ? denom_h : 1.0f;
  const float var = robust ? meas_var * err * err / denom_h : meas_var;
  const float inv_var = 1.0f / var;
#pragma unroll
  for (int i = 0; i < 6; ++i)
    out.eta_c[i] = (j_kf[0][i] * b_u + j_kf[1][i] * b_v) * inv_var;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out.eta_l[i] = (j_lmk[0][i] * b_u + j_lmk[1][i] * b_v) * inv_var;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j)
      out.lam_cc[sym_slot(i, j)] =
          (j_kf[0][i] * j_kf[0][j] + j_kf[1][i] * j_kf[1][j]) * inv_var;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j)
      out.lam_ll[sym_slot(i, j)] =
          (j_lmk[0][i] * j_lmk[0][j] + j_lmk[1][i] * j_lmk[1][j]) * inv_var;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out.lam_cl[i * 3 + j] =
          (j_kf[0][i] * j_lmk[0][j] + j_kf[1][i] * j_lmk[1][j]) * inv_var;
  out.robust = robust;
  out.z = y_cf[2];
}

// The accessor for one edge's column of the packed [109, E] state, the
// column staged in a tile [rows][T] (shared memory on the card).
// edge_math reads a row's old value with ld(row) and writes its new one
// with st(row, x); st_keep marks the factor rows whose new values the
// message phase uses again, and held(row) gives such a value back. Old
// values come from the tile; new values go straight to the global state;
// st_keep also writes the new value over the old one in the tile, and
// held() reads it back from there, so the 54 factor values need no
// registers between the factor update and the messages. Every row's old
// value is read before st_keep overwrites it (edge_math's order).
struct TileColumn {
  float* tile;                // &tile[0][t]
  int tile_stride;            // T
  float* base;                // &pk[0][e]
  long long stride;           // E
  __device__ __forceinline__ float ld(int row) const {
    return tile[row * tile_stride];
  }
  __device__ __forceinline__ void st(int row, float x) const {
    base[row * stride] = x;
  }
  __device__ __forceinline__ void st_keep(int row, float x) const {
    tile[row * tile_stride] = x;
    base[row * stride] = x;
  }
  __device__ __forceinline__ float held(int row) const {
    return tile[row * tile_stride];
  }
};

// One edge of the sweep, in place. ``bc`` holds the edge's camera belief
// (eta 6 | packed Lambda 21), ``bl`` its landmark belief (eta 3 | Lambda
// 6), ``mu`` the adjacent means (camera 6 | landmark 3). ``valid`` is the
// tables' flag (H1: both means finite, else zeroed); the unfused sweep (H4)
// solves its means per edge and passes true, as the JAX edge_math without
// premu tests finiteness of the mean step only. Every old value of a row is
// read before the row is written; each thread touches only its own edge.
__device__ __forceinline__ void edge_math(const SweepParams& p,
                                          const TileColumn& pk, int& dc,
                                          uint8_t& rb, bool active,
                                          const float bc[CAM_COMP],
                                          const float bl[LMK_COMP],
                                          const float mu[9], bool valid,
                                          float meas_u, float meas_v,
                                          float meas_var,
                                          const float intr[3]) {
  // --- prep: damping state machine ---
  const int dc0 = dc;
  float damping = (active && dc0 == 0) ? p.eta_damping : pk.ld(R_DAMPING);
  int damping_count = dc0 + (active ? 1 : 0);

  // relinearisation candidates at the current belief means
  Potential pot;
  linearise(p, mu, mu + 6, meas_u, meas_v, meas_var, intr, pot);

  float mu0[9], d2;
#pragma unroll
  for (int i = 0; i < 9; ++i) mu0[i] = pk.ld(R_MU + i);
  {
    float d = mu[0] - mu0[0];
    d2 = d * d;
#pragma unroll
    for (int i = 1; i < 9; ++i) {
      d = mu[i] - mu0[i];
      d2 = d2 + d * d;
    }
  }
  const bool mu_ok = valid && isfinite(d2);
  const bool count_ok = damping_count > p.relin_count_threshold;
  bool relin;
  float lin_mu[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) lin_mu[i] = pk.ld(R_LIN_MU + i);
  if (p.flags & F_RELIN_EVERY_ITER) {
    relin = active && mu_ok;
  } else {
    relin = active && mu_ok && (d2 < p.dmu_thr2) && count_ok;
    if (p.flags & F_DRIFT) {
      float d = mu[0] - lin_mu[0];
      float drift2 = d * d;
#pragma unroll
      for (int i = 1; i < 9; ++i) {
        d = mu[i] - lin_mu[i];
        drift2 = drift2 + d * d;
      }
      relin = relin || (active && mu_ok && (drift2 > p.drift_thr2)
                        && count_ok);
    }
  }
  if (p.flags & F_MIN_DEPTH) {
    if (p.flags & F_RELIN_BEHIND_CAMERA) {
      relin = relin && (fabsf(pot.z) > p.min_depth);
    } else {
      bool ok_depth = pot.z > p.min_depth;
      if (p.behind_camera_rescue_iters > 0) {
        const bool settled = damping_count > p.behind_camera_rescue_iters;
        ok_depth = ok_depth || (settled && fabsf(pot.z) > p.min_depth);
      }
      relin = relin && ok_depth;
    }
  }

  // adopt the new potentials where relinearised: the new factor values go
  // to the state and are parked in the tile (st_keep), and the message
  // phase reads them back from there (held)
#pragma unroll
  for (int i = 0; i < 6; ++i)
    pk.st_keep(R_F_ETA_C + i, relin ? pot.eta_c[i] : pk.ld(R_F_ETA_C + i));
#pragma unroll
  for (int i = 0; i < 3; ++i)
    pk.st_keep(R_F_ETA_L + i, relin ? pot.eta_l[i] : pk.ld(R_F_ETA_L + i));
#pragma unroll
  for (int s = 0; s < 21; ++s)
    pk.st_keep(R_F_LAM_CC + s,
               relin ? pot.lam_cc[s] : pk.ld(R_F_LAM_CC + s));
#pragma unroll
  for (int s = 0; s < 18; ++s)
    pk.st_keep(R_F_LAM_CL + s,
               relin ? pot.lam_cl[s] : pk.ld(R_F_LAM_CL + s));
#pragma unroll
  for (int s = 0; s < 6; ++s)
    pk.st_keep(R_F_LAM_LL + s,
               relin ? pot.lam_ll[s] : pk.ld(R_F_LAM_LL + s));
  auto fec = [&](int i) { return pk.held(R_F_ETA_C + i); };
  auto fel = [&](int i) { return pk.held(R_F_ETA_L + i); };
  auto fcc = [&](int i, int j) {
    return pk.held(R_F_LAM_CC + sym_slot(i, j));
  };
  auto fcl = [&](int i, int j) { return pk.held(R_F_LAM_CL + i * 3 + j); };
  auto fll = [&](int i, int j) {
    return pk.held(R_F_LAM_LL + sym_slot(i, j));
  };
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    pk.st(R_LIN_MU + i, relin ? mu[i] : lin_mu[i]);
    pk.st(R_MU + i, (active && mu_ok) ? mu[i] : mu0[i]);
  }
  rb = relin ? (uint8_t)pot.robust : rb;
  if (p.flags & F_RESET_DAMPING) damping = relin ? 0.0f : damping;
  if (!(p.flags & F_RELIN_EVERY_ITER))
    damping_count = relin ? -p.num_undamped_iters : damping_count;
  dc = damping_count;
  pk.st(R_DAMPING, damping);

  const bool lambda_damping = p.flags & F_LAMBDA_DAMPING;
  const bool jitter = p.flags & F_JITTER;
  const float keep = 1.0f - damping;

  // Old messages are read before they are overwritten: the landmark-side
  // cavity (old landmark messages) is inverted first, then the landmark
  // messages (which read the old camera messages) are written, then the
  // camera messages.

  // --- to keyframe, part 1: the landmark-side cavity (3x3 adjugate) ---
  float inv_ll[3][3], eta_l_cav[3];
  bool ok_ll;
  {
    float cav[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        const int s = sym_slot(i, j);
        cav[i][j] = fll(i, j) + bl[3 + s] - pk.ld(R_MSG_L_LAM + s);
        cav[j][i] = cav[i][j];
      }
    if (jitter) add_rel_jitter<3>(cav, p.jit3);
    ok_ll = inv_sym3_posdef(cav, inv_ll);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      eta_l_cav[i] = fel(i) + bl[i] - pk.ld(R_MSG_L_ETA + i);
  }

  // --- to landmark: marginalise the keyframe out (6x6 Cholesky) ---
  {
    float cav[6][6];
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        const int s = sym_slot(i, j);
        cav[i][j] = fcc(i, j) + bc[6 + s] - pk.ld(R_MSG_C_LAM + s);
        cav[j][i] = cav[i][j];
      }
    if (jitter) add_rel_jitter<6>(cav, p.jit6);
    float l[6][6], min_pivot;
    cholesky_with_pivot<6>(cav, l, min_pivot);
    const bool ok_cc = min_pivot > 0.0f;
    float eta_c_cav[6], y_sol[6];
#pragma unroll
    for (int i = 0; i < 6; ++i)
      eta_c_cav[i] = fec(i) + bc[i] - pk.ld(R_MSG_C_ETA + i);
    chol_solve<6>(l, eta_c_cav, y_sol);
    float x_cols[3][6];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float col[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) col[i] = fcl(i, a);
      chol_solve<6>(l, col, x_cols[a]);
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float acc = fcl(0, a) * y_sol[0];
#pragma unroll
      for (int i = 1; i < 6; ++i) acc = acc + fcl(i, a) * y_sol[i];
      const float m = fel(a) - acc;
      const float old = pk.ld(R_MSG_L_ETA + a);
      float out = keep * m + damping * old;
      out = ok_cc ? out : old;
      pk.st(R_MSG_L_ETA + a, active ? out : 0.0f);
    }
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b <= a; ++b) {
        const int s = sym_slot(a, b);
        float acc = fcl(0, a) * x_cols[b][0];
#pragma unroll
        for (int i = 1; i < 6; ++i) acc = acc + fcl(i, a) * x_cols[b][i];
        const float m = fll(a, b) - acc;
        const float old = pk.ld(R_MSG_L_LAM + s);
        float out = lambda_damping ? keep * m + damping * old : m;
        out = ok_cc ? out : old;
        pk.st(R_MSG_L_LAM + s, active ? out : 0.0f);
      }
  }

  // --- to keyframe, part 2: the camera messages ---
  {
    float w_cl[6][3];
    {
      float f[6][3];
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) f[i][j] = fcl(i, j);
      matmul<6, 3, 3>(f, inv_ll, w_cl);
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float m = fec(i) - (w_cl[i][0] * eta_l_cav[0]
                                    + w_cl[i][1] * eta_l_cav[1]
                                    + w_cl[i][2] * eta_l_cav[2]);
      const float old = pk.ld(R_MSG_C_ETA + i);
      float out = keep * m + damping * old;
      out = ok_ll ? out : old;
      pk.st(R_MSG_C_ETA + i, active ? out : 0.0f);
    }
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        const int s = sym_slot(i, j);
        const float m = fcc(i, j) - (w_cl[i][0] * fcl(j, 0)
                                     + w_cl[i][1] * fcl(j, 1)
                                     + w_cl[i][2] * fcl(j, 2));
        const float old = pk.ld(R_MSG_C_LAM + s);
        float out = lambda_damping ? keep * m + damping * old : m;
        out = ok_ll ? out : old;
        pk.st(R_MSG_C_LAM + s, active ? out : 0.0f);
      }
  }
}

// One edge of the fused sweep (H1): ``bc`` / ``bl`` are the edge's rows of
// the belief tables, which carry the means solved once per variable.
__device__ __forceinline__ void edge_math_tables(
    const SweepParams& p, const TileColumn& pk, int& dc, uint8_t& rb,
    bool active, const float bc[CAM_WIDTH], const float bl[LMK_WIDTH],
    float meas_u, float meas_v, float meas_var, const float intr[3]) {
  float mu[9];
#pragma unroll
  for (int i = 0; i < 6; ++i) mu[i] = bc[CAM_MU + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) mu[6 + i] = bl[LMK_MU + i];
  const bool valid = bc[CAM_VALID] * bl[LMK_VALID] > 0.5f;
  edge_math(p, pk, dc, rb, active, bc, bl, mu, valid, meas_u, meas_v,
            meas_var, intr);
}

// One edge of the unfused sweep (H4): ``bc`` / ``bl`` are the edge's
// gathered beliefs (eta | packed Lambda). The means are solved here, per
// edge, by the same belief_mean as the table build; the solve's
// temporaries end before edge_math starts.
__device__ __forceinline__ void edge_math_gathered(
    const SweepParams& p, const TileColumn& pk, int& dc, uint8_t& rb,
    bool active, const float bc[CAM_COMP], const float bl[LMK_COMP],
    float meas_u, float meas_v, float meas_var, const float intr[3]) {
  float mu[9];
  belief_mean<6>(bc, bc + 6, mu);
  belief_mean<3>(bl, bl + 3, mu + 6);
  edge_math(p, pk, dc, rb, active, bc, bl, mu, true, meas_u, meas_v,
            meas_var, intr);
}

}  // namespace gbp
