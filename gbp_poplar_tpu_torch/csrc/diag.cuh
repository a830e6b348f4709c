// The per-sweep telemetry (H6): one edge's reprojection residual and flags
// (diag_edge), a thread's edges and a block's sum tree (pass 1), and the
// sum of the blocks' partials in block order (pass 2), as plain functions
// on scalars with no device intrinsics, so that the host build of
// tests/test_torch_kernel_math.py runs the same bodies.
//
// The five sums are the JAX package's reprojection_error + diagnostics
// (core/gbp.py) and ops/diag_kernel.edge_sums_reference's: the number of
// valid edges, the sum of their residual norms, the cost 0.5 sum norm^2,
// the active edges that just relinearised (damping_count ==
// -num_undamped_iters) and the active edges with the Huber weight on.
// Every sum runs in one fixed order: a thread's edges in ascending order,
// the block's threads by a fixed tree, the blocks in ascending order. All
// five accumulate in float64: the counts are exact integers, the float
// sums lose nothing to their float32 terms.
#pragma once

#include <stdint.h>

#include "planes.cuh"
#include "table.cuh"

namespace gbp {

enum : int {
  DIAG_N_ACTIVE = 0, DIAG_SUM_NORM = 1, DIAG_COST = 2, DIAG_N_RELINS = 3,
  DIAG_N_ROBUST = 4, DIAG_SUMS = 5,
};

// Pass 1: blocks of DIAG_THREADS threads; block b owns edges [b * B, (b +
// 1) * B) for B = DIAG_BLOCK_EDGES, thread t the edges t, t + DIAG_THREADS,
// ... of them (coalesced across the block).
constexpr int DIAG_THREADS = 256;
constexpr int DIAG_BLOCK_EDGES = 8 * DIAG_THREADS;

__host__ __device__ constexpr long long diag_blocks(long long n_edges) {
  return (n_edges + DIAG_BLOCK_EDGES - 1) / DIAG_BLOCK_EDGES;
}

// The kernel's operands (ops/diag_kernel.py DiagArgs mirrors it). The
// tables are H2's (table.cuh): a row's mean and validity flag; the edge
// fields are [E] (meas [2, E], intr [3, E] or null; bad null or [E]).
struct DiagArgs {
  const float* cam_tbl;
  const float* lmk_tbl;
  const int* cam_idx;
  const int* lmk_idx;
  const float* meas;
  const float* intr;
  const int* active;
  const int* damping_count;
  const uint8_t* robust;
  const uint8_t* bad;
  long long n_edges;
  float fx, fy, cx, cy;      // pinhole intrinsics (without intr)
  int num_undamped_iters;
};

// Edge e's terms added to ``acc``. Valid: active, both table rows valid
// (their means finite: the table zeroes a non-finite mean and clears the
// flag, where the plain version's unsanitised mean makes the norm
// non-finite), the norm finite, and not marked bad.
__device__ __forceinline__ void diag_edge(const DiagArgs& a, long long e,
                                          double acc[DIAG_SUMS]) {
  const bool act = a.active[e] > 0;
  const float* cam = a.cam_tbl + (long long)a.cam_idx[e] * CAM_WIDTH;
  const float* lmk = a.lmk_tbl + (long long)a.lmk_idx[e] * LMK_WIDTH;
  float in[3] = {0.0f, 0.0f, 0.0f};
  if (a.intr)
    for (int i = 0; i < 3; ++i) in[i] = a.intr[i * a.n_edges + e];
  float r[3][3], y_cf[3], u, v;
  project(cam + CAM_MU, lmk + LMK_MU, a.fx, a.fy, a.cx, a.cy,
          a.intr != nullptr, in, r, y_cf, u, v);
  const float ru = a.meas[e] - u;
  const float rv = a.meas[a.n_edges + e] - v;
  const float norm = sqrtf(ru * ru + rv * rv);
  const bool valid = act && cam[CAM_VALID] > 0.5f && lmk[LMK_VALID] > 0.5f
                     && isfinite(norm) && !(a.bad && a.bad[e]);
  if (valid) {
    acc[DIAG_N_ACTIVE] = acc[DIAG_N_ACTIVE] + 1.0;
    acc[DIAG_SUM_NORM] = acc[DIAG_SUM_NORM] + (double)norm;
    acc[DIAG_COST] = acc[DIAG_COST] + (double)(norm * norm);
  }
  if (act && a.damping_count[e] == -a.num_undamped_iters)
    acc[DIAG_N_RELINS] = acc[DIAG_N_RELINS] + 1.0;
  if (act && a.robust[e])
    acc[DIAG_N_ROBUST] = acc[DIAG_N_ROBUST] + 1.0;
}

// Pass 1, thread t of block b: its edges in ascending order.
__device__ __forceinline__ void diag_thread_edges(const DiagArgs& a,
                                                  long long b, int t,
                                                  double acc[DIAG_SUMS]) {
  for (int k = 0; k < DIAG_SUMS; ++k) acc[k] = 0.0;
  const long long begin = b * DIAG_BLOCK_EDGES;
  const long long end = begin + DIAG_BLOCK_EDGES < a.n_edges
                            ? begin + DIAG_BLOCK_EDGES : a.n_edges;
  for (long long e = begin + t; e < end; e += DIAG_THREADS)
    diag_edge(a, e, acc);
}

// Pass 2, thread t: the partials of blocks t, t + DIAG_THREADS, ... in
// ascending order (``partial`` is [DIAG_SUMS][n_blocks]).
__device__ __forceinline__ void diag_thread_partials(const double* partial,
                                                     long long n_blocks,
                                                     int t,
                                                     double acc[DIAG_SUMS]) {
  for (int k = 0; k < DIAG_SUMS; ++k) {
    double s = 0.0;
    for (long long b = t; b < n_blocks; b += DIAG_THREADS)
      s = s + partial[k * n_blocks + b];
    acc[k] = s;
  }
}

// One level of a block's sum tree over ``sums`` [DIAG_SUMS][DIAG_THREADS]
// (thread t's values in column t): thread t < h adds column t + h to its
// own. Levels h = DIAG_THREADS / 2, ..., 1 leave the block's sums in
// column 0; each level's adds are independent, so the order is fixed.
__device__ __forceinline__ void diag_tree_level(double* sums, int h, int t) {
  for (int k = 0; k < DIAG_SUMS; ++k)
    sums[k * DIAG_THREADS + t] =
        sums[k * DIAG_THREADS + t] + sums[k * DIAG_THREADS + t + h];
}

// The result from the sums of all edges (column 0 after pass 2's tree):
// the cost is half the sum of squared norms.
__device__ __forceinline__ void diag_finish(const double* sums,
                                            double out[DIAG_SUMS]) {
  for (int k = 0; k < DIAG_SUMS; ++k) out[k] = sums[k * DIAG_THREADS];
  out[DIAG_COST] = 0.5 * out[DIAG_COST];
}

}  // namespace gbp
