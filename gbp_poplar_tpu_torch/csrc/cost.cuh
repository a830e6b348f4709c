// The robust data term of the MAP cost at up to COST_MAX_SETS sets of
// variable means (H8): one edge's Huber losses (cost_edge), a thread's
// edges (cost_thread_edges) and the result (cost_finish), as plain
// functions on scalars with no device intrinsics, so that the host build
// of tests/test_torch_chunk_kernels.py runs the same bodies. The partition
// (diag_blocks: 4 edges a thread, blocks of 256), the fold of a block's
// warps and the last block's walk over the partials are H6's (diag.cuh);
// the shuffles and the ticket are block_sums.cuh's.
//
// Per edge and set k: the camera mean [6] and landmark mean [3] of set k
// read by the edge's ids from the set's own planes (no stacked gather),
// the projection (planes.cuh project), the residual whitened by the
// measurement variance and its Huber loss, exactly as the JAX package's
// core/gbp.py::_cost_parts and ops/cost_kernel.cost_sums_reference do:
//   err2 = (ru^2 + rv^2) / var, err = sqrt(err2),
//   loss = k err - k^2 / 2 where err > k, else err2 / 2.
// An edge adds its loss to sum k when it is active, not marked bad and the
// loss is finite. Each sum runs in float64 in one fixed order (a thread's
// edges in ascending order, the lane tree, the warps in order, the blocks'
// partials in block order), so it is the same from run to run and equal
// sets give equal sums; the result is rounded once to float32.
#pragma once

#include <stdint.h>

#include "diag.cuh"
#include "planes.cuh"

namespace gbp {

constexpr int COST_MAX_SETS = 3;

// The kernel's operands (ops/cost_kernel.py CostArgs mirrors it): set k's
// means as planes cam[k] [6, n_cams] and lmk[k] [3, n_lmks] (null past
// n_sets); the edge fields [n_edges] (meas [2, n_edges], intr [3,
// n_edges] or null, bad null or [n_edges]).
struct CostArgs {
  const float* cam[COST_MAX_SETS];
  const float* lmk[COST_MAX_SETS];
  const int* cam_idx;
  const int* lmk_idx;
  const float* meas;
  const float* meas_var;
  const float* intr;
  const int* active;
  const uint8_t* bad;
  long long n_edges, n_cams, n_lmks;
  float fx, fy, cx, cy;      // pinhole intrinsics (without intr)
  float nstds;               // Huber threshold in sigmas
  float huber_c;             // 0.5 * nstds * nstds, rounded once
  int n_sets;
};

// Edge e's losses added to ``acc`` (one per set), its ids ``ci``, ``li``
// already read; nothing when not ``live`` (a lane past the last edge,
// which reads edge n_edges - 1 so that every load stays unconditional).
__device__ __forceinline__ void cost_edge(const CostArgs& a, long long e,
                                          int ci, int li, bool live,
                                          double acc[COST_MAX_SETS]) {
  const int active = a.active[e];
  const bool bad = a.bad && a.bad[e];
  const float mu = a.meas[e], mv = a.meas[a.n_edges + e];
  const float var = a.meas_var[e];
  const bool has_intr = a.intr != nullptr;
  float in[3] = {0.0f, 0.0f, 0.0f};
  if (has_intr)
    for (int i = 0; i < 3; ++i) in[i] = a.intr[i * a.n_edges + e];
  const bool counted = live && active > 0 && !bad;
#pragma unroll
  for (int k = 0; k < COST_MAX_SETS; ++k) {
    if (k >= a.n_sets) break;
    float cam[6], lmk[3];
    for (int i = 0; i < 6; ++i) cam[i] = a.cam[k][i * a.n_cams + ci];
    for (int i = 0; i < 3; ++i) lmk[i] = a.lmk[k][i * a.n_lmks + li];
    float r[3][3], y_cf[3], u, v;
    project(cam, lmk, a.fx, a.fy, a.cx, a.cy, has_intr, in, r, y_cf, u, v);
    const float ru = mu - u;
    const float rv = mv - v;
    const float err2 = (ru * ru + rv * rv) / var;
    const float err = sqrtf(err2);
    const float loss = err > a.nstds ? a.nstds * err - a.huber_c
                                     : 0.5f * err2;
    if (counted && isfinite(loss)) acc[k] = acc[k] + (double)loss;
  }
}

// Thread t of block b: its edges' losses in ascending order (diag.cuh's
// partition), the ids of all its edges read first.
__device__ __forceinline__ void cost_thread_edges(const CostArgs& a,
                                                  long long b, int t,
                                                  double acc[COST_MAX_SETS]) {
  for (int k = 0; k < COST_MAX_SETS; ++k) acc[k] = 0.0;
  if (a.n_edges == 0) return;
  long long e[DIAG_EDGES_PER_THREAD];
  bool live[DIAG_EDGES_PER_THREAD];
  int ci[DIAG_EDGES_PER_THREAD], li[DIAG_EDGES_PER_THREAD];
#pragma unroll
  for (int k = 0; k < DIAG_EDGES_PER_THREAD; ++k) {
    const long long x = b * DIAG_BLOCK_EDGES + t
                        + (long long)k * DIAG_THREADS;
    live[k] = x < a.n_edges;
    e[k] = live[k] ? x : a.n_edges - 1;
    ci[k] = a.cam_idx[e[k]];
    li[k] = a.lmk_idx[e[k]];
  }
#pragma unroll
  for (int k = 0; k < DIAG_EDGES_PER_THREAD; ++k)
    cost_edge(a, e[k], ci[k], li[k], live[k], acc);
}

// The n_sets results from the sums over all edges, rounded to float32.
__device__ __forceinline__ void cost_finish(const double acc[COST_MAX_SETS],
                                            int n_sets, float* out) {
  for (int k = 0; k < n_sets; ++k) out[k] = (float)acc[k];
}

}  // namespace gbp
