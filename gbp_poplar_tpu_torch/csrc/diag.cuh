// The per-sweep telemetry (H6): one edge's reprojection residual and flags
// (diag_edge), a thread's edges (diag_thread_edges), the fold of a block's
// warps (fold_warps), the last block's walk over the partials
// (thread_partials) and the result (diag_finish), as plain functions
// on scalars with no device intrinsics, so that the host build of
// tests/test_torch_kernel_math.py runs the same bodies. The warp shuffles
// and the ticket that picks the last block are csrc/diag.cu's; the test
// mirrors them.
//
// The five sums are the JAX package's reprojection_error + diagnostics
// (core/gbp.py) and ops/diag_kernel.edge_sums_reference's: the number of
// valid edges, the sum of their residual norms, the cost 0.5 sum norm^2,
// the active edges that just relinearised (damping_count ==
// -num_undamped_iters) and the active edges with the Huber weight on.
// Every sum runs in one fixed order, whatever order the blocks finish in:
// a thread's edges in ascending order; a warp's lanes by a fixed tree (lane
// l adds lane l + h for h = 16, 8, 4, 2, 1); a block's warps in ascending
// order; the blocks' partials, thread t of the last block taking blocks t,
// t + DIAG_THREADS, ... in ascending order, then the same lane tree and
// warp fold. All five accumulate in float64: the counts are exact
// integers, the float sums lose nothing to their float32 terms.
#pragma once

#include <stdint.h>

#include "planes.cuh"
#include "table.cuh"

namespace gbp {

enum : int {
  DIAG_N_ACTIVE = 0, DIAG_SUM_NORM = 1, DIAG_COST = 2, DIAG_N_RELINS = 3,
  DIAG_N_ROBUST = 4, DIAG_SUMS = 5,
};

// The partition, a function of n_edges alone: blocks of DIAG_THREADS
// threads; block b owns edges [b * B, (b + 1) * B) for B =
// DIAG_BLOCK_EDGES, thread t the edges t, t + DIAG_THREADS, ... of them
// (coalesced across the block). Four edges a thread: 1,067 blocks of 256
// threads at the Ladybug shape (1,092,608 edges), 273,152 threads for the
// H100's 132 x 2,048 thread slots.
constexpr int DIAG_THREADS = 256;
constexpr int DIAG_WARPS = DIAG_THREADS / 32;
constexpr int DIAG_EDGES_PER_THREAD = 4;
constexpr int DIAG_BLOCK_EDGES = DIAG_EDGES_PER_THREAD * DIAG_THREADS;

// Blocks of the grid: one per DIAG_BLOCK_EDGES edges, and one block (with
// no edges, so it writes zeros) when there are none.
__host__ __device__ constexpr long long diag_blocks(long long n_edges) {
  return n_edges > 0 ? (n_edges + DIAG_BLOCK_EDGES - 1) / DIAG_BLOCK_EDGES
                     : 1;
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

// The rotation R(w) of camera ``ci``'s mean (planes.cuh so3_exp), for each
// edge of a thread (``get(a, k, ci, r)`` for its k-th edge, after
// ``prepare(a, ci)`` with all its edges' cameras): computed per edge here;
// the kernel's warps compute each distinct camera's once and share it
// (diag.cu), the same so3_exp on the same mean, so the same bits.
struct PerEdgeRotations {
  __device__ __forceinline__ void prepare(const DiagArgs&, const int*) {}
  __device__ __forceinline__ void get(const DiagArgs& a, int, int ci,
                                      float r[3][3]) const {
    so3_exp(a.cam_tbl + (long long)ci * CAM_WIDTH + CAM_MU + 3, r);
  }
};

// Edge e's terms added to ``acc``, its camera and landmark ids ``ci``,
// ``li`` and its camera's rotation ``r`` already read; nothing when not
// ``live`` (a lane past the last
// edge, which reads edge e = n_edges - 1 so that every load stays
// unconditional). Valid: active, both table rows valid (their means
// finite: the table zeroes a non-finite mean and clears the flag, where
// the plain version's unsanitised mean makes the norm non-finite), the
// norm finite, and not marked bad.
__device__ __forceinline__ void diag_edge(const DiagArgs& a, long long e,
                                          int ci, int li,
                                          const float r[3][3], bool live,
                                          double acc[DIAG_SUMS]) {
  // every load first, none behind a condition on another
  const int active = a.active[e], count = a.damping_count[e];
  const bool robust = a.robust[e] != 0, bad = a.bad && a.bad[e];
  const float mu = a.meas[e], mv = a.meas[a.n_edges + e];
  const float* cam = a.cam_tbl + (long long)ci * CAM_WIDTH;
  const float* lmk = a.lmk_tbl + (long long)li * LMK_WIDTH;
  const bool cam_ok = cam[CAM_VALID] > 0.5f, lmk_ok = lmk[LMK_VALID] > 0.5f;
  float in[3] = {0.0f, 0.0f, 0.0f};
  if (a.intr)
    for (int i = 0; i < 3; ++i) in[i] = a.intr[i * a.n_edges + e];
  float y_cf[3], u, v;
  project_rotated(r, cam + CAM_MU, lmk + LMK_MU, a.fx, a.fy, a.cx, a.cy,
                  a.intr != nullptr, in, y_cf, u, v);
  const float ru = mu - u;
  const float rv = mv - v;
  const float norm = sqrtf(ru * ru + rv * rv);
  const bool act = live && active > 0;
  if (act && cam_ok && lmk_ok && isfinite(norm) && !bad) {
    acc[DIAG_N_ACTIVE] = acc[DIAG_N_ACTIVE] + 1.0;
    acc[DIAG_SUM_NORM] = acc[DIAG_SUM_NORM] + (double)norm;
    acc[DIAG_COST] = acc[DIAG_COST] + (double)(norm * norm);
  }
  if (act && count == -a.num_undamped_iters)
    acc[DIAG_N_RELINS] = acc[DIAG_N_RELINS] + 1.0;
  if (act && robust)
    acc[DIAG_N_ROBUST] = acc[DIAG_N_ROBUST] + 1.0;
}

// Thread t of block b: its edges' terms in ascending order. The ids of all
// its edges are read first, so that the table-row gathers that depend on
// them are in flight together; ``rot`` gives their cameras' rotations.
template <class Rot = PerEdgeRotations>
__device__ __forceinline__ void diag_thread_edges(const DiagArgs& a,
                                                  long long b, int t,
                                                  double acc[DIAG_SUMS],
                                                  Rot rot = Rot()) {
  for (int k = 0; k < DIAG_SUMS; ++k) acc[k] = 0.0;
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
  rot.prepare(a, ci);
#pragma unroll
  for (int k = 0; k < DIAG_EDGES_PER_THREAD; ++k) {
    float r[3][3];
    rot.get(a, k, ci[k], r);
    diag_edge(a, e[k], ci[k], li[k], r, live[k], acc);
  }
}

// A block's N sums from its warps' (``warp`` [DIAG_WARPS][N], each its
// lane tree's lane 0), added in ascending warp order. H6 and the cost sums
// (cost.cuh, H8) fold their blocks here.
template <int N>
__device__ __forceinline__ void fold_warps(const double (*warp)[N],
                                           double acc[N]) {
  for (int k = 0; k < N; ++k) {
    double s = warp[0][k];
    for (int w = 1; w < DIAG_WARPS; ++w) s = s + warp[w][k];
    acc[k] = s;
  }
}

// The last block's thread t: the partials of blocks t, t + DIAG_THREADS,
// ... in ascending order (``partial`` is [N][n_blocks]; P reads past the
// SM's cache on the card).
template <int N, class P>
__device__ __forceinline__ void thread_partials(P partial, long long n_blocks,
                                                int t, double acc[N]) {
  for (int k = 0; k < N; ++k) acc[k] = 0.0;
  for (long long b = t; b < n_blocks; b += DIAG_THREADS)
    for (int k = 0; k < N; ++k)
      acc[k] = acc[k] + partial[k * n_blocks + b];
}

// The result from the sums over all edges: the cost is half the sum of
// squared norms.
__device__ __forceinline__ void diag_finish(const double acc[DIAG_SUMS],
                                            double out[DIAG_SUMS]) {
  for (int k = 0; k < DIAG_SUMS; ++k) out[k] = acc[k];
  out[DIAG_COST] = 0.5 * out[DIAG_COST];
}

}  // namespace gbp
