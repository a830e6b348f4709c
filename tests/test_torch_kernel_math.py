"""The CUDA kernels' per-edge and per-variable bodies, compiled for the host.

csrc/edge_math.cuh and csrc/planes.cuh hold the whole per-edge body of the
fused sweep kernel (H1, ``edge_math_tables``) and of the unfused one (H4,
``edge_math_gathered``), both through the shared-memory tile accessor
``TileColumn``; csrc/table.cuh the per-variable row of the table build
(H2), csrc/gather.cuh that of the gather (H5), csrc/reduce.cuh the run sum
and chunk combine of H3's two-pass sum, csrc/diag.cuh the per-edge terms
and the one launch of the telemetry sums (H6), as plain ``__device__``
functions on scalars. With a
small header that defines the few CUDA names they use, g++ compiles them
for the CPU; these tests run each body edge by edge (the loop the kernel's
threads run in parallel) against the plain PyTorch version on the same
state. They check the kernels' arithmetic, row offsets and read-before-
write order without a card. The host's sinf/cosf and PyTorch's CPU sqrt
round differently from each other (on the card the two agree bit for
bit), so float fields are held to 1e-4 of each field's magnitude and
every discrete output must be equal.
"""

import ctypes
import dataclasses
import functools
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gbp_poplar_tpu_torch.config import GBPConfig
from gbp_poplar_tpu_torch.core import factor_graph as fg
from gbp_poplar_tpu_torch.core import gbp, slam
from gbp_poplar_tpu_torch.ops import (_cuda, diag_kernel, planes,
                                      reduce_kernel, sweep_kernel,
                                      table_kernel)
from gbp_poplar_tpu_torch.utils import balio, flags

torch.set_num_threads(1)

RTOL = 1e-4

_SHIM = r"""
#pragma once
#include <cmath>
#include <cstddef>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
typedef void* cudaStream_t;
using std::isfinite;
using std::isnan;
"""

_HOST = r"""
#include <algorithm>
#include <vector>
#include "cuda_runtime.h"
#include "diag.cuh"
#include "edge_math.cuh"
#include "gather.cuh"
#include "reduce.cuh"
#include "table.cuh"
using namespace gbp;
// The sweep kernels' tile path: each tile's T columns of the packed state
// copied into a tile buffer [109][T] (the kernels' shared-memory stage),
// the body run on each column through TileColumn (old values from the
// tile, new values to the state, the factor rows parked in the tile), the
// edges of a partial last tile included. ``body(e, col, count, robust,
// in)`` runs one edge: H1's on its table rows (host_sweep_tiled), H4's on
// its gathered beliefs (host_sweep_planes_tiled). T = n makes the whole
// state one tile: the in-place path.
template <class Body>
void walk(const SweepParams* p, float* pk, int* dc, uint8_t* rb,
          const float* intr, int n, int T, Body body) {
  std::vector<float> tile((size_t)PACK_ROWS * T);
  for (int e0 = 0; e0 < n; e0 += T) {
    const int m = std::min(T, n - e0);
    for (int r = 0; r < PACK_ROWS; ++r)
      for (int t = 0; t < m; ++t)
        tile[(size_t)r * T + t] = pk[(size_t)r * n + e0 + t];
    for (int t = 0; t < m; ++t) {
      const int e = e0 + t;
      float in[3] = {0.f, 0.f, 0.f};
      if (p->flags & F_HAS_INTR)
        for (int i = 0; i < 3; ++i) in[i] = intr[i * n + e];
      const TileColumn col{tile.data() + t, T, pk + e, (long long)n};
      int count = dc[e];
      uint8_t robust = rb[e];
      body(e, col, count, robust, in);
      dc[e] = count;
      rb[e] = robust;
    }
  }
}
extern "C" void host_sweep_tiled(const SweepParams* p, float* pk, int* dc,
                                 uint8_t* rb, const int* active,
                                 const float* meas, const float* meas_var,
                                 const float* intr, const int* cam_idx,
                                 const int* lmk_idx, const float* cam_tbl,
                                 const float* lmk_tbl, int n, int T) {
  walk(p, pk, dc, rb, intr, n, T, [&](int e, const TileColumn& col,
                                      int& count, uint8_t& robust,
                                      const float* in) {
    float bc[CAM_WIDTH], bl[LMK_WIDTH];
    for (int i = 0; i < CAM_WIDTH; ++i)
      bc[i] = cam_tbl[(size_t)cam_idx[e] * CAM_WIDTH + i];
    for (int i = 0; i < LMK_WIDTH; ++i)
      bl[i] = lmk_tbl[(size_t)lmk_idx[e] * LMK_WIDTH + i];
    edge_math_tables(*p, col, count, robust, active[e] > 0, bc, bl, meas[e],
                     meas[n + e], meas_var[e], in);
  });
}
extern "C" void host_sweep(const SweepParams* p, float* pk, int* dc,
                           uint8_t* rb, const int* active, const float* meas,
                           const float* meas_var, const float* intr,
                           const int* cam_idx, const int* lmk_idx,
                           const float* cam_tbl, const float* lmk_tbl,
                           int n) {
  host_sweep_tiled(p, pk, dc, rb, active, meas, meas_var, intr, cam_idx,
                   lmk_idx, cam_tbl, lmk_tbl, n, n);
}
extern "C" void host_sweep_planes_tiled(const SweepParams* p, float* pk,
                                        int* dc, uint8_t* rb,
                                        const int* active, const float* meas,
                                        const float* meas_var,
                                        const float* intr, const float* bc,
                                        const float* bl, int n, int T) {
  walk(p, pk, dc, rb, intr, n, T, [&](int e, const TileColumn& col,
                                      int& count, uint8_t& robust,
                                      const float* in) {
    float b_c[CAM_COMP], b_l[LMK_COMP];
    for (int i = 0; i < CAM_COMP; ++i) b_c[i] = bc[(size_t)i * n + e];
    for (int i = 0; i < LMK_COMP; ++i) b_l[i] = bl[(size_t)i * n + e];
    edge_math_gathered(*p, col, count, robust, active[e] > 0, b_c, b_l,
                       meas[e], meas[n + e], meas_var[e], in);
  });
}
extern "C" void host_sweep_planes(const SweepParams* p, float* pk, int* dc,
                                  uint8_t* rb, const int* active,
                                  const float* meas, const float* meas_var,
                                  const float* intr, const float* bc,
                                  const float* bl, int n) {
  host_sweep_planes_tiled(p, pk, dc, rb, active, meas, meas_var, intr, bc,
                          bl, n, n);
}
// H2's per-variable body (table.cuh table_row) for every variable.
extern "C" void host_table(int d, const float* bel, long long n_var,
                           float* tbl) {
  for (long long v = 0; v < n_var; ++v) {
    if (d == 6)
      table_row<6, CAM_WIDTH>(bel, n_var, v, tbl + v * CAM_WIDTH);
    else
      table_row<3, LMK_WIDTH>(bel, n_var, v, tbl + v * LMK_WIDTH);
  }
}
// H3's two passes over a chunk plan: each (component, chunk) gathered into
// its sorted order (padded as in the kernel), its slices summed
// (slice_sum) and one partial per run built from them (chunk_run_sum),
// then each variable's run partials combined in ascending chunk order
// onto the prior (combine_runs).
extern "C" void host_reduce_chunks(const float* planes, long long stride,
                                   int comp, const int16_t* order,
                                   const int* chunk_runs,
                                   const int* run_start, const int* var_ptr,
                                   const int* var_runs, int n_var,
                                   int n_listed, int chunk, int n_chunks,
                                   int n_runs, const float* prior,
                                   float* out) {
  std::vector<float> partial((size_t)comp * n_runs);
  std::vector<float> sorted(chunk + chunk / SLICE), full(chunk / SLICE);
  for (int c = 0; c < comp; ++c)
    for (int k = 0; k < n_chunks; ++k) {
      const long long e0 = (long long)k * chunk;
      const int count = (int)std::min<long long>(chunk, n_listed - e0);
      for (int q = 0; q < count; ++q)
        sorted[pad(q)] = planes[c * stride + e0 + order[e0 + q]];
      for (int q = 0; q * SLICE < count; ++q)
        full[q] = slice_sum(sorted.data() + pad(q * SLICE),
                            std::min(SLICE, count - q * SLICE));
      const int r0 = chunk_runs[k], r1 = chunk_runs[k + 1];
      for (int r = r0; r < r1; ++r)
        partial[(size_t)c * n_runs + r] = chunk_run_sum(
            sorted.data(), full.data(), run_start[r],
            r + 1 < r1 ? run_start[r + 1] : count);
    }
  for (long long t = 0; t < (long long)comp * n_var; ++t) {
    const long long c = t / n_var, v = t % n_var;
    out[t] = combine_runs(partial.data() + c * n_runs, var_runs, var_ptr[v],
                          var_ptr[v + 1], prior ? prior + t : nullptr);
  }
}
extern "C" void host_gather(const float* src, long long n_var, int comp,
                            const int* idx, float* out, long long n) {
  for (long long e = 0; e < n; ++e)
    gather_edge(src, n_var, comp, idx[e], out, n, e);
}
// H6's one launch (csrc/diag.cu diag_sums). A block: each thread's edges
// (diag_thread_edges), each warp's lanes by the tree of the kernel's
// shuffles (lane_tree), then its warps in order (fold_warps). The
// blocks run in the completion order ``order``; each writes its partial
// and draws a ticket as atomicInc(ticket, blocks - 1) does, and the one
// that draws the last adds the partials by the same trees
// (thread_partials, diag_finish) into ``out``. Returns how many
// blocks did that.
// __shfl_down_sync hands lane l the value lane l + h held before the
// step; lanes < h here read lanes >= h before any of those is written.
static void lane_tree(double (*l)[DIAG_SUMS]) {
  for (int h = 16; h > 0; h >>= 1)
    for (int i = 0; i < h; ++i)
      for (int k = 0; k < DIAG_SUMS; ++k) l[i][k] = l[i][k] + l[i + h][k];
}
static void host_block(double (*lanes)[DIAG_SUMS], double out[DIAG_SUMS]) {
  double warp[DIAG_WARPS][DIAG_SUMS];
  for (int w = 0; w < DIAG_WARPS; ++w) {
    lane_tree(lanes + 32 * w);
    for (int k = 0; k < DIAG_SUMS; ++k) warp[w][k] = lanes[32 * w][k];
  }
  fold_warps<DIAG_SUMS>(warp, out);
}
extern "C" long long host_diag_blocks(long long n_edges) {
  return diag_blocks(n_edges);
}
extern "C" int host_diag(const DiagArgs* a, const long long* order,
                         double* partial, unsigned* ticket, double* out) {
  const long long blocks = diag_blocks(a->n_edges);
  std::vector<double> acc((size_t)DIAG_THREADS * DIAG_SUMS);
  double (*lanes)[DIAG_SUMS] = (double (*)[DIAG_SUMS])acc.data();
  double sums[DIAG_SUMS];
  int folds = 0;
  for (long long i = 0; i < blocks; ++i) {
    const long long b = order[i];
    for (int t = 0; t < DIAG_THREADS; ++t)
      diag_thread_edges(*a, b, t, lanes[t]);
    host_block(lanes, sums);
    for (int k = 0; k < DIAG_SUMS; ++k) partial[k * blocks + b] = sums[k];
    const unsigned drawn = *ticket, top = (unsigned)(blocks - 1);
    *ticket = drawn >= top ? 0u : drawn + 1;
    if (drawn != top) continue;
    ++folds;
    for (int t = 0; t < DIAG_THREADS; ++t)
      thread_partials<DIAG_SUMS>((const double*)partial, blocks, t,
                                 lanes[t]);
    host_block(lanes, sums);
    diag_finish(sums, out);
  }
  return folds;
}
// planes.cuh's project on plane inputs: cam [6, n], lmk [3, n], intr
// [3, n] or null; uv [2, n] and y_cf [3, n] out.
extern "C" void host_project(const float* cam, const float* lmk,
                             const float* pinhole, const float* intr,
                             float* uv, float* y, long long n) {
  for (long long e = 0; e < n; ++e) {
    float c[6], l[3], in[3] = {0.f, 0.f, 0.f}, r[3][3], y_cf[3], u, v;
    for (int i = 0; i < 6; ++i) c[i] = cam[i * n + e];
    for (int i = 0; i < 3; ++i) l[i] = lmk[i * n + e];
    if (intr)
      for (int i = 0; i < 3; ++i) in[i] = intr[i * n + e];
    project(c, l, pinhole[0], pinhole[1], pinhole[2], pinhole[3],
            intr != nullptr, in, r, y_cf, u, v);
    uv[e] = u;
    uv[n + e] = v;
    for (int i = 0; i < 3; ++i) y[i * n + e] = y_cf[i];
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler for the host build of the kernel math")
    d = tmp_path_factory.mktemp("kernel_math")
    (d / "cuda_runtime.h").write_text(_SHIM)
    (d / "host.cpp").write_text(_HOST)
    so = d / "libhost.so"
    subprocess.run(
        [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-Wno-unknown-pragmas",
         "-shared", "-fPIC", f"-I{d}", f"-I{_cuda.CSRC}", str(d / "host.cpp"),
         "-o", str(so)], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.host_sweep.argtypes = [p] * 12 + [i]
    lib.host_sweep_planes.argtypes = [p] * 10 + [i]
    lib.host_sweep_tiled.argtypes = [p] * 12 + [i, i]
    lib.host_sweep_planes_tiled.argtypes = [p] * 10 + [i, i]
    lib.host_table.argtypes = [i, p, ll, p]
    lib.host_gather.argtypes = [p, ll, i, p, p, ll]
    lib.host_reduce_chunks.argtypes = [p, ll, i, p, p, p, p, p, i, i, i, i,
                                       i, p, p]
    lib.host_diag.argtypes = [p] * 5
    lib.host_diag.restype = i
    lib.host_diag_blocks.argtypes = [ll]
    lib.host_diag_blocks.restype = ll
    lib.host_project.argtypes = [p, p, p, p, p, p, ll]
    for fn in (lib.host_sweep, lib.host_sweep_planes, lib.host_sweep_tiled,
               lib.host_sweep_planes_tiled, lib.host_table, lib.host_gather,
               lib.host_reduce_chunks, lib.host_project):
        fn.restype = None
    return lib


def _warm_state(name, pad=None):
    prob = {
        "pinhole": lambda: balio.synthetic_problem(
            n_keyframes=6, n_points=60, seed=0, pixel_noise=0.5),
        "snavely": lambda: balio.synthetic_problem_snavely(pixel_noise=0.5),
        "large": lambda: balio.synthetic_problem_large(
            n_keyframes=20, n_points=1000, obs_per_lmk=7, seed=2),
        "large odd": lambda: balio.synthetic_problem_large(
            n_keyframes=20, n_points=1001, obs_per_lmk=7, seed=2),
    }[name]()
    cfg = GBPConfig(accel_every=0)
    if pad is not None:
        cfg = dataclasses.replace(cfg, edge_pad_multiple=pad)
    graph = fg.build_graph(prob, cfg, "cpu")
    state = gbp.initialise(fg.init_state(prob, cfg, "cpu"), graph, cfg)
    # 17 sweeps: the compared one relinearises, with damping already on
    state, _ = gbp.run_gbp(state, graph, cfg, 17, with_diagnostics=False)
    return cfg, graph, state


def _assert_same_sweep(host, ref, state, cfg):
    assert torch.equal(host.damping_count, ref.damping_count)
    assert torch.equal(host.robust, ref.robust)
    relins = int((ref.damping_count == -cfg.num_undamped_iters).sum())
    assert relins > 0 and bool((state.damping > 0).any())
    for f, (a, b) in fg.EDGE_PACK_OFFSETS.items():
        want = ref.pk[a:b].numpy().astype(np.float64)
        got = host.pk[a:b].numpy().astype(np.float64)
        np.testing.assert_allclose(
            got, want, rtol=RTOL, atol=RTOL * max(np.abs(want).max(), 1e-30),
            err_msg=f)


@pytest.mark.parametrize("name", ["pinhole", "snavely", "large"])
def test_host_built_edge_math_matches_plain_sweep(host_lib, name):
    cfg, graph, state = _warm_state(name)
    ct, lt = table_kernel.build_tables(state.cam_bel, state.lmk_bel)
    ref, host = state.clone(), state.clone()
    sweep_kernel.sweep(ref, graph, ct, lt, cfg)
    params = sweep_kernel.sweep_params(cfg, graph.k, graph.intr is not None)
    host_lib.host_sweep(
        ctypes.addressof(params), host.pk.data_ptr(),
        host.damping_count.data_ptr(), host.robust.data_ptr(),
        host.active.data_ptr(), graph.meas.data_ptr(),
        graph.meas_var.data_ptr(), _cuda.ptr(graph.intr),
        graph.cam_idx.data_ptr(), graph.lmk_idx.data_ptr(), ct.data_ptr(),
        lt.data_ptr(), graph.n_edges)
    _assert_same_sweep(host, ref, state, cfg)


def _host_sweep(host_lib, state, graph, cfg, ct, lt, tile=None):
    params = sweep_kernel.sweep_params(cfg, graph.k, graph.intr is not None)
    args = [ctypes.addressof(params), state.pk.data_ptr(),
            state.damping_count.data_ptr(), state.robust.data_ptr(),
            state.active.data_ptr(), graph.meas.data_ptr(),
            graph.meas_var.data_ptr(), _cuda.ptr(graph.intr),
            graph.cam_idx.data_ptr(), graph.lmk_idx.data_ptr(), ct.data_ptr(),
            lt.data_ptr(), graph.n_edges]
    if tile is None:
        host_lib.host_sweep(*args)
    else:
        host_lib.host_sweep_tiled(*args, tile)


@pytest.mark.parametrize("name,pad,tile", [
    ("pinhole", None, 32), ("snavely", None, 32), ("large", None, 32),
    ("pinhole", 1, 32), ("snavely", 1, 7), ("large", 1, 32)])
def test_host_built_tile_path_matches_plain_sweep(host_lib, name, pad, tile):
    """H1's shared-memory tile path (``TileColumn``: old values from the
    tile, new values to the state, factor values re-read from the tile)
    against the plain sweep, and against the in-place column path to the
    bit; ``pad=1`` leaves an edge count that is not a multiple of the
    tile, so the last tile is partial."""
    cfg, graph, state = _warm_state(name, pad)
    if pad == 1:
        assert graph.n_edges % tile != 0
    ct, lt = table_kernel.build_tables(state.cam_bel, state.lmk_bel)
    ref, tiled, col = state.clone(), state.clone(), state.clone()
    sweep_kernel.sweep(ref, graph, ct, lt, cfg)
    _host_sweep(host_lib, tiled, graph, cfg, ct, lt, tile)
    _assert_same_sweep(tiled, ref, state, cfg)
    _host_sweep(host_lib, col, graph, cfg, ct, lt)
    for f in ("pk", "damping_count", "robust"):
        assert torch.equal(getattr(tiled, f), getattr(col, f)), f


def _host_sweep_planes(host_lib, state, graph, cfg, bc, bl):
    params = sweep_kernel.sweep_params(cfg, graph.k, graph.intr is not None)
    host_lib.host_sweep_planes(
        ctypes.addressof(params), state.pk.data_ptr(),
        state.damping_count.data_ptr(), state.robust.data_ptr(),
        state.active.data_ptr(), graph.meas.data_ptr(),
        graph.meas_var.data_ptr(), _cuda.ptr(graph.intr), bc.data_ptr(),
        bl.data_ptr(), graph.n_edges)


@pytest.mark.parametrize("name", ["pinhole", "snavely", "large"])
def test_host_built_unfused_edge_math_matches_plain(host_lib, name):
    """H4's per-edge body (csrc/edge_math.cuh ``edge_math_gathered``: the
    means solved per edge by planes.cuh ``belief_mean``) against the plain
    unfused sweep, with a singular landmark belief and a NaN camera Lambda
    among the inputs; and, on the unpoisoned state, against H1's body on
    the tables: the same result to the bit."""
    cfg, graph, state = _warm_state(name)
    bad = state.clone()
    bad.lmk_bel[3:, 5] = 0.0
    bad.cam_bel[10, 1] = float("nan")
    bc = reduce_kernel.gather(bad.cam_bel, graph.cam_idx)
    bl = reduce_kernel.gather(bad.lmk_bel, graph.lmk_idx)
    ref, host = bad.clone(), bad.clone()
    sweep_kernel.sweep_planes(ref, graph, bc, bl, cfg)
    _host_sweep_planes(host_lib, host, graph, cfg, bc, bl)
    _assert_same_sweep(host, ref, bad, cfg)

    fused, unfused = state.clone(), state.clone()
    ct, lt = table_kernel.build_tables(state.cam_bel, state.lmk_bel)
    params = sweep_kernel.sweep_params(cfg, graph.k, graph.intr is not None)
    host_lib.host_sweep(
        ctypes.addressof(params), fused.pk.data_ptr(),
        fused.damping_count.data_ptr(), fused.robust.data_ptr(),
        fused.active.data_ptr(), graph.meas.data_ptr(),
        graph.meas_var.data_ptr(), _cuda.ptr(graph.intr),
        graph.cam_idx.data_ptr(), graph.lmk_idx.data_ptr(), ct.data_ptr(),
        lt.data_ptr(), graph.n_edges)
    _host_sweep_planes(host_lib, unfused, graph, cfg,
                       reduce_kernel.gather(state.cam_bel, graph.cam_idx),
                       reduce_kernel.gather(state.lmk_bel, graph.lmk_idx))
    for f in ("pk", "damping_count", "robust"):
        assert torch.equal(getattr(fused, f), getattr(unfused, f)), f


def _slam_state(pad=None):
    """The SLAM driver's schedule (relinearise every sweep, the one-sided
    depth guard, the settled-edge rescue after 300 sweeps) on a state that
    takes every branch of it: keyframe 2 inserted into the warmed
    keyframes 0 and 1 (later keyframes inactive), eight active landmarks
    moved behind the cameras (eta negated: the cloud sits in front), the
    damping counters spread over [-2, 700), zeros among them."""
    prob = balio.synthetic_problem(n_keyframes=6, n_points=60, seed=2,
                                   pixel_noise=0.5)
    cfg = GBPConfig(accel_every=0, relin_every_iter=True, eta_damping=0.7,
                    iters_before_damping=0, relin_behind_camera=False,
                    behind_camera_rescue_iters=300)
    if pad is not None:
        cfg = dataclasses.replace(cfg, edge_pad_multiple=pad)
    graph = fg.build_graph(prob, cfg, "cpu")
    state = gbp.initialise(fg.init_state(
        prob, cfg, "cpu", flags=flags.create_flags(prob, cfg.steps)),
        graph, cfg)
    state, _ = gbp.run_gbp(state, graph, cfg, 30, with_diagnostics=False)
    state = slam.insert_keyframe(state, graph, cfg, 2, 6.0)
    state, _ = gbp.run_gbp(state, graph, cfg, 3, with_diagnostics=False)
    lmk = graph.lmk_idx[state.active > 0].unique()
    state.lmk_bel[:3, lmk[:16:2]] *= -1.0
    dc = np.random.default_rng(1).integers(-2, 700, graph.n_edges)
    dc[::17] = 0
    state.damping_count.copy_(torch.tensor(dc, dtype=torch.int32))
    return cfg, graph, state


@pytest.mark.parametrize("pad,tile", [(None, None), (None, 32), (1, 7)])
def test_host_built_sweeps_match_plain_under_slam_config(host_lib, pad,
                                                         tile):
    """H1's and H4's bodies (in place, and through 32- and 7-edge tiles on
    an unpadded edge count) under the SLAM driver's schedule flags
    (``F_RELIN_EVERY_ITER`` set, ``F_RELIN_BEHIND_CAMERA`` clear, a rescue
    threshold) against the plain sweeps; H4 == H1 to the bit. The state
    takes every branch: edges relinearised in front of the camera, edges
    behind it refused until their counter passes 300 and rescued after,
    inactive edges, damping switched on at counter 0."""
    cfg, graph, state = _slam_state(pad)
    e = graph.n_edges
    bc = reduce_kernel.gather(state.cam_bel, graph.cam_idx)
    bl = reduce_kernel.gather(state.lmk_bel, graph.lmk_idx)
    ct, lt = (_host_table(host_lib, bel, d)
              for bel, d in ((state.cam_bel, 6), (state.lmk_bel, 3)))
    ref1, ref4 = state.clone(), state.clone()
    h1, h4 = state.clone(), state.clone()
    sweep_kernel.sweep(ref1, graph, ct, lt, cfg)
    sweep_kernel.sweep_planes(ref4, graph, bc, bl, cfg)
    _host_sweep(host_lib, h1, graph, cfg, ct, lt, tile)
    params = sweep_kernel.sweep_params(cfg, graph.k, graph.intr is not None)
    args = [ctypes.addressof(params), h4.pk.data_ptr(),
            h4.damping_count.data_ptr(), h4.robust.data_ptr(),
            h4.active.data_ptr(), graph.meas.data_ptr(),
            graph.meas_var.data_ptr(), _cuda.ptr(graph.intr), bc.data_ptr(),
            bl.data_ptr(), e]
    if tile is None:
        host_lib.host_sweep_planes(*args)
    else:
        host_lib.host_sweep_planes_tiled(*args, tile)
    for host, ref in ((h1, ref1), (h4, ref4)):
        assert torch.equal(host.damping_count, ref.damping_count)
        assert torch.equal(host.robust, ref.robust)
        for f, (a, b) in fg.EDGE_PACK_OFFSETS.items():
            want = ref.pk[a:b].numpy().astype(np.float64)
            np.testing.assert_allclose(
                host.pk[a:b].numpy(), want, rtol=RTOL,
                atol=RTOL * max(np.abs(want).max(), 1e-30), err_msg=f)
    for f in ("pk", "damping_count", "robust"):
        assert torch.equal(getattr(h1, f), getattr(h4, f)), f
    # every branch was taken (depth at the means the sweep adopted)
    active = state.active > 0
    mu = ref1.mu
    y_cf, _ = planes.w2c_apply(list(mu[:6]), list(mu[6:]))
    z = y_cf[2]
    relin = (ref1.lin_mu != state.lin_mu).any(dim=0)
    settled = ref1.damping_count > cfg.behind_camera_rescue_iters
    behind = active & (z < -cfg.min_depth)
    assert bool(relin[active & (z > cfg.min_depth)].all())
    assert not bool(relin[~active].any())
    assert bool((behind & settled).any()) and bool((behind & ~settled).any())
    assert bool(relin[behind & settled].all())
    assert not bool(relin[behind & ~settled].any())
    switched = active & (state.damping_count == 0)
    assert bool(switched.any())
    assert bool((ref1.damping[switched] == np.float32(0.7)).all())
    if pad == 1:
        assert e % tile != 0


def _host_table(host_lib, bel, d):
    out = torch.empty((bel.shape[1], table_kernel.CAM_WIDTH if d == 6
                       else table_kernel.LMK_WIDTH))
    host_lib.host_table(d, bel.data_ptr(), bel.shape[1], out.data_ptr())
    return out


@pytest.mark.parametrize("name,pad,tile", [
    ("pinhole", None, 32), ("snavely", None, 32), ("pinhole", 1, 32),
    ("snavely", 1, 7), ("large odd", 1, 32)])
def test_host_built_unfused_tile_path_matches_plain(host_lib, name, pad,
                                                    tile):
    """H4's tile path (``edge_math_gathered`` through ``TileColumn`` on a
    tile buffer [109][T]) against the plain unfused sweep, and against H1's
    tile path on the tables to the bit; ``pad=1`` leaves an edge count that
    is not a multiple of the tile (odd for "large odd"), so the last tile
    is partial."""
    cfg, graph, state = _warm_state(name, pad)
    if pad == 1:
        assert graph.n_edges % tile != 0
    if name == "large odd":
        assert graph.n_edges % 2 == 1
    bc = reduce_kernel.gather(state.cam_bel, graph.cam_idx)
    bl = reduce_kernel.gather(state.lmk_bel, graph.lmk_idx)
    ref, tiled, fused = state.clone(), state.clone(), state.clone()
    sweep_kernel.sweep_planes(ref, graph, bc, bl, cfg)
    params = sweep_kernel.sweep_params(cfg, graph.k, graph.intr is not None)
    host_lib.host_sweep_planes_tiled(
        ctypes.addressof(params), tiled.pk.data_ptr(),
        tiled.damping_count.data_ptr(), tiled.robust.data_ptr(),
        tiled.active.data_ptr(), graph.meas.data_ptr(),
        graph.meas_var.data_ptr(), _cuda.ptr(graph.intr), bc.data_ptr(),
        bl.data_ptr(), graph.n_edges, tile)
    _assert_same_sweep(tiled, ref, state, cfg)
    # the tables' means by the same host build of belief_mean (the plain
    # table build's CPU sqrt rounds differently)
    ct, lt = (_host_table(host_lib, bel, d)
              for bel, d in ((state.cam_bel, 6), (state.lmk_bel, 3)))
    _host_sweep(host_lib, fused, graph, cfg, ct, lt, tile)
    for f in ("pk", "damping_count", "robust"):
        assert torch.equal(getattr(tiled, f), getattr(fused, f)), f


@pytest.mark.parametrize("d", [6, 3])
def test_host_built_table_row_matches_plain(host_lib, d):
    """H2's per-variable body (csrc/table.cuh ``table_row``) against the
    plain table build on random beliefs with a zero Lambda and a NaN eta: the
    belief, flag and pad columns equal, the means within 1e-4 of
    1 + |mean| (the host's sqrt and divide against PyTorch's CPU ones)."""
    rng = np.random.default_rng(7 + d)
    n = 500
    a = rng.normal(0, 1, (n, d, d))
    lam = a @ a.transpose(0, 2, 1) + 0.5 * np.eye(d)
    packed = np.stack([lam[:, i, j] for i in range(d) for j in range(i + 1)])
    bel = np.concatenate([rng.normal(0, 1, (d, n)), packed]).astype(
        np.float32)
    bel[d:, 7] = 0.0                          # singular -> invalid
    bel[0, 11] = np.nan                       # poisoned -> invalid
    bel = torch.tensor(bel)
    comp = bel.shape[0]
    ref = table_kernel.build_table_reference(bel, d)
    out = _host_table(host_lib, bel, d)
    same = (out == ref) | (out.isnan() & ref.isnan())
    assert bool(same[:, :comp].all()) and bool(same[:, comp + d:].all())
    # the NaN row is invalid; the singular one too where its mean overflows
    # (landmarks: a zero determinant; the cameras' Cholesky clamps its
    # pivots and stays finite)
    assert not ref[11, comp + d] and bool(ref[7, comp + d]) == (d == 6)
    assert int(ref[:, comp + d].sum()) == n - (1 if d == 6 else 2)
    mu, mu_ref = out[:, comp:comp + d], ref[:, comp:comp + d]
    assert bool(((mu - mu_ref).abs() <= RTOL * (1 + mu_ref.abs())).all())


@pytest.mark.parametrize("kind", ["cam", "lmk"])
def test_host_built_gather_matches_plain(host_lib, kind):
    """H5's per-edge body (csrc/gather.cuh) against ``index_select``, on
    shuffled camera ids: bit-equal on every lane."""
    rng = np.random.default_rng(3)
    prob = balio.synthetic_problem_large(n_keyframes=30, n_points=500,
                                         obs_per_lmk=5, seed=3)
    perm = rng.permutation(prob.n_keyframes)
    prob.cam_idx = perm[prob.cam_idx].astype(prob.cam_idx.dtype)
    graph = fg.build_graph(prob, GBPConfig(), "cpu")
    comp, n_var, idx = ((27, prob.n_keyframes, graph.cam_idx) if kind == "cam"
                        else (9, prob.n_points, graph.lmk_idx))
    src = torch.tensor(rng.normal(0, 1, (comp, n_var)).astype(np.float32))
    out = torch.empty((comp, graph.n_edges))
    host_lib.host_gather(src.data_ptr(), n_var, comp, idx.data_ptr(),
                         out.data_ptr(), graph.n_edges)
    assert torch.equal(out, reduce_kernel.gather(src, idx))


def _shuffled_graph(seed=3):
    """A graph of 20,000 edges (three chunks) with shuffled camera ids."""
    rng = np.random.default_rng(seed)
    prob = balio.synthetic_problem_large(n_keyframes=30, n_points=4000,
                                         obs_per_lmk=5, seed=seed)
    perm = rng.permutation(prob.n_keyframes)
    prob.cam_idx = perm[prob.cam_idx].astype(prob.cam_idx.dtype)
    return fg.build_graph(prob, GBPConfig(), "cpu")


@pytest.mark.parametrize("kind", ["cameras", "camera groups", "group pairs",
                                  "landmark groups"])
def test_host_built_chunked_reduce_matches_plain(host_lib, kind):
    """H3's two-pass bodies (csrc/reduce.cuh ``run_sum``, ``combine_chunks``)
    over the chunk plan of camera-shuffled and group-keyed segments, with a
    prior, against the plain ``index_add_`` and against a float64 sum:
    both within 1e-5 of the sum of |terms| (another rounding tree)."""
    from gbp_poplar_tpu_torch.core import coarse

    graph = _shuffled_graph()
    groups = coarse.group_segments(graph, 4)
    seg = {"cameras": graph.cam_seg, "camera groups": groups.edge_cam,
           "group pairs": groups.edge_pair, "landmark groups": groups.lmk}[kind]
    assert seg.plan is not None and seg.perm is not None
    n_listed = seg.var.shape[0]
    if kind != "landmark groups":
        assert seg.plan.n_chunks == 3
    rng = np.random.default_rng(5)
    comp = 27
    cols = max(n_listed, graph.n_edges)
    planes = torch.tensor(rng.normal(0, 1, (comp, cols)).astype(np.float32))
    prior = torch.tensor(rng.normal(0, 1, (comp, seg.n_var))
                         .astype(np.float32))
    plan = seg.plan

    def host(out):
        host_lib.host_reduce_chunks(
            planes.data_ptr(), planes.stride(0), comp, plan.order.data_ptr(),
            plan.chunk_runs.data_ptr(), plan.run_start.data_ptr(),
            plan.var_ptr.data_ptr(), plan.var_runs.data_ptr(), seg.n_var,
            n_listed, plan.chunk, plan.n_chunks, plan.n_runs,
            prior.data_ptr(), out.data_ptr())
        return out

    out = host(torch.empty((comp, seg.n_var)))
    ref = reduce_kernel.segment_sum(planes, seg, prior)
    scale = reduce_kernel.segment_sum(planes.abs(), seg, prior.abs())
    exact = reduce_kernel.segment_sum(planes.double(), seg, prior.double())
    assert bool(((out - ref).abs() <= 1e-5 * scale).all())
    assert bool(((out.double() - exact).abs() <= 1e-5 * scale).all())
    assert torch.equal(out, host(torch.empty_like(out)))


@pytest.mark.parametrize("snavely", [False, True], ids=["pinhole",
                                                         "snavely"])
def test_host_built_projection_matches_plain(host_lib, snavely):
    """planes.cuh ``project`` (the projection that H1's and H4's
    relinearisation and H6 share) against ``planes.project``, rotations
    at and near 0 included: within 1e-4 of 1 + |value| (the host's
    sinf/cosf)."""
    rng = np.random.default_rng(21)
    n = 400
    cam = rng.normal(0, 1, (6, n))
    cam[3:] *= 0.3
    cam[3:, :5] = 0.0
    cam[3:, 5:10] = 1e-7
    lmk = rng.normal(0, 1, (3, n)) + np.array([[0.0], [0.0], [6.0]])
    cam, lmk = (torch.tensor(x.astype(np.float32)) for x in (cam, lmk))
    k = np.array([[520.0, 0, 320.0], [0, 510.0, 240.0], [0, 0, 1]],
                 np.float32)
    intr = None
    if snavely:
        intr = torch.tensor(np.stack([
            rng.uniform(400, 600, n), rng.normal(0, 1e-2, n),
            rng.normal(0, 1e-3, n)]).astype(np.float32))
    (u, v), y_cf, _ = planes.project(
        planes.unpack_vec(cam, 6), planes.unpack_vec(lmk, 3), k,
        None if intr is None else planes.unpack_vec(intr, 3))
    pinhole = torch.tensor([k[0][0], k[1][1], k[0][2], k[1][2]])
    uv, y = torch.empty((2, n)), torch.empty((3, n))
    host_lib.host_project(cam.data_ptr(), lmk.data_ptr(), pinhole.data_ptr(),
                          _cuda.ptr(intr), uv.data_ptr(), y.data_ptr(), n)
    for got, want in ((uv, torch.stack([u, v])), (y, torch.stack(y_cf))):
        assert bool(((got - want).abs() <= RTOL * (1 + want.abs())).all())


@functools.lru_cache(maxsize=None)
def _diag_state(name, pad):
    """A warmed state one sweep past the first relinearisations, with
    singular beliefs: two landmarks' Lambda zeroed (their means overflow)
    and one camera's eta NaN (``_warm_state``'s padding edges stay); the
    Huber flag set on every fifth edge (no residual here reaches it).
    Shared by the cases that read it; none writes it."""
    cfg, graph, state = _warm_state(name, pad)
    state = gbp.gbp_sweep(state, graph, cfg).clone()
    state.robust[::5] = True
    seen = graph.lmk_idx[state.active > 0].unique()
    state.lmk_bel[3:, seen[:2]] = 0.0
    state.cam_bel[0, 1] = float("nan")
    return cfg, graph, state


def _block_order(order, blocks):
    """The order in which the host-built launch's blocks finish."""
    if order == "in order":
        return np.arange(blocks)
    if order == "reversed":
        return np.arange(blocks)[::-1].copy()
    return np.random.default_rng(9).permutation(blocks)


def _host_diag(host_lib, args, order):
    """The host build of H6's launch on ``args`` with its blocks finishing
    in ``order``: (out, partials [5, blocks]); exactly one block adds the
    partials, and the ticket is 0 again after the launch."""
    blocks = host_lib.host_diag_blocks(args.n_edges)
    seq = torch.tensor(_block_order(order, blocks), dtype=torch.int64)
    partial = torch.full((5, blocks), float("nan"), dtype=torch.float64)
    ticket = torch.zeros(1, dtype=torch.int32)
    out = torch.full((5,), float("nan"), dtype=torch.float64)
    folds = host_lib.host_diag(ctypes.addressof(args), seq.data_ptr(),
                               partial.data_ptr(), ticket.data_ptr(),
                               out.data_ptr())
    assert folds == 1 and int(ticket) == 0
    return out, partial


def _assert_diag_close(out, ref):
    """Counts equal; the float sums within RTOL of the sum of |terms| (the
    sums themselves: the terms are >= 0; the host's sinf/cosf)."""
    counts = [diag_kernel.SUMS.index(c)
              for c in ("n_active", "n_relins", "n_robust")]
    assert torch.equal(out[counts], ref[counts])
    assert bool((out[1:3] - ref[1:3]).abs().le(RTOL * ref[1:3]).all())


@pytest.mark.parametrize("order", ["in order", "reversed", "shuffled"])
@pytest.mark.parametrize("name,pad", [("pinhole", None), ("snavely", None),
                                      ("large", None), ("large odd", 1)])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "bad"])
def test_host_built_diag_matches_plain(host_lib, name, pad, masked, order):
    """H6's launch (csrc/diag.cuh: ``diag_edge``, ``diag_thread_edges``,
    ``fold_warps``, ``thread_partials``, ``diag_finish``, with
    the kernel's lane tree and ticket mirrored) on the plain belief tables
    against ``edge_sums_reference``, on states with singular beliefs,
    padding edges (odd and unpadded for "large odd"), several blocks for
    the large ones and, ``bad``, a tenth of the edges marked bad: the
    counts equal (the tables' validity flags exclude exactly the edges
    whose unsanitised means give a non-finite norm), the float sums within
    1e-4 of the sum of |terms| (the host's sinf/cosf); the blocks
    finishing in ``order`` give the same bits as in order, and a rerun
    repeats them."""
    cfg, graph, state = _diag_state(name, pad)
    e = graph.n_edges
    if pad == 1:
        assert e % 2 == 1 and bool((state.active > 0).all())
    else:
        assert not bool((state.active > 0).all())
    bad = None
    if masked:
        bad = torch.tensor(np.random.default_rng(4).random(e) < 0.1)
    tables = table_kernel.build_tables(state.cam_bel, state.lmk_bel)
    args = diag_kernel.diag_args(state, graph, tables,
                                 cfg.num_undamped_iters, bad)
    blocks = host_lib.host_diag_blocks(e)
    assert blocks == -(-e // 1024)
    if name.startswith("large"):
        assert blocks > 1

    out, partial = _host_diag(host_lib, args, order)
    ref = diag_kernel.edge_sums(state, graph, cfg.num_undamped_iters, bad)
    _assert_diag_close(out, ref)
    # the singular beliefs and the mask took edges out; sweeps relinearised
    live = (state.active > 0) & (True if bad is None else ~bad)
    assert 0 < ref[0] < int(live.sum())
    assert ref[3] > 0 and ref[4] > 0
    # the last block adds every block's partial; the order the blocks
    # finish in changes no bit, nor does a rerun
    np.testing.assert_allclose(
        partial.sum(1).numpy() * [1, 1, 0.5, 1, 1], out.numpy(), rtol=1e-12)
    assert torch.equal(_host_diag(host_lib, args, "in order")[0], out)
    assert torch.equal(_host_diag(host_lib, args, order)[0], out)


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 1025])
def test_host_built_diag_edge_counts(host_lib, n):
    """H6's launch on the first ``n`` edges of the large state: no edges
    (one block with none, which writes zeros), one, one block of 1,024 and
    one edge either side of it (the lanes past the last edge add nothing);
    against the plain version on the same edges, with the blocks in order
    and reversed to the same bits."""
    from types import SimpleNamespace

    cfg, graph, state = _diag_state("large", None)
    assert graph.n_edges > 1025
    sub_graph = SimpleNamespace(
        k=graph.k, n_edges=n, intr=None, meas=graph.meas[:, :n].contiguous(),
        cam_idx=graph.cam_idx[:n], lmk_idx=graph.lmk_idx[:n])
    sub_state = SimpleNamespace(
        cam_bel=state.cam_bel, lmk_bel=state.lmk_bel,
        active=state.active[:n], damping_count=state.damping_count[:n],
        robust=state.robust[:n])
    tables = table_kernel.build_tables(state.cam_bel, state.lmk_bel)
    args = diag_kernel.diag_args(sub_state, sub_graph, tables,
                                 cfg.num_undamped_iters)
    assert host_lib.host_diag_blocks(n) == max(1, -(-n // 1024))
    out, _ = _host_diag(host_lib, args, "in order")
    ref = diag_kernel.edge_sums_reference(sub_state, sub_graph,
                                          cfg.num_undamped_iters)
    _assert_diag_close(out, ref)
    if n == 0:
        assert not bool(out.any())
    elif n > 1:
        assert ref[0] > 0
    assert torch.equal(_host_diag(host_lib, args, "reversed")[0], out)
