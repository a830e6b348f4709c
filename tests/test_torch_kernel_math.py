"""The CUDA kernels' per-edge bodies, compiled for the host.

csrc/edge_math.cuh and csrc/planes.cuh hold the whole per-edge body of the
fused sweep kernel (H1, ``edge_math_tables`` through its shared-memory
tile accessor ``TileColumn``) and of the unfused one (H4,
``edge_math_gathered``), csrc/gather.cuh that of the gather (H5),
csrc/reduce.cuh the run sum and chunk combine of H3's two-pass sum, as
plain ``__device__`` functions on scalars. With a
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
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gbp_poplar_tpu_torch.config import GBPConfig
from gbp_poplar_tpu_torch.core import factor_graph as fg
from gbp_poplar_tpu_torch.core import gbp
from gbp_poplar_tpu_torch.ops import (_cuda, reduce_kernel, sweep_kernel,
                                      table_kernel)
from gbp_poplar_tpu_torch.utils import balio

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
#include "edge_math.cuh"
#include "gather.cuh"
#include "reduce.cuh"
using namespace gbp;
extern "C" void host_sweep(const SweepParams* p, float* pk, int* dc,
                           uint8_t* rb, const int* active, const float* meas,
                           const float* meas_var, const float* intr,
                           const int* cam_idx, const int* lmk_idx,
                           const float* cam_tbl, const float* lmk_tbl,
                           int n) {
  for (int e = 0; e < n; ++e) {
    float bc[CAM_WIDTH], bl[LMK_WIDTH], in[3] = {0.f, 0.f, 0.f};
    for (int i = 0; i < CAM_WIDTH; ++i)
      bc[i] = cam_tbl[(size_t)cam_idx[e] * CAM_WIDTH + i];
    for (int i = 0; i < LMK_WIDTH; ++i)
      bl[i] = lmk_tbl[(size_t)lmk_idx[e] * LMK_WIDTH + i];
    if (p->flags & F_HAS_INTR)
      for (int i = 0; i < 3; ++i) in[i] = intr[i * n + e];
    const EdgeColumn col{pk + e, (long long)n};
    int count = dc[e];
    uint8_t robust = rb[e];
    edge_math_tables(*p, col, count, robust, active[e] > 0, bc, bl, meas[e],
                     meas[n + e], meas_var[e], in);
    dc[e] = count;
    rb[e] = robust;
  }
}
// H1's tile path: each tile's T columns of the packed state copied into a
// tile buffer [109][T] (the kernel's shared-memory stage), the body run on
// each column through TileColumn (old values from the tile, new values to
// the state, the factor rows parked in the tile), the edges of a partial
// last tile included.
extern "C" void host_sweep_tiled(const SweepParams* p, float* pk, int* dc,
                                 uint8_t* rb, const int* active,
                                 const float* meas, const float* meas_var,
                                 const float* intr, const int* cam_idx,
                                 const int* lmk_idx, const float* cam_tbl,
                                 const float* lmk_tbl, int n, int T) {
  std::vector<float> tile((size_t)PACK_ROWS * T);
  for (int e0 = 0; e0 < n; e0 += T) {
    const int m = std::min(T, n - e0);
    for (int r = 0; r < PACK_ROWS; ++r)
      for (int t = 0; t < m; ++t)
        tile[(size_t)r * T + t] = pk[(size_t)r * n + e0 + t];
    for (int t = 0; t < m; ++t) {
      const int e = e0 + t;
      float bc[CAM_WIDTH], bl[LMK_WIDTH], in[3] = {0.f, 0.f, 0.f};
      for (int i = 0; i < CAM_WIDTH; ++i)
        bc[i] = cam_tbl[(size_t)cam_idx[e] * CAM_WIDTH + i];
      for (int i = 0; i < LMK_WIDTH; ++i)
        bl[i] = lmk_tbl[(size_t)lmk_idx[e] * LMK_WIDTH + i];
      if (p->flags & F_HAS_INTR)
        for (int i = 0; i < 3; ++i) in[i] = intr[i * n + e];
      const TileColumn col{tile.data() + t, T, pk + e, (long long)n};
      int count = dc[e];
      uint8_t robust = rb[e];
      edge_math_tables(*p, col, count, robust, active[e] > 0, bc, bl,
                       meas[e], meas[n + e], meas_var[e], in);
      dc[e] = count;
      rb[e] = robust;
    }
  }
}
extern "C" void host_sweep_planes(const SweepParams* p, float* pk, int* dc,
                                  uint8_t* rb, const int* active,
                                  const float* meas, const float* meas_var,
                                  const float* intr, const float* bc,
                                  const float* bl, int n) {
  for (int e = 0; e < n; ++e) {
    float in[3] = {0.f, 0.f, 0.f};
    if (p->flags & F_HAS_INTR)
      for (int i = 0; i < 3; ++i) in[i] = intr[i * n + e];
    const EdgeColumn col{pk + e, (long long)n};
    int count = dc[e];
    uint8_t robust = rb[e];
    edge_math_gathered(*p, col, count, robust, active[e] > 0, bc + e, bl + e,
                       (long long)n, meas[e], meas[n + e], meas_var[e], in);
    dc[e] = count;
    rb[e] = robust;
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
    lib.host_gather.argtypes = [p, ll, i, p, p, ll]
    lib.host_reduce_chunks.argtypes = [p, ll, i, p, p, p, p, p, i, i, i, i,
                                       i, p, p]
    for fn in (lib.host_sweep, lib.host_sweep_planes, lib.host_sweep_tiled,
               lib.host_gather, lib.host_reduce_chunks):
        fn.restype = None
    return lib


def _warm_state(name, pad=None):
    prob = {
        "pinhole": lambda: balio.synthetic_problem(
            n_keyframes=6, n_points=60, seed=0, pixel_noise=0.5),
        "snavely": lambda: balio.synthetic_problem_snavely(pixel_noise=0.5),
        "large": lambda: balio.synthetic_problem_large(
            n_keyframes=20, n_points=1000, obs_per_lmk=7, seed=2),
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
    ct = table_kernel.build_table(state.cam_bel, 6)
    lt = table_kernel.build_table(state.lmk_bel, 3)
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
    ct = table_kernel.build_table(state.cam_bel, 6)
    lt = table_kernel.build_table(state.lmk_bel, 3)
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
    ct = table_kernel.build_table(state.cam_bel, 6)
    lt = table_kernel.build_table(state.lmk_bel, 3)
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
