"""The CUDA kernels' per-edge bodies, compiled for the host.

csrc/edge_math.cuh and csrc/planes.cuh hold the whole per-edge body of the
fused sweep kernel (H1, ``edge_math_tables``) and of the unfused one (H4,
``edge_math_gathered``), csrc/gather.cuh that of the gather (H5), as plain
``__device__`` functions on scalars. With a
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
#include "cuda_runtime.h"
#include "edge_math.cuh"
#include "gather.cuh"
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
    lib.host_gather.argtypes = [p, ll, i, p, p, ll]
    for fn in (lib.host_sweep, lib.host_sweep_planes, lib.host_gather):
        fn.restype = None
    return lib


def _warm_state(name):
    prob = {
        "pinhole": lambda: balio.synthetic_problem(
            n_keyframes=6, n_points=60, seed=0, pixel_noise=0.5),
        "snavely": lambda: balio.synthetic_problem_snavely(pixel_noise=0.5),
        "large": lambda: balio.synthetic_problem_large(
            n_keyframes=20, n_points=1000, obs_per_lmk=7, seed=2),
    }[name]()
    cfg = GBPConfig(accel_every=0)
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
