"""The CUDA sweep kernel's per-edge math, compiled for the host.

csrc/edge_math.cuh and csrc/planes.cuh hold the whole per-edge body of the
sweep kernel (H1) as plain ``__device__`` functions on scalars. With a
small header that defines the few CUDA names they use, g++ compiles them
for the CPU; this test runs that body edge by edge (the loop the kernel's
threads run in parallel) against the plain PyTorch sweep on the same
state. It checks the kernel's arithmetic, row offsets and read-before-
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
from gbp_poplar_tpu_torch.ops import _cuda, sweep_kernel, table_kernel
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
    edge_math(*p, col, count, robust, active[e] > 0, bc, bl, meas[e],
              meas[n + e], meas_var[e], in);
    dc[e] = count;
    rb[e] = robust;
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
    lib.host_sweep.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int]
    lib.host_sweep.restype = None
    return lib


@pytest.mark.parametrize("name", ["pinhole", "snavely", "large"])
def test_host_built_edge_math_matches_plain_sweep(host_lib, name):
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
