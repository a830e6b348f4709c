"""The chunk boundary's kernels, H7 (the coarse step's per-edge system
blocks) and H8 (the MAP cost's data term at K sets of means), on the CPU.

csrc/coarse.cuh and csrc/cost.cuh hold their per-edge bodies as plain
functions on scalars; with the shim of tests/test_torch_kernel_math.py g++
builds them for the host, and these tests run them edge by edge against
the plain versions (ops/coarse_kernel.coarse_edge_blocks_reference,
ops/cost_kernel.cost_sums_reference) on swept states and on every branch:
a landmark on the camera plane, non-finite means, a finite basis whose
products overflow, inactive and padding edges, intrinsics on and off, a
bad mask, K = 1, 2 and 3. H8's launch is mirrored block by block (the
lane tree, the warps in order, the ticket), the blocks finishing in any
order to the same bits. The plain versions are held against the JAX
package: the group sums of the coarse terms against its segment_sum terms
(gbp_poplar_tpu/core/coarse.py), the data term against its _cost_parts.

Tolerances: the host's sinf/cosf and PyTorch's CPU sin/cos round apart,
and the plain coarse terms come from lie.so3_exp's matrix form where the
kernel uses planes.cuh's unrolled one, so the coarse planes are held to
COARSE_RTOL of each plane's largest magnitude, with the same edges
zeroed; H8's float64 sums against the plain float32 sums within COST_RTOL
of the sum of |loss| (the losses are >= 0, so that is the plain sum).
"""

import ctypes
import dataclasses
import shutil
import subprocess
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_coarse import _jax_state, _port, _problem
from test_torch_kernel_math import _SHIM

from gbp_poplar_tpu.config import GBPConfig as JaxConfig
from gbp_poplar_tpu.core import build_graph as jax_build_graph
from gbp_poplar_tpu.core import gbp as jax_gbp
from gbp_poplar_tpu.core import init_state as jax_init_state
from gbp_poplar_tpu.ops import linalg as jax_linalg
from gbp_poplar_tpu.ops import lie as jax_lie
from gbp_poplar_tpu.ops import projection as jax_projection
from gbp_poplar_tpu_torch.config import GBPConfig
from gbp_poplar_tpu_torch.core import coarse, gbp
from gbp_poplar_tpu_torch.core import factor_graph as fg
from gbp_poplar_tpu_torch.ops import _cuda, coarse_kernel, cost_kernel
from gbp_poplar_tpu_torch.ops import reduce_kernel
from gbp_poplar_tpu_torch.utils import balio

torch.set_num_threads(1)

# the host-built coarse planes against the plain ones, per plane, relative
# to the plane's largest magnitude: the rotation block of J_c carries a
# relative error of about an ulp of R over |w| (its (R^T - I) hat(w) + w
# w^T / |w|^2), and R rounds apart here; b_c^T b_l then cancels (measured
# 1.9e-4 at |w| = 3e-3)
COARSE_RTOL = 1e-3
# H8's sums against the plain float32 sums, relative to the sum of |loss|,
# over thousands of edges (measured below 2e-7) ...
COST_RTOL = 1e-6
# ... and over a handful: one edge's loss moves by the host's rounding of
# its residual (measured 3.8e-5 of a 0.028 loss)
HOST_RTOL = 1e-4
# the plain coarse terms' group sums against JAX's, relative to each
# group's sum of |terms|: float32 products and sums in another order, on
# Jacobians whose rotation block carries about an ulp of R over |w| (|w|
# down to 0.028 here) and residuals whose pixel coordinates the two
# projections round an ulp apart (6.1e-5 px of up to 1.2 px); measured
# 1.1e-5 (ab) and 2.1e-5 (rc)
JAX_RTOL = 1e-4
# the plain cost sums against JAX's data term, relative to the sum (of
# losses >= 0): float32 sums of the same Huber losses in another order,
# each residual an ulp of the pixel coordinate apart; measured 8.0e-7 at
# most over K = 3 sets with and without a bad mask (6.9e-8 to 8.0e-7)
COST_JAX_RTOL = 5e-6

_HOST = r"""
#include <vector>
#include "cuda_runtime.h"
#include "coarse.cuh"
#include "cost.cuh"
using namespace gbp;
// H7's launch: every real edge's body (csrc/coarse.cu, one thread each).
extern "C" void host_coarse(const CoarseArgs* a) {
  for (long long e = 0; e < a->n_real; ++e) coarse_edge(*a, e);
}
// H8's launch (csrc/cost.cu cost_sums), as tests/test_torch_kernel_math.py
// mirrors H6's: a block's threads (cost_thread_edges), its warps' lanes by
// the shuffle tree, its warps in order (fold_warps); the blocks in the
// completion order ``order``, each writing its partial and drawing a
// ticket as atomicInc(ticket, blocks - 1) does; the last adds the
// partials by the same trees (thread_partials, cost_finish). Returns how
// many blocks did that.
static void lane_tree(double (*l)[COST_MAX_SETS]) {
  for (int h = 16; h > 0; h >>= 1)
    for (int i = 0; i < h; ++i)
      for (int k = 0; k < COST_MAX_SETS; ++k) l[i][k] = l[i][k] + l[i + h][k];
}
static void host_block(double (*lanes)[COST_MAX_SETS], double* out) {
  double warp[DIAG_WARPS][COST_MAX_SETS];
  for (int w = 0; w < DIAG_WARPS; ++w) {
    lane_tree(lanes + 32 * w);
    for (int k = 0; k < COST_MAX_SETS; ++k) warp[w][k] = lanes[32 * w][k];
  }
  fold_warps<COST_MAX_SETS>(warp, out);
}
extern "C" int host_cost(const CostArgs* a, const long long* order,
                         double* partial, unsigned* ticket, float* out) {
  const long long blocks = diag_blocks(a->n_edges);
  std::vector<double> acc((size_t)DIAG_THREADS * COST_MAX_SETS);
  double (*lanes)[COST_MAX_SETS] = (double (*)[COST_MAX_SETS])acc.data();
  double sums[COST_MAX_SETS];
  int folds = 0;
  for (long long i = 0; i < blocks; ++i) {
    const long long b = order[i];
    for (int t = 0; t < DIAG_THREADS; ++t)
      cost_thread_edges(*a, b, t, lanes[t]);
    host_block(lanes, sums);
    for (int k = 0; k < COST_MAX_SETS; ++k) partial[k * blocks + b] = sums[k];
    const unsigned drawn = *ticket, top = (unsigned)(blocks - 1);
    *ticket = drawn >= top ? 0u : drawn + 1;
    if (drawn != top) continue;
    ++folds;
    for (int t = 0; t < DIAG_THREADS; ++t)
      thread_partials<COST_MAX_SETS>((const double*)partial, blocks, t,
                                     lanes[t]);
    host_block(lanes, sums);
    cost_finish(sums, a->n_sets, out);
  }
  return folds;
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler for the host build of the kernel math")
    d = tmp_path_factory.mktemp("chunk_kernels")
    (d / "cuda_runtime.h").write_text(_SHIM)
    (d / "host.cpp").write_text(_HOST)
    so = d / "libhost.so"
    subprocess.run(
        [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-Wno-unknown-pragmas",
         "-shared", "-fPIC", f"-I{d}", f"-I{_cuda.CSRC}", str(d / "host.cpp"),
         "-o", str(so)], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    p = ctypes.c_void_p
    lib.host_coarse.argtypes = [p]
    lib.host_coarse.restype = None
    lib.host_cost.argtypes = [p] * 5
    lib.host_cost.restype = ctypes.c_int
    return lib


def _swept(name, pad=None):
    """(cfg, graph, state) of a port solve after initialise + 17 sweeps:
    ``large`` synthetic_problem_large(20, 1000, 7), ``snavely`` the
    Snavely problem (per-edge intrinsics); ``pad`` the edge padding."""
    prob = {"large": lambda: balio.synthetic_problem_large(
                n_keyframes=20, n_points=1000, obs_per_lmk=7, seed=2),
            "snavely": lambda: balio.synthetic_problem_snavely(
                pixel_noise=0.5)}[name]()
    cfg = GBPConfig(accel_every=0, coarse_groups=4)
    if pad is not None:
        cfg = dataclasses.replace(cfg, edge_pad_multiple=pad)
    graph = fg.build_graph(prob, cfg, "cpu")
    state = gbp.initialise(fg.init_state(prob, cfg, "cpu"), graph, cfg)
    state, _ = gbp.run_gbp(state, graph, cfg, 17, with_diagnostics=False)
    return cfg, graph, state


def _coarse_inputs(state):
    """The increment's inputs: the means and the cameras' sanitised basis."""
    cam_mu, lmk_mu = gbp._variable_means(state)
    s_cam = coarse._fin(coarse._cam_rigid_basis(coarse._fin(cam_mu.T)))
    return cam_mu, lmk_mu, s_cam.contiguous()


def _host_coarse(host_lib, cam_mu, lmk_mu, s_cam, state, graph, cfg):
    n_real = graph.cam_seg.var.shape[0]
    out = torch.full((coarse_kernel.TERMS, n_real), float("nan"))
    args = coarse_kernel.coarse_args(cam_mu, lmk_mu, s_cam, state, graph,
                                     cfg, graph.intr, out)
    host_lib.host_coarse(ctypes.addressof(args))
    return out


def _assert_planes_close(got, want, apart=None):
    """The host planes against the plain ones: the same edges dropped
    (every term zero), each plane within COARSE_RTOL of its largest
    magnitude, the edges of ``apart`` ([n_real] bool: edges with a huge
    basis, whose terms would set the scale) by their own."""
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert torch.equal((got == 0).all(dim=0), (want == 0).all(dim=0))
    if apart is None:
        apart = torch.zeros(want.shape[1], dtype=torch.bool)
    for cols in (~apart, apart):
        w, g = want[:, cols], got[:, cols]
        if w.shape[1]:
            scale = w.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
            gap = ((g - w).abs() / scale).max().item()
            assert gap <= COARSE_RTOL, gap


def _degenerate(graph, state):
    """A copy of ``state`` and its means on every branch of H7: edge 0's
    landmark at its camera's centre (y_cf = 0, below min_depth), a NaN
    mean of another camera, an infinite landmark mean, 30 inactive edges,
    and a third camera's basis scaled so that its b_c^T b_c overflows
    (b_c^T b_l and b_c^T r stay finite). Returns (means, basis, state, the
    big camera's edges)."""
    from gbp_poplar_tpu_torch.ops import lie

    state = state.clone()
    cam_mu, lmk_mu, s_cam = _coarse_inputs(state)
    ci, li = graph.cam_idx.long(), graph.lmk_idx.long()
    c0 = int(ci[0])
    c_nan, c_big = [c for c in range(graph.n_keyframes) if c != c0][:2]
    r, t = lie.pose_to_rt(cam_mu[:, c0])
    lmk_mu[:, li[0]] = -(r.T @ t)
    cam_mu[2, c_nan] = float("nan")
    lmk_mu[1, li[90]] = float("inf")
    state.active[100:130] = 0
    s_cam[c_big] = s_cam[c_big] * 1e18
    n_real = graph.cam_seg.var.shape[0]
    return cam_mu, lmk_mu, s_cam, state, ci[:n_real] == c_big


@pytest.mark.parametrize("name,pad,degenerate", [
    ("large", None, False), ("snavely", None, False), ("large", 1, False),
    ("large", None, True), ("snavely", None, True)])
def test_host_built_coarse_blocks_match_plain(host_lib, name, pad,
                                              degenerate):
    """H7's body over every real edge against the plain terms; ``pad=1``
    leaves no padding, the default padding edges past n_real; the
    degenerate inputs take every masking branch."""
    cfg, graph, state = _swept(name, pad)
    apart = None
    if degenerate:
        cam_mu, lmk_mu, s_cam, state, apart = _degenerate(graph, state)
    else:
        cam_mu, lmk_mu, s_cam = _coarse_inputs(state)
    n_real = graph.cam_seg.var.shape[0]
    assert (n_real < graph.n_edges) == (pad is None)
    want = coarse_kernel.coarse_edge_blocks(cam_mu, lmk_mu, s_cam, state,
                                            graph, cfg)
    got = _host_coarse(host_lib, cam_mu, lmk_mu, s_cam, state, graph, cfg)
    _assert_planes_close(got, want, apart)
    if degenerate:
        dropped = (want == 0).all(dim=0)
        assert bool(dropped[0]) and bool(dropped[100:130].all())
        live = apart & ~dropped
        assert bool(live.any())
        assert bool((want[:21, live] == 0).any())       # aa overflowed
        assert bool((want[54:, live] != 0).any())       # ab stayed finite


def _cost_sets(state, k, poison=False):
    """K sets of means: the current ones, then shifted copies; with
    ``poison`` the last set has a NaN camera mean and an infinite
    landmark mean (their edges' losses are not finite)."""
    cam, lmk = gbp._variable_means(state)
    rng = np.random.default_rng(k)
    sets = [(cam, lmk)]
    for _ in range(k - 1):
        sets.append((cam + torch.tensor(rng.normal(0, 1e-3, cam.shape),
                                        dtype=cam.dtype),
                     lmk + torch.tensor(rng.normal(0, 1e-2, lmk.shape),
                                        dtype=lmk.dtype)))
    if poison:
        c, l = sets[-1][0].clone(), sets[-1][1].clone()
        c[4, 3] = float("nan")
        l[0, 7] = float("inf")
        sets[-1] = (c, l)
    return sets


def _host_cost(host_lib, state, graph, sets, nstds, bad, order=None):
    """H8's launch mirrored on the host; returns (sums [K], folds)."""
    args = cost_kernel.cost_args(state, graph, sets, nstds, bad,
                                 graph.intr)
    blocks = host_lib_blocks(graph.n_edges)
    order = np.arange(blocks) if order is None else order
    order = torch.tensor(order, dtype=torch.int64)
    partial = torch.zeros(cost_kernel.MAX_SETS * blocks, dtype=torch.float64)
    ticket = ctypes.c_uint(0)
    out = torch.full((len(sets),), float("nan"))
    folds = host_lib.host_cost(ctypes.addressof(args), order.data_ptr(),
                               partial.data_ptr(), ctypes.addressof(ticket),
                               out.data_ptr())
    assert ticket.value == 0
    return out, folds


def host_lib_blocks(n_edges):
    """diag.cuh's diag_blocks: one block per 1,024 edges, at least one."""
    return max(1, -(-n_edges // 1024))


def _bad_mask(graph, seed=0):
    rng = np.random.default_rng(seed)
    bad = torch.zeros(graph.n_edges, dtype=torch.bool)
    bad[torch.tensor(rng.choice(graph.n_edges, 50, replace=False))] = True
    return bad


@pytest.mark.parametrize("name,k,with_bad,poison", [
    ("large", 1, False, False), ("large", 2, True, False),
    ("large", 3, False, True), ("large", 3, True, True),
    ("snavely", 2, False, False), ("snavely", 3, True, True)])
def test_host_built_cost_sums_match_plain(host_lib, name, k, with_bad,
                                          poison):
    """H8's launch against the plain float32 sums; the blocks finishing in
    ascending, reversed and shuffled order give the same bits, one block
    folds, and two equal sets give equal sums."""
    cfg, graph, state = _swept(name)
    state.active[5:40] = 0
    sets = _cost_sets(state, k, poison)
    bad = _bad_mask(graph) if with_bad else None
    want = cost_kernel.cost_sums(state, graph, sets, cfg.huber_nstds, bad)
    got, folds = _host_cost(host_lib, state, graph, sets, cfg.huber_nstds,
                            bad)
    assert folds == 1 and bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= COST_RTOL * want.abs()).all()), (
        got, want)
    blocks = host_lib_blocks(graph.n_edges)
    rng = np.random.default_rng(1)
    for order in (np.arange(blocks)[::-1].copy(), rng.permutation(blocks)):
        again, folds = _host_cost(host_lib, state, graph, sets,
                                  cfg.huber_nstds, bad, order)
        assert folds == 1 and torch.equal(again, got)
    twice, _ = _host_cost(host_lib, state, graph, [sets[0], sets[0]],
                          cfg.huber_nstds, bad)
    assert twice[0] == twice[1] == got[0]


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 1025])
def test_host_built_cost_sums_edge_counts(host_lib, n):
    """H8 on the first n edges: none (one block, zeros), one, and either
    side of a block's 1,024 edges."""
    cfg, graph, state = _swept("large")
    st = SimpleNamespace(active=state.active[:n])
    g = SimpleNamespace(
        n_edges=n, n_keyframes=graph.n_keyframes, n_points=graph.n_points,
        cam_idx=graph.cam_idx[:n], lmk_idx=graph.lmk_idx[:n],
        meas=graph.meas[:, :n].contiguous(), meas_var=graph.meas_var[:n],
        intr=None, k=graph.k)
    sets = _cost_sets(state, 2)
    want = cost_kernel.cost_sums(st, g, sets, cfg.huber_nstds)
    got, folds = _host_cost(host_lib, st, g, sets, cfg.huber_nstds, None)
    assert folds == 1
    assert bool(((got - want).abs() <= HOST_RTOL * want.abs()).all())
    if n == 0:
        assert bool((got == 0).all())


@pytest.fixture(scope="module")
def jax_swept():
    """The small problem after initialise + 30 JAX sweeps (as
    tests/test_torch_coarse.py): (port cfg, graph, state, JAX graph, JAX
    config, JAX state)."""
    tp, jp = _problem("small")
    jc = JaxConfig(coarse_groups=3, edge_pad_multiple=64, accel_every=0)
    jg = jax_build_graph(jp, jc)
    js = jax.jit(lambda s: jax_gbp.initialise(s, jg, jc))(
        jax_init_state(jp, jc))
    js, _ = jax.jit(lambda s: jax_gbp.run_gbp(s, jg, jc, 30))(js)
    fields = {f: np.asarray(getattr(js, f)) for f in fg.STATE_FIELDS}
    cfg, graph, state = _port(tp, fields)
    return cfg, graph, state, jg, jc, _jax_state(fields)


def _jax_terms(js, jg, jc, cam_mu, lmk_mu, s_cam):
    """JAX's per-edge coarse terms and their segment sums, as
    gbp_poplar_tpu/core/coarse.py::coarse_increment computes them (its
    lines from the sanitised means to the segment_sums): aa and rc by the
    camera's group, bb and rl by the landmark's, ab by the pair. The
    cameras' basis ``s_cam`` is given: the two packages' bases differ by
    up to 1.4e-5 here (forward mode in float32 and float64;
    tests/test_torch_coarse.py holds them), which would swamp the terms'
    own agreement."""
    g = jc.coarse_groups
    c = jg.n_keyframes
    camr = jnp.where(jnp.isfinite(cam_mu.T), cam_mu.T, 0.0)
    lmkr = jnp.where(jnp.isfinite(lmk_mu.T), lmk_mu.T, 0.0)
    g_cam = (jnp.arange(c) * g) // c
    g_lmk = jnp.minimum((jg.first_kf * g) // c, g - 1)
    from gbp_poplar_tpu.core import coarse as jax_coarse
    s_lmk = jax_coarse._lmk_rigid_basis(lmkr)
    cam_e, lmk_e = camr[jg.cam_idx], lmkr[jg.lmk_idx]
    intr_e = None if jg.intr is None else jg.intr.T
    j_c, j_l = jax_projection.reproj_jacobians(cam_e, lmk_e, jg.k, intr_e)
    r = jg.meas.T - jax_projection.project(cam_e, lmk_e, jg.k, intr_e)
    err = jnp.linalg.norm(r, axis=-1)
    var, _ = jax_projection.huber_meas_var(err, jg.meas_var, jc.huber_nstds)
    z_cf = jax_lie.w2c_apply(cam_e, lmk_e)[..., 2]
    act = ((js.active > 0) & jnp.all(jnp.isfinite(r), axis=-1)
           & (jnp.abs(z_cf) > jc.min_depth)
           & jnp.all(jnp.isfinite(j_c), axis=(-2, -1))
           & jnp.all(jnp.isfinite(j_l), axis=(-2, -1)))
    w = jnp.where(act, 1.0 / var, 0.0)[:, None, None]
    r = jnp.where(act[:, None], r, 0.0)
    m = act[:, None, None]
    bmm, tr, bmv = jax_linalg.bmm, jax_linalg.transpose, jax_linalg.bmv
    b_c = jnp.where(m, bmm(j_c, s_cam[jg.cam_idx]), 0.0)
    b_l = jnp.where(m, bmm(j_l, s_lmk[jg.lmk_idx]), 0.0)
    ga, gb = g_cam[jg.cam_idx], g_lmk[jg.lmk_idx]

    def fin(x):
        return jnp.where(jnp.isfinite(x), x, 0.0)

    seg = jax.ops.segment_sum
    return {
        "aa": seg(fin(bmm(tr(b_c), b_c) * w), ga, num_segments=g),
        "bb": seg(fin(bmm(tr(b_l), b_l) * w), gb, num_segments=g),
        "ab": seg(fin(bmm(tr(b_c), b_l) * w), ga * g + gb,
                  num_segments=g * g),
        "rc": seg(fin(bmv(tr(b_c), r) * w[..., 0]), ga, num_segments=g),
        "rl": seg(fin(bmv(tr(b_l), r) * w[..., 0]), gb, num_segments=g),
    }


def test_coarse_blocks_reference_group_sums_match_jax(jax_swept):
    """``coarse_edge_blocks_reference``'s planes summed per group (H3's
    plain version over core/coarse.group_segments) against JAX's segment
    sums of the same terms, from the same state and means."""
    cfg, graph, state, jg, jc, js = jax_swept
    cam_mu, lmk_mu, s_cam = _coarse_inputs(state)
    planes = coarse_kernel.coarse_edge_blocks_reference(
        cam_mu, lmk_mu, s_cam, state, graph, cfg,
        graph.cam_seg.var.shape[0])
    segs = coarse.group_segments(graph, cfg.coarse_groups)
    rows = coarse_kernel.ROWS
    by_cam = reduce_kernel.segment_sum(planes[rows["cam"]], segs.edge_cam)
    by_lmk = reduce_kernel.segment_sum(planes[rows["lmk"]], segs.edge_lmk)
    by_pair = reduce_kernel.segment_sum(planes[rows["pair"]], segs.edge_pair)
    mag = planes.abs()
    size = {"cam": reduce_kernel.segment_sum(mag[rows["cam"]], segs.edge_cam),
            "lmk": reduce_kernel.segment_sum(mag[rows["lmk"]], segs.edge_lmk),
            "pair": reduce_kernel.segment_sum(mag[rows["pair"]],
                                              segs.edge_pair)}
    want = _jax_terms(js, jg, jc, jnp.asarray(cam_mu.numpy()),
                      jnp.asarray(lmk_mu.numpy()),
                      jnp.asarray(s_cam.numpy()))
    g = cfg.coarse_groups

    def blocks(by):
        """[27, G] group sums -> (the 6x6 blocks [G, 6, 6], the vectors)."""
        return coarse.pl.unpack_sym_dense(by[:21], 6), by[21:].T

    got, scale = {}, {}
    (got["aa"], got["rc"]), (scale["aa"], scale["rc"]) = (
        blocks(by_cam), blocks(size["cam"]))
    (got["bb"], got["rl"]), (scale["bb"], scale["rl"]) = (
        blocks(by_lmk), blocks(size["lmk"]))
    got["ab"] = by_pair.T.reshape(g * g, 6, 6)
    scale["ab"] = size["pair"].T.reshape(g * g, 6, 6)
    for key, x in got.items():
        w = np.asarray(want[key])
        assert np.abs(w).max() > 0, key
        gap = np.abs(x.numpy() - w) / np.maximum(scale[key].numpy(), 1e-30)
        assert gap.max() <= JAX_RTOL, (key, gap.max())


def test_cost_sums_reference_matches_jax(jax_swept):
    """``cost_sums_reference`` at K = 3 sets of means, with and without a
    bad mask, against JAX's ``_cost_parts`` data term at each set."""
    cfg, graph, state, jg, jc, js = jax_swept
    sets = _cost_sets(state, 3)
    for bad in (None, _bad_mask(graph, 3)):
        got = cost_kernel.cost_sums_reference(state, graph, sets,
                                              cfg.huber_nstds, bad)
        for i, (cam, lmk) in enumerate(sets):
            cam_j, lmk_j = jnp.asarray(cam.numpy()), jnp.asarray(lmk.numpy())
            robust, _, _ = jax_gbp._cost_parts(
                js, jg, jc, cam_j[:, jg.cam_idx], lmk_j[:, jg.lmk_idx],
                cam_j, lmk_j, None if bad is None else jnp.asarray(bad))
            np.testing.assert_allclose(got[i].item(), float(robust),
                                       rtol=COST_JAX_RTOL)
