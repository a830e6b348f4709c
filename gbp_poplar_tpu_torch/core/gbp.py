"""Synchronous Gaussian Belief Propagation — the batch solve.

The PyTorch counterpart of the slice of ``gbp_poplar_tpu/core/gbp.py`` that
the batch bundle-adjustment solve runs:

  initialise (beliefs <- priors, linearise every factor)
  run_gbp:   2*steps annealed iterations (prior weakening, then a sweep),
             then anneal-free sweeps, in chunks of ``accel_every`` with a
             fixed-point extrapolation (``_accel_step``) after each chunk
             from ``accel_start`` on, followed by the coarse-space
             correction (``_coarse_step``, core/coarse.py) when
             ``coarse_groups > 0``; diagnostics after every sweep.

One sweep is one of two pipelines (``cfg.fused``), each of kernels with
their plain PyTorch versions, chosen by the tensors' device and
``cfg.kernels``:
  fused (default):
    1. ops/table_kernel.build_tables: per-variable belief tables with the
       pre-solved means and a validity flag (cameras and landmarks, one
       launch);
    2. ops/sweep_kernel.sweep: the per-edge state machine and messages
       (``edge_math``), in place on the packed edge state;
  unfused (the JAX package's pipeline on graphs without fused windows):
    1. ops/reduce_kernel.gather: the beliefs gathered per edge;
    2. ops/sweep_kernel.sweep_planes: ``edge_math`` with the means solved
       per edge, in place on the packed edge state;
  and then, for both:
    3. ops/reduce_kernel.segment_sum: beliefs = priors + message sums;
    4. with diagnostics, the tables of the new beliefs and the
       telemetry's five sums (ops/diag_kernel: H6 set up once per solve),
       written into one [n, 5] buffer per solve on the device; the next
       fused sweep of the same run reads those tables in place of building
       its own.

At a chunk boundary the accelerator and coarse steps (below) price their
candidate means with H8 (ops/cost_kernel) and the coarse step builds its
system's per-edge terms with H7 (ops/coarse_kernel, core/coarse.py).

Around the solve: ``recenter_priors`` and ``weaken_priors`` edit the
priors, and ``reprojection_error`` / ``map_cost`` take an optional mask of
known-bad associations (``factor_graph.bad_edge_mask``).

The sharded solvers (parallel/) run these functions on each rank with a
``group`` argument: every sum over edges becomes the rank's own sum and one
``all_reduce`` (core/comm.py), at the places the JAX package ``psum``s;
with ``group=None`` nothing else changes.

All per-edge state is in plane layout ([component, E] tensors, see
ops/planes.py). PyTorch runs eagerly: the loop over sweeps is a Python
loop, and diagnostics and the accelerator's decisions stay on the device
until the solve returns.

On a card, with the kernels and without ``group``, the accelerator step
and each anneal-free run of sweeps are captured once per state as CUDA
graphs and replayed from then on (``_AccelGraph``, ``_SweepGraph``): the
same kernels in the same order, ~960 launches a step and ~390 a run of 50
sweeps issued as one.

The solve's steps are spans (utils/trace.py): ``gbp.initialise``,
``gbp.run_gbp``, one ``gbp.sweeps`` per run of sweeps (never one per
sweep; holding ``gbp.sweeps_eager`` or ``gbp.sweeps_capture`` unless it is
a replay), ``gbp.accel_step`` (holding ``gbp.accel_eager`` or
``gbp.accel_capture`` unless it is a replay) and ``gbp.coarse_step``; a
profiler's trace or ``trace.collect`` reads them, and with neither on each
costs a flag read.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import NamedTuple

import torch

from ..config import GBPConfig
from ..ops import planes as pl
from ..utils import trace
from ..ops import (coarse_kernel, cost_kernel, diag_kernel, reduce_kernel,
                   sweep_kernel, table_kernel)
from . import coarse, comm
from .factor_graph import (CAM_DOF, LMK_DOF, MSG_CAM_ROWS, MSG_LMK_ROWS,
                           GBPGraph, GBPState)


def _variable_means(state: GBPState) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve belief means per variable: cam_mu [6, C], lmk_mu [3, L]."""
    return (table_kernel.variable_means(state.cam_bel, CAM_DOF),
            table_kernel.variable_means(state.lmk_bel, LMK_DOF))


def _tables(state: GBPState, cfg: GBPConfig):
    """The belief tables of the current beliefs (ops/table_kernel), by H2
    unless ``cfg.kernels == "reference"``."""
    return table_kernel.build_tables(state.cam_bel, state.lmk_bel,
                                     reference=cfg.kernels == "reference")


def _table_means(state: GBPState, tables):
    """Belief means per variable read from the belief ``tables``, each
    column zeroed whole where any component is not finite: the JAX
    package's ``_sanitize_means(*_variable_means(state))``."""
    return [tbl[:, bel.shape[0]:bel.shape[0] + d].T
            for tbl, bel, d in zip(tables, (state.cam_bel, state.lmk_bel),
                                   (CAM_DOF, LMK_DOF))]


def _sanitized_means(state: GBPState, cfg: GBPConfig):
    """Belief means per variable, each column zeroed whole where any
    component is not finite (``_table_means`` of fresh tables)."""
    return _table_means(state, _tables(state, cfg))


# ---------------------------------------------------------------------------
# belief update
# ---------------------------------------------------------------------------

def update_beliefs(state: GBPState, graph: GBPGraph, cfg: GBPConfig,
                   group=None, lmk_sharded: bool = False) -> GBPState:
    """belief = prior + sum of incoming messages, one segmented sum per
    variable kind over the message rows of the packed edge state.

    With ``group`` (a ``torch.distributed`` process group; the edges are
    split over its ranks, parallel/sharding.py) each rank sums its own
    edges' messages without the prior, the partial sums are summed over
    the ranks in one ``all_reduce``, and then the prior is added: the JAX
    package's psum. With ``lmk_sharded`` (parallel/map_sharding.py: each
    rank owns a landmark block and all of its edges) the landmark sums are
    whole on their rank and only the camera sums cross ranks."""
    ref = cfg.kernels == "reference"
    cam_rows = state.pk[MSG_CAM_ROWS[0]:MSG_CAM_ROWS[1]]
    lmk_rows = state.pk[MSG_LMK_ROWS[0]:MSG_LMK_ROWS[1]]
    if group is None:
        state.cam_bel = reduce_kernel.segment_sum(
            cam_rows, graph.cam_seg, state.cam_prior, reference=ref)
        state.lmk_bel = reduce_kernel.segment_sum(
            lmk_rows, graph.lmk_seg, state.lmk_prior, reference=ref)
        return state
    cam_sum = reduce_kernel.segment_sum(cam_rows, graph.cam_seg,
                                        reference=ref)
    if lmk_sharded:
        (cam_sum,) = comm.all_sum(group, [cam_sum])
        state.lmk_bel = reduce_kernel.segment_sum(
            lmk_rows, graph.lmk_seg, state.lmk_prior, reference=ref)
    else:
        lmk_sum = reduce_kernel.segment_sum(lmk_rows, graph.lmk_seg,
                                            reference=ref)
        cam_sum, lmk_sum = comm.all_sum(group, [cam_sum, lmk_sum])
        state.lmk_bel = state.lmk_prior + lmk_sum
    state.cam_bel = state.cam_prior + cam_sum
    return state


# ---------------------------------------------------------------------------
# relinearisation
# ---------------------------------------------------------------------------

def _linearise_planes(state: GBPState, graph: GBPGraph, cfg: GBPConfig):
    """Relinearise every factor at the current belief means. Returns
    (packed potentials..., robust [E], mu [9, E], z [E]), z the landmark's
    depth in the camera frame (for the depth guards)."""
    cam_mu, lmk_mu = _variable_means(state)
    mu_c = cam_mu.index_select(1, graph.cam_idx)
    mu_l = lmk_mu.index_select(1, graph.lmk_idx)
    eta_c, eta_l, lam_cc, lam_cl, lam_ll, robust, y_cf = pl.linearise(
        pl.unpack_vec(mu_c, 6), pl.unpack_vec(mu_l, 3), graph.k,
        graph.meas[0], graph.meas[1], graph.meas_var, cfg.huber_nstds,
        None if graph.intr is None else pl.unpack_vec(graph.intr, 3))
    return (pl.pack_vec(eta_c), pl.pack_vec(eta_l), pl.pack_sym(lam_cc, 6),
            pl.pack_full(lam_cl), pl.pack_sym(lam_ll, 3), robust,
            torch.cat([mu_c, mu_l]), y_cf[2])


def linearise_all(state: GBPState, graph: GBPGraph,
                  cfg: GBPConfig) -> GBPState:
    """Unconditionally relinearise every factor at the current means."""
    f_eta_c, f_eta_l, f_lam_cc, f_lam_cl, f_lam_ll, robust, mu, _ = (
        _linearise_planes(state, graph, cfg))
    state.f_eta_c.copy_(f_eta_c)
    state.f_eta_l.copy_(f_eta_l)
    state.f_lam_cc.copy_(f_lam_cc)
    state.f_lam_cl.copy_(f_lam_cl)
    state.f_lam_ll.copy_(f_lam_ll)
    state.lin_mu.copy_(mu)
    state.robust.copy_(robust)
    return state


def relinearise_masked(state: GBPState, graph: GBPGraph, cfg: GBPConfig,
                       mask: torch.Tensor) -> GBPState:
    """Relinearise only the edges in ``mask`` [E] at the current belief
    means, in place (SLAM keyframe insertion). An edge whose adjacent mean
    is not finite keeps its factor, and so does one the sweep's depth guard
    would refuse, with the sweep's sidedness: |z| > min_depth with
    ``relin_behind_camera``, else z > min_depth. Writes the factor,
    ``lin_mu``, ``mu`` and ``robust`` rows, as the JAX function does."""
    f_eta_c, f_eta_l, f_lam_cc, f_lam_cl, f_lam_ll, robust, mu, z = (
        _linearise_planes(state, graph, cfg))
    mask = mask & torch.isfinite(torch.sum(torch.abs(mu), dim=0))
    if cfg.min_depth > 0.0:
        mask = mask & (torch.abs(z) > cfg.min_depth if cfg.relin_behind_camera
                       else z > cfg.min_depth)
    for name, new in (("f_eta_c", f_eta_c), ("f_eta_l", f_eta_l),
                      ("f_lam_cc", f_lam_cc), ("f_lam_cl", f_lam_cl),
                      ("f_lam_ll", f_lam_ll), ("lin_mu", mu), ("mu", mu)):
        rows = getattr(state, name)
        rows.copy_(torch.where(mask, new, rows))
    state.robust.copy_(torch.where(mask, robust, state.robust))
    return state


def recenter_priors(state: GBPState, cam_mu=None, lmk_mu=None) -> GBPState:
    """Re-centre the priors at new means, keeping their strengths: prior
    eta = Lambda_prior mu (the reference's ``update_eta``), e.g. to import
    a solution from another solver. ``cam_mu`` [C, 6] and ``lmk_mu``
    [L, 3] are row-major (NumPy or tensors), cast to the state's dtype
    before the product; an omitted kind keeps its prior. Updates
    ``state`` (its prior tensors are replaced) and returns it."""
    for name, mu, d in (("cam_prior", cam_mu, CAM_DOF),
                        ("lmk_prior", lmk_mu, LMK_DOF)):
        if mu is None:
            continue
        prior = getattr(state, name)
        rows = torch.as_tensor(mu, dtype=prior.dtype, device=prior.device).T
        eta = pl.matvec(pl.unpack_sym(prior[d:], d), pl.unpack_vec(rows, d))
        setattr(state, name, torch.cat([pl.pack_vec(eta), prior[d:]]))
    return state


# ---------------------------------------------------------------------------
# prior annealing
# ---------------------------------------------------------------------------

def _anneal_priors(state: GBPState, graph: GBPGraph,
                   cam_live: torch.Tensor, lmk_live: torch.Tensor) -> GBPState:
    """Scale priors by the per-variable annealing factor where ``*_live``,
    decrementing the weaken flags there."""
    cs = torch.where(cam_live, graph.cam_scaling, 1.0)[None, :]
    ls = torch.where(lmk_live, graph.lmk_scaling, 1.0)[None, :]
    state.cam_prior = state.cam_prior * cs
    state.lmk_prior = state.lmk_prior * ls
    state.cam_weaken = state.cam_weaken - cam_live.to(torch.int32)
    state.lmk_weaken = state.lmk_weaken - lmk_live.to(torch.int32)
    return state


def weaken_priors(state: GBPState, graph: GBPGraph,
                  cfg: GBPConfig) -> GBPState:
    """Scale the priors by the per-variable annealing factor where the
    weaken flag is live (> 0), decrementing the flag there, then refresh
    the beliefs. Unlike the JAX function this takes ``cfg``: the belief
    update runs the segmented-sum kernel (ops/reduce_kernel.segment_sum)
    unless ``cfg.kernels == "reference"``."""
    state = _anneal_priors(state, graph, state.cam_weaken > 0,
                           state.lmk_weaken > 0)
    return update_beliefs(state, graph, cfg)


# ---------------------------------------------------------------------------
# one synchronous GBP sweep
# ---------------------------------------------------------------------------

def edge_math(
    bc, bl, meas, meas_var,
    f_eta_c0, f_eta_l0, f_lam_cc0, f_lam_cl0, f_lam_ll0,
    msg_c_eta0, msg_c_lam0, msg_l_eta0, msg_l_lam0,
    damping0, damping_count0, mu0, lin_mu0, robust0, active_i,
    k, cfg: GBPConfig, premu=None, intr=None,
):
    """The complete per-edge GBP sweep body on plane tensors: the damping
    and relinearisation state machine, then the factor-to-variable messages.

    The same function as ``gbp_poplar_tpu.core.gbp.edge_math``, operation
    for operation, on [E] rows. ``bc`` [27, E] / ``bl`` [9, E] are the
    gathered beliefs (eta | packed Lambda). ``premu`` (10 planes: mu_c[6] |
    mu_l[3] | valid[1]) holds the adjacent means solved once per variable,
    zeroed with valid = 0 where a belief's mean is not finite, as both
    fused TPU wrappers run it; with ``premu=None`` (the unfused pipeline)
    the means are solved per edge from ``bc``/``bl`` and, as in the JAX
    function, only the finiteness of the mean step gates them. Returns the
    14 fields f_eta_c, f_eta_l, f_lam_cc, f_lam_cl, f_lam_ll, msg_c_eta,
    msg_c_lam, msg_l_eta, msg_l_lam, damping [E], damping_count [E],
    mu, lin_mu, robust [E]. Selects are ``torch.where``, never a multiply
    by a mask, so a NaN on an inactive or padding lane stays there."""
    active = active_i > 0
    bc_eta, bc_lam = bc[:6], bc[6:]
    bl_eta, bl_lam = bl[:3], bl[3:]

    # --- prep: damping state machine ---
    damping = torch.where(active & (damping_count0 == 0),
                          cfg.eta_damping, damping0)
    damping_count = damping_count0 + active.to(torch.int32)

    if premu is not None:
        mu = premu[:9]
        valid = premu[9] > 0.5
    else:
        mu = torch.cat([table_kernel.variable_means(bc, CAM_DOF),
                        table_kernel.variable_means(bl, LMK_DOF)])
        valid = None

    # relinearisation candidates at the current belief means
    meas_u, meas_v = meas[0], meas[1]
    intr_rows = None if intr is None else pl.unpack_vec(intr, 3)
    (eta_c_n, eta_l_n, lam_cc_n, lam_cl_n, lam_ll_n, robust_new,
     y_cf) = pl.linearise(pl.unpack_vec(mu[:6], 6), pl.unpack_vec(mu[6:], 3),
                          k, meas_u, meas_v, meas_var, cfg.huber_nstds,
                          intr_rows)
    pot_eta_c = pl.pack_vec(eta_c_n)
    pot_eta_l = pl.pack_vec(eta_l_n)
    pot_lam_cc = pl.pack_sym(lam_cc_n, 6)
    pot_lam_cl = pl.pack_full(lam_cl_n)
    pot_lam_ll = pl.pack_sym(lam_ll_n, 3)

    def _sqnorm(delta):
        acc = delta[0] * delta[0]
        for r in delta[1:]:
            acc = acc + r * r
        return acc

    dmu2 = _sqnorm(mu - mu0)
    mu_ok = torch.isfinite(dmu2)
    if valid is not None:
        mu_ok = valid & mu_ok

    if cfg.relin_every_iter:
        relin = active & mu_ok
    else:
        relin = (active & mu_ok
                 & (dmu2 < cfg.dmu_threshold * cfg.dmu_threshold)
                 & (damping_count > cfg.relin_count_threshold))
        if cfg.relin_drift_threshold > 0.0:
            # runaway-edge recapture (drift from the linearisation point)
            drift2 = _sqnorm(mu - lin_mu0)
            thr = cfg.relin_drift_threshold
            relin = relin | (active & mu_ok & (drift2 > thr * thr)
                             & (damping_count > cfg.relin_count_threshold))
    if cfg.min_depth > 0.0:
        # never adopt a linearisation with the landmark on the camera plane
        if cfg.relin_behind_camera:
            relin = relin & (torch.abs(y_cf[2]) > cfg.min_depth)
        else:
            ok_depth = y_cf[2] > cfg.min_depth
            if cfg.behind_camera_rescue_iters > 0:
                settled = damping_count > cfg.behind_camera_rescue_iters
                ok_depth = ok_depth | (
                    settled & (torch.abs(y_cf[2]) > cfg.min_depth))
            relin = relin & ok_depth

    f_eta_c = torch.where(relin, pot_eta_c, f_eta_c0)
    f_eta_l = torch.where(relin, pot_eta_l, f_eta_l0)
    f_lam_cc = torch.where(relin, pot_lam_cc, f_lam_cc0)
    f_lam_cl = torch.where(relin, pot_lam_cl, f_lam_cl0)
    f_lam_ll = torch.where(relin, pot_lam_ll, f_lam_ll0)
    lin_mu = torch.where(relin, mu, lin_mu0)
    robust = torch.where(relin, robust_new, robust0)
    if cfg.reset_damping_on_relin and not cfg.relin_every_iter:
        damping = torch.where(relin, 0.0, damping)
    if not cfg.relin_every_iter:
        damping_count = torch.where(
            relin, torch.tensor(-cfg.num_undamped_iters, dtype=torch.int32,
                                device=relin.device), damping_count)
    new_mu = torch.where(active & mu_ok, mu, mu0)

    # --- factor -> variable messages ---
    f_cl = pl.unpack_full(f_lam_cl, 6, 3)
    f_cc = pl.unpack_sym(f_lam_cc, 6)
    f_ll = pl.unpack_sym(f_lam_ll, 3)
    e_c = pl.unpack_vec(f_eta_c, 6)
    e_l = pl.unpack_vec(f_eta_l, 3)

    # to keyframe: marginalise the landmark out (3x3 inverse, closed form);
    # an indefinite cavity holds the previous message (Sylvester test)
    cav_ll = pl.add_rel_jitter(
        pl.unpack_sym(f_lam_ll + bl_lam - msg_l_lam0, 3), cfg.cavity_jitter)
    inv_ll, ok_ll = pl.inv_sym3_posdef(cav_ll)
    w_cl = pl.matmul(f_cl, inv_ll)                            # 6x3
    eta_l_cav = pl.unpack_vec(f_eta_l + bl_eta - msg_l_eta0, 3)
    msg_c_eta = pl.pack_vec(pl.vsub(e_c, pl.matvec(w_cl, eta_l_cav)))
    mc_lam = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            acc = w_cl[i][0] * f_cl[j][0]
            for k2 in range(1, 3):
                acc = acc + w_cl[i][k2] * f_cl[j][k2]
            v = f_cc[i][j] - acc
            mc_lam[i][j] = v
            mc_lam[j][i] = v
    msg_c_lam = pl.pack_sym(mc_lam, 6)

    # to landmark: marginalise the keyframe out (6x6 Cholesky solves)
    cav_cc = pl.add_rel_jitter(
        pl.unpack_sym(f_lam_cc + bc_lam - msg_c_lam0, 6), cfg.cavity_jitter)
    l_cc, min_pivot = pl.cholesky_with_pivot(cav_cc)
    ok_cc = min_pivot > 0
    eta_c_cav = pl.unpack_vec(f_eta_c + bc_eta - msg_c_eta0, 6)
    y_sol = pl.chol_solve(l_cc, eta_c_cav)
    x_cols = [pl.chol_solve(l_cc, [f_cl[i][a] for i in range(6)])
              for a in range(3)]
    ml_eta = [e_l[a] - pl.vdot([f_cl[i][a] for i in range(6)], y_sol)
              for a in range(3)]
    msg_l_eta = pl.pack_vec(ml_eta)
    ml_lam = [[None] * 3 for _ in range(3)]
    for a in range(3):
        for b in range(a + 1):
            acc = f_cl[0][a] * x_cols[b][0]
            for i in range(1, 6):
                acc = acc + f_cl[i][a] * x_cols[b][i]
            v = f_ll[a][b] - acc
            ml_lam[a][b] = v
            ml_lam[b][a] = v
    msg_l_lam = pl.pack_sym(ml_lam, 3)

    # damping blend against the previous message
    def blend(new, old):
        return (1.0 - damping) * new + damping * old

    msg_c_eta = blend(msg_c_eta, msg_c_eta0)
    msg_l_eta = blend(msg_l_eta, msg_l_eta0)
    if cfg.lambda_damping:
        msg_c_lam = blend(msg_c_lam, msg_c_lam0)
        msg_l_lam = blend(msg_l_lam, msg_l_lam0)

    # PSD holds, then inactive factors emit zeros
    msg_c_eta = torch.where(ok_ll, msg_c_eta, msg_c_eta0)
    msg_c_lam = torch.where(ok_ll, msg_c_lam, msg_c_lam0)
    msg_l_eta = torch.where(ok_cc, msg_l_eta, msg_l_eta0)
    msg_l_lam = torch.where(ok_cc, msg_l_lam, msg_l_lam0)
    msg_c_eta = torch.where(active, msg_c_eta, 0.0)
    msg_l_eta = torch.where(active, msg_l_eta, 0.0)
    msg_c_lam = torch.where(active, msg_c_lam, 0.0)
    msg_l_lam = torch.where(active, msg_l_lam, 0.0)

    return (f_eta_c, f_eta_l, f_lam_cc, f_lam_cl, f_lam_ll,
            msg_c_eta, msg_c_lam, msg_l_eta, msg_l_lam,
            damping, damping_count, new_mu, lin_mu, robust)


def gbp_sweep(state: GBPState, graph: GBPGraph, cfg: GBPConfig,
              group=None, lmk_sharded: bool = False,
              tables=None) -> GBPState:
    """One synchronous sweep, in place on the edge state, then the belief
    update (``group``, ``lmk_sharded``: see ``update_beliefs``).
    ``cfg.fused``: belief tables and the fused per-edge sweep; otherwise
    the beliefs gathered per edge and the unfused sweep. ``tables``: the
    belief tables of the current beliefs (``_tables``), which the fused
    sweep reads in place of building them (``run_gbp`` passes the ones it
    built after the previous sweep); the unfused sweep reads none."""
    ref = cfg.kernels == "reference"
    if cfg.fused:
        cam_tbl, lmk_tbl = _tables(state, cfg) if tables is None else tables
        sweep_kernel.sweep(state, graph, cam_tbl, lmk_tbl, cfg, reference=ref)
    else:
        bc = reduce_kernel.gather(state.cam_bel, graph.cam_idx, reference=ref)
        bl = reduce_kernel.gather(state.lmk_bel, graph.lmk_idx, reference=ref)
        sweep_kernel.sweep_planes(state, graph, bc, bl, cfg, reference=ref)
    return update_beliefs(state, graph, cfg, group, lmk_sharded)


# ---------------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------------

class Diagnostics(NamedTuple):
    reproj_err: torch.Tensor   # mean residual norm over valid active edges
    cost: torch.Tensor         # 0.5 * sum ||r||^2
    n_relins: torch.Tensor     # edges that just relinearised
    n_robust: torch.Tensor     # edges with Huber active
    # camera belief means [6, C], only with ``verbose_means`` (the ba
    # driver's --v prints them after every sweep)
    cam_means: torch.Tensor | None = None


def _diag_sums(state: GBPState, graph: GBPGraph, cfg: GBPConfig | None,
               bad=None, out=None, group=None) -> torch.Tensor:
    """The five telemetry sums (ops/diag_kernel.SUMS) over this graph's
    edges, float64 [5] (written into ``out`` if given): H6 on the tables
    of the current beliefs, or the plain version on the CPU or with
    ``cfg.kernels == "reference"``. With ``group`` the sums run over every
    rank's edges, in one collective."""
    sums = diag_kernel.edge_sums(
        state, graph, 0 if cfg is None else cfg.num_undamped_iters, bad,
        out=out, reference=cfg is not None and cfg.kernels == "reference")
    if group is not None:
        sums.copy_(comm.all_sum(group, [sums])[0])
    return sums


def _mean_error(n_active, sum_norm):
    return torch.where(n_active > 0,
                       sum_norm / torch.clamp_min(n_active, 1.0), torch.nan)


def _diagnostics_from_sums(sums: torch.Tensor, dtype,
                           cam_means=None) -> Diagnostics:
    """Diagnostics from rows of ``_diag_sums`` ([..., 5]): the mean error
    (NaN without a valid edge) and the cost in the beliefs' ``dtype``, the
    counts as int64."""
    n_active, sum_norm, cost = (sums[..., i].to(dtype) for i in range(3))
    return Diagnostics(_mean_error(n_active, sum_norm), cost,
                       sums[..., 3].to(torch.int64),
                       sums[..., 4].to(torch.int64), cam_means)


def reprojection_error(state: GBPState, graph: GBPGraph,
                       bad: torch.Tensor | None = None, group=None,
                       cfg: GBPConfig | None = None):
    """Mean reprojection residual norm and total cost over active edges
    whose residual is finite; NaN (not 0) when no edge is valid. ``bad``
    ([E] bool on the graph's device, ``factor_graph.bad_edge_mask``)
    excludes known-bad associations. With ``group`` the sums run over
    every rank's edges. On a card the sums are H6's unless
    ``cfg.kernels == "reference"``."""
    d = _diagnostics_from_sums(_diag_sums(state, graph, cfg, bad,
                                          group=group), state.cam_bel.dtype)
    return d.reproj_err, d.cost


def diagnostics(state: GBPState, graph: GBPGraph, cfg: GBPConfig,
                with_cam_means: bool = False, group=None) -> Diagnostics:
    """The per-sweep telemetry; with ``group`` its five sums go over every
    rank's edges in one collective."""
    cam_means = _variable_means(state)[0] if with_cam_means else None
    return _diagnostics_from_sums(_diag_sums(state, graph, cfg, group=group),
                                  state.cam_bel.dtype, cam_means)


# ---------------------------------------------------------------------------
# initialisation and the scheduled iteration
# ---------------------------------------------------------------------------

@trace.spanned("gbp.initialise")
def initialise(state: GBPState, graph: GBPGraph, cfg: GBPConfig,
               group=None, lmk_sharded: bool = False) -> GBPState:
    """Beliefs <- priors (+ current messages), then linearise every
    factor."""
    state = update_beliefs(state, graph, cfg, group, lmk_sharded)
    return linearise_all(state, graph, cfg)


def iteration(state: GBPState, graph: GBPGraph, cfg: GBPConfig,
              i: int, group=None, lmk_sharded: bool = False,
              tables=None) -> GBPState:
    """One scheduled iteration: weaken priors on every 2nd iteration
    (flag-gated, so annealing stops after ``steps`` applications), then one
    sweep (``tables``: see ``gbp_sweep``; the annealing leaves the beliefs,
    and so their tables, as they were). As in the JAX package, the sweep's
    prep step sees beliefs one prior refresh stale on those iterations; its
    closing belief update applies the new priors."""
    if (i + 1) % 2 == 0:
        state = _anneal_priors(state, graph, state.cam_weaken > 0,
                               state.lmk_weaken > 0)
    return gbp_sweep(state, graph, cfg, group, lmk_sharded, tables)


# ---------------------------------------------------------------------------
# the fixed-point accelerator
# ---------------------------------------------------------------------------
#
# The JAX package's chunk-boundary extrapolation (gbp_poplar_tpu/core/
# gbp.py, _prior_quad .. _accel_step), its psums at the same places: the
# active degrees, and the costs' edge terms (and landmark prior terms with
# ``lmk_sharded``); the camera means it extrapolates are whole on every
# rank in both sharding modes, so its rate estimate needs none. Every decision
# (alignment, trust region, cost guard) is a torch.where on the device, so
# a chunk boundary adds no host synchronisation. The candidates' data terms
# are priced by H8 (ops/cost_kernel.cost_sums), all K sets in one launch
# that reads each set's means per edge; the message shares ``_apply_shift``
# adds stay a plain index_select per kind, as the JAX package keeps
# jnp.take there.

class CoarseStep(NamedTuple):
    """What one ``_coarse_step`` decided (device tensors)."""

    gain: torch.Tensor        # scale applied: 1.0, 0.3, or 0 (rejected)
    cost_cur: torch.Tensor    # MAP cost the candidates had to beat
    cost_cand: torch.Tensor   # [2] MAP costs at the two scales' means


class AccelStep(NamedTuple):
    """What one ``_accel_step`` decided (0-d device tensors), and the
    coarse step that followed it, if any."""

    gain: torch.Tensor        # extrapolation gain of the candidate jump
    accepted: torch.Tensor    # cost_cand <= cost_cur: the jump was applied
    cost_cur: torch.Tensor    # MAP cost at the current means
    cost_cand: torch.Tensor   # MAP cost at the candidate's means
    coarse: CoarseStep | None = None

    @property
    def cost_kept(self) -> torch.Tensor:
        """The MAP cost of the state the step kept."""
        return torch.where(self.accepted, self.cost_cand, self.cost_cur)


def _prior_quad(lam_planes, eta_planes, mu_planes, d):
    """Gaussian prior quadratic 0.5 mu'Lam mu - eta'mu, summed over finite
    variables (the prior mean's constant cancels in cost comparisons)."""
    lam = pl.unpack_sym(lam_planes, d)
    mu_rows = pl.unpack_vec(mu_planes, d)
    eta_rows = pl.unpack_vec(eta_planes, d)
    lam_mu = pl.matvec(lam, mu_rows)
    val = 0.5 * pl.vdot(mu_rows, lam_mu) - pl.vdot(eta_rows, mu_rows)
    return torch.sum(torch.where(torch.isfinite(val), val, 0.0))


def _cost_parts(state: GBPState, graph: GBPGraph, cfg: GBPConfig, means,
                bad=None):
    """(robust data terms [K], cam prior quads [K], lmk prior quads [K]) of
    the MAP objective at the K <= 3 sets of ``means`` (pairs of belief-mean
    planes [6, C], [3, L]); the data terms by one launch of H8 on a card
    (its plain version on the CPU or with ``kernels="reference"``); edges
    in ``bad`` add no data term."""
    robust = cost_kernel.cost_sums(state, graph, means, cfg.huber_nstds, bad,
                                   reference=cfg.kernels == "reference")
    cam_prior = torch.stack([_prior_quad(state.cam_prior_lam,
                                         state.cam_prior_eta, c, 6)
                             for c, _ in means])
    lmk_prior = torch.stack([_prior_quad(state.lmk_prior_lam,
                                         state.lmk_prior_eta, l, 3)
                             for _, l in means])
    return robust, cam_prior, lmk_prior


def _combine_costs(parts, group=None, lmk_sharded: bool = False):
    """Total ``_cost_parts``' (robust, cam_prior, lmk_prior) into a cost
    vector [K]; with ``group`` the edge terms of every set (and their
    landmark prior terms with ``lmk_sharded``) are summed over the ranks in
    one collective (the camera priors are whole on every rank)."""
    robust, cam_prior, lmk_prior = parts
    if group is not None:
        if lmk_sharded:
            robust, lmk_prior = comm.all_sum(group, [robust, lmk_prior],
                                             torch.float64)
        else:
            robust = comm.all_sum(group, [robust], torch.float64)[0]
    return robust + cam_prior + lmk_prior


def map_cost(state: GBPState, graph: GBPGraph, cfg: GBPConfig,
             bad: torch.Tensor | None = None, group=None,
             lmk_sharded: bool = False):
    """The MAP objective at the current belief means: the sum of whitened
    Huber losses over active edges plus the Gaussian prior quadratic (up to
    the prior mean's constant, which cancels in comparisons). ``bad`` ([E]
    bool) excludes known-bad associations from the data term. With
    ``group`` the data term is summed over the ranks (and the landmark
    prior term too with ``lmk_sharded``; the camera priors are whole on
    every rank)."""
    parts = _cost_parts(state, graph, cfg, [_variable_means(state)], bad)
    return _combine_costs(parts, group, lmk_sharded)[0]


def _active_degrees(state: GBPState, graph: GBPGraph, cfg: GBPConfig,
                    group=None, lmk_sharded: bool = False):
    """Number of active edges incident to each variable ([C], [L]), by the
    deterministic segmented sum (counts of 1.0 are exact in float32), over
    every rank's edges with ``group`` (a landmark's are all on its rank
    with ``lmk_sharded``)."""
    act = (state.active > 0).to(state.cam_bel.dtype)[None]
    ref = cfg.kernels == "reference"
    degc = reduce_kernel.segment_sum(act, graph.cam_seg, reference=ref)[0]
    degl = reduce_kernel.segment_sum(act, graph.lmk_seg, reference=ref)[0]
    if group is not None:
        if lmk_sharded:
            (degc,) = comm.all_sum(group, [degc])
        else:
            degc, degl = comm.all_sum(group, [degc, degl])
    return degc, degl


def _mean_shift_etas(state: GBPState, dc_mu, dl_mu, degs):
    """Belief-eta corrections Lambda_v @ dmu_v realising the mean shift
    (dc_mu [6, C], dl_mu [3, L]) at fixed Lambda; non-finite components
    and variables without active edges carry none."""
    degc, degl = degs
    cam_deta = pl.pack_vec(pl.matvec(pl.unpack_sym(state.cam_lam, 6),
                                     pl.unpack_vec(dc_mu, 6)))
    lmk_deta = pl.pack_vec(pl.matvec(pl.unpack_sym(state.lmk_lam, 3),
                                     pl.unpack_vec(dl_mu, 3)))
    cam_deta = torch.where(torch.isfinite(cam_deta) & (degc > 0)[None],
                           cam_deta, 0.0)
    lmk_deta = torch.where(torch.isfinite(lmk_deta) & (degl > 0)[None],
                           lmk_deta, 0.0)
    return cam_deta, lmk_deta


def _cand_means(state: GBPState, cam_deta, lmk_deta, scale: float):
    """Belief means of the shift candidate (eta + scale * deta at fixed
    Lambda): exactly the means ``_apply_shift`` will give the beliefs."""
    cam = table_kernel.variable_means(
        torch.cat([state.cam_eta + scale * cam_deta, state.cam_lam]), CAM_DOF)
    lmk = table_kernel.variable_means(
        torch.cat([state.lmk_eta + scale * lmk_deta, state.lmk_lam]), LMK_DOF)
    return cam, lmk


def _shift_gather(graph: GBPGraph, dmsg_c, dmsg_l):
    """The per-message eta shares gathered to the edges, as ``_apply_shift``
    adds them: [6, E] and [3, E]."""
    return (dmsg_c.index_select(1, graph.cam_idx),
            dmsg_l.index_select(1, graph.lmk_idx))


def _msg_shares(cam_deta, lmk_deta, degs):
    """Per-message eta-correction shares (deta / active degree)."""
    degc, degl = degs
    cshare = torch.where(degc > 0, 1.0 / torch.clamp_min(degc, 1.0), 0.0)
    lshare = torch.where(degl > 0, 1.0 / torch.clamp_min(degl, 1.0), 0.0)
    return cam_deta * cshare[None], lmk_deta * lshare[None]


def _apply_shift(state: GBPState, dmsg_c, dmsg_l, cam_deta, lmk_deta,
                 gain) -> GBPState:
    """Apply ``gain`` (a 0-d tensor, >= 0) times the shift: the active
    messages' eta rows of the packed state pick up their per-edge shares
    (``dmsg_*``, gathered), the belief etas the full correction, so the
    next sweep reads the shifted beliefs and its reduction re-establishes
    belief = prior + sum(messages). ``gain`` 0 is an exact no-op."""
    act = (state.active > 0).to(cam_deta.dtype)[None]
    live = gain > 0

    def upd(old, d):
        return torch.where(live, old + gain * d, old)

    state.msg_c_eta.copy_(upd(state.msg_c_eta, act * dmsg_c))
    state.msg_l_eta.copy_(upd(state.msg_l_eta, act * dmsg_l))
    state.cam_bel = torch.cat([upd(state.cam_eta, cam_deta), state.cam_lam])
    state.lmk_bel = torch.cat([upd(state.lmk_eta, lmk_deta), state.lmk_lam])
    return state


def _accel_math(state: GBPState, snap, avg, graph: GBPGraph,
                cfg: GBPConfig, degs, group=None, lmk_sharded: bool = False):
    """One fixed-point extrapolation at a chunk boundary (the JAX
    package's ``_accel_step``; its docstring gives the reasoning).

    Successive chunk-averaged mean displacements d_k contract as
    d_k ~ r d_{k-1}; where they are aligned (cos^2 > 0.8, r > 0.1) the
    means jump by gain * d_k, gain = r / (1 - r) with r clipped to
    ``accel_max_rate`` and the jump capped at ``accel_max_step`` per
    camera. The jump is realised on the eta state (``_apply_shift``) and
    accepted only if the MAP cost at the candidate's exact means does not
    exceed the current one.

    ``snap`` = (avg_cam_prev, avg_lmk_prev, cam_dmu_prev), ``avg`` = this
    chunk's averaged (avg_cam, avg_lmk). Returns (state, next snap,
    AccelStep); the JAX function's third result, the cost of the state
    kept, is ``cost_cand`` where ``accepted``, else ``cost_cur``."""
    cam_mu_prev, lmk_mu_prev, dmu_prev = snap
    avg_cam, avg_lmk = avg
    dc_mu = avg_cam - cam_mu_prev
    dl_mu = avg_lmk - lmk_mu_prev
    # weakly constrained landmarks can have transiently singular beliefs;
    # never extrapolate a non-finite row
    dl_mu = torch.where(torch.isfinite(dl_mu), dl_mu, 0.0)

    num = torch.sum(dc_mu * dmu_prev)
    den = torch.sum(dmu_prev * dmu_prev)
    cur = torch.sum(dc_mu * dc_mu)
    safe_den = torch.where(den > 0, den, 1.0)
    r = torch.where(den > 0, num / safe_den, 0.0)
    cos2 = torch.where((den > 0) & (cur > 0),
                       (num * num) / (safe_den * torch.where(cur > 0, cur,
                                                             1.0)),
                       0.0)
    aligned = (cos2 > 0.8) & (r > 0.1) & torch.isfinite(dc_mu).all()
    r = torch.clamp(r, 0.0, cfg.accel_max_rate)
    gain = torch.where(aligned, r / (1.0 - r), 0.0)
    # trust region: no camera mean moves more than accel_max_step
    step = gain * torch.sqrt(torch.max(torch.sum(dc_mu * dc_mu, dim=0)))
    gain = gain * torch.clamp_max(
        cfg.accel_max_step / torch.clamp_min(step, 1e-30), 1.0)

    cam_deta, lmk_deta = _mean_shift_etas(state, gain * dc_mu, gain * dl_mu,
                                          degs)
    dmsg_c, dmsg_l = _msg_shares(cam_deta, lmk_deta, degs)
    cam_mu, lmk_mu = _variable_means(state)
    cand = _cand_means(state, cam_deta, lmk_deta, 1.0)
    cost_cur, cost_cand = _combine_costs(
        _cost_parts(state, graph, cfg, [(cam_mu, lmk_mu), cand]), group,
        lmk_sharded)
    better = cost_cand <= cost_cur
    state = _apply_shift(state, *_shift_gather(graph, dmsg_c, dmsg_l),
                         cam_deta, lmk_deta, better.to(cam_mu.dtype))

    # the next chunk's displacement is measured from the accepted state's
    # frame: shift the stored averages by the applied jump
    jump_c = torch.where(better, gain * dc_mu, 0.0)
    jump_l = torch.where(better, gain * dl_mu, 0.0)
    snap = (avg_cam + jump_c, avg_lmk + jump_l, dc_mu)
    return state, snap, AccelStep(gain, better, cost_cur, cost_cand)


def _step_inputs(state: GBPState, snap, avg, degs) -> tuple:
    """What ``_accel_math`` reads that is reallocated between chunk
    boundaries, in ``_AccelGraph``'s order: the beliefs, the priors (the
    annealing replaces them), the snap, the chunk's averaged means and the
    active degrees."""
    return (state.cam_bel, state.lmk_bel, state.cam_prior, state.lmk_prior,
            *snap, *avg, *degs)


def _accel_key(state: GBPState, snap, avg, graph: GBPGraph, cfg: GBPConfig,
               degs):
    """(baked, sig): the tensors a captured step reads in place, and what
    else it was captured for (its inputs' shapes, dtypes and devices, the
    baked tensors' shapes, the config numbers and the intrinsics it
    reads)."""
    baked = (state.pk, state.active, graph.cam_idx, graph.lmk_idx,
             graph.meas, graph.meas_var, graph.intr)
    sig = (tuple((t.shape, t.dtype, t.device)
                 for t in _step_inputs(state, snap, avg, degs)),
           tuple(None if t is None else t.shape for t in baked),
           cfg.accel_max_rate, cfg.accel_max_step, cfg.huber_nstds,
           tuple(float(x) for x in graph.k.ravel()))
    return baked, sig


# ---------------------------------------------------------------------------
# captured steps
# ---------------------------------------------------------------------------
#
# On a card, with the kernels and without ``group`` (``_capturable``), a
# step that makes no host decision is captured once per state as one CUDA
# graph and replayed: the accelerator step (``_AccelGraph``) and each
# anneal-free run of sweeps of ``run_gbp`` (``_SweepGraph``). A step's
# first call on a state runs eagerly (the warm-up: every kernel loaded,
# its launch attributes set), the second is captured and replayed, and
# each later one is a replay; a call whose key differs from the held
# graph's runs eagerly and drops it, and the next recaptures. Both share
# ``_Captured``: the key match, the state's pool and stream, the input
# copies and the launch counts.

# device -> (the graph that keeps a memory pool open, the pool's capture
# stream, a weak reference to the ``_GraphPool`` that captured into it
# last); see ``_GraphPool``
_POOLS = {}

# the kernel wrappers that count their launches (``fn.launches``)
_COUNTED = (sweep_kernel.sweep, sweep_kernel.sweep_planes,
            table_kernel.build_tables, reduce_kernel.segment_sum,
            reduce_kernel.gather, diag_kernel.edge_sums,
            coarse_kernel.coarse_edge_blocks, cost_kernel.cost_sums)


def _capturable(state: GBPState, cfg: GBPConfig, group) -> bool:
    """Whether the state's steps may be captured: on a card, with the
    kernels and without a process group (the sharded solvers)."""
    return (group is None and cfg.kernels != "reference"
            and state.pk.device.type == "cuda")


class _GraphPool:
    """The memory pool and capture stream that one state's captured steps
    share: the device's shared pool and its stream when no other state's
    steps use them, so that a freed state's graphs' memory serves the next
    state's captures instead of staying cached beside it (the allocator
    reuses a pool's free blocks on their own stream only, and returns a
    freed graph's own pool only when memory runs short); else a stream and
    a pool of the state's own. Two states' graphs must not share one: a
    replay's temporaries may lie where another state's beliefs do. One
    state's graphs may, since each replay reads the state's inputs from
    buffers of its own, allocated outside the pool, and whatever it hands
    out from the pool is read or replaced before the state's next
    replay."""

    def __init__(self, dev):
        keeper, stream, user = _POOLS.get(dev, (None, None, None))
        if keeper is None:
            # a graph of one fill, never replayed: while it lives the pool
            # stays open to later captures
            stream, keeper = torch.cuda.Stream(dev), torch.cuda.CUDAGraph()
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                keeper.capture_begin()
                try:
                    torch.zeros(1, device=dev)
                finally:
                    keeper.capture_end()
        elif user() is not None:
            self.stream = torch.cuda.Stream(dev)
            self.handle = torch.cuda.graph_pool_handle()
            return
        _POOLS[dev] = keeper, stream, weakref.ref(self)
        self.stream, self.handle = stream, keeper.pool()


class _Captured:
    """One step captured as one CUDA graph for one state, held by the state
    and freed with it (it holds no reference to the state, so no cycle
    outlives it). The graph reads in place the tensors of its key's
    ``baked``, held by weak reference, and the step's other inputs are
    copied into buffers of its own before each replay. It is captured and
    replayed on the stream of its state's ``_GraphPool``. Each replay adds
    the captured launches to the kernel wrappers' ``launches`` counts, as
    the eager step's calls do."""

    def __init__(self, key):
        baked, self.sig = key
        self.refs = tuple(None if t is None else weakref.ref(t)
                          for t in baked)
        self.graph = None

    def matches(self, key) -> bool:
        baked, sig = key
        return sig == self.sig and all(
            t is None if r is None else r() is t
            for r, t in zip(self.refs, baked))

    def _claim(self, state: GBPState) -> torch.cuda.Stream:
        """Join the pool of the state's other captured steps, or take one;
        returns its stream."""
        held = (state.accel_graph, *(state.sweep_graphs or {}).values())
        self.pool = next((g.pool for g in held if g is not None
                          and g is not self and g.graph is not None), None)
        if self.pool is None:
            self.pool = _GraphPool(state.pk.device)
        return self.pool.stream

    def _record(self, inputs, body):
        """Record ``body(*buffers)`` on buffers of the ``inputs``' shapes
        (capture executes nothing; ``_replay`` runs it) and return what it
        returns: the graph's outputs."""
        self.ins = [torch.empty_like(t) for t in inputs]
        stream = self.pool.stream
        # by hand: ``torch.cuda.graph`` drains the device and empties the
        # whole cache before each capture
        cuda_graph = torch.cuda.CUDAGraph()
        before = [fn.launches for fn in _COUNTED]
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        with torch.cuda.stream(stream):
            cuda_graph.capture_begin(self.pool.handle)
            try:
                out = body(*self.ins)
            finally:
                cuda_graph.capture_end()
        # the capture launched nothing: its wrappers' counts are each
        # replay's
        self.launches = [fn.launches - n for fn, n in zip(_COUNTED, before)]
        for fn, n in zip(_COUNTED, self.launches):
            fn.launches -= n
        self.graph = cuda_graph
        return out

    def _replay(self, inputs) -> None:
        """Copy ``inputs`` in (those that are not already its buffers) and
        replay the graph."""
        for buf, t in zip(self.ins, inputs):
            if buf is not t:
                buf.copy_(t)
        stream = self.pool.stream
        cur = torch.cuda.current_stream(stream.device)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            self.graph.replay()
        cur.wait_stream(stream)
        for fn, n in zip(_COUNTED, self.launches):
            fn.launches += n


class _AccelGraph(_Captured):
    """``_accel_math`` captured for one state, held as
    ``state.accel_graph``. It reads ``_accel_key``'s ``baked`` in place
    (the packed edge state, whose message rows the step shifts in place,
    the active flags, the graph's edge tensors) and copies
    ``_step_inputs`` in. Its outputs are handed over, not copied: the
    beliefs to the state (the next sweep replaces them; a caller that
    keeps ``state.cam_bel`` past the next step clones it), and clones of
    the snap and of the four scalars (one launch) to the caller, so
    nothing the caller keeps is overwritten by the next replay. The H8
    launch inside uses its stream's scratch, reserved before the capture
    and held here, so it serves launches on one stream, one after
    another, each leaving its ticket at 0."""

    def capture(self, state: GBPState, snap, avg, graph: GBPGraph,
                cfg: GBPConfig, degs) -> None:
        """Record ``_accel_math`` for replays from these inputs' shapes."""
        stream = self._claim(state)
        self.scratch = cost_kernel.scratch(state.pk.device,
                                           stream.cuda_stream, graph.n_edges)

        def body(cam_bel, lmk_bel, cam_prior, lmk_prior, *rest):
            proxy = dataclasses.replace(state, cam_bel=cam_bel,
                                        lmk_bel=lmk_bel, cam_prior=cam_prior,
                                        lmk_prior=lmk_prior)
            proxy, snap, info = _accel_math(proxy, tuple(rest[:3]),
                                            tuple(rest[3:5]), graph, cfg,
                                            tuple(rest[5:]))
            # the four scalars as bytes in one buffer, the flag last so
            # that each number lies at a multiple of its size
            fields = (info.gain, info.cost_cur, info.cost_cand,
                      info.accepted)
            packed = torch.cat([t.reshape(1).view(torch.uint8)
                                for t in fields])
            return proxy, snap, fields, packed

        proxy, self.snap, fields, self.info = self._record(
            _step_inputs(state, snap, avg, degs), body)
        self.bel = (proxy.cam_bel, proxy.lmk_bel)
        self.layout = [(t.dtype, t.element_size()) for t in fields]

    def replay(self, state: GBPState, snap, avg, degs):
        """``_accel_math(state, snap, avg, ...)`` as one replay; the same
        results to the bit."""
        self._replay(_step_inputs(state, snap, avg, degs))
        state.cam_bel, state.lmk_bel = self.bel
        info, at, fields = self.info.clone(), 0, []
        for dtype, n in self.layout:
            fields.append(info[at:at + n].view(dtype)[0])
            at += n
        gain, cost_cur, cost_cand, accepted = fields
        return (state, tuple(t.clone() for t in self.snap),
                AccelStep(gain, accepted, cost_cur, cost_cand))


@trace.spanned("gbp.accel_step")
def _accel_step(state: GBPState, snap, avg, graph: GBPGraph,
                cfg: GBPConfig, degs, group=None, lmk_sharded: bool = False):
    """``_accel_math`` (its docstring says what one step does), eagerly or
    as a replay of its CUDA graph (``_AccelGraph``), by the rule of the
    captured steps (above). Spans: ``gbp.accel_eager`` around an eager
    step, ``gbp.accel_capture`` around a capture. Returns (state, next
    snap, AccelStep), to the bit the same either way."""
    if _capturable(state, cfg, group):
        key = _accel_key(state, snap, avg, graph, cfg, degs)
        held = state.accel_graph
        if held is not None and held.matches(key):
            if held.graph is None:
                with trace.span("gbp.accel_capture"):
                    held.capture(state, snap, avg, graph, cfg, degs)
            return held.replay(state, snap, avg, degs)
        state.accel_graph = _AccelGraph(key)
    with trace.span("gbp.accel_eager"):
        return _accel_math(state, snap, avg, graph, cfg, degs, group,
                           lmk_sharded)


@trace.spanned("gbp.coarse_step")
def _coarse_step(state: GBPState, graph: GBPGraph, cfg: GBPConfig, degs,
                 cost: torch.Tensor | None = None, group=None,
                 lmk_sharded: bool = False):
    """Coarse-space correction (core/coarse.py): solve the MAP increment in
    the per-group rigid subspace and apply it at scale 1 or 0.3, whichever
    lowers the MAP cost most below ``cost`` (the caller's cost of
    ``state``, ``AccelStep.cost_kept``; computed here when None), or not
    at all. Both scales are priced at their exact means in one H8 launch
    and the chosen one is applied once (``_apply_shift``). Returns
    (state, CoarseStep)."""
    cam_mu, lmk_mu = _variable_means(state)
    d_cam, d_lmk = coarse.coarse_increment(state, graph, cfg, cam_mu, lmk_mu,
                                           group, lmk_sharded)
    cam_deta, lmk_deta = _mean_shift_etas(state, d_cam, d_lmk, degs)
    dmsg_c, dmsg_l = _msg_shares(cam_deta, lmk_deta, degs)
    scales = (1.0, 0.3)
    cands = [_cand_means(state, cam_deta, lmk_deta, s) for s in scales]
    # price the current means only when the caller did not
    means = ([(cam_mu, lmk_mu)] if cost is None else []) + cands
    costs = _combine_costs(_cost_parts(state, graph, cfg, means), group,
                           lmk_sharded)
    if cost is None:
        cost, costs = costs[0], costs[1:]
    best = cost
    gain = torch.zeros((), dtype=cam_mu.dtype, device=cam_mu.device)
    for s, c in zip(scales, costs):
        better = c < best
        gain = torch.where(better, s, gain)
        best = torch.where(better, c, best)
    state = _apply_shift(state, *_shift_gather(graph, dmsg_c, dmsg_l),
                         cam_deta, lmk_deta, gain)
    return state, CoarseStep(gain, cost, costs)


# ---------------------------------------------------------------------------
# runs of sweeps
# ---------------------------------------------------------------------------

def _sweep_run(s: GBPState, graph: GBPGraph, cfg: GBPConfig, n: int,
               collect: bool, row, tabled: bool, anneal_from=None,
               group=None, lmk_sharded: bool = False):
    """``n`` sweeps (annealed iterations from index ``anneal_from``); after
    sweep j, ``row(s, tables, j)`` (if given) writes its telemetry. With
    ``collect``, also the sum of the post-sweep sanitised means. With
    ``collect`` or ``tabled`` the post-sweep tables are built; they serve
    ``row``, the means and the next sweep of this run, which would build
    the same tables from the same beliefs. Returns (state, sums or
    None)."""
    sums = None
    if collect:
        sums = (torch.zeros_like(s.cam_bel[:CAM_DOF]),
                torch.zeros_like(s.lmk_bel[:LMK_DOF]))
    tables = None
    for j in range(n):
        if anneal_from is not None:
            s = iteration(s, graph, cfg, anneal_from + j, group=group,
                          lmk_sharded=lmk_sharded, tables=tables)
        else:
            s = gbp_sweep(s, graph, cfg, group=group,
                          lmk_sharded=lmk_sharded, tables=tables)
        tables = _tables(s, cfg) if collect or tabled else None
        if row is not None:
            row(s, tables, j)
        if collect:
            mc, ml = _table_means(s, tables)
            sums = (sums[0] + mc, sums[1] + ml)
    return s, sums


def _sweep_inputs(state: GBPState) -> tuple:
    """What a run of sweeps reads that is reallocated between runs, in
    ``_SweepGraph``'s order: the beliefs and the priors (the annealing
    replaces them)."""
    return state.cam_bel, state.lmk_bel, state.cam_prior, state.lmk_prior


def _sweeps_key(state: GBPState, graph: GBPGraph, cfg: GBPConfig, n: int,
                collect: bool, diag: bool):
    """(baked, sig): the tensors a captured run of sweeps reads or writes
    in place (the edge state, the active flags, the graph's edge tensors
    and segments), and what else it was captured for (its inputs' shapes,
    dtypes and devices, the baked tensors' shapes, the config, the
    intrinsics, ``n``, ``collect`` and the telemetry)."""
    baked = (state.pk, state.damping_count, state.robust, state.active,
             graph.cam_idx, graph.lmk_idx, graph.meas, graph.meas_var,
             graph.intr, graph.cam_seg, graph.lmk_seg)
    sig = (tuple((t.shape, t.dtype, t.device) for t in _sweep_inputs(state)),
           tuple(None if t is None else t.shape for t in baked[:9]), cfg,
           tuple(float(x) for x in graph.k.ravel()), n, collect, diag)
    return baked, sig


class _SweepGraph(_Captured):
    """An anneal-free run of ``n`` sweeps (``_sweep_run``) captured for one
    state, held in ``state.sweep_graphs`` under (n, collect). It reads and
    writes ``_sweeps_key``'s ``baked`` in place and copies
    ``_sweep_inputs`` in. With telemetry its own H6 launch
    (``DiagLaunch`` on the capture stream, with its own scratch and
    ticket) writes sweep j's sums into row j of a block of its own, which
    each replay copies into the solve's rows. The graph writes its closing
    beliefs into its input buffers, and a replay hands all four buffers
    to the state, so that the state holds no second copy of its beliefs
    and priors (the next replay from them copies nothing in; a caller that
    keeps ``state.cam_bel`` or ``state.cam_prior`` past the state's next
    run of sweeps clones it). The means' sums go to the caller, which
    reads them before the state's next replay (``run_gbp`` averages them
    at once)."""

    def capture(self, state: GBPState, graph: GBPGraph, cfg: GBPConfig,
                n: int, collect: bool, diag: bool) -> None:
        """Record ``_sweep_run`` for replays from these inputs' shapes."""
        stream = self._claim(state)
        self.rows = self.launch = None
        if diag:
            self.rows = torch.empty((n, len(diag_kernel.SUMS)),
                                    dtype=torch.float64,
                                    device=state.pk.device)
            self.launch = diag_kernel.DiagLaunch(
                state, graph, cfg.num_undamped_iters, self.rows,
                stream=stream.cuda_stream)

        def body(cam_bel, lmk_bel, cam_prior, lmk_prior):
            proxy = dataclasses.replace(state, cam_bel=cam_bel,
                                        lmk_bel=lmk_bel, cam_prior=cam_prior,
                                        lmk_prior=lmk_prior)
            proxy, sums = _sweep_run(proxy, graph, cfg, n, collect,
                                     self.launch, diag)
            cam_bel.copy_(proxy.cam_bel)
            lmk_bel.copy_(proxy.lmk_bel)
            return sums

        self.sums = self._record(_sweep_inputs(state), body)

    def replay(self, state: GBPState, rows, done: int):
        """The run as one replay, its telemetry into ``rows[done:]``; the
        same results to the bit."""
        self._replay(_sweep_inputs(state))
        if self.rows is not None:
            rows[done:done + self.rows.shape[0]].copy_(self.rows)
        state.cam_bel, state.lmk_bel, state.cam_prior, state.lmk_prior = (
            self.ins)
        return state, self.sums


def _sweep_graph(state: GBPState, graph: GBPGraph, cfg: GBPConfig, n: int,
                 collect: bool, diag: bool):
    """The state's ``_SweepGraph`` for this run if it replays (captured,
    or to be captured now), else None: the run's first sight on the state,
    or a key that differs from the held graph's (which is dropped), runs
    eagerly, and the next such run captures."""
    key = _sweeps_key(state, graph, cfg, n, collect, diag)
    if state.sweep_graphs is None:
        state.sweep_graphs = {}
    held = state.sweep_graphs.get((n, collect))
    if held is not None and held.matches(key):
        return held
    state.sweep_graphs[(n, collect)] = _SweepGraph(key)
    return None


# ---------------------------------------------------------------------------
# full solves
# ---------------------------------------------------------------------------

@trace.spanned("gbp.run_gbp")
def run_gbp(state: GBPState, graph: GBPGraph, cfg: GBPConfig, n_iters: int,
            with_diagnostics: bool = True, iter_offset: int = 0,
            accel_log: list | None = None, verbose_means: bool = False,
            group=None, lmk_sharded: bool = False):
    """Run ``n_iters`` GBP iterations. Returns (state, Diagnostics of
    [n_iters] tensors, or None without diagnostics). The state is updated
    in place. ``group`` and ``lmk_sharded``: the sharded solvers' rank
    (see ``update_beliefs``); every rank runs the same schedule, since it
    is decided from the integer arguments alone.

    Weaken flags are only set at a solve's iteration 0, so annealing runs
    for the first ``warm = min(n, 2*steps - iter_offset)`` iterations and
    the remaining sweeps skip it.

    With ``cfg.accel_every = ce > 0`` and at least ``2 ce`` anneal-free
    sweeps, those run as chunks of ``ce`` with an ``_accel_step`` after
    each chunk that ends at or after ``cfg.accel_start``, fed the chunk's
    averaged sanitised means; leftover sweeps run after the chunks. Chunks
    that end before ``accel_start`` run as plain sweeps (the JAX package's
    static dead-chunk elision): only the last of them averages its means,
    which seeds the first live step. With ``cfg.coarse_groups > 0`` a
    ``_coarse_step`` follows each live accelerator step, as in the JAX
    package, where the coarse step runs only inside accelerator chunks
    (so with ``accel_every = 0`` it never runs). A chunk the JAX package
    gates under a traced offset keeps its previous displacement and gets
    gain 0 from both steps, so the elided schedule here is the same one.
    ``accel_log``, if given, receives (sweep count at the boundary,
    AccelStep with its ``coarse`` record) per accelerator step.
    ``verbose_means`` also stacks each sweep's camera means into
    ``Diagnostics.cam_means``."""
    # row j: sweep j's five sums (_diag_sums), filled in place on the device
    rows = (torch.empty((n_iters, len(diag_kernel.SUMS)), dtype=torch.float64,
                        device=state.pk.device) if with_diagnostics else None)
    # on a card, H6 set up once for the whole solve: one ctypes call a sweep
    launch = None
    if (with_diagnostics and n_iters and cfg.kernels != "reference"
            and state.pk.device.type != "cpu"):
        launch = diag_kernel.DiagLaunch(state, graph, cfg.num_undamped_iters,
                                        rows)
    cam_means = []
    done = 0
    replayable = _capturable(state, cfg, group) and not verbose_means

    def row(s, tables, j):
        """Sweep j of the current run: its five sums into its row."""
        i = done + j
        if launch is None:
            _diag_sums(s, graph, cfg, out=rows[i], group=group)
        else:
            launch(s, tables, i)
            if group is not None:
                rows[i] = comm.all_sum(group, [rows[i]])[0]
        if verbose_means:
            cam_means.append(_variable_means(s)[0])

    @trace.spanned("gbp.sweeps")
    def sweeps(s, n, collect=False, anneal_from=None):
        """``_sweep_run``: eagerly (span ``gbp.sweeps_eager``), or, when
        anneal-free and ``replayable``, by the rule of the captured steps
        as a replay of its ``_SweepGraph`` (captured inside span
        ``gbp.sweeps_capture``)."""
        nonlocal done
        held = None
        if replayable and anneal_from is None and n:
            held = _sweep_graph(s, graph, cfg, n, collect, with_diagnostics)
        if held is None:
            with trace.span("gbp.sweeps_eager"):
                s, sums = _sweep_run(s, graph, cfg, n, collect,
                                     row if with_diagnostics else None,
                                     launch is not None, anneal_from, group,
                                     lmk_sharded)
        else:
            if held.graph is None:
                with trace.span("gbp.sweeps_capture"):
                    held.capture(s, graph, cfg, n, collect, with_diagnostics)
            s, sums = held.replay(s, rows, done)
        done += n
        return s, sums

    warm = min(n_iters, max(0, 2 * cfg.steps - iter_offset))
    state, _ = sweeps(state, warm, anneal_from=iter_offset)
    n2 = n_iters - warm
    off2 = iter_offset + warm
    ce = cfg.accel_every
    if ce > 0 and n2 >= 2 * ce:
        n_chunks = n2 // ce
        degs = _active_degrees(state, graph, cfg, group=group,
                               lmk_sharded=lmk_sharded)
        n_dead = min(n_chunks,
                     max(0, -(-(cfg.accel_start - ce - off2) // ce)))
        if n_dead:
            state, _ = sweeps(state, (n_dead - 1) * ce)
            state, sums = sweeps(state, ce, collect=True)
            avg_c, avg_l = sums[0] / ce, sums[1] / ce
            snap = (avg_c, avg_l, torch.zeros_like(avg_c))
        else:
            cam_mu0, lmk_mu0 = _variable_means(state)
            snap = (cam_mu0, lmk_mu0, torch.zeros_like(cam_mu0))
        for c in range(n_dead, n_chunks):
            state, sums = sweeps(state, ce, collect=True)
            state, snap, info = _accel_step(
                state, snap, (sums[0] / ce, sums[1] / ce), graph, cfg, degs,
                group=group, lmk_sharded=lmk_sharded)
            if cfg.coarse_groups > 0:
                state, cinfo = _coarse_step(state, graph, cfg, degs,
                                            cost=info.cost_kept, group=group,
                                            lmk_sharded=lmk_sharded)
                info = info._replace(coarse=cinfo)
            if accel_log is not None:
                accel_log.append((off2 + (c + 1) * ce, info))
        n2 -= n_chunks * ce
    state, _ = sweeps(state, n2)
    if not with_diagnostics or not n_iters:
        return state, None
    return state, _diagnostics_from_sums(
        rows, state.cam_bel.dtype,
        torch.stack(cam_means) if verbose_means else None)


def solve(state: GBPState, graph: GBPGraph, cfg: GBPConfig,
          n_iters: int | None = None, group=None, lmk_sharded: bool = False):
    """Full batch-BA solve: initialise + run_gbp."""
    n = cfg.n_iters if n_iters is None else n_iters
    state = initialise(state, graph, cfg, group, lmk_sharded)
    return run_gbp(state, graph, cfg, n, group=group,
                   lmk_sharded=lmk_sharded)
