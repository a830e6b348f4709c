"""Synchronous Gaussian Belief Propagation — the batch solve.

The PyTorch counterpart of the slice of ``gbp_poplar_tpu/core/gbp.py`` that
the batch bundle-adjustment solve runs without the fixed-point accelerator
and the coarse corrector:

  initialise (beliefs <- priors, linearise every factor)
  run_gbp:   2*steps annealed iterations (prior weakening, then a sweep),
             then anneal-free sweeps; diagnostics after every sweep.

One sweep is three kernels (each with its plain PyTorch version, chosen by
the tensors' device and ``cfg.kernels``):
  1. ops/table_kernel.build_table: per-variable belief tables with the
     pre-solved means and a validity flag (cameras and landmarks);
  2. ops/sweep_kernel.sweep: the per-edge state machine and messages
     (``edge_math``), in place on the packed edge state;
  3. ops/reduce_kernel.segment_sum: beliefs = priors + message sums.

All per-edge state is in plane layout ([component, E] tensors, see
ops/planes.py). PyTorch runs eagerly: the loop over sweeps is a Python
loop, and diagnostics stay on the device until the solve returns.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import GBPConfig
from ..ops import planes as pl
from ..ops import reduce_kernel, sweep_kernel, table_kernel
from .factor_graph import (CAM_DOF, LMK_DOF, MSG_CAM_ROWS, MSG_LMK_ROWS,
                           GBPGraph, GBPState)


def _variable_means(state: GBPState) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve belief means per variable: cam_mu [6, C], lmk_mu [3, L]."""
    return (table_kernel.variable_means(state.cam_bel, CAM_DOF),
            table_kernel.variable_means(state.lmk_bel, LMK_DOF))


# ---------------------------------------------------------------------------
# belief update
# ---------------------------------------------------------------------------

def update_beliefs(state: GBPState, graph: GBPGraph,
                   cfg: GBPConfig) -> GBPState:
    """belief = prior + sum of incoming messages, one segmented sum per
    variable kind over the message rows of the packed edge state."""
    ref = cfg.kernels == "reference"
    state.cam_bel = reduce_kernel.segment_sum(
        state.pk[MSG_CAM_ROWS[0]:MSG_CAM_ROWS[1]], graph.cam_seg,
        state.cam_prior, reference=ref)
    state.lmk_bel = reduce_kernel.segment_sum(
        state.pk[MSG_LMK_ROWS[0]:MSG_LMK_ROWS[1]], graph.lmk_seg,
        state.lmk_prior, reference=ref)
    return state


# ---------------------------------------------------------------------------
# relinearisation
# ---------------------------------------------------------------------------

def _linearise_planes(state: GBPState, graph: GBPGraph, cfg: GBPConfig):
    """Relinearise every factor at the current belief means. Returns
    (packed potentials..., robust [E], mu [9, E])."""
    cam_mu, lmk_mu = _variable_means(state)
    mu_c = cam_mu.index_select(1, graph.cam_idx)
    mu_l = lmk_mu.index_select(1, graph.lmk_idx)
    eta_c, eta_l, lam_cc, lam_cl, lam_ll, robust, _ = pl.linearise(
        pl.unpack_vec(mu_c, 6), pl.unpack_vec(mu_l, 3), graph.k,
        graph.meas[0], graph.meas[1], graph.meas_var, cfg.huber_nstds,
        None if graph.intr is None else pl.unpack_vec(graph.intr, 3))
    return (pl.pack_vec(eta_c), pl.pack_vec(eta_l), pl.pack_sym(lam_cc, 6),
            pl.pack_full(lam_cl), pl.pack_sym(lam_ll, 3), robust,
            torch.cat([mu_c, mu_l]))


def linearise_all(state: GBPState, graph: GBPGraph,
                  cfg: GBPConfig) -> GBPState:
    """Unconditionally relinearise every factor at the current means."""
    f_eta_c, f_eta_l, f_lam_cc, f_lam_cl, f_lam_ll, robust, mu = (
        _linearise_planes(state, graph, cfg))
    state.f_eta_c.copy_(f_eta_c)
    state.f_eta_l.copy_(f_eta_l)
    state.f_lam_cc.copy_(f_lam_cc)
    state.f_lam_cl.copy_(f_lam_cl)
    state.f_lam_ll.copy_(f_lam_ll)
    state.lin_mu.copy_(mu)
    state.robust.copy_(robust)
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


# ---------------------------------------------------------------------------
# one synchronous GBP sweep
# ---------------------------------------------------------------------------

def edge_math(
    bc, bl, meas, meas_var,
    f_eta_c0, f_eta_l0, f_lam_cc0, f_lam_cl0, f_lam_ll0,
    msg_c_eta0, msg_c_lam0, msg_l_eta0, msg_l_lam0,
    damping0, damping_count0, mu0, lin_mu0, robust0, active_i,
    k, cfg: GBPConfig, premu, intr=None,
):
    """The complete per-edge GBP sweep body on plane tensors: the damping
    and relinearisation state machine, then the factor-to-variable messages.

    The same function as ``gbp_poplar_tpu.core.gbp.edge_math``, operation
    for operation, on [E] rows, with the pre-solved means as both fused
    TPU wrappers run it. ``bc`` [27, E] / ``bl`` [9, E] are the gathered
    beliefs (eta | packed Lambda); ``premu`` (10 planes: mu_c[6] | mu_l[3]
    | valid[1]) the adjacent means solved once per variable, zeroed with
    valid = 0 where a belief's mean is not finite. Returns the 14
    fields f_eta_c, f_eta_l, f_lam_cc, f_lam_cl, f_lam_ll, msg_c_eta,
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

    mu = premu[:9]
    valid = premu[9] > 0.5

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
    mu_ok = valid & torch.isfinite(dmu2)

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


def gbp_sweep(state: GBPState, graph: GBPGraph, cfg: GBPConfig) -> GBPState:
    """One synchronous sweep: belief tables, the per-edge sweep (in place),
    then the belief update."""
    ref = cfg.kernels == "reference"
    cam_tbl = table_kernel.build_table(state.cam_bel, CAM_DOF, reference=ref)
    lmk_tbl = table_kernel.build_table(state.lmk_bel, LMK_DOF, reference=ref)
    sweep_kernel.sweep(state, graph, cam_tbl, lmk_tbl, cfg, reference=ref)
    return update_beliefs(state, graph, cfg)


# ---------------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------------

class Diagnostics(NamedTuple):
    reproj_err: torch.Tensor   # mean residual norm over valid active edges
    cost: torch.Tensor         # 0.5 * sum ||r||^2
    n_relins: torch.Tensor     # edges that just relinearised
    n_robust: torch.Tensor     # edges with Huber active


def reprojection_error(state: GBPState, graph: GBPGraph):
    """Mean reprojection residual norm and total cost over active edges
    whose residual is finite; NaN (not 0) when no edge is valid."""
    cam_mu, lmk_mu = _variable_means(state)
    mu_c = cam_mu.index_select(1, graph.cam_idx)
    mu_l = lmk_mu.index_select(1, graph.lmk_idx)
    (u, v), _, _ = pl.project(
        pl.unpack_vec(mu_c, 6), pl.unpack_vec(mu_l, 3), graph.k,
        None if graph.intr is None else pl.unpack_vec(graph.intr, 3))
    ru = graph.meas[0] - u
    rv = graph.meas[1] - v
    norm = torch.sqrt(ru * ru + rv * rv)
    valid = (state.active > 0) & torch.isfinite(norm)
    norm = torch.where(valid, norm, 0.0)
    n_active = torch.sum(valid.to(norm.dtype))
    sum_norm = torch.sum(norm)
    cost = 0.5 * torch.sum(norm * norm)
    mean_err = torch.where(n_active > 0,
                           sum_norm / torch.clamp_min(n_active, 1.0),
                           torch.nan)
    return mean_err, cost


def diagnostics(state: GBPState, graph: GBPGraph,
                cfg: GBPConfig) -> Diagnostics:
    err, cost = reprojection_error(state, graph)
    act = state.active > 0
    n_relins = torch.sum(
        (state.damping_count == -cfg.num_undamped_iters) & act)
    n_robust = torch.sum(state.robust & act)
    return Diagnostics(err, cost, n_relins, n_robust)


# ---------------------------------------------------------------------------
# full solves
# ---------------------------------------------------------------------------

def initialise(state: GBPState, graph: GBPGraph, cfg: GBPConfig) -> GBPState:
    """Beliefs <- priors (+ current messages), then linearise every
    factor."""
    state = update_beliefs(state, graph, cfg)
    return linearise_all(state, graph, cfg)


def iteration(state: GBPState, graph: GBPGraph, cfg: GBPConfig,
              i: int) -> GBPState:
    """One scheduled iteration: weaken priors on every 2nd iteration
    (flag-gated, so annealing stops after ``steps`` applications), then one
    sweep. As in the JAX package, the sweep's prep step sees beliefs one
    prior refresh stale on those iterations; its closing belief update
    applies the new priors."""
    if (i + 1) % 2 == 0:
        state = _anneal_priors(state, graph, state.cam_weaken > 0,
                               state.lmk_weaken > 0)
    return gbp_sweep(state, graph, cfg)


def run_gbp(state: GBPState, graph: GBPGraph, cfg: GBPConfig, n_iters: int,
            with_diagnostics: bool = True, iter_offset: int = 0):
    """Run ``n_iters`` GBP iterations. Returns (state, Diagnostics of
    [n_iters] tensors, or None without diagnostics). The state is updated
    in place.

    Weaken flags are only set at a solve's iteration 0, so annealing runs
    for the first ``warm = min(n, 2*steps - iter_offset)`` iterations and
    the remaining sweeps skip it.

    The fixed-point accelerator (``accel_every > 0``) and the coarse
    corrector (``coarse_groups > 0``) are not ported yet: they raise
    NotImplementedError rather than run a different schedule."""
    if cfg.accel_every > 0 or cfg.coarse_groups > 0:
        raise NotImplementedError(
            "the fixed-point accelerator and the coarse corrector are not "
            "ported yet (ROADMAP.md, A6): use accel_every=0 and "
            f"coarse_groups=0 (got accel_every={cfg.accel_every}, "
            f"coarse_groups={cfg.coarse_groups})")
    warm = min(n_iters, max(0, 2 * cfg.steps - iter_offset))
    diags = []
    for i in range(n_iters):
        if i < warm:
            state = iteration(state, graph, cfg, i + iter_offset)
        else:
            state = gbp_sweep(state, graph, cfg)
        if with_diagnostics:
            diags.append(diagnostics(state, graph, cfg))
    if not with_diagnostics or not diags:
        return state, None
    return state, Diagnostics(*(torch.stack(x) for x in zip(*diags)))


def solve(state: GBPState, graph: GBPGraph, cfg: GBPConfig,
          n_iters: int | None = None):
    """Full batch-BA solve: initialise + run_gbp."""
    n = cfg.n_iters if n_iters is None else n_iters
    state = initialise(state, graph, cfg)
    return run_gbp(state, graph, cfg, n)
