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
    1. ops/table_kernel.build_table: per-variable belief tables with the
       pre-solved means and a validity flag (cameras and landmarks);
    2. ops/sweep_kernel.sweep: the per-edge state machine and messages
       (``edge_math``), in place on the packed edge state;
  unfused (the JAX package's pipeline on graphs without fused windows):
    1. ops/reduce_kernel.gather: the beliefs gathered per edge;
    2. ops/sweep_kernel.sweep_planes: ``edge_math`` with the means solved
       per edge, in place on the packed edge state;
  and then, for both:
    3. ops/reduce_kernel.segment_sum: beliefs = priors + message sums.

All per-edge state is in plane layout ([component, E] tensors, see
ops/planes.py). PyTorch runs eagerly: the loop over sweeps is a Python
loop, and diagnostics and the accelerator's decisions stay on the device
until the solve returns.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import GBPConfig
from ..ops import planes as pl
from ..ops import reduce_kernel, sweep_kernel, table_kernel
from . import coarse
from .factor_graph import (CAM_DOF, LMK_DOF, MSG_CAM_ROWS, MSG_LMK_ROWS,
                           GBPGraph, GBPState)


def _variable_means(state: GBPState) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve belief means per variable: cam_mu [6, C], lmk_mu [3, L]."""
    return (table_kernel.variable_means(state.cam_bel, CAM_DOF),
            table_kernel.variable_means(state.lmk_bel, LMK_DOF))


def _sanitized_means(state: GBPState, cfg: GBPConfig):
    """Belief means per variable, each column zeroed whole where any
    component is not finite: the JAX package's
    ``_sanitize_means(*_variable_means(state))``, read from the belief
    tables (ops/table_kernel.build_table) that hold exactly that."""
    ref = cfg.kernels == "reference"
    out = []
    for bel, d in ((state.cam_bel, CAM_DOF), (state.lmk_bel, LMK_DOF)):
        tbl = table_kernel.build_table(bel, d, reference=ref)
        comp = bel.shape[0]
        out.append(tbl[:, comp:comp + d].T)
    return out


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


def gbp_sweep(state: GBPState, graph: GBPGraph, cfg: GBPConfig) -> GBPState:
    """One synchronous sweep, in place on the edge state, then the belief
    update. ``cfg.fused``: belief tables and the fused per-edge sweep;
    otherwise the beliefs gathered per edge and the unfused sweep."""
    ref = cfg.kernels == "reference"
    if cfg.fused:
        cam_tbl = table_kernel.build_table(state.cam_bel, CAM_DOF,
                                           reference=ref)
        lmk_tbl = table_kernel.build_table(state.lmk_bel, LMK_DOF,
                                           reference=ref)
        sweep_kernel.sweep(state, graph, cam_tbl, lmk_tbl, cfg, reference=ref)
    else:
        bc = reduce_kernel.gather(state.cam_bel, graph.cam_idx, reference=ref)
        bl = reduce_kernel.gather(state.lmk_bel, graph.lmk_idx, reference=ref)
        sweep_kernel.sweep_planes(state, graph, bc, bl, cfg, reference=ref)
    return update_beliefs(state, graph, cfg)


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


def diagnostics(state: GBPState, graph: GBPGraph, cfg: GBPConfig,
                with_cam_means: bool = False) -> Diagnostics:
    err, cost = reprojection_error(state, graph)
    act = state.active > 0
    n_relins = torch.sum(
        (state.damping_count == -cfg.num_undamped_iters) & act)
    n_robust = torch.sum(state.robust & act)
    cam_means = _variable_means(state)[0] if with_cam_means else None
    return Diagnostics(err, cost, n_relins, n_robust, cam_means)


# ---------------------------------------------------------------------------
# initialisation and the scheduled iteration
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


# ---------------------------------------------------------------------------
# the fixed-point accelerator (single device)
# ---------------------------------------------------------------------------
#
# The JAX package's chunk-boundary extrapolation (gbp_poplar_tpu/core/
# gbp.py, _prior_quad .. _accel_step), without its psums. Every decision
# (alignment, trust region, cost guard) is a torch.where on the device, so
# a chunk boundary adds no host synchronisation. The per-edge gathers stay
# plain index_select, as the JAX package keeps jnp.take there.

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


def _cost_parts(state: GBPState, graph: GBPGraph, cfg: GBPConfig,
                mu_c_e, mu_l_e, cam_mu, lmk_mu):
    """(robust data term, cam prior quad, lmk prior quad) of the MAP
    objective at the given means, the per-edge means already gathered."""
    (u, v), _, _ = pl.project(
        pl.unpack_vec(mu_c_e, 6), pl.unpack_vec(mu_l_e, 3), graph.k,
        None if graph.intr is None else pl.unpack_vec(graph.intr, 3))
    ru = graph.meas[0] - u
    rv = graph.meas[1] - v
    err2 = (ru * ru + rv * rv) / graph.meas_var
    err = torch.sqrt(err2)
    k = cfg.huber_nstds
    loss = torch.where(err > k, k * err - 0.5 * k * k, 0.5 * err2)
    ok = (state.active > 0) & torch.isfinite(loss)
    robust = torch.sum(torch.where(ok, loss, 0.0))
    cam_prior = _prior_quad(state.cam_prior_lam, state.cam_prior_eta,
                            cam_mu, 6)
    lmk_prior = _prior_quad(state.lmk_prior_lam, state.lmk_prior_eta,
                            lmk_mu, 3)
    return robust, cam_prior, lmk_prior


def map_cost(state: GBPState, graph: GBPGraph, cfg: GBPConfig):
    """The MAP objective at the current belief means: the sum of whitened
    Huber losses over active edges plus the Gaussian prior quadratic (up to
    the prior mean's constant, which cancels in comparisons)."""
    cam_mu, lmk_mu = _variable_means(state)
    mu_c = cam_mu.index_select(1, graph.cam_idx)
    mu_l = lmk_mu.index_select(1, graph.lmk_idx)
    robust, cam_prior, lmk_prior = _cost_parts(
        state, graph, cfg, mu_c, mu_l, cam_mu, lmk_mu)
    return robust + cam_prior + lmk_prior


def _active_degrees(state: GBPState, graph: GBPGraph, cfg: GBPConfig):
    """Number of active edges incident to each variable ([C], [L]), by the
    deterministic segmented sum (counts of 1.0 are exact in float32)."""
    act = (state.active > 0).to(state.cam_bel.dtype)[None]
    ref = cfg.kernels == "reference"
    return (reduce_kernel.segment_sum(act, graph.cam_seg, reference=ref)[0],
            reduce_kernel.segment_sum(act, graph.lmk_seg, reference=ref)[0])


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


def _shift_gather(graph: GBPGraph, cam_groups, lmk_groups):
    """One stacked gather per variable kind of the planes a shift trial
    needs per edge (current and candidate means, message shares)."""
    gc = torch.cat(cam_groups).index_select(1, graph.cam_idx)
    gl = torch.cat(lmk_groups).index_select(1, graph.lmk_idx)
    return (gc.split([g.shape[0] for g in cam_groups]),
            gl.split([g.shape[0] for g in lmk_groups]))


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


def _combine_costs(parts):
    """Total each (robust, cam_prior, lmk_prior) triple into a cost vector."""
    robust = torch.stack([p[0] for p in parts])
    cam_prior = torch.stack([p[1] for p in parts])
    lmk_prior = torch.stack([p[2] for p in parts])
    return robust + cam_prior + lmk_prior


def _accel_step(state: GBPState, snap, avg, graph: GBPGraph,
                cfg: GBPConfig, degs):
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
    cand_c, cand_l = _cand_means(state, cam_deta, lmk_deta, 1.0)
    cg, lg = _shift_gather(graph, [cam_mu, cand_c, dmsg_c],
                           [lmk_mu, cand_l, dmsg_l])
    cost_cur, cost_cand = _combine_costs(
        [_cost_parts(state, graph, cfg, cg[0], lg[0], cam_mu, lmk_mu),
         _cost_parts(state, graph, cfg, cg[1], lg[1], cand_c, cand_l)])
    better = cost_cand <= cost_cur
    state = _apply_shift(state, cg[2], lg[2], cam_deta, lmk_deta,
                         better.to(cam_mu.dtype))

    # the next chunk's displacement is measured from the accepted state's
    # frame: shift the stored averages by the applied jump
    jump_c = torch.where(better, gain * dc_mu, 0.0)
    jump_l = torch.where(better, gain * dl_mu, 0.0)
    snap = (avg_cam + jump_c, avg_lmk + jump_l, dc_mu)
    return state, snap, AccelStep(gain, better, cost_cur, cost_cand)


def _coarse_step(state: GBPState, graph: GBPGraph, cfg: GBPConfig, degs,
                 cost: torch.Tensor | None = None):
    """Coarse-space correction (core/coarse.py): solve the MAP increment in
    the per-group rigid subspace and apply it at scale 1 or 0.3, whichever
    lowers the MAP cost most below ``cost`` (the caller's cost of
    ``state``, ``AccelStep.cost_kept``; computed here when None), or not
    at all. Both scales are priced at their exact means from one stacked
    gather and the chosen one is applied once (``_apply_shift``). Returns
    (state, CoarseStep)."""
    cam_mu, lmk_mu = _variable_means(state)
    d_cam, d_lmk = coarse.coarse_increment(state, graph, cfg, cam_mu, lmk_mu)
    cam_deta, lmk_deta = _mean_shift_etas(state, d_cam, d_lmk, degs)
    dmsg_c, dmsg_l = _msg_shares(cam_deta, lmk_deta, degs)
    scales = (1.0, 0.3)
    cands = [_cand_means(state, cam_deta, lmk_deta, s) for s in scales]
    # gather the current means only when the caller did not price them
    mu_groups = int(cost is None)
    cg, lg = _shift_gather(
        graph, [cam_mu] * mu_groups + [c for c, _ in cands] + [dmsg_c],
        [lmk_mu] * mu_groups + [l for _, l in cands] + [dmsg_l])
    parts = []
    if cost is None:
        parts.append(_cost_parts(state, graph, cfg, cg[0], lg[0],
                                 cam_mu, lmk_mu))
    for i, (cand_c, cand_l) in enumerate(cands):
        parts.append(_cost_parts(state, graph, cfg, cg[mu_groups + i],
                                 lg[mu_groups + i], cand_c, cand_l))
    costs = _combine_costs(parts)
    if cost is None:
        cost, costs = costs[0], costs[1:]
    best = cost
    gain = torch.zeros((), dtype=cam_mu.dtype, device=cam_mu.device)
    for s, c in zip(scales, costs):
        better = c < best
        gain = torch.where(better, s, gain)
        best = torch.where(better, c, best)
    state = _apply_shift(state, cg[-1], lg[-1], cam_deta, lmk_deta, gain)
    return state, CoarseStep(gain, cost, costs)


# ---------------------------------------------------------------------------
# full solves
# ---------------------------------------------------------------------------

def run_gbp(state: GBPState, graph: GBPGraph, cfg: GBPConfig, n_iters: int,
            with_diagnostics: bool = True, iter_offset: int = 0,
            accel_log: list | None = None, verbose_means: bool = False):
    """Run ``n_iters`` GBP iterations. Returns (state, Diagnostics of
    [n_iters] tensors, or None without diagnostics). The state is updated
    in place.

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
    diags = []

    def sweeps(s, n, collect=False, anneal_from=None):
        """``n`` sweeps (annealed iterations from index ``anneal_from``);
        with ``collect``, also the sum of the post-sweep sanitised means."""
        sums = None
        if collect:
            sums = (torch.zeros_like(s.cam_bel[:CAM_DOF]),
                    torch.zeros_like(s.lmk_bel[:LMK_DOF]))
        for j in range(n):
            if anneal_from is not None:
                s = iteration(s, graph, cfg, anneal_from + j)
            else:
                s = gbp_sweep(s, graph, cfg)
            if with_diagnostics:
                diags.append(diagnostics(s, graph, cfg, verbose_means))
            if collect:
                mc, ml = _sanitized_means(s, cfg)
                sums = (sums[0] + mc, sums[1] + ml)
        return s, sums

    warm = min(n_iters, max(0, 2 * cfg.steps - iter_offset))
    state, _ = sweeps(state, warm, anneal_from=iter_offset)
    n2 = n_iters - warm
    off2 = iter_offset + warm
    ce = cfg.accel_every
    if ce > 0 and n2 >= 2 * ce:
        n_chunks = n2 // ce
        degs = _active_degrees(state, graph, cfg)
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
                state, snap, (sums[0] / ce, sums[1] / ce), graph, cfg, degs)
            if cfg.coarse_groups > 0:
                state, cinfo = _coarse_step(state, graph, cfg, degs,
                                            cost=info.cost_kept)
                info = info._replace(coarse=cinfo)
            if accel_log is not None:
                accel_log.append((off2 + (c + 1) * ce, info))
        n2 -= n_chunks * ce
    state, _ = sweeps(state, n2)
    if not with_diagnostics or not diags:
        return state, None
    return state, Diagnostics(*(None if x[0] is None else torch.stack(x)
                                for x in zip(*diags)))


def solve(state: GBPState, graph: GBPGraph, cfg: GBPConfig,
          n_iters: int | None = None):
    """Full batch-BA solve: initialise + run_gbp."""
    n = cfg.n_iters if n_iters is None else n_iters
    state = initialise(state, graph, cfg)
    return run_gbp(state, graph, cfg, n)
