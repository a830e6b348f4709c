"""Levenberg-Marquardt / iterative-Schur bundle adjustment (the GN oracle
and the ba driver's ``--polish``).

The PyTorch counterpart of ``gbp_poplar_tpu/core/gauss_newton.py``, on its
plane-major path only (the JAX package's large-E branch, without its edge
chunks): the per-edge normal-equation blocks come from
ops/planes.linearise, the same code the GBP sweep linearises with; the
reduced camera system S = A + P_c - W M^-1 W^T is applied matrix-free
(gathers over cam_idx / lmk_idx and per-variable sums), landmarks are
eliminated per landmark by a closed-form 3x3 inverse, and cameras are
solved by block-Jacobi preconditioned CG with the exact block diagonal of
S. The JAX package's batched [E, d, d] path and its 512k-edge chunks exist
for TPU tile padding and compile limits; on one H100 the whole edge set is
one pass (at 5M edges the cross blocks W are [18, E], 0.36 GB).

Every per-variable sum over edges is the deterministic segmented sum (H3,
ops/reduce_kernel.segment_sum, ``kernels="reference"``: its plain
``index_add_`` version): the LM accept decision is a float32 cost
comparison, and sums in run-dependent order would change it from run to
run. The accept/reject and the damping update stay on the device
(``torch.where``); the LM loop reads nothing back to the host.

GN has no per-edge activity mask: give it the exact edge set
(``edge_pad_multiple=1``, as ``solve_problem`` and the ba driver build it).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..config import GBPConfig
from ..ops import planes as pl
from ..ops import reduce_kernel
from ..ops.linalg import bmv, inv6x6_cholesky_ex
from .factor_graph import GBPGraph


class GNPriors(NamedTuple):
    """Per-variable isotropic Gaussian priors of the MAP objective."""

    cam_lam: torch.Tensor  # [C] precision
    cam_mu: torch.Tensor   # [C, 6]
    lmk_lam: torch.Tensor  # [L] precision
    lmk_mu: torch.Tensor   # [L, 3]


class GNResult(NamedTuple):
    cam: torch.Tensor         # [C, 6] final poses
    lmk: torch.Tensor         # [L, 3] final landmarks
    cost: torch.Tensor        # [n_lm_iters] MAP cost after each iteration
    reproj_err: torch.Tensor  # [n_lm_iters] mean reprojection error (px)
    accepted: torch.Tensor    # [n_lm_iters] bool, LM step accepted
    lm_lambda: torch.Tensor   # final damping


def annealed_priors(graph: GBPGraph, cam_mu0: torch.Tensor,
                    lmk_mu0: torch.Tensor, cam_lam0: torch.Tensor,
                    lmk_lam0: torch.Tensor, cfg: GBPConfig) -> GNPriors:
    """The priors GBP ends with after its annealing schedule: anchor
    keyframes at 1/first_cam_prior_std^2, every other variable weakened by
    prior_std_weaker_factor^2."""
    c = cam_lam0.shape[0]
    anchor = torch.arange(c, device=cam_lam0.device) < cfg.num_anchor_cams
    weak = cfg.prior_std_weaker_factor ** 2
    cam_lam = torch.where(anchor, 1.0 / cfg.first_cam_prior_std ** 2,
                          cam_lam0 / weak)
    return GNPriors(cam_lam=cam_lam, cam_mu=cam_mu0,
                    lmk_lam=lmk_lam0 / weak, lmk_mu=lmk_mu0)


class _NormalEqs(NamedTuple):
    a_c: torch.Tensor        # [C, 6, 6] damped camera blocks
    m_inv6: torch.Tensor     # [6, L] packed symmetric landmark inverses
    w18: torch.Tensor        # [18, E] cross blocks W (6x3 row-major)
    b_c: torch.Tensor        # [C, 6]
    b_l3: torch.Tensor       # [3, L]
    s_diag: torch.Tensor     # [C, 6, 6] exact block diagonal of S
    s_diag_inv: torch.Tensor  # [C, 6, 6] its inverse, the preconditioner


def _sum(rows, seg, ref: bool) -> torch.Tensor:
    """Per-variable sums of a list of [E] rows -> [len(rows), V]."""
    return reduce_kernel.segment_sum(torch.stack(rows), seg, reference=ref)


def _edge_means(camT, lmkT, graph: GBPGraph):
    """Per-edge mean rows (6 camera, 3 landmark) gathered from planes."""
    return (pl.unpack_vec(camT.index_select(1, graph.cam_idx), 6),
            pl.unpack_vec(lmkT.index_select(1, graph.lmk_idx), 3))


def _intr_rows(graph: GBPGraph):
    return None if graph.intr is None else pl.unpack_vec(graph.intr, 3)


def _build_planes(camT, lmkT, graph: GBPGraph, priors: GNPriors,
                  nstds: float, lm_lambda: torch.Tensor,
                  ref: bool) -> _NormalEqs:
    """The damped normal equations at the current means (camT [6, C],
    lmkT [3, L]). The per-edge blocks come from planes.linearise at
    x0 = the current means (eta = J^T W (J x0 + r0)), so the GN right-hand
    side is b = eta - Lambda x0."""
    mu_c, mu_l = _edge_means(camT, lmkT, graph)
    eta_c, eta_l, lam_cc, lam_cl, lam_ll, _, _ = pl.linearise(
        mu_c, mu_l, graph.k, graph.meas[0], graph.meas[1], graph.meas_var,
        nstds, _intr_rows(graph))
    b_c_rows = [eta_c[i]
                - pl.vdot(lam_cc[i], mu_c)
                - pl.vdot(lam_cl[i], mu_l) for i in range(6)]
    b_l_rows = [eta_l[j]
                - pl.vdot([lam_cl[i][j] for i in range(6)], mu_c)
                - pl.vdot(lam_ll[j], mu_l) for j in range(3)]
    cam_sums = _sum([lam_cc[i][j] for (i, j) in pl.SYM6_IDX] + b_c_rows,
                    graph.cam_seg, ref)                         # [27, C]
    lmk_sums = _sum([lam_ll[i][j] for (i, j) in pl.SYM3_IDX] + b_l_rows,
                    graph.lmk_seg, ref)                         # [9, L]
    w18 = torch.stack([lam_cl[i][j] for i in range(6) for j in range(3)])

    # priors and LM damping (additive Marquardt: (1 + lambda) on the
    # diagonal of data + prior), then the landmark blocks inverted in
    # plane form
    damp = 1.0 + lm_lambda
    eye6 = torch.eye(6, dtype=camT.dtype, device=camT.device)
    a_c = (pl.unpack_sym_dense(cam_sums[:21], 6)
           + priors.cam_lam[:, None, None] * eye6)
    a_c = a_c * torch.where(eye6 > 0, damp, 1.0)
    b_c = cam_sums[21:].T + priors.cam_lam[:, None] * (priors.cam_mu
                                                       - camT.T)
    m_l6 = lmk_sums[:6].clone()
    diag3 = [pl.sym_slot(i, i) for i in range(3)]
    m_l6[diag3] = (m_l6[diag3] + priors.lmk_lam[None, :]) * damp
    b_l3 = lmk_sums[6:] + priors.lmk_lam[None, :] * (priors.lmk_mu.T - lmkT)
    m_inv6 = pl.pack_sym(pl.inv_sym3(pl.unpack_sym(m_l6, 3)), 3)

    # the exact block diagonal of S: each (camera, landmark) pair is one
    # edge, so W M^-1 W^T summed per camera is exact
    mv_g = m_inv6.index_select(1, graph.lmk_idx)
    mv = [[mv_g[pl.sym_slot(i, j)] for j in range(3)] for i in range(3)]
    w_m = pl.unpack_full(w18, 6, 3)
    t = pl.matmul(w_m, mv)
    wmw = [pl.vdot(t[i], w_m[j]) for (i, j) in pl.SYM6_IDX]
    s_diag = a_c - pl.unpack_sym_dense(_sum(wmw, graph.cam_seg, ref), 6)
    return _NormalEqs(a_c, m_inv6, w18, b_c, b_l3, s_diag,
                      inv6x6_cholesky_ex(s_diag))


def schur_block_diagonal(cam: torch.Tensor, lmk: torch.Tensor,
                         graph: GBPGraph, priors: GNPriors, cfg: GBPConfig,
                         lm_lambda: float) -> torch.Tensor:
    """The damped reduced camera system's exact block diagonal [C, 6, 6]
    at cam [C, 6], lmk [L, 3] and damping ``lm_lambda``: the blocks whose
    inverses (``inv6x6_cholesky_ex``) precondition ``solve_lm``'s CG."""
    lam = torch.tensor(lm_lambda, dtype=cam.dtype, device=cam.device)
    return _build_planes(cam.T, lmk.T, graph, priors, cfg.huber_nstds, lam,
                         cfg.kernels == "reference").s_diag


def _wt_v_l3(ne: _NormalEqs, graph: GBPGraph, v: torch.Tensor,
             ref: bool) -> torch.Tensor:
    """W^T v summed per landmark -> [3, L] (v: [C, 6])."""
    ve = pl.unpack_vec(v.T.index_select(1, graph.cam_idx), 6)
    w_m = pl.unpack_full(ne.w18, 6, 3)
    rows = [pl.vdot([w_m[i][j] for i in range(6)], ve) for j in range(3)]
    return _sum(rows, graph.lmk_seg, ref)


def _w_z_c6(ne: _NormalEqs, graph: GBPGraph, z3: torch.Tensor,
            ref: bool) -> torch.Tensor:
    """W z summed per camera -> [C, 6] (z3: [3, L])."""
    ze = pl.unpack_vec(z3.index_select(1, graph.lmk_idx), 3)
    rows = pl.matvec(pl.unpack_full(ne.w18, 6, 3), ze)
    return _sum(rows, graph.cam_seg, ref).T


def _minv_apply(ne: _NormalEqs, y3: torch.Tensor) -> torch.Tensor:
    """M^-1 y per landmark, plane form: [3, L] -> [3, L]."""
    return pl.pack_vec(pl.matvec(pl.unpack_sym(ne.m_inv6, 3),
                                 pl.unpack_vec(y3, 3)))


def _schur_matvec_p(ne: _NormalEqs, graph: GBPGraph, v: torch.Tensor,
                    ref: bool) -> torch.Tensor:
    """S v = (A - W M^-1 W^T) v, matrix-free. v: [C, 6]."""
    z3 = _minv_apply(ne, _wt_v_l3(ne, graph, v, ref))
    return bmv(ne.a_c, v) - _w_z_c6(ne, graph, z3, ref)


def _pcg(ne: _NormalEqs, rhs: torch.Tensor, n_iters: int, tol: float,
         matvec) -> torch.Tensor:
    """Block-Jacobi preconditioned CG on the reduced camera system, a fixed
    ``n_iters`` iterations; once the relative residual is below ``tol``
    the step length is 0 (no host check)."""

    def precond(r):
        return bmv(ne.s_diag_inv, r)

    x = torch.zeros_like(rhs)
    r = rhs
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    rhs_norm2 = torch.clamp_min(torch.sum(rhs * rhs), 1e-30)
    for _ in range(n_iters):
        ap = matvec(p)
        pap = torch.sum(p * ap)
        converged = torch.sum(r * r) / rhs_norm2 < tol * tol
        alpha = torch.where(pap > 0, rz / torch.clamp_min(pap, 1e-30), 0.0)
        alpha = torch.where(converged, 0.0, alpha)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = torch.sum(r * z)
        beta = torch.where(rz > 0, rz_new / torch.clamp_min(rz, 1e-30), 0.0)
        p = z + beta * p
        rz = rz_new
    return x


def _residual_sums_planes(camT, lmkT, graph: GBPGraph, nstds: float):
    """(sum of whitened Huber losses, sum of residual norms) over the
    edges, from planes.project (the projection the sweep uses)."""
    mu_c, mu_l = _edge_means(camT, lmkT, graph)
    (u, v), _, _ = pl.project(mu_c, mu_l, graph.k, _intr_rows(graph))
    ru = graph.meas[0] - u
    rv = graph.meas[1] - v
    r2 = ru * ru + rv * rv
    err2 = r2 / graph.meas_var
    err = torch.sqrt(err2)
    loss = torch.where(err > nstds, nstds * err - 0.5 * nstds * nstds,
                       0.5 * err2)
    return torch.sum(loss), torch.sum(torch.sqrt(r2))


def _prior_cost_planes(camT, lmkT, priors: GNPriors) -> torch.Tensor:
    """The Gaussian priors' part of the MAP cost."""
    dc = camT.T - priors.cam_mu
    dl = lmkT - priors.lmk_mu.T
    return 0.5 * (torch.sum(priors.cam_lam[:, None] * dc * dc)
                  + torch.sum(priors.lmk_lam[None, :] * dl * dl))


def _map_cost_planes(camT, lmkT, graph: GBPGraph, priors: GNPriors,
                     nstds: float) -> torch.Tensor:
    loss, _ = _residual_sums_planes(camT, lmkT, graph, nstds)
    return loss + _prior_cost_planes(camT, lmkT, priors)


def map_cost(cam: torch.Tensor, lmk: torch.Tensor, graph: GBPGraph,
             priors: GNPriors, cfg: GBPConfig) -> torch.Tensor:
    """The MAP objective both solvers optimise (whitened Huber losses plus
    the Gaussian priors) at cam [C, 6], lmk [L, 3]."""
    return _map_cost_planes(cam.T, lmk.T, graph, priors, cfg.huber_nstds)


def solve_lm(cam0: torch.Tensor, lmk0: torch.Tensor, graph: GBPGraph,
             priors: GNPriors, cfg: GBPConfig, n_lm_iters: int = 30,
             cg_iters: int = 50, cg_tol: float = 1e-6,
             lambda0: float = 1e-4) -> GNResult:
    """Levenberg-Marquardt with iterative-Schur steps from (cam0 [C, 6],
    lmk0 [L, 3]). A step is accepted when it lowers the MAP cost; the
    damping falls by 3 on acceptance and grows by 5 otherwise. The cold
    start from the prior means is float32-sensitive on hard problems;
    warm starts (polishing a GBP solution) are robust."""
    nstds = cfg.huber_nstds
    ref = cfg.kernels == "reference"
    n_edges = graph.cam_idx.shape[0]
    cam = cam0
    lmkT = lmk0.T
    lm_lambda = torch.tensor(lambda0, dtype=cam0.dtype, device=cam0.device)
    cost = _map_cost_planes(cam.T, lmkT, graph, priors, nstds)
    ys = []
    for _ in range(n_lm_iters):
        ne = _build_planes(cam.T, lmkT, graph, priors, nstds, lm_lambda,
                           ref)
        rhs = ne.b_c - _w_z_c6(ne, graph, _minv_apply(ne, ne.b_l3), ref)
        dx_c = _pcg(ne, rhs, cg_iters, cg_tol,
                    lambda p: _schur_matvec_p(ne, graph, p, ref))
        dx_l3 = _minv_apply(ne, ne.b_l3 - _wt_v_l3(ne, graph, dx_c, ref))
        cam_new = cam + dx_c
        lmkT_new = lmkT + dx_l3
        cost_new = _map_cost_planes(cam_new.T, lmkT_new, graph, priors,
                                    nstds)
        accept = (cost_new < cost) & torch.isfinite(cost_new)
        cam = torch.where(accept, cam_new, cam)
        lmkT = torch.where(accept, lmkT_new, lmkT)
        cost = torch.where(accept, cost_new, cost)
        lm_lambda = torch.where(accept,
                                torch.clamp_min(lm_lambda / 3.0, 1e-9),
                                torch.clamp_max(lm_lambda * 5.0, 1e6))
        _, norms = _residual_sums_planes(cam.T, lmkT, graph, nstds)
        ys.append((cost, norms / n_edges, accept))
    if ys:
        costs, errs, accepted = (torch.stack([y[j] for y in ys])
                                 for j in range(3))
    else:
        costs = errs = cam0.new_zeros(0)
        accepted = torch.zeros(0, dtype=torch.bool, device=cam0.device)
    return GNResult(cam=cam, lmk=lmkT.T, cost=costs, reproj_err=errs,
                    accepted=accepted, lm_lambda=lm_lambda)


def problem_priors(problem, cfg: GBPConfig, graph: GBPGraph) -> GNPriors:
    """The annealed priors of ``problem`` on the graph's device."""
    from ..utils import priors as priors_lib

    dev = graph.cam_idx.device
    cam_lam0, lmk_lam0 = priors_lib.prior_lambdas(problem, cfg.meas_var, dev)
    return annealed_priors(
        graph, torch.tensor(problem.cam_means, dtype=torch.float32,
                            device=dev),
        torch.tensor(problem.lmk_means, dtype=torch.float32, device=dev),
        cam_lam0, lmk_lam0, cfg)


def solve_problem(problem, cfg: GBPConfig, device: torch.device | str,
                  **kw) -> GNResult:
    """Build the exact-edge graph and the annealed priors of ``problem`` on
    ``device`` and run ``solve_lm`` from the problem's means."""
    from .factor_graph import build_graph

    graph = build_graph(problem, dataclasses.replace(cfg, edge_pad_multiple=1),
                        device)
    pri = problem_priors(problem, cfg, graph)
    return solve_lm(pri.cam_mu, pri.lmk_mu, graph, pri, cfg, **kw)
