"""Coarse-space correction: the MAP increment over per-group rigid motions.

The PyTorch counterpart of ``gbp_poplar_tpu/core/coarse.py`` (its module
docstring gives the reasoning). Keyframes are split into ``coarse_groups``
contiguous groups and every landmark joins the group of its first
observing keyframe; group g spans 6 directions, the rigid motion of its
world content. The reduced 6G x 6G Gauss-Newton system (Huber-IRLS
weights, the current annealed priors) is assembled from per-edge [2, 6]
reduced Jacobians and solved with one Cholesky factorisation; the increment
vanishes at the MAP fixed point. ``core/gbp._coarse_step`` applies it on
the message state, accepted only where the MAP cost falls.

Each edge's terms of the system (its reduced Jacobians' Huber-weighted
products) come from H7 (ops/coarse_kernel.coarse_edge_blocks) as planes
[90, n_real], and the per-group sums of those planes go through the
deterministic segmented sum (H3, ops/reduce_kernel.segment_sum) over
segments keyed by the edges' groups, built once per graph
(``group_segments``): the accept decision downstream is a float32 cost
comparison, and a sum in run-dependent order (atomics) would make it, and
a resumed solve, change from run to run. The prior terms (batched
products over the C cameras and L landmarks), the 6G x 6G Cholesky and the
all-reduces are plain PyTorch.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import GBPConfig
from ..ops import coarse_kernel, lie, reduce_kernel
from ..ops import projection  # noqa: F401  (tests read coarse.projection)
from ..ops.coarse_kernel import lmk_rigid_basis as _lmk_rigid_basis
from ..ops import planes as pl
from . import comm
from .factor_graph import GBPGraph, GBPState, Segments, build_segments

RIGID_DOF = 6


@dataclasses.dataclass
class GroupSegments:
    """Segments of the coarse sums for one group count ``g``."""

    g_cam: torch.Tensor     # [C] int64 group of each keyframe
    g_lmk: torch.Tensor     # [L] int64 group of each landmark
    edge_cam: Segments      # edges by their camera's group (G segments)
    edge_lmk: Segments      # edges by their landmark's group (G)
    edge_pair: Segments     # edges by ga * G + gb (G * G)
    cam: Segments           # keyframes by group (G)
    lmk: Segments           # landmarks by group (G)


def group_segments(graph: GBPGraph, g: int) -> GroupSegments:
    """The group keys and their segments, built on the host once per graph
    and group count and kept in ``graph.derived``. Edges beyond the
    graph's segments (the inert padding) are left out."""
    key = ("coarse", g)
    if key in graph.derived:
        return graph.derived[key]
    c, l = graph.n_keyframes, graph.n_points
    dev = graph.cam_idx.device
    n_real = graph.cam_seg.var.shape[0]
    g_cam = (torch.arange(c, device=dev) * g) // c
    g_lmk = torch.clamp_max((graph.first_kf.long() * g) // c, g - 1)
    ga = g_cam[graph.cam_idx[:n_real].long()].cpu().numpy()
    gb = g_lmk[graph.lmk_idx[:n_real].long()].cpu().numpy()
    segs = GroupSegments(
        g_cam=g_cam, g_lmk=g_lmk,
        edge_cam=build_segments(ga, g, n_real, dev),
        edge_lmk=build_segments(gb, g, n_real, dev),
        edge_pair=build_segments(ga * g + gb, g * g, n_real, dev),
        cam=build_segments(g_cam.cpu().numpy(), g, c, dev),
        lmk=build_segments(g_lmk.cpu().numpy(), g, l, dev))
    graph.derived[key] = segs
    return segs


def _group_sum(x: torch.Tensor, seg: Segments, ref: bool) -> torch.Tensor:
    """Sum the rows [N, ...] of ``x`` per segment -> [V, ...]."""
    n = x.shape[0]
    planes = x.reshape(n, -1).T.contiguous()
    out = reduce_kernel.segment_sum(planes, seg, reference=ref)
    return out.T.reshape((seg.n_var,) + x.shape[1:])


def _composed(x: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Parameters of T_w2c(x) . G(xi)^-1: the same physical camera after
    the world content moved by G (p -> R_g p + xi_t)."""
    r = lie.so3_exp(x[3:])
    rg = lie.so3_exp(xi[3:])
    rn = r @ rg.T
    tn = x[:3] - rn @ xi[:3]
    return torch.cat([tn, lie.so3_log(rn)])


def _cam_rigid_basis(cam_mu: torch.Tensor) -> torch.Tensor:
    """d(params of T_w2c . G(xi)^-1)/d(xi) at xi = 0, per camera: S
    [C, 6, 6] from cam_mu [C, 6] (t, w). Forward mode, as the JAX
    function's jacfwd: so3_exp's sqrt has no derivative at xi = 0, and
    its select passes only the taken branch's (finite) tangent. PyTorch's
    forward mode carries the tangent of a Python float times a 0-d tensor
    in float64, so the result is cast back to the means' dtype."""
    zero = torch.zeros(RIGID_DOF, dtype=cam_mu.dtype, device=cam_mu.device)
    jac = torch.func.jacfwd(_composed, argnums=1)
    return torch.func.vmap(jac, in_dims=(0, None))(cam_mu, zero).to(
        cam_mu.dtype)


def _fin(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, 0.0)


def lmk_prior_terms(state: GBPState, lmkr: torch.Tensor,
                    s_lmk: torch.Tensor):
    """The landmark priors' curvature S^T Lam S [L, 6, 6] and gradient S^T
    (eta - Lam y) [L, 6] in the rigid basis ``s_lmk`` [L, 3, 6] at the
    sanitised means ``lmkr`` [L, 3]: batched products over the L
    landmarks."""
    lam_l = pl.unpack_sym_dense(state.lmk_prior_lam, 3)         # [L,3,3]
    grad_l = state.lmk_prior_eta.T - (lam_l @ lmkr[..., None])[..., 0]
    s_lmkt = s_lmk.transpose(-1, -2)
    return s_lmkt @ (lam_l @ s_lmk), (s_lmkt @ grad_l[..., None])[..., 0]


def coarse_increment(state: GBPState, graph: GBPGraph, cfg: GBPConfig,
                     cam_mu: torch.Tensor, lmk_mu: torch.Tensor,
                     group=None, lmk_sharded: bool = False):
    """Solve the reduced Gauss-Newton system over per-group rigid modes.

    ``cam_mu`` [6, C] / ``lmk_mu`` [3, L] are the current belief means in
    plane layout. Returns (delta_cam [6, C], delta_lmk [3, L]), zero where
    the coarse gradient is zero. With ``group`` the edge terms of the
    system are summed over the ranks, and with ``lmk_sharded`` the
    landmark prior terms too (the JAX function's two psums)."""
    g = cfg.coarse_groups
    ref = cfg.kernels == "reference"
    segs = group_segments(graph, g)
    camr = _fin(cam_mu.T)                             # [C, 6] row-major
    lmkr = _fin(lmk_mu.T)                             # [L, 3]
    s_cam = _fin(_cam_rigid_basis(camr))              # [C, 6, 6]
    s_lmk = _lmk_rigid_basis(lmkr)                    # [L, 3, 6]

    # --- per-edge reduced system blocks (H7), summed per group (H3) ---
    planes = coarse_kernel.coarse_edge_blocks(cam_mu, lmk_mu, s_cam, state,
                                              graph, cfg, reference=ref)
    rows = coarse_kernel.ROWS
    by_cam = reduce_kernel.segment_sum(planes[rows["cam"]], segs.edge_cam,
                                       reference=ref)          # [27, G]
    by_lmk = reduce_kernel.segment_sum(planes[rows["lmk"]], segs.edge_lmk,
                                       reference=ref)          # [27, G]
    by_pair = reduce_kernel.segment_sum(planes[rows["pair"]],
                                        segs.edge_pair, reference=ref)

    diag = torch.arange(g, device=camr.device)
    a = torch.zeros((g, g, RIGID_DOF, RIGID_DOF), dtype=camr.dtype,
                    device=camr.device)
    a[diag, diag] += pl.unpack_sym_dense(by_cam[:21], RIGID_DOF)
    a[diag, diag] += pl.unpack_sym_dense(by_lmk[:21], RIGID_DOF)
    a_ab = by_pair.T.reshape(g, g, 6, 6)
    a = a + a_ab
    a = a + a_ab.permute(1, 0, 3, 2)        # block (gb, ga) gets ab^T
    rhs = by_cam[21:].T + by_lmk[21:].T                        # [G, 6]
    if group is not None:
        a, rhs = comm.all_sum(group, [a, rhs])

    # --- prior terms (gradient and curvature of the annealed priors) ---
    lam_c = pl.unpack_sym_dense(state.cam_prior_lam, 6)         # [C,6,6]
    grad_c = state.cam_prior_eta.T - (lam_c @ camr[..., None])[..., 0]
    s_camt = s_cam.transpose(-1, -2)
    pa_c = s_camt @ (lam_c @ s_cam)
    pb_c = (s_camt @ grad_c[..., None])[..., 0]
    pa_l, pb_l = lmk_prior_terms(state, lmkr, s_lmk)
    a_p = torch.zeros_like(a)
    a_p[diag, diag] = _group_sum(pa_c, segs.cam, ref)
    a = a + a_p
    a_pl = _group_sum(pa_l, segs.lmk, ref)
    r_pl = _group_sum(pb_l, segs.lmk, ref)
    if group is not None and lmk_sharded:
        a_pl, r_pl = comm.all_sum(group, [a_pl, r_pl])
    a_p = torch.zeros_like(a)
    a_p[diag, diag] = a_pl
    a = a + a_p
    rhs = rhs + _group_sum(pb_c, segs.cam, ref) + r_pl

    # --- assemble dense [6G, 6G], damp, solve ---
    n = g * RIGID_DOF
    a_dense = a.permute(0, 2, 1, 3).reshape(n, n)
    dg = torch.diagonal(a_dense)
    a_dense = a_dense + torch.diag(1e-3 * torch.clamp_min(dg, 1e-8) + 1e-8)
    ok = torch.isfinite(a_dense).all() & torch.isfinite(rhs).all()
    a_dense = torch.where(ok, a_dense,
                          torch.eye(n, dtype=a.dtype, device=a.device))
    rhs_flat = torch.where(ok, rhs.reshape(-1), 0.0)
    # cholesky_ex: no host sync and no raise on a matrix that is not
    # positive definite; such a solve is dropped below, as the JAX solve's
    # NaNs are
    chol, info = torch.linalg.cholesky_ex(a_dense)
    xi = torch.cholesky_solve(rhs_flat[:, None], chol)[:, 0]
    xi = torch.where((info == 0) & torch.isfinite(xi), xi, 0.0).reshape(g, 6)

    d_cam = (s_cam @ xi.index_select(0, segs.g_cam)[..., None])[..., 0]
    d_lmk = (s_lmk @ xi.index_select(0, segs.g_lmk)[..., None])[..., 0]
    return d_cam.T, d_lmk.T
