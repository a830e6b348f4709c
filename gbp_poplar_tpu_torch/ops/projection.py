"""Reprojection model and Jacobians in row-major ([E, 6] / [E, 3]) form.

The counterpart of ``gbp_poplar_tpu/ops/projection.py``, batched over a
leading edge axis: the host-style 2x9 Jacobian for
``utils.priors.prior_lambdas``; the measurement function, its analytic
Jacobians and the Huber variance inflation for the coarse corrector
(core/coarse.py); and the dense factor linearisation
(``linearise_factor``), the row-major form of what the sweep computes on
planes (ops/planes.linearise). ``k`` is the [3, 3] shared pinhole as host
numbers; ``intr`` [..., 3] per-edge Snavely (f, k1, k2) selects the BAL
model.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import lie


_SMALL_THETA_SQ = 1e-12


def project(cam: torch.Tensor, lmk: torch.Tensor, k,
            intr: torch.Tensor | None = None) -> torch.Tensor:
    """Pixel coordinates [..., 2] of ``lmk`` [..., 3] seen by ``cam``
    [..., 6]; with ``intr`` the Snavely model (camera looks down -z,
    uv = f (1 + k1 r^2 + k2 r^4) p, p = -(x/z, y/z))."""
    y_cf = lie.w2c_apply(cam, lmk)
    if intr is None:
        u = float(k[0][0]) * (y_cf[..., 0] / y_cf[..., 2]) + float(k[0][2])
        v = float(k[1][1]) * (y_cf[..., 1] / y_cf[..., 2]) + float(k[1][2])
        return torch.stack([u, v], dim=-1)
    p = -y_cf[..., :2] / y_cf[..., 2:3]
    rho = torch.sum(p * p, dim=-1, keepdim=True)
    dist = 1.0 + rho * (intr[..., 1:2] + intr[..., 2:3] * rho)
    return intr[..., 0:1] * dist * p


def _proj_jacobian(y_cf: torch.Tensor, k, intr: torch.Tensor | None = None):
    """d(u,v)/d(y_cam): [..., 2, 3]; with ``intr`` the Snavely-model chain
    rule through the radial distortion. ``k`` is host numbers [3, 3]."""
    z = y_cf[..., 2]
    inv_z = 1.0 / z
    inv_z2 = inv_z * inv_z
    zero = torch.zeros_like(z)
    if intr is None:
        fx, fy = float(k[0][0]), float(k[1][1])
        row_u = torch.stack([fx * inv_z, zero, -fx * y_cf[..., 0] * inv_z2],
                            dim=-1)
        row_v = torch.stack([zero, fy * inv_z, -fy * y_cf[..., 1] * inv_z2],
                            dim=-1)
        return torch.stack([row_u, row_v], dim=-2)
    f, d1, d2 = intr[..., 0], intr[..., 1], intr[..., 2]
    px = -y_cf[..., 0] * inv_z
    py = -y_cf[..., 1] * inv_z
    rho = px * px + py * py
    dist = 1.0 + rho * (d1 + d2 * rho)
    g = d1 + 2.0 * d2 * rho
    dpx = torch.stack([-inv_z, zero, y_cf[..., 0] * inv_z2], dim=-1)
    dpy = torch.stack([zero, -inv_z, y_cf[..., 1] * inv_z2], dim=-1)
    drho = 2.0 * (px[..., None] * dpx + py[..., None] * dpy)
    row_u = f[..., None] * (dist[..., None] * dpx + (px * g)[..., None] * drho)
    row_v = f[..., None] * (dist[..., None] * dpy + (py * g)[..., None] * drho)
    return torch.stack([row_u, row_v], dim=-2)


def reproj_jacobian_local(cam: torch.Tensor, lmk: torch.Tensor, k,
                          intr: torch.Tensor | None = None) -> torch.Tensor:
    """Host-style 2x9 Jacobian with the local rotation perturbation
    dR(w)y/dw ~= -hat(R y), ordered (translation, rotation, landmark);
    used only for prior-strength estimation. Returns [..., 2, 9]."""
    r, _ = lie.pose_to_rt(cam)
    y_cf = lie.w2c_apply(cam, lmk)
    j_proj = _proj_jacobian(y_cf, k, intr)
    r_lmk = (r @ lmk[..., None])[..., 0]
    d_rot = -lie.so3_hat(r_lmk)
    j_rot = j_proj @ d_rot
    j_lmk = j_proj @ r
    return torch.cat([j_proj, j_rot, j_lmk], dim=-1)


def reproj_jacobians(cam: torch.Tensor, lmk: torch.Tensor, k,
                     intr: torch.Tensor | None = None):
    """Analytic Jacobians of the reprojection wrt the pose [..., 2, 6] and
    the landmark [..., 2, 3]: J_lmk = J_proj R; the pose's rotation block
    by the global axis-angle derivative
    dRy/dw = -R hat(y) ((R^T - I) hat(w) + w w^T) / ||w||^2, with the
    exact limit -hat(y) below ||w||^2 = 1e-12."""
    r, _ = lie.pose_to_rt(cam)
    y_cf = lie.w2c_apply(cam, lmk)
    j_proj = _proj_jacobian(y_cf, k, intr)
    j_lmk = j_proj @ r
    w = cam[..., 3:6]
    w_hat = lie.so3_hat(w)
    y_hat = lie.so3_hat(lmk)
    ww = w[..., :, None] * w[..., None, :]
    eye = torch.eye(3, dtype=cam.dtype, device=cam.device)
    numerator = (r.transpose(-1, -2) - eye) @ w_hat + ww
    theta_sq = torch.sum(w * w, dim=-1)
    small = theta_sq < _SMALL_THETA_SQ
    denom = torch.where(small, 1.0, theta_sq)
    d_ry_dw = -((r @ y_hat) @ numerator) / denom[..., None, None]
    d_ry_dw = torch.where(small[..., None, None], -y_hat, d_ry_dw)
    j_rot = j_proj @ d_ry_dw
    return torch.cat([j_proj, j_rot], dim=-1), j_lmk


def huber_meas_var(err: torch.Tensor, meas_var: torch.Tensor, nstds: float):
    """Huber variance inflation: (var', robust flag), with
    var' = var err^2 / (2 (N sqrt(var) err - N^2 var / 2)) where
    err > N sqrt(var), else var."""
    sigma = torch.sqrt(meas_var)
    robust = err > nstds * sigma
    denom = 2.0 * (nstds * sigma * err - 0.5 * nstds * nstds * meas_var)
    denom = torch.where(robust, denom, 1.0)
    inflated = meas_var * err * err / denom
    return torch.where(robust, inflated, meas_var), robust


class FactorPotential(NamedTuple):
    """Linearised reprojection-factor potential, blockwise (the lc block is
    cl^T and not stored)."""

    eta_c: torch.Tensor    # [..., 6]
    eta_l: torch.Tensor    # [..., 3]
    lam_cc: torch.Tensor   # [..., 6, 6]
    lam_cl: torch.Tensor   # [..., 6, 3]
    lam_ll: torch.Tensor   # [..., 3, 3]


def linearise_factor(cam_mu: torch.Tensor, lmk_mu: torch.Tensor, k,
                     meas: torch.Tensor, meas_var: torch.Tensor,
                     nstds: float, intr: torch.Tensor | None = None):
    """Relinearise reprojection factors at the given means (cam_mu [..., 6],
    lmk_mu [..., 3], meas [..., 2], meas_var [...]):
    Lambda = J^T J / var', eta = J^T (J x0 + z - h(x0)) / var', with the
    Huber inflation var' of the residual norm |h(x0) - z|. Returns
    (FactorPotential, robust flag [...])."""
    j_kf, j_lmk = reproj_jacobians(cam_mu, lmk_mu, k, intr)
    hx0 = project(cam_mu, lmk_mu, k, intr)
    jx0 = (j_kf @ cam_mu[..., None])[..., 0] + (j_lmk @ lmk_mu[..., None])[
        ..., 0]
    b = jx0 + meas - hx0
    err = torch.linalg.vector_norm(hx0 - meas, dim=-1)
    var, robust = huber_meas_var(err, meas_var, nstds)
    inv_var = (1.0 / var)[..., None]
    eta_c = (j_kf.transpose(-1, -2) @ b[..., None])[..., 0] * inv_var
    eta_l = (j_lmk.transpose(-1, -2) @ b[..., None])[..., 0] * inv_var
    inv_var2 = inv_var[..., None]
    lam_cc = (j_kf.transpose(-1, -2) @ j_kf) * inv_var2
    lam_ll = (j_lmk.transpose(-1, -2) @ j_lmk) * inv_var2
    lam_cl = (j_kf.transpose(-1, -2) @ j_lmk) * inv_var2
    return FactorPotential(eta_c, eta_l, lam_cc, lam_cl, lam_ll), robust
