"""Reprojection Jacobians for prior construction.

The subset of ``gbp_poplar_tpu/ops/projection.py`` that
``utils.priors.prior_lambdas`` needs: the host-style 2x9 Jacobian, batched
over a leading edge axis.
"""

from __future__ import annotations

import torch

from . import lie


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
