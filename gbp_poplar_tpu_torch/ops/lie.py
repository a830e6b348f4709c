"""Batched SO(3)/SE(3) operations on [..., 3] / [..., 6] tensors.

The counterpart of ``gbp_poplar_tpu/ops/lie.py``: the rotations that prior
construction, the coarse corrector's rigid basis and the trajectory export
need, the homogeneous transforms and the optic-axis point. Pose
convention: a keyframe is ``x = [t (3), w (3)]`` with world-to-camera
action ``y_cam = exp(w^) y_world + t``.
"""

from __future__ import annotations

import torch

_SMALL_THETA = 1e-6


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """Hat operator: [..., 3] -> [..., 3, 3] skew-symmetric."""
    zero = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([zero, -w[..., 2], w[..., 1]], dim=-1),
        torch.stack([w[..., 2], zero, -w[..., 0]], dim=-1),
        torch.stack([-w[..., 1], w[..., 0], zero], dim=-1),
    ], dim=-2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula: [..., 3] axis-angle -> [..., 3, 3] rotation,
    branch-free with the identity below theta = 1e-6."""
    theta_sq = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta_sq)
    small = theta < _SMALL_THETA
    theta_safe = torch.where(small, 1.0, theta)
    theta_sq_safe = torch.where(small, 1.0, theta_sq)
    a = torch.where(small, 1.0, torch.sin(theta_safe) / theta_safe)
    b = torch.where(small, 0.5, (1.0 - torch.cos(theta_safe)) / theta_sq_safe)
    w_hat = so3_hat(w)
    w_hat_sq = w_hat @ w_hat
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * w_hat + b[..., None, None] * w_hat_sq


def so3_log(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> axis-angle [..., 3], by the
    acos-trace formula with the identity (d -> 1, where it is 0/0) guarded
    by a select, as the JAX function. Forward-mode derivatives (the coarse
    basis) see the select's taken branch only."""
    d = 0.5 * (r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2] - 1.0)
    d = torch.clamp(d, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(d)
    coef = theta / (2.0 * torch.sqrt(1.0 - d * d))
    coef = torch.where(torch.abs(d - 1.0) < 1e-6, 0.5, coef)
    ln_r = coef[..., None, None] * (r - r.transpose(-1, -2))
    return torch.stack([ln_r[..., 2, 1], ln_r[..., 0, 2], ln_r[..., 1, 0]],
                       dim=-1)


def pose_to_rt(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split pose [..., 6] into (R_w2c [..., 3, 3], t [..., 3])."""
    return so3_exp(x[..., 3:6]), x[..., :3]


def w2c_apply(x: torch.Tensor, y_world: torch.Tensor) -> torch.Tensor:
    """Transform world points into the camera frame: R y + t."""
    r, t = pose_to_rt(x)
    return (r @ y_world[..., None])[..., 0] + t


def _homogeneous(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation and [..., 3] translation -> [..., 4, 4]."""
    top = torch.cat([r, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=r.dtype,
                          device=r.device).expand(*r.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def tranf_w2c(x: torch.Tensor) -> torch.Tensor:
    """Pose [..., 6] -> homogeneous world-to-camera transform [..., 4, 4]."""
    r, t = pose_to_rt(x)
    return _homogeneous(r, t)


def tranf_c2w(x: torch.Tensor) -> torch.Tensor:
    """Pose [..., 6] -> camera-to-world transform [..., 4, 4] (R^T, -R^T t)."""
    r, t = pose_to_rt(x)
    rt = r.transpose(-1, -2)
    return _homogeneous(rt, -(rt @ t[..., None])[..., 0])


def optic_axis_point_world(x: torch.Tensor,
                           depth: float | torch.Tensor = 1.0) -> torch.Tensor:
    """World coordinates [..., 3] of the point at ``depth`` on the camera's
    optic axis: the camera-frame point (0, 0, depth) mapped through T_c2w,
    as the average-depth landmark initialiser places it."""
    r, t = pose_to_rt(x)
    zero = torch.zeros_like(x[..., 0])
    p_cam = torch.stack([zero, zero, torch.as_tensor(
        depth, dtype=x.dtype, device=x.device).expand_as(zero)], dim=-1)
    return (r.transpose(-1, -2) @ (p_cam - t)[..., None])[..., 0]
