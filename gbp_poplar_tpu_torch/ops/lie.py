"""Batched SO(3)/SE(3) operations on [..., 3] / [..., 6] tensors.

The subset of ``gbp_poplar_tpu/ops/lie.py`` that prior construction needs.
Pose convention: a keyframe is ``x = [t (3), w (3)]`` with world-to-camera
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


def pose_to_rt(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split pose [..., 6] into (R_w2c [..., 3, 3], t [..., 3])."""
    return so3_exp(x[..., 3:6]), x[..., :3]


def w2c_apply(x: torch.Tensor, y_world: torch.Tensor) -> torch.Tensor:
    """Transform world points into the camera frame: R y + t."""
    r, t = pose_to_rt(x)
    return (r @ y_world[..., None])[..., 0] + t
