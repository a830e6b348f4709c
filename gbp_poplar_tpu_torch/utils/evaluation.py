"""Trajectory evaluation and the host-side reprojection-error oracle.

The counterpart of ``gbp_poplar_tpu/utils/evaluation.py``, on the host in
float64: camera centres, Umeyama alignment, absolute trajectory error,
TUM-format export (rotations by ops/lie), and the independent NumPy
re-implementation of the measurement model (its own Rodrigues and
projection, no code shared with the solver) for end-to-end checks of the
device results.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import lie


def _rotations(cam_means: np.ndarray) -> np.ndarray:
    """World-to-camera rotations [C, 3, 3] of [C, 6] (t, w) poses, float64
    (ops/lie.so3_exp)."""
    w = torch.tensor(np.asarray(cam_means, np.float64)[:, 3:6])
    return lie.so3_exp(w).numpy()


def camera_centers(cam_means: np.ndarray) -> np.ndarray:
    """World-frame camera centres -R^T t from [C, 6] (t, w) w2c poses."""
    cams = np.asarray(cam_means, np.float64)
    return -np.einsum("cji,cj->ci", _rotations(cams), cams[:, :3])


def umeyama_align(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares similarity/rigid transform (R, t, s) with
    ``dst ~= s * R @ src + t`` (Umeyama 1991)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    u, d, vt = np.linalg.svd(cov)
    s_mat = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_mat[2, 2] = -1.0
    r = u @ s_mat @ vt
    if with_scale:
        var_s = (xs * xs).sum() / src.shape[0]
        scale = float(np.trace(np.diag(d) @ s_mat) / var_s)
    else:
        scale = 1.0
    return r, mu_d - scale * r @ mu_s, scale


def ate_rmse(est_cam_means: np.ndarray, ref_cam_means: np.ndarray,
             align: bool = True, with_scale: bool = False) -> float:
    """Absolute trajectory error: RMSE of the camera centres (metres),
    after aligning the estimate to the reference; inf if either has a
    non-finite centre."""
    est = camera_centers(est_cam_means)
    ref = camera_centers(ref_cam_means)
    if not (np.isfinite(est).all() and np.isfinite(ref).all()):
        return float("inf")
    if align:
        r, t, s = umeyama_align(est, ref, with_scale)
        est = (s * (r @ est.T)).T + t
    d = est - ref
    return float(np.sqrt((d * d).sum(axis=-1).mean()))


def _rot_to_quat(m: np.ndarray) -> np.ndarray:
    """[3, 3] rotation -> quaternion (x, y, z, w), TUM convention."""
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    return np.array([x, y, z, w])


def export_tum(path: str, cam_means: np.ndarray,
               timestamps: np.ndarray | None = None) -> None:
    """Write a TUM-format trajectory, ``t x y z qx qy qz qw`` per keyframe,
    camera-to-world (the TUM convention)."""
    cams = np.asarray(cam_means)
    r_w2c = _rotations(cams)
    centers = camera_centers(cams)
    if timestamps is None:
        timestamps = np.arange(cams.shape[0], dtype=np.float64)
    with open(path, "w") as f:
        for i in range(cams.shape[0]):
            q = _rot_to_quat(r_w2c[i].T)
            c = centers[i]
            f.write(f"{timestamps[i]:.6f} {c[0]:.9f} {c[1]:.9f} {c[2]:.9f} "
                    f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n")


def numpy_reprojection_error(cam_mu: np.ndarray, lmk_mu: np.ndarray,
                             problem, bad_associations=None):
    """(mean residual norm px, total cost 0.5 * sum ||r||^2) over edges with
    a finite residual, skipping the original edge ids in
    ``bad_associations``."""
    cam = np.asarray(cam_mu, np.float64)      # [C, 6] (t, w)
    lmk = np.asarray(lmk_mu, np.float64)      # [L, 3]
    k = np.asarray(problem.k, np.float64)
    ci = np.asarray(problem.cam_idx)
    li = np.asarray(problem.lmk_idx)
    t = cam[ci, :3]
    w = cam[ci, 3:]
    y = lmk[li]
    theta = np.linalg.norm(w, axis=1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        axis = np.where(theta > 1e-12, w / theta, 0.0)
    ct = np.cos(theta)
    st = np.sin(theta)
    # Rodrigues: R y = y c + (a x y) s + a (a.y)(1-c);  x_c = R y + t
    cross = np.cross(axis, y)
    dot = np.sum(axis * y, axis=1, keepdims=True)
    y_cf = y * ct + cross * st + axis * dot * (1.0 - ct) + t
    z = y_cf[:, 2]
    intr = getattr(problem, "intrinsics", None)
    if intr is None:
        u = k[0, 0] * y_cf[:, 0] / z + k[0, 2]
        v = k[1, 1] * y_cf[:, 1] / z + k[1, 2]
    else:
        # Snavely/BAL model: uv = f (1 + k1 r^2 + k2 r^4) * (-x/z, -y/z)
        f_e, k1_e, k2_e = np.asarray(intr, np.float64)[ci].T
        px = -y_cf[:, 0] / z
        py = -y_cf[:, 1] / z
        rho = px * px + py * py
        dist = 1.0 + rho * (k1_e + k2_e * rho)
        u = f_e * dist * px
        v = f_e * dist * py
    meas = np.asarray(problem.measurements, np.float64)
    r = np.stack([meas[:, 0] - u, meas[:, 1] - v], axis=1)
    norm = np.linalg.norm(r, axis=1)
    ok = np.isfinite(norm)
    if bad_associations is not None:
        bad = np.zeros(norm.shape[0], bool)
        bad[np.asarray(list(bad_associations), np.int64)] = True
        ok &= ~bad
    return float(norm[ok].mean()), float(0.5 * np.sum(norm[ok] ** 2))
