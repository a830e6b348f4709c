"""Host-side reprojection-error oracle (NumPy).

The NumPy oracle of ``gbp_poplar_tpu/utils/evaluation.py``: an
independent float64 re-implementation of the measurement model (its own
Rodrigues and projection, no code shared with the solver), for end-to-end
checks of the device results.
"""

from __future__ import annotations

import numpy as np


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
