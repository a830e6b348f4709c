"""Prior construction, annealing scalings, and initialisation noise.

The PyTorch counterpart of ``gbp_poplar_tpu/utils/priors.py``: per-variable
prior strength from max |J| over incident edges, the prior-annealing
scalings, and the NumPy initialisation perturbations.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import GBPConfig, InitConfig
from ..ops import planes as pl
from ..ops import projection
from .balio import BAProblem

# Edges per Jacobian chunk: the [chunk, 2, 9] evaluation's intermediates
# stay bounded at any problem size (the JAX package's 5M-edge limit).
_CHUNK = 1 << 19


def prior_lambdas(problem: BAProblem, meas_var: float,
                  device: torch.device | str = "cpu"):
    """Per-variable isotropic prior precision (cam_lam [C], lmk_lam [L]):
    lambda_v = (max over edges at v of max |J_edge|)^2 / meas_var, with J the
    host-style 2x9 reprojection Jacobian. Variables with no edge get 0."""
    f32 = torch.float32
    k = np.asarray(problem.k, np.float32)
    intr = getattr(problem, "intrinsics", None)
    cam_all = torch.as_tensor(np.asarray(problem.cam_means, np.float32),
                              device=device)
    lmk_all = torch.as_tensor(np.asarray(problem.lmk_means, np.float32),
                              device=device)
    intr_all = (None if intr is None else
                torch.as_tensor(np.asarray(intr, np.float32), device=device))
    ci = torch.as_tensor(problem.cam_idx.astype(np.int64), device=device)
    li = torch.as_tensor(problem.lmk_idx.astype(np.int64), device=device)
    parts = []
    for o in range(0, problem.n_edges, _CHUNK):
        c, l = ci[o:o + _CHUNK], li[o:o + _CHUNK]
        intr_e = None if intr_all is None else intr_all[c]
        jac = projection.reproj_jacobian_local(cam_all[c], lmk_all[l], k,
                                               intr_e)
        parts.append(torch.amax(torch.abs(jac), dim=(-2, -1)))
    max_abs = (torch.cat(parts) if parts
               else torch.zeros(0, dtype=f32, device=device))
    # segment max starting from 0: |J| >= 0, so this is the segment max
    # with the empty-segment -inf clamped to 0
    cam_max = torch.zeros(problem.n_keyframes, dtype=f32, device=device)
    cam_max = cam_max.scatter_reduce(0, ci, max_abs, "amax")
    lmk_max = torch.zeros(problem.n_points, dtype=f32, device=device)
    lmk_max = lmk_max.scatter_reduce(0, li, max_abs, "amax")
    return cam_max ** 2 / meas_var, lmk_max ** 2 / meas_var


def build_priors(problem: BAProblem, cfg: GBPConfig,
                 device: torch.device | str = "cpu") -> dict:
    """Initial prior (eta, Lambda) per variable plus annealing scalings, in
    plane layout: eta [d, V], Lambda packed symmetric [n_slots, V]
    (isotropic: diagonal slots only)."""
    f32 = torch.float32
    cam_lam_s, lmk_lam_s = prior_lambdas(problem, cfg.meas_var, device)
    cam_mu = torch.as_tensor(np.asarray(problem.cam_means.T, np.float32),
                             device=device)
    lmk_mu = torch.as_tensor(np.asarray(problem.lmk_means.T, np.float32),
                             device=device)
    diag6 = torch.zeros(pl.N_SYM6, dtype=f32, device=device)
    diag6[[pl.sym_slot(i, i) for i in range(6)]] = 1.0
    diag3 = torch.zeros(pl.N_SYM3, dtype=f32, device=device)
    diag3[[pl.sym_slot(i, i) for i in range(3)]] = 1.0

    anchor = torch.arange(problem.n_keyframes, device=device) \
        < cfg.num_anchor_cams
    # steps == 0 disables annealing (scaling 1)
    inv_steps = 1.0 / cfg.steps if cfg.steps else 0.0
    anchor_scaling = torch.exp(
        -inv_steps * torch.log(cam_lam_s * cfg.first_cam_prior_std ** 2))
    weak_scaling = torch.exp(torch.tensor(
        -2.0 * inv_steps * np.log(cfg.prior_std_weaker_factor), dtype=f32,
        device=device))
    return dict(
        cam_prior_eta=cam_lam_s[None, :] * cam_mu,
        cam_prior_lam=diag6[:, None] * cam_lam_s[None, :],
        lmk_prior_eta=lmk_lam_s[None, :] * lmk_mu,
        lmk_prior_lam=diag3[:, None] * lmk_lam_s[None, :],
        cam_scaling=torch.where(anchor, anchor_scaling, weak_scaling),
        lmk_scaling=torch.full((problem.n_points,), float(weak_scaling),
                               dtype=f32, device=device),
    )


# ---------------------------------------------------------------------------
# Initialisation perturbations (host-side NumPy, run once at load time)
# ---------------------------------------------------------------------------

def _so3exp_np(w: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(w)
    if theta < 1e-9:
        return np.eye(3)
    w_hat = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    return (np.eye(3) + np.sin(theta) / theta * w_hat
            + (1 - np.cos(theta)) / theta**2 * (w_hat @ w_hat))


def _so3log_np(r: np.ndarray) -> np.ndarray:
    d = 0.5 * (np.trace(r) - 1)
    d = np.clip(d, -1 + 1e-9, 1 - 1e-9)
    if abs(d - 1) < 1e-9:
        return np.zeros(3)
    ln_r = (np.arccos(d) / (2 * np.sqrt(1 - d * d))) * (r - r.T)
    return np.array([ln_r[2, 1], ln_r[0, 2], ln_r[1, 0]])


def add_cam_trans_noise(cam_means: np.ndarray, std: float,
                        rng: np.random.Generator, k_anchor: int = 2):
    """Gaussian translation noise, skipping the first k anchor keyframes."""
    out = cam_means.copy()
    out[k_anchor:, :3] += rng.normal(0, std, out[k_anchor:, :3].shape)
    return out


def add_cam_rot_noise(cam_means: np.ndarray, std_deg: float,
                      rng: np.random.Generator, k_anchor: int = 2):
    """Random-axis rotation perturbation composed in the camera frame."""
    out = cam_means.copy()
    for c in range(k_anchor, out.shape[0]):
        angle = rng.normal(0, std_deg) * np.pi / 180
        axis = rng.integers(0, 3)
        ca, sa = np.cos(angle), np.sin(angle)
        r_noise = np.eye(3)
        i, j = [(1, 2), (0, 2), (0, 1)][axis]
        r_noise[i, i] = ca
        r_noise[j, j] = ca
        r_noise[i, j] = -sa if axis != 1 else sa
        r_noise[j, i] = sa if axis != 1 else -sa
        t_w2c = np.eye(4)
        t_w2c[:3, :3] = _so3exp_np(out[c, 3:])
        t_w2c[:3, 3] = out[c, :3]
        t_c2w = np.linalg.inv(t_w2c)
        t_c2w[:3, :3] = r_noise @ t_c2w[:3, :3]
        t_w2c = np.linalg.inv(t_c2w)
        out[c, :3] = t_w2c[:3, 3]
        out[c, 3:] = _so3log_np(t_w2c[:3, :3])
    return out


def add_lmk_noise(lmk_means: np.ndarray, std: float,
                  rng: np.random.Generator) -> np.ndarray:
    """Gaussian noise on all landmarks."""
    return lmk_means + rng.normal(0, std, lmk_means.shape)


def av_depth_init(problem: BAProblem, av_depth: float,
                  cam_means: np.ndarray) -> np.ndarray:
    """Place each landmark at ``av_depth`` on the optic axis of the first
    keyframe that observes it (pinhole +z convention only)."""
    if getattr(problem, "intrinsics", None) is not None:
        raise ValueError(
            "av_depth_init assumes the pinhole +z optic-axis convention; "
            "BAL/Snavely problems ship initial landmark estimates")
    out = problem.lmk_means.copy()
    first_cam = np.full(problem.n_points, -1, np.int64)
    for e in np.argsort(problem.cam_idx, kind="stable"):
        l = problem.lmk_idx[e]
        if first_cam[l] < 0:
            first_cam[l] = problem.cam_idx[e]
    for l in range(problem.n_points):
        c = first_cam[l]
        if c < 0:
            continue
        r = _so3exp_np(cam_means[c, 3:])
        out[l] = r.T @ (np.array([0.0, 0.0, av_depth]) - cam_means[c, :3])
    return out


def apply_init_noise(problem: BAProblem, init_cfg: InitConfig,
                     k_anchor: int = 2) -> BAProblem:
    """Apply the configured initialisation perturbations."""
    rng = np.random.default_rng(init_cfg.seed)
    cam_means = problem.cam_means
    lmk_means = problem.lmk_means
    if init_cfg.trans_noise != 0.0:
        cam_means = add_cam_trans_noise(cam_means, init_cfg.trans_noise, rng,
                                        k_anchor)
    if init_cfg.rot_noise != 0.0:
        cam_means = add_cam_rot_noise(cam_means, init_cfg.rot_noise, rng,
                                      k_anchor)
    if init_cfg.lmk_noise != 0.0 and not init_cfg.av_depth_on:
        lmk_means = add_lmk_noise(lmk_means, init_cfg.lmk_noise, rng)
    elif init_cfg.av_depth_on:
        lmk_means = av_depth_init(problem, init_cfg.av_depth, cam_means)
    return dataclasses.replace(problem, cam_means=cam_means,
                               lmk_means=lmk_means)
