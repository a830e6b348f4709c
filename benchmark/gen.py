"""The benchmark's problem generator: a bundle-adjustment problem at a
configuration's exact sizes, made from ``--seed``.

A copy of ``gbp_poplar_tpu_torch.utils.balio.synthetic_problem_large``
(cameras along a line with a smooth rotation walk, each landmark seen by a
run of consecutive keyframes: the trajectory visibility of a vehicle or
hand-held sequence), kept here so that a change to the program cannot move
the yardstick. It is extended in three ways:

- per-landmark track lengths (each >= 2) that sum exactly to the source's
  observation count. The multiset of lengths is drawn once per
  configuration (``track_seed``, a geometric tail above 2 with the
  source's mean); ``--seed`` only deals them out to the landmarks, so
  every seed gives the same amount of work in another arrangement;
- the pinhole intrinsics and image size come from the configuration;
- the runs' starts are spread so that the last keyframe is seen as often
  as the first.

The initial estimate is the repo's main path: keyframes at their true
poses, landmarks perturbed by N(0, ``lmk_noise``) per axis.

Everything is NumPy on the host, vectorised (about 1 s at a million
edges). Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Problem:
    """A generated problem: the inputs both sides get, and the truth."""

    n_keyframes: int
    n_points: int
    n_edges: int
    k: np.ndarray              # [3, 3] shared pinhole intrinsics
    intrinsics: np.ndarray | None   # [C, 3] Snavely (f, k1, k2) or None
    cam_idx: np.ndarray        # [E] uint32
    lmk_idx: np.ndarray        # [E] uint32
    measurements: np.ndarray   # [E, 2] float64 pixels
    cam_init: np.ndarray       # [C, 6] initial (t, w): y_cam = R(w) y + t
    lmk_init: np.ndarray       # [L, 3] initial landmark positions
    cam_true: np.ndarray       # [C, 6]
    lmk_true: np.ndarray       # [L, 3]


def track_lengths(n_points: int, n_obs: int, cap: int,
                  track_seed: int) -> np.ndarray:
    """[n_points] int64 track lengths, each in [2, cap], summing exactly to
    ``n_obs``: 2 plus a geometric tail with the mean n_obs / n_points,
    then single observations added or taken at random landmarks until the
    sum is exact. Depends on the arguments only (not on ``--seed``)."""
    if not 2 * n_points <= n_obs <= cap * n_points:
        raise ValueError(f"{n_obs} observations cannot be dealt to "
                         f"{n_points} landmarks with tracks of 2..{cap}")
    rng = np.random.default_rng(track_seed)
    extra = n_obs / n_points - 2.0
    if extra > 0:
        t = 1 + rng.geometric(1.0 / (1.0 + extra), n_points)
    else:
        t = np.full(n_points, 2)
    t = np.minimum(t.astype(np.int64), cap)
    while (diff := n_obs - int(t.sum())) != 0:
        pool = np.flatnonzero(t < cap) if diff > 0 else np.flatnonzero(t > 2)
        pick = rng.choice(pool, min(abs(diff), pool.size), replace=False)
        t[pick] += 1 if diff > 0 else -1
    return t


def rodrigues(w: np.ndarray, y: np.ndarray) -> np.ndarray:
    """R(w) y for rows of axis-angle ``w`` and points ``y`` ([N, 3])."""
    th = np.linalg.norm(w, axis=1, keepdims=True)
    small = th < 1e-8
    ths = np.where(small, 1.0, th)
    a = np.where(small, 1.0, np.sin(ths) / ths)
    b = np.where(small, 0.5, (1.0 - np.cos(ths)) / (ths * ths))
    wxy = np.cross(w, y)
    return y + a * wxy + b * np.cross(w, wxy)


def make_problem(config: dict, seed: int) -> Problem:
    """The configuration's problem for ``seed`` (any whole number)."""
    c, l, e = (config["n_keyframes"], config["n_points"],
               config["n_observations"])
    gen = config["generator"]
    rng = np.random.default_rng(abs(int(seed)))
    snavely = config["camera_model"] == "snavely"
    cap = min(c, gen["max_track"])
    t = rng.permutation(track_lengths(l, e, cap, gen["track_seed"]))

    cams = np.zeros((c, 6))
    cams[:, 0] = np.linspace(0.0, gen["baseline"] * c, c)
    cams[:, 1] = rng.normal(0, 0.05, c)
    cams[:, 2] = rng.normal(0, 0.05, c)
    cams[:, 3:] = np.cumsum(rng.normal(0, gen["rotation_walk"], (c, 3)),
                            axis=0)
    intr = None
    if snavely:
        f_lo, f_hi = gen["focal_range"]
        intr = np.stack([rng.uniform(f_lo, f_hi, c),
                         np.full(c, gen["k1"]), np.full(c, gen["k2"])], 1)
        # unused by the Snavely projection; the original's constant
        k = np.array([[500.0, 0, 0], [0, 500.0, 0], [0, 0, 1.0]])
    else:
        fx, fy, cx, cy = config["pinhole"]
        k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])

    # landmark l is seen by keyframes anchor .. anchor + t - 1, anchors
    # spread evenly in landmark order along the trajectory, so the last
    # keyframe is seen as often as the first (the original's spread reached
    # it with one landmark only); placed in view of its anchor
    anchor = (np.arange(l) * (c - t + 1)) // l
    z0, z1 = gen["depth_range"]
    zdepth = rng.uniform(z0, z1, l)
    if snavely:
        pu = rng.uniform(-0.35, 0.35, l)
        pv = rng.uniform(-0.25, 0.25, l)
        y_cf0 = np.stack([pu * zdepth, pv * zdepth, -zdepth], 1)
    else:
        w_img, h_img = config["image_size"]
        pu = rng.uniform(0.15 * w_img, 0.85 * w_img, l)
        pv = rng.uniform(0.15 * h_img, 0.85 * h_img, l)
        y_cf0 = np.stack([(pu - cx) / fx * zdepth,
                          (pv - cy) / fy * zdepth, zdepth], 1)
    pts = rodrigues(-cams[anchor, 3:], y_cf0 - cams[anchor, :3])

    lmk_idx = np.repeat(np.arange(l), t)
    start = np.repeat(np.cumsum(t) - t, t)
    cam_idx = np.repeat(anchor, t) + (np.arange(e) - start)
    y_cf = rodrigues(cams[cam_idx, 3:], pts[lmk_idx]) + cams[cam_idx, :3]
    if snavely:
        z = np.minimum(y_cf[:, 2], -1e-3)
        f_e, k1_e, k2_e = intr[cam_idx].T
        px, py = -y_cf[:, 0] / z, -y_cf[:, 1] / z
        rho = px * px + py * py
        dist = 1.0 + rho * (k1_e + k2_e * rho)
        meas = np.stack([f_e * dist * px, f_e * dist * py], 1)
    else:
        z = np.maximum(y_cf[:, 2], 1e-3)
        meas = np.stack([fx * y_cf[:, 0] / z + cx,
                         fy * y_cf[:, 1] / z + cy], 1)
    meas = meas + rng.normal(0, gen["pixel_noise"], meas.shape)
    lmk_init = pts + rng.normal(0, config["init"]["lmk_noise"], pts.shape)
    return Problem(n_keyframes=c, n_points=l, n_edges=e, k=k,
                   intrinsics=intr, cam_idx=cam_idx.astype(np.uint32),
                   lmk_idx=lmk_idx.astype(np.uint32), measurements=meas,
                   cam_init=cams.copy(), lmk_init=lmk_init, cam_true=cams,
                   lmk_true=pts)
