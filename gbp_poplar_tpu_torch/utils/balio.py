"""BAL-format problem loading.

Two on-disk formats are supported and auto-detected:

- the reference's TUM variant (reference: ba/dataio.cpp:17-57,
  include/dataio.h:11-69): header ``n_keyframes n_points n_edges``, shared
  pinhole intrinsics ``fx fy cx cy``, one ``camID lmkID u v`` line per
  edge, then ``6*n_keyframes + 3*n_points`` initial parameters;
- the original BAL dataset format (Agarwal et al., "Bundle Adjustment in
  the Large"): header, observations, then NINE parameters per camera
  (axis-angle rotation, translation, focal f, radial distortion k1 k2) and
  three per point. These use the Snavely camera model (camera looks down
  -z, ``uv = f (1 + k1 r^2 + k2 r^4) * -(x/z, y/z)``, pixels centred);
  loading one sets :attr:`BAProblem.intrinsics` and the whole solver stack
  (GBP sweeps, kernels, GN/coarse/polish, oracles) switches to that model.
  The intrinsics are held fixed (the reference never optimises intrinsics
  either).

The counterpart of ``gbp_poplar_tpu/utils/balio.py``, copied so that the
PyTorch package never imports the JAX one. Plain TUM-variant files go
through the native C++ parser (native/balio.cpp, built with g++ on first
use); original-BAL (Snavely) and compressed files, files the strict native
parse refuses, and machines where it cannot be built take the NumPy path
below, which is also the native parser's correctness oracle.
"""

from __future__ import annotations

import dataclasses
import os
import warnings

import numpy as np

# Candidate directories for the TUM sequences shipped with the reference.
_SEQUENCE_DIRS = [
    os.environ.get("GBP_SEQUENCES_DIR", ""),
    os.path.join(os.path.dirname(__file__), "..", "..", "data", "sequences"),
]


@dataclasses.dataclass
class BAProblem:
    """A bundle-adjustment problem instance (host-side, NumPy)."""

    n_keyframes: int
    n_points: int
    n_edges: int
    k: np.ndarray            # [3, 3] intrinsics
    cam_idx: np.ndarray      # [E] uint32
    lmk_idx: np.ndarray      # [E] uint32
    measurements: np.ndarray  # [E, 2] float
    cam_means: np.ndarray    # [C, 6] float — initial pose parameters
    lmk_means: np.ndarray    # [L, 3] float — initial landmark positions
    # Snavely/BAL per-camera intrinsics (f, k1, k2), or None for the shared
    # pinhole model. Presence selects the camera model everywhere.
    intrinsics: np.ndarray | None = None   # [C, 3] float or None

    @property
    def camera_model(self) -> str:
        return "pinhole" if self.intrinsics is None else "snavely"

    @property
    def n_edges_per_kf(self) -> np.ndarray:
        return np.bincount(self.cam_idx, minlength=self.n_keyframes)

    @property
    def n_edges_per_lmk(self) -> np.ndarray:
        return np.bincount(self.lmk_idx, minlength=self.n_points)


def find_sequence(name: str) -> str:
    """Resolve a sequence name (e.g. 'fr1xyz') to a file path."""
    if os.path.exists(name):
        return name
    suffixes = ("", ".txt", ".txt.bz2", ".txt.gz")
    for d in _SEQUENCE_DIRS:
        for suf in suffixes:
            if d and os.path.exists(os.path.join(d, name + suf)):
                return os.path.join(d, name + suf)
    raise FileNotFoundError(
        f"sequence '{name}' not found in {_SEQUENCE_DIRS}; "
        "set GBP_SEQUENCES_DIR"
    )


def _open_text(path: str):
    """Open a BAL file, transparently decompressing by suffix — the
    published BAL datasets (Ladybug, Venice, Final...) ship as
    problem-*.txt.bz2 (the reference requires pre-decompressed files)."""
    if path.endswith(".bz2"):
        import bz2
        return bz2.open(path, "rt")
    if path.endswith(".gz"):
        import gzip
        return gzip.open(path, "rt")
    return open(path)


def _load_native(path: str) -> BAProblem | None:
    """The native parse of ``path``, or None where the parser refuses the
    file or cannot be built (a warning then says why)."""
    from ..native import balio_native

    try:
        balio_native.library()
    except (OSError, RuntimeError) as exc:
        warnings.warn(f"native BAL parser unavailable, using NumPy: {exc}")
        return None
    try:
        return balio_native.load(path)
    except ValueError:
        return None


def _sniff_is_snavely(path: str) -> bool:
    """Cheap line-2 sniff: the TUM variant's second line is the shared
    intrinsics ``fx fy cx cy`` (floats, written with decimal points);
    original-BAL's second line is the first observation ``cam pt u v``
    with two bare integer indices. Ambiguous sniffs fall through to the
    exact token-count check in :func:`_from_tokens`."""
    with _open_text(path) as f:
        header = f.readline().split()
        second = f.readline().split()
    if len(header) < 3 or len(second) < 2:
        return False
    try:
        n_kf, n_pts = int(float(header[0])), int(float(header[1]))
        t0, t1 = second[0], second[1]
        plain_int = all(ch not in t for t in (t0, t1) for ch in ".eE")
        return plain_int and 0 <= int(t0) < n_kf and 0 <= int(t1) < n_pts
    except ValueError:
        return False   # non-numeric tokens: let the exact parse decide


def load_bal(path_or_name: str, use_native: bool = True) -> BAProblem:
    """Load a BAL-format file (TUM variant or original BAL) into a
    BAProblem. The format is auto-detected (see module docstring); with
    ``use_native`` an uncompressed TUM-variant file is parsed natively."""
    path = find_sequence(path_or_name)
    if (use_native and not path.endswith((".bz2", ".gz"))
            and not _sniff_is_snavely(path)):
        problem = _load_native(path)
        if problem is not None:
            return problem
    # read + split tokenises on any whitespace in one pass (np.fromfile
    # with sep=' ' deprecates — and will raise — on non-numeric trailing
    # data, which the strict token-count check below must see instead)
    with _open_text(path) as f:
        raw = f.read().split()
    try:
        tokens = np.asarray(raw, dtype=np.float64)
    except ValueError as exc:
        raise ValueError(f"{path}: non-numeric token in BAL file: {exc}")
    return _from_tokens(tokens, path)


def _from_tokens(tokens: np.ndarray, path: str) -> BAProblem:
    n_kf, n_pts, n_edges = (int(tokens[i]) for i in range(3))
    # exact disambiguation by total token count (the two layouts can never
    # collide: 7 + 6C == 3 + 9C has no integer solution)
    n_tum = 7 + 4 * n_edges + 6 * n_kf + 3 * n_pts
    n_bal = 3 + 4 * n_edges + 9 * n_kf + 3 * n_pts
    if tokens.size == n_bal:
        return _from_tokens_snavely(tokens, n_kf, n_pts, n_edges)
    if tokens.size != n_tum:
        # strict: a truncated/corrupted BAL file must not silently fall
        # through to the TUM parse (which would read the first observation
        # as intrinsics and shift every subsequent value by 4 tokens)
        raise ValueError(
            f"{path}: {tokens.size} tokens matches neither the TUM layout "
            f"({n_tum}) nor the BAL layout ({n_bal})")

    fx, fy, cx, cy = tokens[3:7]
    k = np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], np.float64)

    edge_block = tokens[7 : 7 + 4 * n_edges].reshape(n_edges, 4)
    cam_idx = edge_block[:, 0].astype(np.uint32)
    lmk_idx = edge_block[:, 1].astype(np.uint32)
    measurements = edge_block[:, 2:4].astype(np.float64)

    params = tokens[7 + 4 * n_edges :]
    n_params = 6 * n_kf + 3 * n_pts
    if params.size < n_params:
        raise ValueError(f"{path}: expected {n_params} parameters, got {params.size}")
    cam_means = params[: 6 * n_kf].reshape(n_kf, 6)
    lmk_means = params[6 * n_kf : n_params].reshape(n_pts, 3)

    return BAProblem(
        n_keyframes=n_kf,
        n_points=n_pts,
        n_edges=n_edges,
        k=k,
        cam_idx=cam_idx,
        lmk_idx=lmk_idx,
        measurements=measurements,
        cam_means=cam_means.copy(),
        lmk_means=lmk_means.copy(),
    )


def _from_tokens_snavely(
    tokens: np.ndarray, n_kf: int, n_pts: int, n_edges: int
) -> BAProblem:
    """Original BAL layout: observations, then 9 params per camera
    (w[3], t[3], f, k1, k2 — rotation FIRST, Snavely convention), then 3
    per point."""
    edge_block = tokens[3 : 3 + 4 * n_edges].reshape(n_edges, 4)
    p0 = 3 + 4 * n_edges
    cam_params = tokens[p0 : p0 + 9 * n_kf].reshape(n_kf, 9)
    lmk_means = tokens[p0 + 9 * n_kf : p0 + 9 * n_kf + 3 * n_pts].reshape(
        n_pts, 3)
    # internal pose layout is (t, w)
    cam_means = np.concatenate([cam_params[:, 3:6], cam_params[:, 0:3]], 1)
    return BAProblem(
        n_keyframes=n_kf,
        n_points=n_pts,
        n_edges=n_edges,
        k=np.eye(3, dtype=np.float64),   # unused under the Snavely model
        cam_idx=edge_block[:, 0].astype(np.uint32),
        lmk_idx=edge_block[:, 1].astype(np.uint32),
        measurements=edge_block[:, 2:4].astype(np.float64).copy(),
        cam_means=cam_means.copy(),
        lmk_means=lmk_means.copy(),
        intrinsics=cam_params[:, 6:9].copy(),
    )


def save_bal(path: str, problem: BAProblem) -> None:
    """Write a BAProblem back out (TUM variant, or original BAL layout when
    the problem carries Snavely intrinsics)."""
    snavely = problem.intrinsics is not None
    with open(path, "w") as f:
        f.write(f"{problem.n_keyframes} {problem.n_points} {problem.n_edges}\n")
        if not snavely:
            k = problem.k
            f.write(f"{k[0, 0]:.9f} {k[1, 1]:.9f} "
                    f"{k[0, 2]:.9f} {k[1, 2]:.9f}\n")
        for c, l, (u, v) in zip(problem.cam_idx, problem.lmk_idx, problem.measurements):
            f.write(f"{c} {l}\t{u:.6e} {v:.6e}\n")
        for i, row in enumerate(problem.cam_means):
            if snavely:
                # BAL camera block: w[3], t[3], f, k1, k2
                row = np.concatenate([row[3:6], row[0:3],
                                      problem.intrinsics[i]])
            f.write("\n".join(f"{x:.16e}" for x in row) + "\n")
        for row in problem.lmk_means:
            f.write("\n".join(f"{x:.16e}" for x in row) + "\n")


def _so3exp_np(w: np.ndarray) -> np.ndarray:
    """Rodrigues' formula for one axis-angle vector (NumPy, generators)."""
    theta = np.linalg.norm(w)
    if theta < 1e-9:
        return np.eye(3)
    w_hat = np.array(
        [[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    return (np.eye(3) + np.sin(theta) / theta * w_hat
            + (1 - np.cos(theta)) / theta**2 * (w_hat @ w_hat))


def synthetic_problem(
    n_keyframes: int = 6,
    n_points: int = 60,
    seed: int = 0,
    obs_per_lmk: int = 3,
    image_size: tuple[int, int] = (640, 480),
    pixel_noise: float = 0.0,
) -> BAProblem:
    """Generate a consistent synthetic BA problem for tests.

    Cameras on an arc looking at a cloud of points in front of them;
    measurements are exact projections plus optional pixel noise.
    """
    rng = np.random.default_rng(seed)
    fx = fy = 500.0
    cx, cy = image_size[0] / 2, image_size[1] / 2
    k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])

    # Points in a box in front of the cameras (world frame).
    pts = rng.uniform([-2, -2, 4], [2, 2, 8], size=(n_points, 3))

    # Cameras: small lateral offsets, looking down +z with tiny rotations.
    cams = np.zeros((n_keyframes, 6))
    cams[:, 0] = np.linspace(-1.0, 1.0, n_keyframes)          # x translation
    cams[:, 1] = rng.normal(0, 0.05, n_keyframes)
    cams[:, 2] = rng.normal(0, 0.05, n_keyframes)
    cams[:, 3:] = rng.normal(0, 0.03, (n_keyframes, 3))       # small rotations

    # Project with the module-level NumPy measurement model.
    cam_idx, lmk_idx, meas = [], [], []
    for l in range(n_points):
        # observed by `obs_per_lmk` nearest cameras (by index ring)
        start = l % n_keyframes
        for j in range(min(obs_per_lmk, n_keyframes)):
            c = (start + j) % n_keyframes
            r = _so3exp_np(cams[c, 3:])
            p = r @ pts[l] + cams[c, :3]
            if p[2] <= 0.1:
                continue
            u = fx * p[0] / p[2] + cx
            v = fy * p[1] / p[2] + cy
            cam_idx.append(c)
            lmk_idx.append(l)
            meas.append([u, v])
    meas = np.asarray(meas)
    if pixel_noise > 0:
        meas = meas + rng.normal(0, pixel_noise, meas.shape)

    order = np.argsort(np.asarray(cam_idx), kind="stable")
    return BAProblem(
        n_keyframes=n_keyframes,
        n_points=n_points,
        n_edges=len(cam_idx),
        k=k,
        cam_idx=np.asarray(cam_idx, np.uint32)[order],
        lmk_idx=np.asarray(lmk_idx, np.uint32)[order],
        measurements=meas[order],
        cam_means=cams,
        lmk_means=pts,
    )


def synthetic_problem_snavely(
    n_keyframes: int = 8,
    n_points: int = 80,
    seed: int = 0,
    obs_per_lmk: int = 4,
    pixel_noise: float = 0.0,
    distortion: tuple[float, float] = (-0.3, 0.1),
) -> BAProblem:
    """Synthetic problem under the Snavely/BAL camera model (per-camera
    focal + radial distortion, camera looks down -z). Used to exercise the
    BAL-dataset code path without shipping a BAL dataset."""
    rng = np.random.default_rng(seed)
    # points in front of the cameras = NEGATIVE z (Snavely convention)
    pts = rng.uniform([-2, -2, -8], [2, 2, -4], size=(n_points, 3))
    cams = np.zeros((n_keyframes, 6))
    cams[:, 0] = np.linspace(-1.0, 1.0, n_keyframes)
    cams[:, 1] = rng.normal(0, 0.05, n_keyframes)
    cams[:, 2] = rng.normal(0, 0.05, n_keyframes)
    cams[:, 3:] = rng.normal(0, 0.03, (n_keyframes, 3))
    intr = np.stack([
        rng.uniform(450.0, 550.0, n_keyframes),
        np.full(n_keyframes, distortion[0]),
        np.full(n_keyframes, distortion[1]),
    ], axis=1)

    cam_idx, lmk_idx, meas = [], [], []
    for l in range(n_points):
        start = l % n_keyframes
        for j in range(min(obs_per_lmk, n_keyframes)):
            c = (start + j) % n_keyframes
            p = _so3exp_np(cams[c, 3:]) @ pts[l] + cams[c, :3]
            if p[2] >= -0.1:          # must be in front: z < 0
                continue
            px, py = -p[0] / p[2], -p[1] / p[2]
            rho = px * px + py * py
            dist = 1.0 + rho * (intr[c, 1] + intr[c, 2] * rho)
            cam_idx.append(c)
            lmk_idx.append(l)
            meas.append([intr[c, 0] * dist * px, intr[c, 0] * dist * py])
    meas = np.asarray(meas)
    if pixel_noise > 0:
        meas = meas + rng.normal(0, pixel_noise, meas.shape)
    order = np.argsort(np.asarray(cam_idx), kind="stable")
    return BAProblem(
        n_keyframes=n_keyframes, n_points=n_points, n_edges=len(cam_idx),
        k=np.eye(3),
        cam_idx=np.asarray(cam_idx, np.uint32)[order],
        lmk_idx=np.asarray(lmk_idx, np.uint32)[order],
        measurements=meas[order],
        cam_means=cams, lmk_means=pts, intrinsics=intr,
    )


def _rodrigues(w: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Batched axis-angle rotation R(w) y (NumPy; rows of w and y pair up).
    R y = y cos(t) + (axis x y) sin(t) + axis (axis . y)(1 - cos(t))."""
    theta = np.linalg.norm(w, axis=1, keepdims=True)
    theta = np.where(theta < 1e-12, 1e-12, theta)
    axis = w / theta
    ct, st = np.cos(theta), np.sin(theta)
    cross = np.cross(axis, y)
    dot = np.sum(axis * y, axis=1, keepdims=True)
    return y * ct + cross * st + axis * dot * (1 - ct)


def synthetic_problem_large(
    n_keyframes: int = 1723,
    n_points: int = 156_000,
    obs_per_lmk: int = 7,
    seed: int = 0,
    pixel_noise: float = 0.5,
    snavely: bool = False,
) -> BAProblem:
    """Fully-vectorised generator for Ladybug-scale problems (~1M edges).

    Cameras along a line looking at a deep point cloud; each landmark
    observed by `obs_per_lmk` consecutive keyframes (a trajectory
    visibility pattern, like the BAL Ladybug sequences). Unlike
    :func:`synthetic_problem` there is no per-edge Python loop, so building
    a million-edge problem takes ~1 s. With ``snavely`` the problem uses
    the BAL camera model (per-camera f/k1/k2, points in front at -z).
    """
    rng = np.random.default_rng(seed)
    fx = fy = 500.0
    cx, cy = (0.0, 0.0) if snavely else (320.0, 240.0)
    k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])

    cams = np.zeros((n_keyframes, 6))
    cams[:, 0] = np.linspace(0.0, 0.02 * n_keyframes, n_keyframes)
    cams[:, 1] = rng.normal(0, 0.05, n_keyframes)
    cams[:, 2] = rng.normal(0, 0.05, n_keyframes)
    # Orientations drift SMOOTHLY (random walk), not independently: under
    # the y_cf = R y + t convention the rotation lever arm is |t| (~50
    # units at 2500 kf), so independent N(0, 0.02) per-camera rotations
    # displace a shared landmark by ~|dw| * |t| ~ 1.5 units between
    # neighbouring views — deeper than the 4-8 sampling depth, putting a
    # tail of landmarks BEHIND their non-anchor observers, whose clamped
    # projections then make the generated measurements astronomically
    # inconsistent (oracle err 7.7 px at 10M edges, round-5 find). A
    # 0.002/step walk keeps neighbour deltas ~0.004 rad while still
    # exercising the full rotation DOF over the trajectory.
    cams[:, 3:] = np.cumsum(rng.normal(0, 0.002, (n_keyframes, 3)), axis=0)
    intr = None
    if snavely:
        intr = np.stack([rng.uniform(450.0, 550.0, n_keyframes),
                         np.full(n_keyframes, -0.3),
                         np.full(n_keyframes, 0.1)], axis=1)

    # Landmark l must be IN VIEW of the cameras that see it: sample a
    # sensor pixel + a depth and back-project through the anchor pose
    # (y = R^T (y_cf - t)). The pre-round-5 placement added the anchor's
    # TRANSLATION x to the landmark — but under this convention the
    # camera center is -R^T t, so camera and "its" landmarks drifted
    # ~2 t_x apart: at 1723 keyframes that is ~69 units at 4-8 depth,
    # a grazing-geometry problem whose conditioning degrades with chain
    # length (the 1.09M-edge solve plateaued at 14 px under EVERY
    # schedule while the 200-kf shape converged — root-caused round 5).
    anchor = (np.arange(n_points) * max(1, n_keyframes - obs_per_lmk)
              // max(1, n_points - 1)).astype(np.int64)
    anchor = np.minimum(anchor, n_keyframes - obs_per_lmk)
    zdepth = rng.uniform(4, 8, n_points)
    if snavely:
        pu = rng.uniform(-0.35, 0.35, n_points)
        pv = rng.uniform(-0.25, 0.25, n_points)
        y_cf0 = np.stack([pu * zdepth, pv * zdepth, -zdepth], 1)
    else:
        pu = rng.uniform(0.15 * 2 * cx, 0.85 * 2 * cx, n_points)
        pv = rng.uniform(0.15 * 2 * cy, 0.85 * 2 * cy, n_points)
        y_cf0 = np.stack([(pu - cx) / fx * zdepth,
                          (pv - cy) / fy * zdepth, zdepth], 1)
    pts = _rodrigues(-cams[anchor, 3:], y_cf0 - cams[anchor, :3])

    # edges: landmark l observed by keyframes anchor..anchor+obs-1
    lmk_idx = np.repeat(np.arange(n_points, dtype=np.uint32), obs_per_lmk)
    cam_idx = (np.repeat(anchor, obs_per_lmk)
               + np.tile(np.arange(obs_per_lmk), n_points)).astype(np.uint32)

    # vectorised projection (batched Rodrigues via the JAX ops would pull in
    # a device; keep it NumPy)
    y_cf = _rodrigues(cams[cam_idx, 3:], pts[lmk_idx]) + cams[cam_idx, :3]
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
    if pixel_noise > 0:
        meas = meas + rng.normal(0, pixel_noise, meas.shape)

    return BAProblem(
        n_keyframes=n_keyframes, n_points=n_points, n_edges=len(cam_idx),
        k=k, cam_idx=cam_idx, lmk_idx=lmk_idx, measurements=meas,
        cam_means=cams, lmk_means=pts, intrinsics=intr,
    )
