"""The benchmark's problem generator: a bundle-adjustment problem at a
configuration's exact sizes, made from ``--seed``.

Two models of which cameras see which points, chosen by the generator key
``visibility``:

- ``"trajectory"`` (the default): a copy of
  ``gbp_poplar_tpu_torch.utils.balio.synthetic_problem_large`` (cameras
  along a line with a smooth rotation walk, each landmark seen by a run of
  consecutive keyframes: the visibility of a vehicle or hand-held
  sequence), kept here so that a change to the program cannot move the
  yardstick. It is extended in two ways: the pinhole intrinsics and image
  size come from the configuration, and the runs' starts are spread so
  that the last keyframe is seen as often as the first.
- ``"collection"``: a photo collection of one city, the kind of problem
  that BAL's Trafalgar, Dubrovnik, Venice and Final are (Snavely, Seitz
  and Szeliski, "Photo Tourism", SIGGRAPH 2006; Agarwal et al., "Building
  Rome in a Day", ICCV 2009). Those sources give the kind, not the
  numbers: every property below that decides the work is an assumption,
  set by the module constants, until the statistics of a real
  collection's file are in the repository.

  - Sites. The cameras are split over ``SITES`` sites: each gets
    ``max_track`` cameras (so no track is cut) and the rest are dealt out
    in shares drawn from a symmetric Dirichlet of concentration
    ``SITE_CONCENTRATION`` (lower is more skewed). Where the cameras are
    too few for that many sites of ``max_track``, fewer sites are made,
    down to one.
  - Points. Each point belongs to one site, drawn with the site's share of
    the cameras, or for a share ``BRIDGE`` of the points to two
    neighbouring sites, and is seen by half of its track in each. A track
    is drawn without replacement from its site's cameras, uniformly
    (Floyd's algorithm, one column of all tracks at a time), so the
    observations per camera are near uniform: real collections are
    skewed there, by an amount not known here.
  - One connected reconstruction, every camera seen. The first points'
    tracks are windows of the cameras in site order, each window sharing
    its first camera with the last of the window before (a window across
    two sites is a bridge point), until every camera is covered. That
    needs ``n_observations - n_points >= n_keyframes - 1``, which any
    connected problem meets; smaller counts raise ``ValueError``.
  - Geometry. The site centres lie one ball radius (``BALL`` x the nearest
    depth) apart along one path through the city. A site's cameras stand
    on a ring around its centre, at distances drawn from ``depth_range``
    and heights within ``LIFT`` x the nearest depth of the centre's, each
    facing the centre; its points lie in a ball of ``BALL`` x the nearest
    depth around it, so that every camera of the site sees every point of
    it; a bridge point lies within the ball of both sites.
  - Ids. Camera ids are a seeded permutation of the sites' order, as a
    list of downloaded photos comes. Point ids are in reconstruction
    order: an incremental reconstruction numbers its points as it
    triangulates them, while it grows from one site to the next. Here the
    sites join in path order, a point joins with its site (a bridge with
    the later of its two) and the points of a site are in no order among
    themselves (a reconstruction that adds a site's cameras one at a time
    orders them further). So a chunk of consecutive points draws on the
    cameras of one or two sites, and not on all of them as ids in
    arbitrary order would.

Both models:

- per-landmark track lengths (each >= 2, at most ``max_track`` and the
  number of cameras) that sum exactly to the source's observation count.
  The multiset of lengths is drawn once per configuration (``track_seed``,
  a geometric tail above 2 with the source's mean); ``--seed`` only deals
  them out to the landmarks, so every seed gives the same amount of work
  in another arrangement;
- every point placed in view of a camera that sees it: a trajectory
  landmark of its run's first keyframe (|x/z| <= 0.35 and |y/z| <= 0.25
  before distortion for the Snavely camera, the middle 70 % of the image
  for the pinhole one), a collection point of every camera of its site or
  sites (in front, |x/z| and |y/z| <= 0.235: inside the Snavely field of
  view and the image of any pinhole that wide);
- the Snavely intrinsics per camera (f uniform in ``focal_range``, ``k1``,
  ``k2``) or the configuration's pinhole, and pixel noise N(0,
  ``pixel_noise``) per axis;
- the initial estimate is the repo's main path: keyframes at their true
  poses, landmarks perturbed by N(0, ``lmk_noise``) per axis.

Each model draws from the seed in its own fixed order (the tests pin the
trajectory problems by digest). Everything is NumPy on the host,
vectorised: 4-8 s at five million edges. Nothing here imports the
program.
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




# The collection model's assumed shape (see the module docstring): sites,
# the Dirichlet concentration of their camera shares, and the share of
# points between two neighbouring sites.
SITES = 16
SITE_CONCENTRATION = 0.5
BRIDGE = 0.05
# A collection site's points lie within BALL x depth_range[0] of its
# centre and its cameras' heights within LIFT x depth_range[0] of the
# centre's: at depth z >= (1 - BALL) depth_range[0], |x/z| <= 0.15 / 0.85
# and |y/z| <= (0.15 + 0.05) / 0.85 = 0.235.
BALL = 0.15
LIFT = 0.05


def make_problem(config: dict, seed: int) -> Problem:
    """The configuration's problem for ``seed`` (any whole number)."""
    gen = config["generator"]
    visibility = gen.get("visibility", "trajectory")
    if visibility not in ("trajectory", "collection"):
        raise ValueError(f"unknown visibility {visibility!r}: "
                         "'trajectory' or 'collection'")
    c, l, e = (config["n_keyframes"], config["n_points"],
               config["n_observations"])
    rng = np.random.default_rng(abs(int(seed)))
    cap = min(c, gen["max_track"])
    t = rng.permutation(track_lengths(l, e, cap, gen["track_seed"]))
    place = _trajectory if visibility == "trajectory" else _collection
    return _observe(config, rng, *place(config, rng, t, cap))


def _intrinsics(config: dict, rng, c: int):
    """([3, 3] shared pinhole intrinsics, [C, 3] Snavely (f, k1, k2) or
    None)."""
    gen = config["generator"]
    if config["camera_model"] == "snavely":
        f_lo, f_hi = gen["focal_range"]
        intr = np.stack([rng.uniform(f_lo, f_hi, c),
                         np.full(c, gen["k1"]), np.full(c, gen["k2"])], 1)
        # unused by the Snavely projection; the original's constant
        return np.array([[500.0, 0, 0], [0, 500.0, 0], [0, 0, 1.0]]), intr
    fx, fy, cx, cy = config["pinhole"]
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]]), None


def _trajectory(config: dict, rng, t: np.ndarray, cap: int):
    """Trajectory visibility: (cameras [C, 6], points [L, 3], k, intrinsics,
    cam_idx, lmk_idx), the edges in landmark order."""
    c, l, e = (config["n_keyframes"], config["n_points"],
               config["n_observations"])
    gen = config["generator"]
    snavely = config["camera_model"] == "snavely"
    cams = np.zeros((c, 6))
    cams[:, 0] = np.linspace(0.0, gen["baseline"] * c, c)
    cams[:, 1] = rng.normal(0, 0.05, c)
    cams[:, 2] = rng.normal(0, 0.05, c)
    cams[:, 3:] = np.cumsum(rng.normal(0, gen["rotation_walk"], (c, 3)),
                            axis=0)
    k, intr = _intrinsics(config, rng, c)

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
        fx, fy, cx, cy = config["pinhole"]
        w_img, h_img = config["image_size"]
        pu = rng.uniform(0.15 * w_img, 0.85 * w_img, l)
        pv = rng.uniform(0.15 * h_img, 0.85 * h_img, l)
        y_cf0 = np.stack([(pu - cx) / fx * zdepth,
                          (pv - cy) / fy * zdepth, zdepth], 1)
    pts = rodrigues(-cams[anchor, 3:], y_cf0 - cams[anchor, :3])

    lmk_idx = np.repeat(np.arange(l), t)
    start = np.repeat(np.cumsum(t) - t, t)
    cam_idx = np.repeat(anchor, t) + (np.arange(e) - start)
    return cams, pts, k, intr, cam_idx, lmk_idx


def _collection(config: dict, rng, t: np.ndarray, cap: int):
    """Photo-collection visibility (see the module docstring): (cameras
    [C, 6], points [L, 3], k, intrinsics, cam_idx, lmk_idx), the edges in
    landmark order."""
    c, l, e = (config["n_keyframes"], config["n_points"],
               config["n_observations"])
    if e - l < c - 1:
        raise ValueError(f"{l} points seen {e} times cannot connect {c} "
                         "cameras")
    gen = config["generator"]
    n_sites = max(1, min(SITES, c // cap))
    size = cap + rng.multinomial(c - n_sites * cap, rng.dirichlet(
        np.full(n_sites, SITE_CONCENTRATION)))
    first = np.cumsum(size) - size
    z0, z1 = gen["depth_range"]
    ball = BALL * z0

    # site centres one ball radius apart along a path with a turning heading
    heading = np.cumsum(rng.normal(0.0, 0.5, n_sites))
    step = ball * np.stack([np.cos(heading), np.zeros(n_sites),
                            np.sin(heading)], 1)
    centre = np.cumsum(step, 0) - step[0]

    # cameras in site order, each facing its site's centre: yaw a about the
    # vertical y axis, w = (0, a, 0), optical axis -z (Snavely) or +z
    # (pinhole), which R(w)^T turns to (-sin a, 0, cos a) times its sign
    yaw = rng.uniform(-np.pi, np.pi, c)
    dist = rng.uniform(z0, z1, c)
    lift = rng.uniform(-LIFT * z0, LIFT * z0, c)
    sign = -1.0 if config["camera_model"] == "snavely" else 1.0
    look = sign * np.stack([-np.sin(yaw), np.zeros(c), np.cos(yaw)], 1)
    site_of = np.repeat(np.arange(n_sites), size)
    pos = centre[site_of] - dist[:, None] * look
    pos[:, 1] += lift
    w = np.zeros((c, 3))
    w[:, 1] = yaw
    cam_id = rng.permutation(c)            # site order -> camera id
    cams = np.empty((c, 6))
    cams[cam_id] = np.concatenate([-rodrigues(w, pos), w], 1)
    k, intr = _intrinsics(config, rng, c)

    # the spine: points 0 .. n_spine - 1 see windows of the cameras in site
    # order, each window's first camera the last of the window before (the
    # last window ends at the last camera), so every camera is seen and all
    # are linked; a window spans at most two sites, since a site holds at
    # least cap cameras
    reach = np.cumsum(t - 1)
    n_spine = int(np.searchsorted(reach, c - 1)) + 1
    ts = t[:n_spine]
    lo = np.minimum(np.concatenate([[0], reach[:n_spine - 1]]), c - ts)

    # points: a site each, drawn with its share of the cameras, or a pair of
    # neighbouring sites (site, site + 1) for the bridges; the spine's by
    # their windows
    site = rng.choice(n_sites, l, p=size / c)
    bridge = (rng.random(l) < BRIDGE) & (n_sites > 1)
    site[bridge] = rng.integers(0, n_sites - 1, int(bridge.sum()))
    site[:n_spine] = site_of[lo]
    bridge[:n_spine] = site_of[lo + ts - 1] != site_of[lo]
    mid = np.where(bridge[:, None],
                   (centre[site] + centre[np.minimum(site + 1, n_sites - 1)])
                   / 2, centre[site])
    radius = np.where(bridge, ball / 2, ball) * rng.random(l) ** (1 / 3)
    way = rng.normal(size=(l, 3))
    pts = mid + (radius / np.linalg.norm(way, axis=1))[:, None] * way

    # tracks (cameras in site order): the spine's windows; then a draw of t
    # cameras from the site, or of half each from the two sites of a bridge
    rest = np.arange(n_spine, l)
    br = rest[bridge[rest]]
    half = (t + 1) // 2
    draw_lmk = np.concatenate([rest, br])
    draw_site = np.concatenate([site[rest], site[br] + 1])
    draw_t = np.concatenate([np.where(bridge[rest], half[rest], t[rest]),
                             (t - half)[br]])
    pick = _subsets(rng, size[draw_site], draw_t)
    along = np.arange(ts.sum()) - np.repeat(np.cumsum(ts) - ts, ts)
    order_cam = np.concatenate([np.repeat(lo, ts) + along,
                                np.repeat(first[draw_site], draw_t) + pick])
    point = np.concatenate([np.repeat(np.arange(n_spine), ts),
                            np.repeat(draw_lmk, draw_t)])

    # point ids in reconstruction order: by the site with which each joins
    # (a bridge's later one), in no order within a site
    lmk_id = np.empty(l, np.int64)
    lmk_id[np.lexsort((rng.random(l), site + bridge))] = np.arange(l)
    pts_out = np.empty_like(pts)
    pts_out[lmk_id] = pts
    cam_idx, lmk_idx = cam_id[order_cam], lmk_id[point]
    order = np.lexsort((cam_idx, lmk_idx))
    return cams, pts_out, k, intr, cam_idx[order], lmk_idx[order]


def _subsets(rng, n: np.ndarray, t: np.ndarray) -> np.ndarray:
    """For each row i, ``t[i]`` distinct values drawn uniformly from
    [0, ``n[i]``) (t <= n), flat and row after row: Floyd's algorithm, its
    step i taken for all rows with more than i values at once."""
    start = np.cumsum(t) - t
    out = np.empty(int(t.sum()), np.int64)
    for i in range(int(t.max(initial=0))):
        rows = np.flatnonzero(t > i)
        j = n[rows] - t[rows] + i
        r = rng.integers(0, j + 1)
        taken = (out[start[rows, None] + np.arange(i)] == r[:, None]).any(1)
        out[start[rows] + i] = np.where(taken, j, r)
    return out


def _observe(config: dict, rng, cams, pts, k, intr, cam_idx,
             lmk_idx) -> Problem:
    """The problem: each edge's measurement at the truth plus pixel noise,
    and the initial estimate (keyframes at their true poses, landmarks
    perturbed by N(0, ``lmk_noise``) per axis)."""
    y_cf = rodrigues(cams[cam_idx, 3:], pts[lmk_idx]) + cams[cam_idx, :3]
    if intr is not None:
        z = np.minimum(y_cf[:, 2], -1e-3)
        f_e, k1_e, k2_e = intr[cam_idx].T
        px, py = -y_cf[:, 0] / z, -y_cf[:, 1] / z
        rho = px * px + py * py
        dist = 1.0 + rho * (k1_e + k2_e * rho)
        meas = np.stack([f_e * dist * px, f_e * dist * py], 1)
    else:
        fx, fy, cx, cy = config["pinhole"]
        z = np.maximum(y_cf[:, 2], 1e-3)
        meas = np.stack([fx * y_cf[:, 0] / z + cx,
                         fy * y_cf[:, 1] / z + cy], 1)
    meas = meas + rng.normal(0, config["generator"]["pixel_noise"],
                             meas.shape)
    lmk_init = pts + rng.normal(0, config["init"]["lmk_noise"], pts.shape)
    c, l = cams.shape[0], pts.shape[0]
    return Problem(n_keyframes=c, n_points=l, n_edges=len(cam_idx), k=k,
                   intrinsics=intr, cam_idx=cam_idx.astype(np.uint32),
                   lmk_idx=lmk_idx.astype(np.uint32), measurements=meas,
                   cam_init=cams.copy(), lmk_init=lmk_init, cam_true=cams,
                   lmk_true=pts)
