"""The generator hits each configuration's published sizes exactly, keeps
the trajectory problems to the bit (pinned digests), and makes photo
collections (``visibility: "collection"``) that keep the model's
properties at BAL Venice-1778's published sizes."""

import copy
import dataclasses
import hashlib
import json
import os
import time

import numpy as np
import pytest
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

import gen
from tiny import COLLECTION, SIZES

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _configs():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    return [(c["name"], os.path.join(ROOT, c["file"]))
            for c in bench["configs"]]


def _config(name):
    with open(dict(_configs())[name]) as f:
        return json.load(f)


def _collection(base="bal-ladybug-1723", **sizes):
    """A photo collection from ``base``'s keys and the collection model's
    own, at ``sizes``."""
    cfg = _config(base)
    cfg.update(sizes)
    cfg["generator"].update(COLLECTION)
    return cfg


VENICE = {"n_keyframes": 1778, "n_points": 993923,
          "n_observations": 5001946}


def _camera_frame(p):
    """Each edge's point at the truth in its camera's frame, [E, 3]."""
    ci, li = p.cam_idx.astype(np.int64), p.lmk_idx.astype(np.int64)
    return (gen.rodrigues(p.cam_true[ci, 3:], p.lmk_true[li])
            + p.cam_true[ci, :3])


def _assert_in_front_and_in_view(p, cfg):
    y = _camera_frame(p)
    depth = -y[:, 2] if cfg["camera_model"] == "snavely" else y[:, 2]
    assert depth.min() > 0
    x, v = np.abs(y[:, 0]) / depth, np.abs(y[:, 1]) / depth
    if cfg["camera_model"] == "snavely":
        assert x.max() <= 0.35 and v.max() <= 0.25
    else:
        fx, fy, cx, cy = cfg["pinhole"]
        w_img, h_img = cfg["image_size"]
        u, r = fx * y[:, 0] / depth + cx, fy * y[:, 1] / depth + cy
        assert 0 <= u.min() and u.max() <= w_img
        assert 0 <= r.min() and r.max() <= h_img


def _covisibility_components(p):
    """Connected components of the cameras linked by shared points."""
    c = p.n_keyframes
    g = coo_matrix((np.ones(p.n_edges), (p.cam_idx.astype(np.int64),
                                        c + p.lmk_idx.astype(np.int64))),
                   shape=(c + p.n_points,) * 2)
    return connected_components(g, directed=False)[0]


def _assert_collection(p, cfg):
    """The collection model's own properties: distinct cameras in each
    track, every camera seen, every observation in front and in view, one
    connected reconstruction."""
    pair = p.lmk_idx.astype(np.int64) * p.n_keyframes + p.cam_idx
    assert np.unique(pair).size == p.n_edges
    assert np.bincount(p.cam_idx, minlength=p.n_keyframes).min() > 0
    _assert_in_front_and_in_view(p, cfg)
    assert _covisibility_components(p) == 1


def _runs_a_chunk(p, lmk_idx=None, chunk=8192):
    """Mean distinct cameras in each chunk of ``chunk`` edges in landmark
    order (``lexsort((cam, lmk))``, the landmarks numbered by ``lmk_idx``,
    by default the problem's): the camera-side partial sums of the
    program's chunk plan."""
    lmk = p.lmk_idx if lmk_idx is None else lmk_idx
    cam = p.cam_idx[np.lexsort((p.cam_idx, lmk))].astype(np.int64)
    runs = np.unique(np.arange(cam.size) // chunk * p.n_keyframes + cam)
    return runs.size / -(-cam.size // chunk)


def _digest(p) -> str:
    """SHA-256 over every field of a problem: names, dtypes, shapes and
    bytes of its arrays, and its counts."""
    h = hashlib.sha256()
    for f in dataclasses.fields(p):
        v = getattr(p, f.name)
        h.update(f.name.encode())
        if isinstance(v, np.ndarray):
            h.update(f"{v.dtype.str}{v.shape}".encode())
            h.update(np.ascontiguousarray(v).tobytes())
        else:
            h.update(repr(v).encode())
    return h.hexdigest()


@pytest.mark.parametrize("name,seed,digest", [
    ("bal-ladybug-1723", 0,
     "711848123f1cc0875c501f9146a2294ebf04ab08433d812215cd18cc5c4bb476"),
    ("bal-ladybug-1723", 2 ** 31 + 5,
     "25edeb2ae16a76e64a4f4e0370df515297cab764ed8465e40e103b1ab9dafe1a"),
    ("tum-fr1desk", 0,
     "810d104b558e645a065ae9b43555781e64a1ab8c1934c1f34d8b23bb0b6b9e04"),
    ("tum-fr1desk", 2 ** 31 + 5,
     "e04a1afcd4f7df4541ec9322bdf31e6050b38959d31fa980cb15fba754d8e02b")])
def test_trajectory_problems_are_pinned_to_the_bit(name, seed, digest):
    """The trajectory problems as first generated, to the bit: a change to
    the generator may not move an existing cell's inputs."""
    assert _digest(gen.make_problem(_config(name), seed)) == digest


@pytest.mark.parametrize("name,path", _configs())
def test_published_sizes_and_tracks(name, path):
    with open(path) as f:
        cfg = json.load(f)
    p = gen.make_problem(cfg, 2 ** 31 + 5)
    assert (p.n_keyframes, p.n_points, p.n_edges) == (
        cfg["n_keyframes"], cfg["n_points"], cfg["n_observations"])
    assert len(p.cam_idx) == len(p.lmk_idx) == cfg["n_observations"]
    tracks = np.bincount(p.lmk_idx, minlength=p.n_points)
    assert tracks.min() >= 2 and tracks.sum() == cfg["n_observations"]
    seen = np.bincount(p.cam_idx, minlength=p.n_keyframes)
    assert seen.min() > 0 and p.cam_idx.max() == p.n_keyframes - 1
    assert (p.intrinsics is not None) == (cfg["camera_model"] == "snavely")
    if cfg["generator"].get("visibility", "trajectory") == "collection":
        _assert_collection(p, cfg)
        return
    # each landmark's run of keyframes is consecutive
    first = np.full(p.n_points, p.n_keyframes)
    np.minimum.at(first, p.lmk_idx, p.cam_idx)
    last = np.zeros(p.n_points, np.int64)
    np.maximum.at(last, p.lmk_idx, p.cam_idx)
    assert np.array_equal(last - first + 1, tracks)


def test_seed_repeats_and_deals_the_same_tracks():
    cfg = _config("tum-fr1desk")
    a, b = gen.make_problem(cfg, 7), gen.make_problem(cfg, 7)
    c = gen.make_problem(cfg, 8)
    assert np.array_equal(a.measurements, b.measurements)
    assert np.array_equal(a.lmk_init, b.lmk_init)
    assert not np.array_equal(a.measurements[:10], c.measurements[:10])
    ta = np.sort(np.bincount(a.lmk_idx))
    tc = np.sort(np.bincount(c.lmk_idx))
    assert np.array_equal(ta, tc)


@pytest.mark.parametrize("n_points,n_obs,cap", [
    (10, 20, 5), (10, 50, 5), (1000, 4337, 64), (7, 23, 63)])
def test_track_lengths_exact(n_points, n_obs, cap):
    t = gen.track_lengths(n_points, n_obs, cap, 3)
    assert t.sum() == n_obs and t.min() >= 2 and t.max() <= cap


def test_track_lengths_refuse_impossible_counts():
    with pytest.raises(ValueError):
        gen.track_lengths(10, 19, 5, 0)
    with pytest.raises(ValueError):
        gen.track_lengths(10, 51, 5, 0)


def _noise_ratio(problems, noise):
    """Mean residual norm at the true means over ``problems``, over that of
    a 2-D N(0, noise^2) residual, noise sqrt(pi / 2)."""
    import reference
    import torch

    norms = []
    for p in problems:
        e = reference.edges(p, torch.device("cpu"))
        _, err, _ = reference.cost(e, p.cam_true, p.lmk_true, 4.0, 2.5)
        norms.append((err, p.n_edges))
    mean = sum(x * n for x, n in norms) / sum(n for _, n in norms)
    return mean / (noise * np.sqrt(np.pi / 2))


def test_generated_measurements_fit_the_truth():
    """At the true means the residuals are the pixel noise alone."""
    cfg = _config("tum-fr1desk")
    ratio = _noise_ratio([gen.make_problem(cfg, 11)],
                         cfg["generator"]["pixel_noise"])
    assert abs(ratio - 1) < 0.03


def test_an_unknown_visibility_is_refused():
    cfg = _collection(**SIZES)
    cfg["generator"]["visibility"] = "orbit"
    with pytest.raises(ValueError):
        gen.make_problem(cfg, 1)


@pytest.fixture(scope="module")
def venice():
    """The collection at BAL Venice-1778's sizes, and its host seconds."""
    cfg = _collection(**VENICE)
    t0 = time.perf_counter()
    p = gen.make_problem(cfg, 2 ** 31 + 5)
    return cfg, p, time.perf_counter() - t0


def test_collection_generates_within_its_host_budget(venice):
    assert venice[2] <= 15.0


def test_collection_keeps_the_sizes_and_the_track_multiset(venice):
    cfg, p, _ = venice
    assert (p.n_keyframes, p.n_points, p.n_edges) == tuple(VENICE.values())
    assert p.cam_idx.size == p.lmk_idx.size == p.n_edges
    assert p.cam_idx.max() == p.n_keyframes - 1
    assert p.lmk_idx.max() == p.n_points - 1
    want = gen.track_lengths(p.n_points, p.n_edges,
                             cfg["generator"]["max_track"],
                             cfg["generator"]["track_seed"])
    assert np.array_equal(np.sort(np.bincount(p.lmk_idx)), np.sort(want))
    assert np.bincount(p.cam_idx, minlength=p.n_keyframes).min() > 0


def test_collection_is_in_front_in_view_and_connected(venice):
    cfg, p, _ = venice
    _assert_collection(p, cfg)


def test_collection_runs_a_chunk_under_both_orderings(venice):
    """Distinct cameras a chunk: the generator's reconstruction order
    draws each chunk from a site or two, several times the trajectory's
    run of keyframes; the same problem with its point ids in arbitrary
    order draws on almost every camera."""
    cfg, p, _ = venice
    traj = copy.deepcopy(cfg)
    traj["generator"]["visibility"] = "trajectory"
    along = _runs_a_chunk(gen.make_problem(traj, 2 ** 31 + 5))
    built = _runs_a_chunk(p)
    shuffled = _runs_a_chunk(p, np.random.default_rng(0).permutation(
        p.n_points)[p.lmk_idx])
    assert 3 * along <= built <= shuffled / 4
    assert shuffled >= 20 * along


def test_collection_repeats_by_seed(venice):
    cfg, p, _ = venice
    again = gen.make_problem(cfg, 2 ** 31 + 5)
    assert _digest(again) == _digest(p)
    other = gen.make_problem(cfg, 2 ** 31 + 6)
    assert not np.array_equal(other.cam_idx, p.cam_idx)
    assert not np.array_equal(other.measurements[:10], p.measurements[:10])


@pytest.mark.parametrize("camera", ["snavely", "pinhole"])
def test_tiny_collection_fits_the_truth(camera):
    """At the tests' tiny sizes (too few cameras for two sites) a problem is
    still made, and its residuals at the truth are the pixel noise: over
    20 seeds, as many edges as the fr1desk check above reads."""
    base = "bal-ladybug-1723" if camera == "snavely" else "tum-fr1desk"
    cfg = _collection(base, **SIZES)
    problems = [gen.make_problem(cfg, 2 ** 31 + s) for s in range(20)]
    for p in problems:
        assert p.n_edges == SIZES["n_observations"]
        _assert_collection(p, cfg)
    ratio = _noise_ratio(problems, cfg["generator"]["pixel_noise"])
    assert abs(ratio - 1) < 0.03


@pytest.mark.parametrize("seed", [2 ** 31 + s for s in range(8)])
def test_few_points_still_connect_and_see_every_camera(seed):
    """40 cameras in 16 sites of two or more, linked by 45 points of two
    observations each (one more than a spanning tree needs)."""
    cfg = _collection(n_keyframes=40, n_points=45, n_observations=90)
    cfg["generator"]["max_track"] = 2
    _assert_collection(gen.make_problem(cfg, seed), cfg)


def test_too_few_observations_to_connect_are_refused():
    """30 points of two observations link at most 31 of 40 cameras."""
    cfg = _collection(n_keyframes=40, n_points=30, n_observations=60)
    cfg["generator"]["max_track"] = 2
    with pytest.raises(ValueError):
        gen.make_problem(cfg, 1)


def test_small_collection_is_well_posed_under_the_priors():
    """Five sites of 12 cameras and more: the reference's solve from the
    initial estimate, under the configuration's priors, ends with the
    measurement term at or below 1.05 times its value at the truth."""
    import reference
    import torch

    cfg = _collection(n_keyframes=60, n_points=3000, n_observations=15000)
    cfg["generator"]["max_track"] = 12
    p = gen.make_problem(cfg, 2 ** 31 + 5)
    _assert_collection(p, cfg)
    dev = torch.device("cpu")
    meas, pri = cfg["measurement"], cfg["priors"]
    priors = reference.priors(p, dev, meas["meas_var"], pri["weaker_factor"],
                              pri["first_cam_prior_std"], pri["anchor_cams"])
    e = reference.edges(p, dev)

    def term(cam, lmk):
        return reference.cost(e, cam, lmk, meas["meas_var"],
                              meas["huber_nstds"])[0]

    truth = term(p.cam_true, p.lmk_true)
    assert term(p.cam_init, p.lmk_init) > 10 * truth
    cam, lmk, _ = reference.solve(e, p.cam_init, p.lmk_init,
                                  meas["meas_var"], meas["huber_nstds"],
                                  priors)
    assert term(cam, lmk) <= 1.05 * truth
