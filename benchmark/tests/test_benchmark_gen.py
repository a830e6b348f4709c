"""The generator hits each configuration's published sizes exactly."""

import json
import os

import numpy as np
import pytest

import gen

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _configs():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    return [(c["name"], os.path.join(ROOT, c["file"]))
            for c in bench["configs"]]


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
    # each landmark's run of keyframes is consecutive
    first = np.full(p.n_points, p.n_keyframes)
    np.minimum.at(first, p.lmk_idx, p.cam_idx)
    last = np.zeros(p.n_points, np.int64)
    np.maximum.at(last, p.lmk_idx, p.cam_idx)
    assert np.array_equal(last - first + 1, tracks)
    assert (p.intrinsics is not None) == (cfg["camera_model"] == "snavely")


def test_seed_repeats_and_deals_the_same_tracks():
    path = dict(_configs())["tum-fr1desk"]
    with open(path) as f:
        cfg = json.load(f)
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


def test_generated_measurements_fit_the_truth():
    """At the true means the residuals are the pixel noise alone."""
    import reference
    import torch

    path = dict(_configs())["tum-fr1desk"]
    with open(path) as f:
        cfg = json.load(f)
    p = gen.make_problem(cfg, 11)
    e = reference.edges(p, torch.device("cpu"))
    _, err, _ = reference.cost(e, p.cam_true, p.lmk_true, 4.0, 2.5)
    noise = cfg["generator"]["pixel_noise"]
    # mean norm of a 2-D N(0, s^2) residual: s sqrt(pi / 2)
    assert abs(err / (noise * np.sqrt(np.pi / 2)) - 1) < 0.03
