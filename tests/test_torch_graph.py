"""Problem generators, BAL I/O, graph and state of the PyTorch port against
the JAX package.

Generators and I/O are NumPy in both packages: their arrays must be equal.
Graph and state fields are compared field by field; the only float
differences come from the prior Jacobians (PyTorch's and XLA's sin, cos
and sqrt round differently), bounded by a few float32 ulps.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from gbp_poplar_tpu.config import GBPConfig as JaxConfig
from gbp_poplar_tpu.core import build_graph as jax_build_graph
from gbp_poplar_tpu.core import init_state as jax_init_state
from gbp_poplar_tpu.utils import balio as jax_balio
from gbp_poplar_tpu_torch.config import GBPConfig
from gbp_poplar_tpu_torch.core import factor_graph as fg
from gbp_poplar_tpu_torch.utils import balio, priors

torch.set_num_threads(1)

RTOL = 1e-5        # prior strengths: max |J|^2 through sin/cos/sqrt

PROBLEMS = {
    "pinhole": ("synthetic_problem",
                dict(n_keyframes=6, n_points=60, seed=0, pixel_noise=0.5)),
    "snavely": ("synthetic_problem_snavely", dict(pixel_noise=0.5)),
    "large": ("synthetic_problem_large",
              dict(n_keyframes=40, n_points=3000, obs_per_lmk=7, seed=1)),
}


def _problems(name):
    fn, kw = PROBLEMS[name]
    return getattr(balio, fn)(**kw), getattr(jax_balio, fn)(**kw)


def _assert_problem_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or y is None:
            assert x is None and y is None, f.name
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=f.name)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_generators_match(name):
    tp, jp = _problems(name)
    _assert_problem_equal(tp, jp)


@pytest.mark.parametrize("name", ["pinhole", "snavely"])
def test_save_load_round_trip(name, tmp_path):
    tp, _ = _problems(name)
    path = str(tmp_path / "p.txt")
    balio.save_bal(path, tp)
    back = balio.load_bal(path)
    ref = jax_balio.load_bal(path, use_native=False)
    _assert_problem_equal(back, ref)
    np.testing.assert_allclose(back.measurements, tp.measurements,
                               rtol=1e-6, atol=0)
    assert back.camera_model == tp.camera_model


def _compare(t, j, what, rtol=RTOL):
    a = np.asarray(j)
    b = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if a.dtype.kind in "biu":
        np.testing.assert_array_equal(b, a, err_msg=what)
    else:
        np.testing.assert_allclose(b, a, rtol=rtol,
                                   atol=rtol * np.abs(a).max(), err_msg=what)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_build_graph_matches(name):
    tp, jp = _problems(name)
    cfg = GBPConfig()
    g = fg.build_graph(tp, cfg, "cpu")
    jg = jax_build_graph(jp, JaxConfig())
    for f in fg.GRAPH_FIELDS:
        t, j = getattr(g, f), getattr(jg, f)
        if j is None:
            assert t is None, f
            continue
        _compare(t, j, f)
    assert g.n_edges == jg.n_edges == fg.padded_n_edges(tp, cfg)
    assert g.n_edges % cfg.edge_pad_multiple == 0
    # canonical order: landmark-major, keyframe-minor over the real edges
    n = tp.n_edges
    key = g.lmk_idx[:n].long() * tp.n_keyframes + g.cam_idx[:n].long()
    assert bool((key[1:] > key[:-1]).all())


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_init_state_matches(name):
    tp, jp = _problems(name)
    s = fg.init_state(tp, GBPConfig(), "cpu")
    js = jax_init_state(jp, JaxConfig())
    out = fg.state_to_numpy(s)
    for f in fg.STATE_FIELDS:
        _compare(out[f], getattr(js, f), f)
    # padding edges are inactive, the counter starts at -iters_before_damping
    assert int(s.active.sum()) == tp.n_edges
    assert bool((s.damping_count == -15).all())


@pytest.mark.parametrize("name", ["pinhole", "large"])
def test_segments_cover_real_edges_in_order(name):
    tp, _ = _problems(name)
    g = fg.build_graph(tp, GBPConfig(), "cpu")
    for seg, idx, n_var in ((g.cam_seg, g.cam_idx, tp.n_keyframes),
                            (g.lmk_seg, g.lmk_idx, tp.n_points)):
        ptr = seg.ptr.long()
        assert seg.n_var == n_var and int(ptr[-1]) == tp.n_edges
        edges = (torch.arange(tp.n_edges) if seg.perm is None
                 else seg.perm.long())
        # every real edge once, each segment ascending and of its variable
        assert torch.equal(torch.sort(edges).values,
                           torch.arange(tp.n_edges))
        for v in range(0, n_var, max(1, n_var // 50)):
            e = edges[ptr[v]:ptr[v + 1]]
            assert bool((idx[e] == v).all())
            assert bool((e[1:] > e[:-1]).all())
    assert g.lmk_seg.perm is None          # landmark-sorted already


def test_from_numpy_round_trip():
    tp, jp = _problems("snavely")
    cfg = JaxConfig()
    jg = jax_build_graph(jp, cfg)
    js = jax_init_state(jp, cfg)
    g = fg.graph_from_numpy(
        {f: (None if getattr(jg, f) is None else np.asarray(getattr(jg, f)))
         for f in fg.GRAPH_FIELDS}, "cpu")
    for f in fg.GRAPH_FIELDS:
        _compare(getattr(g, f), getattr(jg, f), f, rtol=0)
    fields = {f: np.asarray(getattr(js, f)) for f in fg.STATE_FIELDS}
    s = fg.state_from_numpy(fields, "cpu")
    out = fg.state_to_numpy(s)
    for f in fg.STATE_FIELDS:
        np.testing.assert_array_equal(out[f], fields[f], err_msg=f)
    # the tensors own their memory: writing them leaves the JAX arrays alone
    s.damping_count += 1
    assert np.array_equal(np.asarray(js.damping_count), fields["damping_count"])
    # the segments of a padded JAX graph list every edge, padding included
    assert int(g.cam_seg.ptr[-1]) == jg.n_edges


@pytest.mark.parametrize("name", ["pinhole", "large"])
def test_flag_schedules_match(name):
    """The batch and SLAM flag schedules are NumPy in both packages: equal
    arrays, keyframe by keyframe."""
    from gbp_poplar_tpu.utils import flags as jax_flags
    from gbp_poplar_tpu_torch.utils import flags

    tp, jp = _problems(name)
    for a, b in zip(flags.ba_flags(tp, 5), jax_flags.ba_flags(jp, 5)):
        np.testing.assert_array_equal(a, b)
    ft, fj = flags.create_flags(tp, 5), jax_flags.create_flags(jp, 5)
    for kf in range(min(4, tp.n_keyframes - 2)):
        for a, b in zip(ft, fj):
            np.testing.assert_array_equal(a, b)
        (ft, nt), (fj, nj) = (flags.update_flags(tp, ft, 5, kf),
                              jax_flags.update_flags(jp, fj, 5, kf))
        assert nt == nj


def test_prior_lambdas_match():
    from gbp_poplar_tpu.utils import priors as jax_priors

    tp, jp = _problems("large")
    ct, lt = priors.prior_lambdas(tp, 4.0)
    cj, lj = jax_priors.prior_lambdas(jp, 4.0)
    _compare(ct, cj, "cam")
    _compare(lt, lj, "lmk")
    assert jax.numpy.all(cj > 0)


def test_from_jax_checkpoint(tmp_path):
    """A JAX checkpoint npz (state and graph) loads into the port, and one
    sweep from it matches the same sweep from the in-memory fields."""
    from gbp_poplar_tpu.core import gbp as jax_gbp
    from gbp_poplar_tpu.utils.checkpoint import save_checkpoint
    from gbp_poplar_tpu_torch.core import gbp

    _, jp = _problems("pinhole")
    cfg = JaxConfig(use_pallas=False, accel_every=0)
    jg = jax_build_graph(jp, cfg)
    js = jax_gbp.initialise(jax_init_state(jp, cfg), jg, cfg)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, js, jg, step=0, cfg=cfg)
    with np.load(path) as z:
        s = fg.state_from_numpy(z, "cpu")
        g = fg.graph_from_numpy(z, "cpu")
    want = fg.state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in fg.STATE_FIELDS}, "cpu")
    for f in fg.STATE_FIELDS:
        np.testing.assert_array_equal(fg.state_to_numpy(s)[f],
                                      fg.state_to_numpy(want)[f], err_msg=f)
    assert g.intr is None and g.n_edges == jg.n_edges
    tc = GBPConfig(accel_every=0)
    out_a = fg.state_to_numpy(gbp.gbp_sweep(s, g, tc))
    out_b = fg.state_to_numpy(gbp.gbp_sweep(
        want, fg.build_graph(_problems("pinhole")[0], tc, "cpu"), tc))
    for f in fg.STATE_FIELDS:
        np.testing.assert_allclose(out_a[f], out_b[f], rtol=1e-6,
                                   atol=1e-6 * np.abs(out_b[f]).max(),
                                   err_msg=f)
