"""The port's unfused sweep pipeline against the JAX package's.

The unfused pipeline gathers the beliefs per edge (the port's H5
``reduce_kernel.gather``; JAX: T6 ``blocked_gather``), runs ``edge_math``
with the means solved per edge (H4 ``sweep_kernel.sweep_planes``; JAX: T5
``sweep_edge_math_pallas``) and reduces the messages (H3; JAX: T4). The
JAX kernels run in interpret mode, as the JAX package's own tests run them
on the CPU. The JAX package takes this pipeline on graphs without
fused-sweep windows, such as a photo collection with more than 1,024
unordered cameras (the last test).

Tolerances: a gather copies, so it must be bit-equal on real lanes. One
sweep from the same state: float fields within SWEEP_RTOL of the field's
largest finite magnitude (the two stacks round sin/cos/sqrt differently and
the reductions sum in other orders), every discrete output and every
non-finite lane equal. Inside the port, the unfused and the fused pipeline
must agree to the bit on the CPU: the means solved per edge and per
variable are the same elementwise operations.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbp_poplar_tpu.config import GBPConfig as JaxConfig
from gbp_poplar_tpu.core import build_graph as jax_build_graph
from gbp_poplar_tpu.core import factor_graph as jax_fg
from gbp_poplar_tpu.core import gbp as jax_gbp
from gbp_poplar_tpu.core import init_state as jax_init_state
from gbp_poplar_tpu.ops.reduce_kernel import (blocked_gather,
                                              build_blocked_index)
from gbp_poplar_tpu.utils import balio as jax_balio
from gbp_poplar_tpu_torch import GBPConfig
from gbp_poplar_tpu_torch.core import factor_graph as fg
from gbp_poplar_tpu_torch.core import gbp
from gbp_poplar_tpu_torch.ops import reduce_kernel, sweep_kernel
from gbp_poplar_tpu_torch.utils import balio

torch.set_num_threads(1)

SWEEP_RTOL = 1e-5
PAD = 64

PROBLEMS = {
    "pinhole": ("synthetic_problem",
                dict(n_keyframes=5, n_points=40, seed=4, pixel_noise=0.5)),
    "snavely": ("synthetic_problem_snavely", dict(pixel_noise=0.5)),
}


def _problems(name):
    fn, kw = PROBLEMS[name]
    return getattr(balio, fn)(**kw), getattr(jax_balio, fn)(**kw)


def shuffle_cameras(prob, seed=0):
    """The problem with its cameras relabelled by a random permutation
    (new id of camera c: perm[c]), as the ids of an unordered BAL photo
    collection follow no sequence."""
    perm = np.random.default_rng(seed).permutation(prob.n_keyframes)

    def moved(x):
        if x is None:
            return None
        out = np.empty_like(x)
        out[perm] = x
        return out

    return dataclasses.replace(
        prob, cam_idx=perm[prob.cam_idx].astype(prob.cam_idx.dtype),
        cam_means=moved(prob.cam_means), intrinsics=moved(prob.intrinsics))


def _jax_fields(s):
    return {f: np.asarray(getattr(s, f)) for f in fg.STATE_FIELDS}


def _assert_close(got, want, rtol, msg):
    """Equal non-finite pattern; finite values within rtol of the largest
    finite magnitude; integer and boolean arrays equal."""
    got, want = np.asarray(got), np.asarray(want).reshape(np.shape(got))
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=msg)
        return
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=msg)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=msg)
    scale = np.abs(want[fin]).max() if fin.any() else 0.0
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol,
                               atol=rtol * max(scale, 1e-30), err_msg=msg)


@pytest.fixture(scope="module")
def large():
    """Ladybug-like visibility at 40 keyframes: 21,000 edges."""
    prob = balio.synthetic_problem_large(n_keyframes=40, n_points=3000,
                                         obs_per_lmk=7, seed=1)
    return prob, fg.build_graph(prob, GBPConfig(), "cpu")


@pytest.mark.parametrize("kind", ["cam", "lmk"])
def test_gather_matches_blocked_gather(large, kind):
    """H5's plain version against the JAX blocked one-hot gather (T6, in
    interpret mode) on random planes: bit-equal on the real lanes. (On
    padding lanes T6 returns 0 and an index gather returns variable 0's
    column; padding edges are inactive, so the sweep ignores both.)"""
    prob, g = large
    rng = np.random.default_rng(5)
    comp, n_var, idx, be = (
        (27, prob.n_keyframes, g.cam_idx, 8192) if kind == "cam"
        else (9, prob.n_points, g.lmk_idx, 1024))
    bidx = build_blocked_index(idx.numpy()[:prob.n_edges], n_var, be,
                               n_edges_padded=g.n_edges)
    assert bidx is not None
    src = rng.normal(0, 1, (comp, n_var)).astype(np.float32)
    want = np.asarray(blocked_gather(jnp.asarray(src),
                                     jnp.asarray(idx.numpy()), bidx,
                                     interpret=True))
    got = reduce_kernel.gather(torch.tensor(src), idx)
    assert tuple(got.shape) == (comp, g.n_edges)
    np.testing.assert_array_equal(got.numpy()[:, :prob.n_edges],
                                  want[:, :prob.n_edges])
    assert reduce_kernel.gather.launches == 0           # CPU: plain version


@pytest.fixture(scope="module")
def warmed():
    """Per problem: (port problem, JAX state after initialise + 17 XLA
    sweeps, JAX graph). The next sweep is the first whose damping counter
    passes the relinearisation threshold, with damping already on."""
    out = {}
    cfg = JaxConfig(use_pallas=False, accel_every=0, edge_pad_multiple=PAD)
    for name in PROBLEMS:
        tp, jp = _problems(name)
        jg = jax_build_graph(jp, cfg)
        js = jax.jit(lambda s, jg=jg: jax_gbp.initialise(s, jg, cfg))(
            jax_init_state(jp, cfg))
        step = jax.jit(lambda s, jg=jg: jax_gbp.gbp_sweep(s, jg, cfg))
        for _ in range(17):
            js = step(js)
        out[name] = (tp, js, jg)
    return out


def test_edge_math_without_premu_matches_jax(warmed):
    """``edge_math(premu=None)`` (means solved per edge) against the JAX
    function on the same gathered inputs, with a singular landmark belief,
    a NaN landmark eta and a NaN camera Lambda among them: the guards
    (finiteness of the mean step only, the PSD holds) must take the same
    lanes in both."""
    _, js, jg = warmed["snavely"]
    cam_eta = np.array(js.cam_eta)
    cam_lam = np.array(js.cam_lam)
    lmk_eta = np.array(js.lmk_eta)
    lmk_lam = np.array(js.lmk_lam)
    lmk_lam[:, 3] = 0.0                      # singular -> NaN mean
    lmk_eta[1, 7] = np.nan
    cam_lam[4, 2] = np.nan                   # NaN camera mean, cavity hold
    bc = np.concatenate([cam_eta, cam_lam])[:, np.asarray(jg.cam_idx)]
    bl = np.concatenate([lmk_eta, lmk_lam])[:, np.asarray(jg.lmk_idx)]
    edge = ("f_eta_c", "f_eta_l", "f_lam_cc", "f_lam_cl", "f_lam_ll",
            "msg_c_eta", "msg_c_lam", "msg_l_eta", "msg_l_lam", "damping",
            "damping_count", "mu", "lin_mu", "robust", "active")
    args = ([bc, bl, np.asarray(jg.meas), np.asarray(jg.meas_var)]
            + [np.asarray(getattr(js, n)) for n in edge])
    out_j = jax_gbp.edge_math(*[jnp.asarray(a) for a in args], jg.k,
                              JaxConfig(accel_every=0), intr=jg.intr)
    out_t = gbp.edge_math(*[torch.tensor(a) for a in args],
                          np.asarray(jg.k), GBPConfig(), None,
                          intr=torch.tensor(np.array(jg.intr)))
    for i, (a, b) in enumerate(zip(out_j, out_t)):
        _assert_close(b.numpy(), a, SWEEP_RTOL, str(i))
    mu_bad = ~np.isfinite(out_t[11].numpy()).all(axis=0)
    assert not mu_bad.any()                  # NaN means were never adopted
    relin = out_t[10].numpy() == -GBPConfig().num_undamped_iters
    touched = ((np.asarray(jg.lmk_idx) == 3) | (np.asarray(jg.lmk_idx) == 7)
               | (np.asarray(jg.cam_idx) == 2))
    assert relin[~touched].any() and not relin[touched].any()


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_unfused_sweep_matches_jax_kernels(warmed, monkeypatch, name):
    """One unfused port sweep against JAX ``gbp_sweep`` on its unfused
    kernel path, with T6, T5 and T4 all in interpret mode (the blocked
    structures forced on as tests/test_reduce_kernel.py does)."""
    monkeypatch.setattr(jax_fg, "BLOCKED_REDUCE_MIN_EDGES", 1)
    monkeypatch.setattr(jax_fg, "CAM_ONEHOT_MAX_BYTES", 0)
    tp, js, _ = warmed[name]
    jp = _problems(name)[1]
    jc = JaxConfig(use_pallas="interpret", pallas_fused=False,
                   accel_every=0, edge_pad_multiple=PAD)
    jg = jax_build_graph(jp, jc)
    assert jg.cam_blocked is not None and jg.lmk_blocked is not None
    want = _jax_fields(jax_gbp.gbp_sweep(js, jg, jc))
    before = _jax_fields(js)
    tc = GBPConfig(fused=False, accel_every=0, edge_pad_multiple=PAD)
    graph = fg.build_graph(tp, tc, "cpu")
    sweep_kernel.sweep_planes.launches = 0
    out = fg.state_to_numpy(gbp.gbp_sweep(fg.state_from_numpy(before, "cpu"),
                                          graph, tc))
    for f in fg.STATE_FIELDS:
        _assert_close(out[f], want[f], SWEEP_RTOL, f)
    assert (want["damping_count"] == -jc.num_undamped_iters).sum() > 0
    assert sweep_kernel.sweep_planes.launches == 0      # CPU: plain version


@pytest.mark.parametrize("name", ["pinhole", "snavely", "large"])
def test_unfused_matches_fused_in_port(name):
    """The port's two pipelines from the same state, 20 sweeps each, the
    anneal included: bit-identical state on the CPU."""
    prob = {
        "pinhole": lambda: _problems("pinhole")[0],
        "snavely": lambda: _problems("snavely")[0],
        "large": lambda: shuffle_cameras(balio.synthetic_problem_large(
            n_keyframes=20, n_points=1000, obs_per_lmk=5, seed=2)),
    }[name]()
    states = []
    for fused in (True, False):
        cfg = GBPConfig(fused=fused, accel_every=0)
        g = fg.build_graph(prob, cfg, "cpu")
        s = gbp.initialise(fg.init_state(prob, cfg, "cpu"), g, cfg)
        s, d = gbp.run_gbp(s, g, cfg, 20)
        states.append((s, d))
    (a, da), (b, db) = states
    for f in ("pk", "damping_count", "robust", "cam_bel", "lmk_bel"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(da.reproj_err, db.reproj_err)
    assert da.n_relins.sum() > 0


def test_camera_shuffled_collection_has_no_fused_windows():
    """With more than 1,024 cameras whose ids follow no sequence, the JAX
    package's build_graph finds no fused-sweep windows (some 1,024-edge
    block spans more than 1,024 camera ids), so JAX ``gbp_sweep`` takes the
    unfused pipeline; in sequence order the same problem keeps them. One
    unfused port sweep on the shuffled problem matches the JAX sweep
    (XLA path) from the same state."""
    kw = dict(n_keyframes=1100, n_points=4000, obs_per_lmk=5)
    jc = JaxConfig(use_pallas=False, accel_every=0)
    assert jax_build_graph(jax_balio.synthetic_problem_large(**kw),
                           jc).cam_win is not None
    jp = shuffle_cameras(jax_balio.synthetic_problem_large(**kw))
    jg = jax_build_graph(jp, jc)
    assert jg.cam_win is None and jg.lmk_win is None
    js = jax.jit(lambda s: jax_gbp.initialise(s, jg, jc))(
        jax_init_state(jp, jc))
    step = jax.jit(lambda s: jax_gbp.gbp_sweep(s, jg, jc))
    for _ in range(3):
        js = step(js)
    want = _jax_fields(step(js))
    tc = GBPConfig(fused=False, accel_every=0)
    tp = shuffle_cameras(balio.synthetic_problem_large(**kw))
    graph = fg.build_graph(tp, tc, "cpu")
    np.testing.assert_array_equal(graph.cam_idx.numpy(),
                                  np.asarray(jg.cam_idx))
    out = fg.state_to_numpy(gbp.gbp_sweep(
        fg.state_from_numpy(_jax_fields(js), "cpu"), graph, tc))
    for f in fg.STATE_FIELDS:
        _assert_close(out[f], want[f], SWEEP_RTOL, f)
