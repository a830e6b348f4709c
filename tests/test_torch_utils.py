"""The port's checkpoints, trajectory evaluation and intrinsics refit against
the JAX package, and chip_smoke.py's refusal to run without a card or
without the package beside it.

Checkpoints: a round trip through the npz format is lossless and a resumed
solve lands on the uninterrupted one to the bit; the port's config comes
back equal, and a JAX checkpoint's config loads with its TPU knobs
dropped. Evaluation: camera centres, alignment, ATE and the TUM export on
the same inputs as the JAX functions (float64 here, float32 there).
"""

import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from gbp_poplar_tpu.config import GBPConfig as JaxConfig
from gbp_poplar_tpu.core import build_graph as jax_build_graph
from gbp_poplar_tpu.core import gbp as jax_gbp
from gbp_poplar_tpu.core import init_state as jax_init_state
from gbp_poplar_tpu.core import intrinsics as jax_intrinsics
from gbp_poplar_tpu.utils import balio as jax_balio
from gbp_poplar_tpu.utils import checkpoint as jax_checkpoint
from gbp_poplar_tpu.utils import evaluation as jax_evaluation
from gbp_poplar_tpu_torch import GBPConfig
from gbp_poplar_tpu_torch.core import factor_graph as fg
from gbp_poplar_tpu_torch.core import gbp
from gbp_poplar_tpu_torch.core.intrinsics import refit_intrinsics
from gbp_poplar_tpu_torch.utils import balio, checkpoint, evaluation

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX package evaluates camera centres in float32
CENTER_ATOL = 1e-5


def test_checkpoint_round_trip_and_bit_exact_resume(synthetic, tmp_path):
    cfg = GBPConfig()
    graph = fg.build_graph(synthetic, cfg, "cpu")
    state = gbp.initialise(fg.init_state(synthetic, cfg, "cpu"), graph, cfg)
    mid, _ = gbp.run_gbp(state.clone(), graph, cfg, 10)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_checkpoint(path, mid, graph, step=10, cfg=cfg)

    mid2, graph2, meta = checkpoint.load_checkpoint(path, "cpu")
    assert meta["step"] == 10 and checkpoint.load_config(meta) == cfg
    a, b = fg.state_to_numpy(mid), fg.state_to_numpy(mid2)
    for f in fg.STATE_FIELDS:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    for f in fg.GRAPH_FIELDS:
        x, y = getattr(graph, f), getattr(graph2, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=f)

    final_a, _ = gbp.run_gbp(mid, graph, cfg, 10, iter_offset=10)
    final_b, _ = gbp.run_gbp(mid2, graph2, cfg, 10, iter_offset=10)
    assert torch.equal(final_a.cam_bel, final_b.cam_bel)
    assert torch.equal(final_a.pk, final_b.pk)


def test_jax_checkpoint_loads_with_its_tpu_knobs_dropped(synthetic,
                                                         tmp_path):
    jc = JaxConfig(coarse_groups=3, accel_every=20)
    jg = jax_build_graph(synthetic, jc)
    js = jax.jit(lambda s: jax_gbp.initialise(s, jg, jc))(
        jax_init_state(synthetic, jc))
    path = str(tmp_path / "jax.npz")
    jax_checkpoint.save_checkpoint(path, js, jg, step=4, cfg=jc)
    state, graph, meta = checkpoint.load_checkpoint(path, "cpu")
    cfg = checkpoint.load_config(meta)
    assert meta["step"] == 4
    assert cfg == GBPConfig(coarse_groups=3, accel_every=20)
    got = fg.state_to_numpy(state)
    for f in fg.STATE_FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(js, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(graph.cam_idx.numpy(),
                                  np.asarray(jg.cam_idx))
    # the port writes what the JAX package reads
    port_path = str(tmp_path / "port.npz")
    checkpoint.save_checkpoint(port_path, state, graph, step=4)
    js2, jg2, _ = jax_checkpoint.load_checkpoint(port_path)
    for f in fg.STATE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(js2, f)),
                                      np.asarray(getattr(js, f)), err_msg=f)
    np.testing.assert_array_equal(np.asarray(jg2.meas), np.asarray(jg.meas))


def test_camera_centers_and_ate_match_jax():
    rng = np.random.default_rng(0)
    cams = rng.normal(0, 0.5, (10, 6))
    cams[0, 3:] = 0.0                      # the identity rotation
    np.testing.assert_allclose(evaluation.camera_centers(cams),
                               jax_evaluation.camera_centers(cams),
                               rtol=0, atol=CENTER_ATOL)
    assert evaluation.ate_rmse(cams, cams, align=False) == 0.0
    other = cams + rng.normal(0, 0.01, cams.shape)
    for align, scale in ((False, False), (True, False), (True, True)):
        np.testing.assert_allclose(
            evaluation.ate_rmse(other, cams, align, scale),
            jax_evaluation.ate_rmse(other, cams, align, scale),
            rtol=1e-4)
    bad = cams.copy()
    bad[2, 0] = np.nan
    assert evaluation.ate_rmse(bad, cams) == float("inf")

    # a rigidly moved trajectory aligns back to ATE ~ 0
    centers = evaluation.camera_centers(cams)
    r, _, _ = evaluation.umeyama_align(rng.normal(0, 1, (4, 3)),
                                       rng.normal(0, 1, (4, 3)))
    moved = (r @ centers.T).T + np.array([1.0, -2.0, 3.0])
    rr, tt, ss = evaluation.umeyama_align(moved, centers)
    assert np.abs((ss * (rr @ moved.T)).T + tt - centers).max() < 1e-7
    want = jax_evaluation.umeyama_align(moved, centers, True)
    for x, y in zip(evaluation.umeyama_align(moved, centers, True), want):
        np.testing.assert_allclose(x, y, rtol=1e-10, atol=1e-12)


def test_export_tum_matches_jax(tmp_path):
    prob = balio.synthetic_problem(n_keyframes=6, n_points=60, seed=0)
    cams = prob.cam_means.astype(np.float32)
    ours, theirs = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    evaluation.export_tum(ours, cams, np.arange(6) * 0.5)
    jax_evaluation.export_tum(theirs, cams, np.arange(6) * 0.5)
    a, b = np.loadtxt(ours), np.loadtxt(theirs)
    assert a.shape == (6, 8)
    np.testing.assert_array_equal(a[:, 0], np.arange(6) * 0.5)
    np.testing.assert_allclose(a, b, rtol=0, atol=CENTER_ATOL)
    np.testing.assert_allclose(np.linalg.norm(a[:, 4:], axis=1), 1.0,
                               atol=1e-8)
    for m in (np.eye(3), np.diag([1.0, -1.0, -1.0]),
              np.diag([-1.0, 1.0, -1.0]), np.diag([-1.0, -1.0, 1.0])):
        np.testing.assert_array_equal(evaluation._rot_to_quat(m),
                                      jax_evaluation._rot_to_quat(m))


def test_refit_intrinsics_matches_jax():
    """One intrinsics refit from the same state (a Snavely problem with its
    focal lengths off by up to 7 %, after 40 JAX sweeps): the same
    decision and the same new (f, k1, k2)."""
    def perturbed(mod):
        prob = mod.synthetic_problem_snavely(8, 80, pixel_noise=0.3, seed=3)
        rng = np.random.default_rng(1)
        prob.intrinsics[:, 0] *= rng.uniform(0.93, 1.07, prob.n_keyframes)
        prob.intrinsics[:, 1] += rng.normal(0, 0.05, prob.n_keyframes)
        return prob

    jp, tp = perturbed(jax_balio), perturbed(balio)
    jc = JaxConfig(use_pallas=False, accel_every=0)
    jg = jax_build_graph(jp, jc)
    js, _ = jax.jit(lambda s: jax_gbp.solve(s, jg, jc, n_iters=40))(
        jax_init_state(jp, jc))
    want_intr, want_acc = jax_intrinsics.refit_intrinsics(js, jg, jc)

    cfg = GBPConfig(accel_every=0)
    graph = fg.build_graph(tp, cfg, "cpu")
    state = fg.state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in fg.STATE_FIELDS}, "cpu")
    new_intr, acc = refit_intrinsics(state, graph, cfg)
    assert bool(acc) and bool(want_acc)
    np.testing.assert_allclose(new_intr.numpy(), np.asarray(want_intr),
                               rtol=1e-4, atol=1e-5)
    assert not torch.equal(new_intr, graph.intr)
    cost0 = gbp.map_cost(state, graph, cfg).item()
    cost1 = gbp.map_cost(state, dataclasses.replace(graph, intr=new_intr),
                         cfg).item()
    assert cost1 < cost0
    with pytest.raises(ValueError, match="Snavely"):
        refit_intrinsics(state, dataclasses.replace(graph, intr=None), cfg)


def test_chip_smoke_refuses_without_a_card_or_the_package(tmp_path):
    """chip_smoke.py copied alone into an empty directory exits non-zero
    and prints no result: here at its CUDA check; on a card at
    ``import gbp_poplar_tpu_torch`` (not beside it)."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
