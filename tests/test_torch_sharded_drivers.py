"""The port's ``--devices N`` command lines (drivers/ba.py, drivers/slam.py
over parallel/launch.py), run in process through ``main(argv)`` under
``GBP_PLATFORM=cpu`` with 2 CPU ranks: rank 0 runs in this process and
prints, the other rank is a spawned process.

  - ba: the edges split over the ranks; its lines against ``--devices 1``
    by outcome, its checkpoint (the global layout) resumed at either
    count, and the intrinsics refit across ranks;
  - slam: the landmark map split over the ranks; a checkpoint of the
    partitioned layout, its bit-exact resume, the polish and the host
    oracle; a JAX map-sharded checkpoint resumed in the port.

JAX is imported inside the tests only (the spawned rank imports this
module).
"""

import numpy as np
import pytest
import torch

from gbp_poplar_tpu_torch.drivers import ba, slam
from gbp_poplar_tpu_torch.utils import balio

torch.set_num_threads(1)

# 600 edges padded to 1024: the two ranks split the real edges 512 / 88
BA_PROBLEM = dict(n_keyframes=10, n_points=200, seed=4, pixel_noise=0.5)
SPAN = 200               # one span: an accelerator step and a coarse step
# --devices 2 against --devices 1, per printed line: the per-variable sums
# run in another order, and the accelerator's step after sweep 160 lands a
# little apart (measured: 6.5e-4 px and costs 2.1e-3 relative, both on the
# sweep after that step; below 1e-4 relative elsewhere)
SHARD_ATOL_PX = 1e-3
SHARD_COST_RTOL = 5e-3
SLAM_IBK = 40
SLAM_ATOL_PX = 1e-3
SLAM_COST_RTOL = 1e-3


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch):
    monkeypatch.setenv("GBP_PLATFORM", "cpu")


def _run(capsys, main, *argv):
    rc = main([str(a) for a in argv])
    out = capsys.readouterr()
    return rc, out.out, out.err


def _iters(out):
    return [ln for ln in out.splitlines() if ln.startswith("iter")]


def _close_lines(got, want, atol_px, cost_rtol):
    """Same iteration numbers and format; errors and costs by outcome."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gt, wt = g.split(), w.split()
        assert [len(t) for t in g.split(" ")] == [len(t) for t in w.split(" ")]
        assert gt[1] == wt[1]
        np.testing.assert_allclose(float(gt[3]), float(wt[3]), rtol=0,
                                   atol=atol_px)
        np.testing.assert_allclose(float(gt[6]), float(wt[6]),
                                   rtol=cost_rtol)


@pytest.fixture(scope="module")
def ba_bal(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ba") / "p.txt")
    balio.save_bal(path, balio.synthetic_problem(**BA_PROBLEM))
    return path


def test_ba_two_ranks_match_one(ba_bal, tmp_path, capsys):
    """ba --devices 2: rank 0 prints the lines of --devices 1 by outcome,
    with the polish, the host oracle and the trajectory; its checkpoint
    holds the global layout and resumes at --devices 1 and 2 alike."""
    base = ("--bal_file", ba_bal, "--ltn", "0.05", "--n_iters", SPAN)
    ckpt2, traj = str(tmp_path / "c2.npz"), str(tmp_path / "t.txt")
    rc, out1, err1 = _run(capsys, ba.main, *base)
    assert rc == 0, err1[-2000:]
    rc, out2, err2 = _run(capsys, ba.main, *base, "--devices", 2,
                          "--checkpoint", ckpt2, "--save_traj", traj)
    assert rc == 0, err2[-2000:]
    assert "launch: 2 ranks on cpu, cpu, backend gloo" in err2
    _close_lines(_iters(out2), _iters(out1), SHARD_ATOL_PX, SHARD_COST_RTOL)
    for what in ("polish: reproj", "host oracle: reproj_err",
                 "trajectory written", "checkpoint written"):
        assert what in err2, what
    assert "WARNING" not in err2
    assert np.loadtxt(traj).shape == (10, 8)
    with np.load(ckpt2) as z:
        assert z["state.f_eta_c"].shape == (6, 1024)
    resumed = {}
    for n in (1, 2):
        rc, out, err = _run(capsys, ba.main, *base[:-1], SPAN + 20,
                            "--no_polish", "--resume", ckpt2, "--devices", n)
        assert rc == 0, err[-2000:]
        assert f"at iter {SPAN}" in err and "warning" not in err
        resumed[n] = _iters(out)
        assert resumed[n][0].split()[1] == str(SPAN)
    _close_lines(resumed[2], resumed[1], SHARD_ATOL_PX, SHARD_COST_RTOL)


def test_refine_intrinsics_across_ranks(tmp_path, capsys):
    """--refine_intrinsics --devices 2 on a Snavely problem whose
    intrinsics are off: the per-camera sums, maxima and costs run over
    both ranks' edges and the refit is accepted, as at --devices 1."""
    prob = balio.synthetic_problem_snavely(12, 160, pixel_noise=0.3, seed=3)
    rng = np.random.default_rng(1)
    prob.intrinsics[:, 0] *= rng.uniform(0.93, 1.07, prob.n_keyframes)
    prob.intrinsics[:, 1] += rng.normal(0, 0.05, prob.n_keyframes)
    path = str(tmp_path / "p.txt")
    balio.save_bal(path, prob)
    errs = {}
    for n in (1, 2):
        rc, out, err = _run(capsys, ba.main, "--bal_file", path, "--n_iters",
                            2 * SPAN, "--print_every", 100, "--no_polish",
                            "--refine_intrinsics", "--devices", n)
        assert rc == 0, err[-2000:]
        assert "intrinsics refits: 1/1 accepted" in err
        errs[n] = float(err.split("host oracle: reproj_err ")[1].split()[0])
    np.testing.assert_allclose(errs[2], errs[1], rtol=0, atol=SHARD_ATOL_PX)


@pytest.fixture(scope="module")
def slam_bal(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("slam") / "seq.txt")
    balio.save_bal(path, balio.synthetic_problem(n_keyframes=6, n_points=60,
                                                 seed=2, pixel_noise=0.5))
    return path


def _keep_checkpoints(mp, module):
    """Keep a copy of every checkpoint the driver module writes, as
    ``<path>.kf<k>``."""
    import shutil

    real = module._amend_meta

    def spy(path, **extra):
        real(path, **extra)
        shutil.copy(path, f"{path}.kf{extra['kf']}")

    mp.setattr(module, "_amend_meta", spy)


def test_slam_two_ranks_checkpoint_resume_polish(slam_bal, tmp_path, capsys,
                                                  monkeypatch):
    """slam --devices 2 with a checkpoint after every insertion, the
    polish, the host oracle and the trajectory; the checkpoint after
    keyframe 3's insertion holds the partitioned layout and resumes at
    --devices 2 to exactly the uninterrupted run's lines; the final one
    to the same trajectory; at --devices 1 it exits with 2."""
    ckpt, traj = str(tmp_path / "c.npz"), str(tmp_path / "t.txt")
    base = ("--bal_file", slam_bal, "--iters_between_kfs", SLAM_IBK,
            "--avdepth", 6.0, "--devices", 2)
    _keep_checkpoints(monkeypatch, slam)
    rc, out, err = _run(capsys, slam.main, *base, "--checkpoint", ckpt,
                        "--checkpoint_every", SLAM_IBK, "--polish",
                        "--save_traj", traj)
    assert rc == 0, err[-2000:]
    lines = _iters(out)
    assert len(lines) == 5 * SLAM_IBK
    final = float(err.split("final reprojection error: ")[1].split()[0])
    assert final < 1.5
    pol = float(err.split("polish: reproj ")[1].split(" px")[0])
    assert pol <= final + 0.05 and "host oracle: reproj_err" in err
    with np.load(ckpt) as z:
        import json
        meta = json.loads(bytes(z["__meta__"]).decode())
        assert meta["devices"] == 2 and meta["kf"] == 6
        # 60 landmarks in 2 blocks of 30; the edges in 2 equal blocks
        assert z["state.lmk_eta"].shape == (3, 60)
        assert z["graph.lmk_idx"].max() < 30
    rc, out2, err2 = _run(capsys, slam.main, *base, "--resume",
                          ckpt + ".kf3")
    assert rc == 0, err2[-2000:]
    assert _iters(out2) == lines[2 * SLAM_IBK:]
    traj2 = str(tmp_path / "t2.txt")
    rc, out3, err3 = _run(capsys, slam.main, *base, "--polish", "--resume",
                          ckpt, "--save_traj", traj2)
    assert rc == 0, err3[-2000:]
    assert "at keyframe 6" in err3 and _iters(out3) == []
    with open(traj) as a, open(traj2) as b:
        assert a.read() == b.read()
    rc, _, err = _run(capsys, slam.main, "--bal_file", slam_bal, "--resume",
                      ckpt)
    assert rc == 2 and "--devices 2, run has --devices 1" in err


def test_jax_map_sharded_checkpoint_resumes_in_the_port(slam_bal, tmp_path,
                                                        capsys):
    """A checkpoint the JAX slam driver writes at --devices 2 (its
    map-sharded solver on the virtual CPU mesh) resumes in the port at
    --devices 2: the port's lines follow the JAX run's from keyframe 4's
    insertion on, by outcome."""
    from gbp_poplar_tpu.drivers import slam as jax_slam

    ckpt = str(tmp_path / "jax.npz")
    base = ("--bal_file", slam_bal, "--iters_between_kfs", SLAM_IBK,
            "--avdepth", 6.0, "--devices", 2)
    with pytest.MonkeyPatch.context() as mp:
        _keep_checkpoints(mp, jax_slam)
        rc, want, err = _run(capsys, jax_slam.main, *base, "--checkpoint",
                             ckpt, "--checkpoint_every", SLAM_IBK)
    assert rc == 0, err[-2000:]
    rc, got, err = _run(capsys, slam.main, *base, "--resume", ckpt + ".kf4")
    assert rc == 0, err[-2000:]
    assert f"resumed from {ckpt}.kf4 at keyframe 4" in err
    got, want = _iters(got), _iters(want)[3 * SLAM_IBK:]
    assert got[0].split()[1] == str(3 * SLAM_IBK)
    _close_lines(got, want, SLAM_ATOL_PX, SLAM_COST_RTOL)
