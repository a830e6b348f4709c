"""The port's ba command line (drivers/ba.py, drivers/common.py), run in
process through ``main(argv)`` under ``GBP_PLATFORM=cpu``: the defaults
(coarse corrector over min(16, keyframes) groups, LM polish), telemetry,
checkpoint write and bit-exact resume, a JAX checkpoint resumed by the
port, trajectory export, the flags, and the per-iteration line against
the JAX driver's.
"""

import numpy as np
import pytest
import torch

from gbp_poplar_tpu.drivers import ba as jax_ba
from gbp_poplar_tpu.drivers import common as jax_common
from gbp_poplar_tpu_torch.core import gbp
from gbp_poplar_tpu_torch.drivers import ba, common
from gbp_poplar_tpu_torch.utils import balio

torch.set_num_threads(1)

# a 200-sweep span holds one live accelerator chunk (the default schedule:
# every 50 sweeps from sweep 150), so the coarse step runs once per span
SPAN = 200
# the port's resume of a JAX checkpoint against the JAX driver's resume,
# per printed line (measured: 6e-5 px; costs 3.2e-4 relative)
CROSS_ATOL_PX = 1e-3
CROSS_COST_RTOL = 1e-3


@pytest.fixture(scope="module")
def tiny_bal(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bal") / "tiny.txt")
    balio.save_bal(path, balio.synthetic_problem(n_keyframes=5, n_points=40,
                                                 seed=4, pixel_noise=0.5))
    return path


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch):
    monkeypatch.setenv("GBP_PLATFORM", "cpu")


def _run(capsys, main, *argv):
    rc = main([str(a) for a in argv])
    out = capsys.readouterr()
    return rc, out.out, out.err


def _iters(out):
    return [ln for ln in out.splitlines() if ln.startswith("iter")]


class _Capture:
    """stdout/stderr of a block, for module-scoped fixtures (capsys is
    function-scoped)."""

    def __enter__(self):
        import contextlib
        import io
        self._o, self._e = io.StringIO(), io.StringIO()
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(contextlib.redirect_stdout(self._o))
        self._stack.enter_context(contextlib.redirect_stderr(self._e))
        return self

    def __exit__(self, *exc):
        self._stack.close()
        self.out, self.err = self._o.getvalue(), self._e.getvalue()
        return False


@pytest.fixture(scope="module")
def first_run(tiny_bal, tmp_path_factory):
    """One SPAN-sweep run with the defaults and every output: (rc, stdout,
    stderr, checkpoint, trajectory, coarse steps taken, their groups)."""
    d = tmp_path_factory.mktemp("run")
    ckpt, traj = str(d / "c.npz"), str(d / "t.txt")
    calls = []
    real = gbp._coarse_step

    def spy(state, graph, cfg, *a, **k):
        calls.append(cfg.coarse_groups)
        return real(state, graph, cfg, *a, **k)

    with pytest.MonkeyPatch.context() as mp, _Capture() as cap:
        mp.setenv("GBP_PLATFORM", "cpu")
        mp.setattr(gbp, "_coarse_step", spy)
        rc = ba.main(["--bal_file", tiny_bal, "--ltn", "0.05", "--n_iters",
                      str(SPAN), "--print_every", "20", "--checkpoint", ckpt,
                      "--save_traj", traj, "--gn_check"])
    return rc, cap.out, cap.err, ckpt, traj, calls


def test_ba_end_to_end_with_defaults(first_run):
    rc, out, err, ckpt, traj, calls = first_run
    assert rc == 0, err[-2000:]
    lines = _iters(out)
    assert len(lines) == SPAN
    assert float(lines[-1].split()[3]) < float(lines[0].split()[3])
    # the coarse corrector ran at the live chunk boundary, its 16 groups
    # capped at the problem's 5 keyframes
    assert calls == [5]
    for what in ("polish: reproj", "host oracle: reproj_err", "GN baseline",
                 "ATE(GBP vs GN)", "trajectory written"):
        assert what in err, what
    assert "WARNING" not in err
    rows = np.loadtxt(traj)
    assert rows.shape == (5, 8) and np.isfinite(rows).all()
    np.testing.assert_allclose(np.linalg.norm(rows[:, 4:], axis=1), 1.0,
                               atol=1e-6)
    pol = float(err.split("polish: reproj ")[1].split(" px")[0])
    assert pol <= float(lines[-1].split()[3]) + 0.05


def test_resume_is_bit_exact(first_run, tiny_bal, capsys):
    """Resuming the first run's checkpoint (GBP state at sweep SPAN) for
    another span prints exactly the lines an uninterrupted run prints."""
    ckpt = first_run[3]
    common_args = ("--bal_file", tiny_bal, "--ltn", "0.05", "--no_polish")
    rc, out2, err2 = _run(capsys, ba.main, *common_args, "--resume", ckpt,
                          "--n_iters", 2 * SPAN)
    assert rc == 0, err2[-2000:]
    assert f"resumed from {ckpt} at iter {SPAN}" in err2
    assert "polish:" not in err2 and "warning" not in err2
    rc, out3, err3 = _run(capsys, ba.main, *common_args,
                          "--n_iters", 2 * SPAN)
    assert rc == 0, err3[-2000:]
    resumed, whole = _iters(out2), _iters(out3)
    assert resumed[0].split()[1] == str(SPAN)
    assert resumed == whole[SPAN:]


def test_jax_checkpoint_resumes_in_the_port(tiny_bal, tmp_path, capsys):
    """A checkpoint written by the JAX driver resumes in the port, and the
    resumed lines follow the JAX driver's own resume: same format, the
    same counts, the errors to CROSS_ATOL_PX and the costs to
    CROSS_COST_RTOL."""
    ckpt = str(tmp_path / "jax.npz")
    base = ("--bal_file", tiny_bal, "--ltn", "0.05", "--no_polish")
    rc, _, err = _run(capsys, jax_ba.main, *base, "--n_iters", 12,
                      "--checkpoint", ckpt)
    assert rc == 0, err[-2000:]
    rc, want, err = _run(capsys, jax_ba.main, *base, "--resume", ckpt,
                         "--n_iters", 24)
    assert rc == 0, err[-2000:]
    rc, got, err = _run(capsys, ba.main, *base, "--resume", ckpt,
                        "--n_iters", 24)
    assert rc == 0, err[-2000:]
    assert "resumed from" in err and "warning" not in err
    want, got = _iters(want), _iters(got)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        gt, wt = g.split(), w.split()
        assert [len(t) for t in g.split(" ")] == [len(t) for t in w.split(" ")]
        assert gt[1] == wt[1] and gt[8] == wt[8] and gt[10] == wt[10]
        np.testing.assert_allclose(float(gt[3]), float(wt[3]), rtol=0,
                                   atol=CROSS_ATOL_PX)
        np.testing.assert_allclose(float(gt[6]), float(wt[6]),
                                   rtol=CROSS_COST_RTOL)


def test_iteration_line_format_matches_jax(capsys):
    for args in ((0, 12.3456789, 1234.56789, 7, 3),
                 (1499, 0.1, 1e9, 0, 12345), (3, float("nan"), 0.0, 1, 1)):
        jax_common.print_iteration(*args)
        want = capsys.readouterr().out
        common.print_iteration(*args)
        assert capsys.readouterr().out == want


def test_verbose_prints_the_means_every_sweep(tiny_bal, capsys):
    rc, out, err = _run(capsys, ba.main, "--bal_file", tiny_bal, "--n_iters",
                        12, "--print_every", 6, "--no_polish", "--v")
    assert rc == 0, err[-2000:]
    dumps = [ln for ln in out.splitlines()
             if ln.startswith("beliefs (cam means) at iter")]
    assert len(dumps) == 12
    seg = out.split("beliefs (cam means) at iter 11:")[1]
    assert "nan" not in seg.lower() and "inf" not in seg.lower()
    assert "cam means:" in out


def test_profile_writes_a_trace(tiny_bal, tmp_path, capsys):
    rc, _, err = _run(capsys, ba.main, "--bal_file", tiny_bal, "--n_iters",
                      6, "--no_polish", "--profile", "--profile_dir",
                      tmp_path / "prof")
    assert rc == 0, err[-2000:]
    trace = tmp_path / "prof" / "trace.json"
    assert f"profile written to {trace}" in err
    assert trace.stat().st_size > 0


def test_bad_assoc_is_excluded_from_the_oracle(tiny_bal, tmp_path, capsys):
    ids = tmp_path / "bad.txt"
    ids.write_text("0\n7\n")
    errs = []
    for extra in ((), ("--bad_assoc", "0,7"), ("--bad_assoc", f"@{ids}")):
        rc, _, err = _run(capsys, ba.main, "--bal_file", tiny_bal,
                          "--n_iters", 20, "--no_polish", *extra)
        assert rc == 0, err[-2000:]
        assert ("(2 bad associations excluded)" in err) == bool(extra)
        errs.append(float(err.split("host oracle: reproj_err ")[1].split()[0]))
    assert errs[1] == errs[2] != errs[0]
    assert common.parse_bad_assoc(None) == []


def test_refine_intrinsics_on_a_snavely_problem(tmp_path, capsys):
    """--refine_intrinsics on a Snavely problem whose intrinsics are off
    lands well below the run without it (the JAX package's driver test);
    a pinhole problem is refused with exit code 2."""
    prob = balio.synthetic_problem_snavely(8, 80, pixel_noise=0.3, seed=3)
    rng = np.random.default_rng(1)
    prob.intrinsics[:, 0] *= rng.uniform(0.93, 1.07, prob.n_keyframes)
    prob.intrinsics[:, 1] += rng.normal(0, 0.05, prob.n_keyframes)
    prob.lmk_means = prob.lmk_means + rng.normal(0, 0.05,
                                                 prob.lmk_means.shape)
    path = str(tmp_path / "p.txt")
    balio.save_bal(path, prob)
    errs = {}
    for extra in ((), ("--refine_intrinsics",)):
        rc, out, err = _run(capsys, ba.main, "--bal_file", path, "--n_iters",
                            2 * SPAN, "--print_every", 100, "--no_polish",
                            *extra)
        assert rc == 0, err[-2000:]
        errs[bool(extra)] = float(_iters(out)[-1].split()[3])
        if extra:
            assert "intrinsics refits: 1/1 accepted" in err
    assert errs[True] < 0.75 * errs[False], errs

    tum = str(tmp_path / "tum.txt")
    balio.save_bal(tum, balio.synthetic_problem(5, 40, seed=4))
    rc, _, err = _run(capsys, ba.main, "--bal_file", tum, "--n_iters", 10,
                      "--refine_intrinsics")
    assert rc == 2 and "pinhole" in err


def test_devices_above_one_raise(tiny_bal):
    with pytest.raises(NotImplementedError, match="A10"):
        ba.main(["--bal_file", tiny_bal, "--devices", "2"])


def test_no_cuda_device_is_an_error(tiny_bal, monkeypatch):
    """Without GBP_PLATFORM=cpu the driver runs on cuda:0 or stops; it
    never carries on on the CPU."""
    monkeypatch.delenv("GBP_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        ba.main(["--bal_file", tiny_bal])
    monkeypatch.setenv("GBP_PLATFORM", "tpu")
    with pytest.raises(SystemExit, match="GBP_PLATFORM"):
        ba.main(["--bal_file", tiny_bal])


def test_resume_graph_keeps_the_built_graph(tiny_bal, tmp_path, capsys):
    """A checkpoint's plain graph arrays equal to the freshly built graph
    resume on the built one (its segments and caches); a different graph
    is kept as loaded, with a warning."""
    import dataclasses

    from gbp_poplar_tpu_torch import GBPConfig
    from gbp_poplar_tpu_torch.core import factor_graph as fg
    from gbp_poplar_tpu_torch.utils import checkpoint

    cfg = GBPConfig()
    prob = balio.load_bal(tiny_bal)
    built = fg.build_graph(prob, cfg, "cpu")
    path = str(tmp_path / "g.npz")
    checkpoint.save_checkpoint(path, fg.init_state(prob, cfg, "cpu"), built,
                               step=7, cfg=cfg)
    _, loaded, _ = checkpoint.load_checkpoint(path, "cpu")
    assert common.resume_graph(built, loaded) is built
    assert common.resume_graph(built, None) is built
    tampered = dataclasses.replace(loaded,
                                   cam_idx=torch.roll(loaded.cam_idx, 1))
    assert common.resume_graph(built, tampered) is tampered
    assert "checkpoint graph differs" in capsys.readouterr().err
