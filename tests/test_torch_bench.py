"""The port's benchmark (``gbp_poplar_tpu_torch/tools/bench.py``) on the
CPU, against the JAX package's ``bench.py``.

The guard error of the headline row is held against the JAX
``bench._bench_tum`` on the same file, and the incremental-SLAM row
against the JAX ``bench._bench_slam``. Timing is not tested (a CPU time
says nothing of a card); that each timed repetition starts from the same
state is. The other tools are tests/test_torch_bench_tools.py's.
"""

import json

import numpy as np
import pytest
import torch

import bench as jax_bench
from gbp_poplar_tpu_torch import GBPConfig
from gbp_poplar_tpu_torch.core import build_graph, factor_graph as fg
from gbp_poplar_tpu_torch.core import gbp, init_state
from gbp_poplar_tpu_torch.drivers import slam as slam_driver
from gbp_poplar_tpu_torch.tools import bench, time_reps
from gbp_poplar_tpu_torch.utils import balio

torch.set_num_threads(1)

# final errors of two float32 solves of the same problem, relative (the
# PX_RTOL of tests/test_torch_tools.py)
PX_RTOL = 1e-3
SMALL_SHAPE = (12, 300, 5)
HOOKS = dict(GBP_PLATFORM="cpu", GBP_BENCH_SWEEPS="20",
             GBP_BENCH_GUARD_ITERS="80", GBP_BENCH_GUARD_PX="3.0",
             GBP_BENCH_EXTRA="0", GBP_BENCH_SCALE="0")


@pytest.fixture(scope="module")
def tiny_bal(tmp_path_factory):
    """tests/test_drivers.py's tiny BAL file."""
    path = str(tmp_path_factory.mktemp("bal") / "tiny.txt")
    balio.save_bal(path, balio.synthetic_problem(
        n_keyframes=5, n_points=40, seed=4, pixel_noise=0.5))
    return path


def test_bench_main_prints_the_json_contract(tiny_bal, monkeypatch, capsys):
    """``main()`` with test_bench_emits_json's hooks: one JSON last line
    with exactly the JAX benchmark's keys, its guard error the port's own
    ``bench_tum`` rounded, and that error the JAX ``_bench_tum``'s on the
    same file."""
    for k, v in dict(HOOKS, GBP_BENCH_SEQ=tiny_bal).items():
        monkeypatch.setenv(k, v)
    assert bench.main() == 0
    out = capsys.readouterr()
    data = json.loads(out.out.strip().splitlines()[-1])
    assert set(data) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert data["value"] > 0 and data["unit"] == "sweeps/s"
    assert data["metric"] == "gbp_sweeps_per_sec_tiny"
    assert set(data["extra"]) == {"err_at_guard_px"}
    assert "(cpu)" in out.err

    port = bench.bench_tum(tiny_bal, 20, 80, 3.0, device="cpu")
    _, jax_err = jax_bench._bench_tum(tiny_bal, 20, 80, 3.0)
    assert data["extra"]["err_at_guard_px"] == round(port["err_at_guard_px"],
                                                     3)
    assert port["err_at_guard_px"] == pytest.approx(jax_err, rel=PX_RTOL)


def test_bench_guard_that_cannot_pass_returns_1(tiny_bal, monkeypatch,
                                                 capsys):
    for k, v in dict(HOOKS, GBP_BENCH_SEQ=tiny_bal,
                     GBP_BENCH_GUARD_PX="0").items():
        monkeypatch.setenv(k, v)
    assert bench.main() == 1
    out = capsys.readouterr()
    assert "CONVERGENCE GUARD FAILED" in out.err
    assert out.out == ""


def test_bench_ladybug_reps_start_from_one_state():
    """Every timed run of both programs starts from the state after
    initialise, which stays as it was: the same error after each run, the
    guard holds (lower and finite), and the state's error is unchanged."""
    r = bench.bench_ladybug(4, shape=SMALL_SHAPE, device="cpu")
    assert len(r["rep_errs"]) == 3 and len(set(r["rep_errs"])) == 1
    assert len(r["run_errs"]) == 3 and len(set(r["run_errs"])) == 1
    assert r["state_kept"]
    assert np.isfinite(r["err_px"]) and r["err_px"] < r["err0"]
    assert r["ms_per_sweep"] > 0 and r["run_gbp_ms_per_sweep"] > 0
    assert r["edges"] == fg.padded_n_edges(
        balio.synthetic_problem_large(*SMALL_SHAPE), GBPConfig())


def test_time_reps_never_touches_the_state():
    prob = balio.synthetic_problem_large(*SMALL_SHAPE)
    cfg = GBPConfig()
    graph = build_graph(prob, cfg, "cpu")
    state = gbp.initialise(init_state(prob, cfg, "cpu"), graph, cfg)
    before = fg.state_to_numpy(state.clone())
    seen = []
    dt, outs = time_reps(lambda s: seen.append(s) or gbp.gbp_sweep(
        s, graph, cfg), state, reps=2, after=lambda s: s.pk.sum().item())
    assert dt > 0 and len(outs) == 2 and outs[0] == outs[1]
    assert len({id(s) for s in seen}) == 3
    assert all(s is not state for s in seen)
    after = fg.state_to_numpy(state)
    for f in fg.STATE_FIELDS:
        np.testing.assert_array_equal(after[f], before[f], err_msg=f)


def test_bench_slam_config_is_the_slam_drivers(tmp_path):
    """The benchmark's SLAM schedule is the slam driver's default config
    at the same cadence, so chip_smoke.py's SLAM phase can run it."""
    args = slam_driver.build_parser().parse_args(
        ["--bal_file", "-", "--iters_between_kfs", "200"])
    cfg, _ = slam_driver.config_from_args(args)
    assert bench.slam_config(200) == cfg


def test_bench_slam_matches_jax_bench_slam(tmp_path):
    """The SLAM row on a small file: the sweep count, the guard, and the
    final error against the JAX ``_bench_slam`` by outcome."""
    path = str(tmp_path / "slam.txt")
    balio.save_bal(path, balio.synthetic_problem(
        n_keyframes=6, n_points=60, seed=2, pixel_noise=0.5))
    r = bench.bench_slam(path, 30, device="cpu")
    assert r["sweeps"] == 5 * 30 and r["sweeps_per_sec"] > 0
    assert r["accel_steps"] == 0      # 30 sweeps < two accelerator chunks
    _, jax_err = jax_bench._bench_slam(path, 30)
    assert r["final_err_px"] == pytest.approx(jax_err, rel=PX_RTOL)
