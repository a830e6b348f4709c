"""The port's sequence-level tools end to end on the CPU: the
``exp_ate_grid`` protocol against the JAX package's script, and every
tool's ``main`` on a BAL file, on an absent sequence name and on a JAX-only
override. The problem and the bounds are tests/test_torch_seq_tools.py's.
"""

import jax
import numpy as np
import pytest
import torch

from gbp_poplar_tpu.config import GBPConfig as JaxConfig
from gbp_poplar_tpu.core import build_graph as jax_build_graph
from gbp_poplar_tpu.core import gauss_newton as jax_gn
from gbp_poplar_tpu.core import gbp as jax_gbp
from gbp_poplar_tpu.core import init_state as jax_init_state
from gbp_poplar_tpu.utils import balio as jax_balio
from gbp_poplar_tpu.utils import evaluation as jax_evaluation
from gbp_poplar_tpu_torch.tools import diagnose_accuracy as da
from gbp_poplar_tpu_torch.tools import exp_ate_grid as eg
from gbp_poplar_tpu_torch.tools import exp_drift_phase as ed
from gbp_poplar_tpu_torch.tools import tune_schedule as ts
from gbp_poplar_tpu_torch.tools import validate_sequences as vs
from gbp_poplar_tpu_torch.tools.seq_common import ORACLE_LM_ITERS
from gbp_poplar_tpu_torch.utils import balio
from test_torch_seq_tools import (ATE_ATOL_M, COST_RTOL, N_ITERS,  # noqa: F401
                                  PX_RTOL, SHAPE, bal_path, jax_map_cost)

torch.set_num_threads(1)


def _jax_grid_base(bal_path, n_iters: int) -> dict:
    """scripts/exp_ate_grid.py's GN oracle and ``base`` row."""
    prob = jax_balio.load_bal(bal_path)
    base = JaxConfig(coarse_groups=min(16, prob.n_keyframes))
    res_gn = jax_gn.solve_problem(prob, base, n_lm_iters=ORACLE_LM_ITERS)
    gn_cam, gn_lmk = np.asarray(res_gn.cam), np.asarray(res_gn.lmk)
    split = jax_map_cost(prob, base)

    def map_cost(cam, lmk):
        return sum(split(cam, lmk))

    c_gn = map_cost(gn_cam, gn_lmk)
    graph = jax_build_graph(prob, base)
    final, diag = jax.jit(lambda s: jax_gbp.solve(s, graph, base,
                                                  n_iters=n_iters))(
        jax_init_state(prob, base))
    cam_mu, lmk_mu = map(np.asarray, jax_gbp._variable_means(final))
    return {"gn_err": float(res_gn.reproj_err[-1]), "gn_cost": c_gn,
            "err": float(np.asarray(diag.reproj_err)[-1]),
            "ate": jax_evaluation.ate_rmse(cam_mu.T, gn_cam),
            "ratio": map_cost(cam_mu.T, lmk_mu.T) / c_gn}


def test_exp_ate_grid_base_and_unfused_match_jax(bal_path):
    """``base`` and ``fused=0`` (H5 + H4's plain versions) against the JAX
    grid's ``base`` row, and against each other."""
    prob = balio.load_bal(bal_path)
    got = eg.grid(prob, N_ITERS, ["base", "fused=0"], device="cpu")
    want = _jax_grid_base(bal_path, N_ITERS)
    np.testing.assert_allclose(got["gn_err"], want["gn_err"], rtol=PX_RTOL)
    np.testing.assert_allclose(got["gn_cost"], want["gn_cost"],
                               rtol=COST_RTOL)
    base, unfused = got["rows"]
    assert (base["spec"], unfused["spec"]) == ("base", "fused=0")
    for row, ref in ((base, want), (unfused, want), (unfused, base)):
        np.testing.assert_allclose(row["err"], ref["err"], rtol=PX_RTOL)
        np.testing.assert_allclose(row["ratio"], ref["ratio"],
                                   rtol=COST_RTOL)
        np.testing.assert_allclose(row["ate"], ref["ate"], rtol=0,
                                   atol=ATE_ATOL_M)
    lines = eg.report("f", prob, N_ITERS, got)
    assert lines[0].startswith(f"f: {SHAPE[0]} kf / {prob.n_edges} edges, ")
    assert lines[2].startswith("base ") and lines[3].startswith("fused=0 ")


# --------------------------------------------------------------------------
# the mains
# --------------------------------------------------------------------------

def test_mains_run_on_a_bal_file(bal_path, monkeypatch, capsys):
    """Each main end to end on the file, printing the JAX scripts' header
    lines."""
    monkeypatch.setenv("GBP_PLATFORM", "cpu")
    n_kf, n_lmk, n_e = SHAPE[0], SHAPE[1], SHAPE[1] * SHAPE[2]
    header = f"{bal_path}: {n_kf} kf / {n_lmk} lmk / {n_e} edges"

    assert ts.main(["--seq", bal_path, "--n_iters", "60", "--set",
                    "reference", "--set", "drift:relin_drift_threshold=0.05"
                    ]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == header
    assert out[1].startswith("  reference ") and "e[59]=" in out[1]
    assert out[2].startswith("  drift ")

    assert ed.main([bal_path, "60", "20", "accel_every=0"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == (f"{header}; total 60, phase1 20; overrides "
                      "{'accel_every': 0}")
    assert out[1].startswith("GN: ")
    tags = ("drift always", "drift never", "drift first 20",
            "drift AFTER 20")
    assert [ln[2:30].strip() for ln in out[2:]] == list(tags)

    assert "nan" not in " ".join(out)

    assert da.main([bal_path, "60", "accel_every=0"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"{header}; cfg overrides: {{'accel_every': 0}}"
    assert any(ln.startswith("MAP cost: GBP ") for ln in out)
    assert any(ln.startswith("  LM-polish of GBP point: ") for ln in out)

    assert eg.main([bal_path, "60", "base", "accel_every=0"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"{bal_path}: {n_kf} kf / {n_e} edges, 60 "
                             "iters; GN reproj ")
    assert [ln.split()[0] for ln in out[2:4]] == ["base", "accel_every=0"]

    # the JAX script's budget (1,000 sweeps, 300 a keyframe), cut here
    monkeypatch.setattr(vs, "N_ITERS", 60)
    monkeypatch.setattr(vs, "SLAM_IBK", 10)
    assert vs.main([bal_path]) == 0
    assert capsys.readouterr().out.startswith(f"{bal_path:10s} | GBP ")


def test_an_absent_sequence_fails_with_balio_error(monkeypatch):
    """A name that is absent fails with load_bal's error (naming
    GBP_SEQUENCES_DIR); no tool falls back to a synthetic problem."""
    monkeypatch.setenv("GBP_PLATFORM", "cpu")
    name = "no_such_sequence_xyz"
    for run in (lambda: vs.main([name]),
                lambda: da.main([name, "10"]),
                lambda: eg.main([name, "10", "base"]),
                lambda: ed.main([name, "10", "5"]),
                lambda: ts.main(["--seq", name, "--n_iters", "10"])):
        with pytest.raises(FileNotFoundError, match="GBP_SEQUENCES_DIR"):
            run()


def test_a_bad_spec_stops_before_solving(bal_path, monkeypatch):
    monkeypatch.setenv("GBP_PLATFORM", "cpu")
    with pytest.raises(ValueError, match="use_pallas"):
        eg.main([bal_path, "10", "use_pallas=0"])
    with pytest.raises(ValueError, match="table_carry"):
        ts.main(["--seq", bal_path, "--set", "x:table_carry=1"])


def test_mains_need_a_card_unless_told(bal_path, monkeypatch):
    """Without GBP_PLATFORM=cpu each main takes cuda:0, and stops with an
    error where there is no card (it never falls back to the CPU)."""
    monkeypatch.delenv("GBP_PLATFORM", raising=False)
    if torch.cuda.is_available():
        return
    for run in (lambda: vs.main([bal_path]),
                lambda: da.main([bal_path, "10"]),
                lambda: eg.main([bal_path, "10", "base"]),
                lambda: ed.main([bal_path, "10", "5"]),
                lambda: ts.main(["--seq", bal_path, "--n_iters", "10"])):
        with pytest.raises(SystemExit, match="no CUDA device"):
            run()
