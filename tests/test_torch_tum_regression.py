"""The sequence-level regression guards of tests/test_tum_regression.py and
tests/test_slam.py::test_slam_fr1desk_stability, on the port: the same
sequences, budgets and thresholds, run on a CUDA card when one is present
and on the CPU otherwise (the kernels' plain versions).

Skipped when the TUM sequences are not on disk (conftest's
``requires_sequences``), and in the slow tier.
"""

import numpy as np
import pytest
import torch

from gbp_poplar_tpu_torch import GBPConfig
from gbp_poplar_tpu_torch.core import build_graph, gauss_newton, gbp
from gbp_poplar_tpu_torch.core import init_state, slam
from gbp_poplar_tpu_torch.drivers.ba import _polish_problem
from gbp_poplar_tpu_torch.utils import analysis, balio, evaluation
from gbp_poplar_tpu_torch.utils import flags as flags_lib

from conftest import requires_sequences

pytestmark = [pytest.mark.slow, requires_sequences]


@pytest.fixture
def dev():
    """cuda:0 where a card is present, else the CPU."""
    return torch.device("cuda", 0) if torch.cuda.is_available() else \
        torch.device("cpu")


def _solve(name: str, cfg: GBPConfig, n_iters: int, dev):
    prob = balio.load_bal(name)
    graph = build_graph(prob, cfg, dev)
    state, diag = gbp.solve(init_state(prob, cfg, dev), graph, cfg,
                            n_iters=n_iters)
    return prob, state, diag.reproj_err.cpu().numpy()


def test_fr2robot2_reference_schedule_matches_gn(dev):
    """GBP converges to the GN MAP solution on fr2robot2 (GN 0.879 px;
    ATE 0.001 m measured in the JAX package's rounds 1-2)."""
    cfg = GBPConfig()
    prob, state, errs = _solve("fr2robot2", cfg, 300, dev)
    assert np.isfinite(errs).all()
    assert errs[-1] < 1.0, errs[-1]
    res = gauss_newton.solve_problem(prob, cfg, dev, n_lm_iters=25)
    assert float(res.reproj_err[-1]) < 1.0
    cam_mu, _ = analysis.belief_means(state)
    ate = evaluation.ate_rmse(cam_mu, res.cam.cpu().numpy())
    assert ate < 0.01, ate


def test_fr1xyz_short_budget_px(dev):
    """The library-default schedule reaches GN-level error on fr1xyz in 300
    sweeps (the JAX package measured ~1.6 px on a CPU; fail at 2.5)."""
    _, _, errs = _solve("fr1xyz", GBPConfig(), 300, dev)
    assert np.isfinite(errs).all()
    assert errs[-1] < 2.5, errs[-1]


def test_fr1desk_default_schedule_polishes_to_map(dev):
    """fr1desk on the ba driver's default schedule (drift recapture 0.05,
    coarse 16, lambda damping): error at GN parity (GN 1.386 px), no late
    Huber storm, and the LM polish of the GBP point lands on the MAP cost
    of the cold GN."""
    cfg = GBPConfig(coarse_groups=16)
    prob, state, errs = _solve("fr1desk", cfg, 1500, dev)
    assert np.isfinite(errs).all()
    assert errs[-1] < 2.5, errs[-1]
    transient = max(200, 40 * cfg.steps)
    assert errs[transient:].max() < 4.0, errs[transient:].max()

    res_gn = gauss_newton.solve_problem(prob, cfg, dev, n_lm_iters=25)
    cam_mu, lmk_mu = analysis.belief_means(state)
    res_pol = gauss_newton.solve_lm(
        torch.tensor(cam_mu, device=dev), torch.tensor(lmk_mu, device=dev),
        *_polish_problem(prob, cfg, dev), cfg, n_lm_iters=30)
    cost_pol = float(res_pol.cost[-1])
    cost_gn = float(res_gn.cost[-1])
    assert np.isfinite(cost_pol) and np.isfinite(cost_gn)
    assert cost_pol < 1.02 * cost_gn, (cost_pol, cost_gn)


def test_fr1desk_lazy_lambda_damped_converges(dev):
    """The pure lazy schedule (relin_drift 0, accelerator off: the
    reference's dynamics) with lambda damping converges on fr1desk, with
    no Huber storm past the annealing transient. (The JAX test also sets
    ``use_pallas=False``, a TPU kernel option the port does not have.)"""
    cfg = GBPConfig(relin_drift_threshold=0.0, accel_every=0,
                    lambda_damping=True)
    _, _, errs = _solve("fr1desk", cfg, 1500, dev)
    assert np.isfinite(errs).all()
    assert errs[-1] < 2.0, f"lambda-damped lazy desk at {errs[-1]} px"
    assert errs[200:].max() < 4.0


def test_slam_fr1desk_stability(dev):
    """Incremental SLAM on fr1desk with the slam driver's damped-GN
    schedule holds through all 62 keyframe insertions, at 150 sweeps a
    keyframe."""
    problem = balio.load_bal("fr1desk")
    cfg = GBPConfig(relin_every_iter=True, eta_damping=0.7,
                    lambda_damping=True, iters_before_damping=0,
                    relin_behind_camera=False,
                    behind_camera_rescue_iters=300)
    graph = build_graph(problem, cfg, dev)
    flags = flags_lib.create_flags(problem, cfg.steps)
    state = init_state(problem, cfg, dev, flags=flags)
    result = slam.solve_slam(state, graph, cfg, iters_between_kfs=150,
                             av_depth=1.0)
    errs = np.asarray(result.reproj_err)       # [n_kf-1, 150]
    assert np.isfinite(errs).all()
    final_err = float(errs[-1, -10:].mean())
    assert final_err < 2.5, final_err
    assert errs[40:, -1].max() < 5.0, errs[40:, -1]
    active = result.state.active.cpu().numpy()[:problem.n_edges]
    assert (active == 1).all()
