"""Accuracy and agreement per sequence: batch GBP, the Gauss-Newton
oracle and incremental SLAM.

    python -m gbp_poplar_tpu_torch.tools.validate_sequences [SEQ|FILE ...]
    GBP_PLATFORM=cpu python -m gbp_poplar_tpu_torch.tools.validate_sequences f.txt

The counterpart of the JAX package's ``scripts/validate_sequences.py``
(the table of docs/VALIDATION.md), step for step. Each argument is a
sequence name (found as ``utils/balio.load_bal`` finds it, under
``GBP_SEQUENCES_DIR``) or a BAL file; the default is the three TUM
sequences. Per sequence:

  1. batch GBP with ``GBPConfig()``, ``n_iters`` sweeps (default 1,000):
     the mean error of the last 10 sweeps;
  2. the cold GN oracle, 40 LM iterations of 80 CG steps: its final error
     and ATE(GBP, GN) (``utils.evaluation.ate_rmse``);
  3. incremental SLAM from ``create_flags`` with
     ``relin_drift_threshold=0.05, lambda_damping=True``, 300 sweeps a
     keyframe and ``av_depth=1.0`` (the script's own config, not the slam
     driver's): the mean error of the last segment's last 10 sweeps and
     ATE(SLAM, GN).
"""

from __future__ import annotations

import dataclasses
import sys

from ..config import GBPConfig
from ..core import build_graph, gbp, init_state, slam
from ..utils import analysis, balio, evaluation, flags as flags_lib
from . import device_label, resolve_device, timed
from .seq_common import SEQUENCES, gn_oracle

N_ITERS = 1000
GN_LM_ITERS, GN_CG_ITERS = 40, 80
SLAM_IBK = 300


def run_sequence(seq: str, n_iters: int = N_ITERS, device=None,
                 iters_between_kfs: int = SLAM_IBK) -> dict:
    """The three solves of ``seq`` (a name or a BAL path); prints the JAX
    script's line and returns its numbers (``gbp_err``, ``gn_err``,
    ``ate``, ``slam_err``, ``ate_slam``) with the wall times."""
    dev = resolve_device(device)
    problem = balio.load_bal(seq)
    cfg = GBPConfig()

    graph = build_graph(problem, cfg, dev)
    state = init_state(problem, cfg, dev)
    (state, diag), dt = timed(
        dev, lambda: gbp.solve(state, graph, cfg, n_iters=n_iters))
    gbp_err = float(diag.reproj_err.cpu().numpy()[-10:].mean())
    cam_mu, _ = analysis.belief_means(state)
    del state, graph, diag

    res, dt_gn = timed(dev, lambda: gn_oracle(
        problem, cfg, GN_LM_ITERS, GN_CG_ITERS, dev))
    gn_err = float(res.reproj_err[-1])
    gn_cam = res.cam.cpu().numpy()
    ate = evaluation.ate_rmse(cam_mu, gn_cam)

    flags = flags_lib.create_flags(problem, cfg.steps)
    state_i = init_state(problem, cfg, dev, flags=flags)
    slam_cfg = dataclasses.replace(cfg, relin_drift_threshold=0.05,
                                   lambda_damping=True)
    graph_s = build_graph(problem, slam_cfg, dev)
    result, dt_slam = timed(dev, lambda: slam.solve_slam(
        state_i, graph_s, slam_cfg, iters_between_kfs=iters_between_kfs,
        av_depth=1.0))
    slam_err = float(result.reproj_err[-1, -10:].mean())
    cam_slam, _ = analysis.belief_means(result.state)
    ate_slam = evaluation.ate_rmse(cam_slam, gn_cam)

    label = device_label(dev)
    print(f"{seq:10s} | GBP {gbp_err:7.3f}px ({n_iters} it, {dt:5.1f}s) | "
          f"GN {gn_err:7.3f}px | ATE(GBP,GN) {ate:.5f} m | "
          f"SLAM {slam_err:7.3f}px | ATE(SLAM,GN) {ate_slam:.5f} m | "
          f"{label}", flush=True)
    return dict(seq=seq, gbp_err=gbp_err, gn_err=gn_err, ate=ate,
                slam_err=slam_err, ate_slam=ate_slam,
                gn_cost=float(res.cost[-1]), edges=problem.n_edges,
                n_iters=n_iters, iters_between_kfs=iters_between_kfs,
                device=label,
                seconds={"gbp": dt, "gn": dt_gn, "slam": dt_slam})


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    dev = resolve_device()
    for seq in argv or SEQUENCES:
        run_sequence(seq, N_ITERS, dev, SLAM_IBK)
    return 0


if __name__ == "__main__":
    sys.exit(main())
