"""The JAX package's incremental SLAM at the TUM fr1desk shape: the final
reprojection error that chip_smoke.py prints beside the port's.

    JAX_PLATFORMS=cpu python scripts/slam_reference_error.py [--ibk 700]

The problem is synthetic_problem_large(62, 1900, 7) (62 keyframes, 13,300
edges, keyframe-local visibility) with its landmarks perturbed by
N(0, 5 cm), solved with the slam driver's default schedule (damped
Gauss-Newton, one-sided depth guard, rescue after 300 sweeps), one segment
of ``--ibk`` sweeps per keyframe, no diagnostics; the final error is that
of the final state, as bench.py's SLAM row reads it.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np

from gbp_poplar_tpu.config import GBPConfig, InitConfig
from gbp_poplar_tpu.core import build_graph, gbp, init_state, slam
from gbp_poplar_tpu.utils import balio, evaluation, flags as flags_lib, priors

SHAPE = (62, 1900, 7)
LMK_NOISE = 0.05


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ibk", type=int, default=700)
    p.add_argument("--n_keyframes", type=int, default=SHAPE[0])
    args = p.parse_args()
    raw = balio.synthetic_problem_large(*SHAPE)
    err_true, _ = evaluation.numpy_reprojection_error(raw.cam_means,
                                                      raw.lmk_means, raw)
    problem = priors.apply_init_noise(raw, InitConfig(lmk_noise=LMK_NOISE,
                                                      seed=0))
    cfg = GBPConfig(relin_every_iter=True, eta_damping=0.7,
                    lambda_damping=True, iters_before_damping=0,
                    relin_behind_camera=False,
                    behind_camera_rescue_iters=300,
                    iters_between_kfs=args.ibk)
    graph = build_graph(problem, cfg)
    state = init_state(problem, cfg,
                       flags=flags_lib.create_flags(problem, cfg.steps))
    runner = jax.jit(lambda s: gbp.run_gbp(s, graph, cfg, args.ibk,
                                           with_diagnostics=False))
    inserter = jax.jit(
        lambda s, k: slam.insert_keyframe(s, graph, cfg, k, 1.0))
    initialiser = jax.jit(lambda s: gbp.initialise(s, graph, cfg))
    t0 = time.perf_counter()
    res = slam.solve_slam(state, graph, cfg, n_keyframes=args.n_keyframes,
                          iters_between_kfs=args.ibk, with_diagnostics=False,
                          runner=runner, inserter=inserter,
                          initialiser=initialiser)
    err = float(jax.jit(lambda s: gbp.reprojection_error(s, graph)[0])(
        res.state))
    print(f"JAX SLAM, synthetic_problem_large{SHAPE}, landmarks perturbed by "
          f"N(0, {LMK_NOISE} m): oracle at the true means {err_true:.5f} px; "
          f"{args.n_keyframes} keyframes x {args.ibk} sweeps on "
          f"{jax.default_backend()}: final error {err:.6f} px "
          f"({time.perf_counter() - t0:.1f} s)")
    return 0 if np.isfinite(err) else 1


if __name__ == "__main__":
    sys.exit(main())
