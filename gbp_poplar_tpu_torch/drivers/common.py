"""Shared CLI plumbing for the drivers.

The flags, their defaults and the per-iteration log line are those of
``gbp_poplar_tpu/drivers/common.py`` (flag names follow the reference
CLIs), so a command line moves between the two packages unchanged. The
device choice replaces the JAX package's ``GBP_PLATFORM`` platform switch:
``GBP_PLATFORM=cpu`` runs on the CPU with the kernels' plain versions;
otherwise the drivers run on ``cuda:0`` and stop with an error when there
is no CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from ..config import GBPConfig, InitConfig
from ..core.factor_graph import GRAPH_FIELDS


def select_device() -> torch.device:
    """The device a driver runs on: the CPU under ``GBP_PLATFORM=cpu``,
    else ``cuda:0``. Exits with an error if that is not available, rather
    than carry on elsewhere."""
    plat = os.environ.get("GBP_PLATFORM", "").lower()
    if plat == "cpu":
        return torch.device("cpu")
    if plat not in ("", "cuda", "gpu"):
        raise SystemExit(f"error: GBP_PLATFORM={plat!r}: this package runs "
                         "on 'cuda' (the default) or 'cpu'")
    if not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device; set GBP_PLATFORM=cpu to run "
                         "on the CPU with the kernels' plain versions")
    return torch.device("cuda", 0)


def check_devices(n_devices: int) -> None:
    """Only one device is ported: ``--devices > 1`` raises."""
    if n_devices > 1:
        raise NotImplementedError(
            f"--devices {n_devices}: sharding over several devices is not "
            "ported yet (ROADMAP.md, A10); run with --devices 1")


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--bal_file", required=True,
                   help="BAL-format file or sequence name (e.g. fr1xyz)")
    p.add_argument("--tn", type=float, default=0.0,
                   help="keyframe translation noise std (m)")
    p.add_argument("--rn", type=float, default=0.0,
                   help="keyframe rotation noise std (degrees)")
    p.add_argument("--ltn", type=float, default=0.0,
                   help="landmark translation noise std (m)")
    p.add_argument("--avdepth_on", action="store_true",
                   help="initialise landmarks at --avdepth on the first "
                        "observing keyframe's optic axis")
    p.add_argument("--avdepth", type=float, default=1.0)
    p.add_argument("--reproj_meas_var", type=float, default=4.0,
                   help="measurement variance (px^2)")
    p.add_argument("--prior_std_weaker_factor", type=float, default=100.0)
    p.add_argument("--first_cam_prior_std", type=float, default=0.01)
    p.add_argument("--steps", type=int, default=5,
                   help="prior-annealing steps")
    p.add_argument("--undamped_start", type=int, default=15,
                   help="undamped iterations before damping activates")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--v", action="store_true", help="verbose belief dumps")
    p.add_argument("--profile", action="store_true",
                   help="capture a torch.profiler trace of the solve to "
                        "--profile_dir")
    p.add_argument("--profile_dir",
                   default=os.path.join(tempfile.gettempdir(), "gbp_profile"))
    p.add_argument("--devices", type=int, default=1,
                   help="shard the edge axis over this many devices (only "
                        "1 is ported; more raises)")
    p.add_argument("--save_traj", default=None,
                   help="write final TUM trajectory here")
    p.add_argument("--checkpoint", default=None,
                   help="write a checkpoint here at the end (and every "
                        "--checkpoint_every iters)")
    p.add_argument("--checkpoint_every", type=int, default=0)
    p.add_argument("--resume", default=None,
                   help="resume from a checkpoint file (of either package)")
    p.add_argument("--print_every", type=int, default=1,
                   help="print telemetry every N iterations")
    p.add_argument("--relin_drift", type=float, default=None,
                   help="relinearise when the belief mean drifts this far "
                        "from the linearisation point (<=0 disables)")
    p.add_argument("--lambda_damping", dest="lambda_damping",
                   action="store_true", default=None,
                   help="damp Lambda messages too (DEFAULT ON); "
                        "--no_lambda_damping opts out")
    p.add_argument("--no_lambda_damping", dest="lambda_damping",
                   action="store_false")
    p.add_argument("--rescue_iters", type=int, default=None,
                   help="with the incremental one-sided depth guard, edges "
                        "that have neither relinearised nor seen a keyframe "
                        "insertion for this many sweeps may relinearise "
                        "behind the camera (<=0 disables)")
    p.add_argument("--coarse_groups", type=int, default=None,
                   help="coarse-space correction over this many rigid "
                        "keyframe groups at each accelerator chunk boundary "
                        "(core/coarse.py); <=0 disables. The batch ba "
                        "driver defaults to 16")
    p.add_argument("--schedule", choices=["reference", "gn"],
                   default="reference",
                   help="'reference' = the reference's lazy-relinearisation "
                        "schedule; 'gn' = relinearise every sweep with "
                        "Lambda damping 0.7 (damped Gauss-Newton message "
                        "passing)")
    p.add_argument("--bad_assoc", default=None,
                   help="known-bad data associations to exclude from the "
                        "error evaluation: comma-separated original edge "
                        "ids, or @file with one id per line")


def parse_bad_assoc(arg: str | None) -> list[int]:
    """--bad_assoc value -> list of original-problem edge indices."""
    if not arg:
        return []
    if arg.startswith("@"):
        with open(arg[1:]) as f:
            return [int(t) for t in f.read().split()]
    return [int(t) for t in arg.split(",") if t.strip()]


def config_from_args(
    args,
    default_relin_drift: float = 0.05,
    default_lambda_damping: bool = True,
    relin_behind_camera: bool = True,
    default_rescue_iters: int = 0,
    default_coarse_groups: int = 0,
) -> tuple[GBPConfig, InitConfig]:
    """(GBPConfig, InitConfig) from the parsed flags, as the JAX
    package's ``config_from_args``."""
    relin_drift = (default_relin_drift if args.relin_drift is None
                   else args.relin_drift)
    lambda_damping = (default_lambda_damping if args.lambda_damping is None
                      else args.lambda_damping)
    rescue = (default_rescue_iters
              if getattr(args, "rescue_iters", None) is None
              else args.rescue_iters)
    coarse = (default_coarse_groups
              if getattr(args, "coarse_groups", None) is None
              else args.coarse_groups)
    gn_schedule = getattr(args, "schedule", "reference") == "gn"
    cfg = GBPConfig(
        relin_behind_camera=relin_behind_camera,
        behind_camera_rescue_iters=rescue,
        coarse_groups=max(coarse, 0),
        meas_var=args.reproj_meas_var,
        prior_std_weaker_factor=args.prior_std_weaker_factor,
        first_cam_prior_std=args.first_cam_prior_std,
        steps=args.steps,
        iters_before_damping=0 if gn_schedule else args.undamped_start,
        n_iters=getattr(args, "n_iters", 1500),
        iters_between_kfs=getattr(args, "iters_between_kfs", 700),
        relin_drift_threshold=relin_drift,
        lambda_damping=True if gn_schedule else lambda_damping,
        relin_every_iter=gn_schedule,
        eta_damping=0.7 if gn_schedule else 0.4,
    )
    if (cfg.relin_drift_threshold <= 0 and not cfg.lambda_damping
            and not cfg.relin_every_iter):
        print("warning: --relin_drift 0 without --lambda_damping runs the "
              "reference's exact lazy dynamics INCLUDING its oscillation "
              "instability; add --lambda_damping for a stable lazy "
              "schedule.", file=sys.stderr)
    init_cfg = InitConfig(
        trans_noise=args.tn, rot_noise=args.rn, lmk_noise=args.ltn,
        av_depth_on=args.avdepth_on, av_depth=args.avdepth, seed=args.seed)
    return cfg, init_cfg


def print_iteration(i: int, err: float, cost: float,
                    n_relins: int, n_robust: int) -> None:
    # the reference's telemetry line (ba/ba.cpp:1026-1028)
    print(f"iter {i:5d}  reproj_err {err:10.5f} px  cost {cost:14.4f}  "
          f"relins {n_relins:5d}  robust {n_robust:5d}", flush=True)


def resume_graph(built, loaded):
    """The graph to run with after a checkpoint load: the freshly built
    one when the checkpoint's plain arrays equal it (the normal case: the
    same BAL file and config; its segments cover the real edges only),
    else the checkpoint's own graph, with a warning."""
    if loaded is None:
        return built

    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)

    def same(f):
        a, b = getattr(built, f), getattr(loaded, f)
        if a is None or b is None:
            return a is None and b is None
        a, b = host(a), host(b)
        return a.shape == b.shape and bool(np.array_equal(a, b))

    if all(same(f) for f in GRAPH_FIELDS):
        return built
    print("warning: checkpoint graph differs from the one built from "
          "--bal_file; running with the checkpoint graph", file=sys.stderr)
    return loaded
