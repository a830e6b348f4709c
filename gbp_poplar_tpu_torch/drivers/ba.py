"""Batch bundle-adjustment driver: the PyTorch counterpart of
``gbp_poplar_tpu/drivers/ba.py``, with the same flags, defaults and
per-iteration log line.

    python -m gbp_poplar_tpu_torch.drivers.ba --bal_file fr1xyz --n_iters 1500
    GBP_PLATFORM=cpu python -m gbp_poplar_tpu_torch.drivers.ba --bal_file f.txt

The defaults are the JAX driver's: the fixed-point accelerator every 50
sweeps with the coarse corrector over 16 keyframe groups after each step,
then 15 warm-started Levenberg-Marquardt/Schur iterations (``--polish``)
on the exported means. The solve runs on the device in spans of
``4 * accel_every`` sweeps; the per-sweep telemetry is read back once per
span, checked against the NumPy host oracle, and printed.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from ..config import GBPConfig
from ..core import build_graph, gbp, init_state
from ..core import gauss_newton as gn
from ..core.intrinsics import refit_intrinsics
from ..utils import analysis, balio, checkpoint, evaluation, priors
from . import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="GBP bundle adjustment (batch) on one CUDA device")
    common.add_common_args(p)
    p.add_argument("--n_iters", type=int, default=1500)
    p.add_argument("--gn_check", action="store_true",
                   help="also run the Gauss-Newton/Schur baseline and "
                        "report agreement")
    p.add_argument("--polish", dest="polish", action="store_true",
                   default=True,
                   help="refine the GBP solution to the exact MAP with a "
                        "warm-started Levenberg-Marquardt/Schur pass (the "
                        "exported trajectory uses the polished means; the "
                        "checkpoint keeps the GBP state). DEFAULT ON; "
                        "disable with --no_polish")
    p.add_argument("--no_polish", dest="polish", action="store_false",
                   help="export the raw GBP means without the LM polish")
    p.add_argument("--refine_intrinsics", action="store_true",
                   help="Snavely/BAL problems only: between execution "
                        "chunks, refit every camera's (f, k1, k2) with a "
                        "damped per-camera Gauss-Newton step, accepted only "
                        "when the MAP objective decreases "
                        "(core/intrinsics.py)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    common.check_devices(args.devices)
    dev = common.select_device()

    # coarse_groups=16: the per-group rigid coarse correction at the
    # accelerator's chunk boundaries (the JAX driver's default)
    cfg, init_cfg = common.config_from_args(args, default_coarse_groups=16)

    problem = balio.load_bal(args.bal_file)
    if cfg.coarse_groups > problem.n_keyframes:
        cfg = dataclasses.replace(cfg, coarse_groups=problem.n_keyframes)
    problem = priors.apply_init_noise(problem, init_cfg,
                                      k_anchor=cfg.num_anchor_cams)
    print(f"{args.bal_file}: {problem.n_keyframes} keyframes, "
          f"{problem.n_points} landmarks, {problem.n_edges} edges",
          file=sys.stderr)

    graph = build_graph(problem, cfg, dev)
    if args.resume:
        state, g2, meta = checkpoint.load_checkpoint(args.resume, dev)
        graph = common.resume_graph(graph, g2)
        start_iter = meta.get("step", 0)
        print(f"resumed from {args.resume} at iter {start_iter}",
              file=sys.stderr)
    else:
        state = init_state(problem, cfg, dev)
        start_iter = 0

    if args.refine_intrinsics and problem.intrinsics is None:
        print("error: --refine_intrinsics needs a Snavely/BAL problem "
              "(per-camera intrinsics); this file uses the shared "
              "pinhole model", file=sys.stderr)
        return 2

    n_refits = [0, 0]               # accepted, attempted
    prof = None
    if args.profile:
        prof = torch.profiler.profile(activities=_profiler_activities(dev))
        prof.start()

    t0 = time.perf_counter()
    if start_iter == 0:
        state = gbp.initialise(state, graph, cfg)
    # the accelerator/coarse chunk path engages only where one run_gbp call
    # spans at least two accelerator chunks: run spans of 4 * accel_every
    # sweeps and print their buffered per-sweep lines after each
    chunk = max(1, args.print_every)
    if cfg.accel_every > 0:
        chunk = max(chunk, 4 * cfg.accel_every)
    i = start_iter
    t_first_chunk = None
    while i < args.n_iters:
        n = min(chunk, args.n_iters - i)
        state, diag = gbp.run_gbp(state, graph, cfg, n, iter_offset=i,
                                  verbose_means=args.v)
        errs = diag.reproj_err.cpu().numpy()
        costs = diag.cost.cpu().numpy()
        relins = diag.n_relins.cpu().numpy()
        robusts = diag.n_robust.cpu().numpy()
        v_means = diag.cam_means.cpu().numpy() if args.v else None
        if t_first_chunk is None:
            t_first_chunk = time.perf_counter()   # kernel build happened here
        for j in range(n):
            common.print_iteration(i + j, errs[j], costs[j],
                                   int(relins[j]), int(robusts[j]))
            if v_means is not None:
                np.set_printoptions(precision=5, suppress=True)
                print(f"beliefs (cam means) at iter {i + j}:\n"
                      f"{v_means[j].T}", flush=True)
        i += n
        # independent host oracle once per span (NumPy, no code shared
        # with the device telemetry): silent when it agrees. The state is
        # past the chunk's boundary steps while errs[-1] is its last
        # sweep, so the bound leaves room for that cost-decreasing jump.
        h_err, _ = evaluation.numpy_reprojection_error(
            *analysis.belief_means(state), problem)
        dev_err = float(errs[-1])
        if not abs(h_err - dev_err) <= max(0.25, 0.05 * abs(dev_err)):
            print(f"WARNING: host oracle disagrees at iter {i}: "
                  f"device {dev_err:.5f} px vs host {h_err:.5f} px",
                  file=sys.stderr)
        if args.refine_intrinsics and i < args.n_iters:
            # block-coordinate intrinsics step, after the oracle check so
            # that it saw the intrinsics the chunk ran under
            new_intr, acc = refit_intrinsics(state, graph, cfg)
            n_refits[1] += 1
            if bool(acc):
                graph = dataclasses.replace(graph, intr=new_intr)
                # the stored potentials were linearised under the old
                # intrinsics: refresh them all at the current means
                state = gbp.linearise_all(state, graph, cfg)
                n_refits[0] += 1
                problem.intrinsics = _per_camera_intr(new_intr, graph,
                                                      problem)
        if args.checkpoint and args.checkpoint_every and (
                i % args.checkpoint_every < chunk):
            checkpoint.save_checkpoint(args.checkpoint, state, graph,
                                       step=i, cfg=cfg)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_end = time.perf_counter()
    dt = t_end - t0
    msg = (f"total {dt:.3f}s ({(args.n_iters - start_iter) / dt:.1f} "
           "sweeps/s incl. kernel build")
    steady_iters = args.n_iters - start_iter - chunk
    if steady_iters > 0 and t_end > t_first_chunk:
        msg += (f"; steady-state "
                f"{steady_iters / (t_end - t_first_chunk):.1f} sweeps/s")
    print(msg + ")", file=sys.stderr)

    if args.refine_intrinsics:
        print(f"intrinsics refits: {n_refits[0]}/{n_refits[1]} accepted",
              file=sys.stderr)

    if prof is not None:
        prof.stop()
        os.makedirs(args.profile_dir, exist_ok=True)
        path = os.path.join(args.profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        print(f"profile written to {path}", file=sys.stderr)

    cam_mu, lmk_mu = analysis.belief_means(state)
    if args.polish:
        # GBP resolves the geometry; a few warm-started LM/Schur steps on
        # the same MAP objective (the annealed priors) remove the residual
        # smooth-mode error
        graph1, pri = _polish_problem(problem, cfg, dev)
        res = gn.solve_lm(torch.tensor(cam_mu, device=dev),
                          torch.tensor(lmk_mu, device=dev), graph1, pri, cfg,
                          n_lm_iters=15)
        pol_cam = res.cam.cpu().numpy()
        moved = float(np.linalg.norm(pol_cam[:, :3] - cam_mu[:, :3],
                                     axis=1).max())
        cam_mu, lmk_mu = pol_cam, res.lmk.cpu().numpy()
        print(f"polish: reproj {float(res.reproj_err[-1]):.5f} px, "
              f"max camera movement {moved:.5f} m", file=sys.stderr)
    # the independent host oracle at the end of the solve (--bad_assoc:
    # the reference's skip list)
    bad = common.parse_bad_assoc(args.bad_assoc)
    o_err, o_cost = evaluation.numpy_reprojection_error(
        cam_mu, lmk_mu, problem, bad_associations=bad or None)
    excl = f"  ({len(bad)} bad associations excluded)" if bad else ""
    print(f"host oracle: reproj_err {o_err:.5f} px  cost {o_cost:.4f}{excl}",
          file=sys.stderr)
    if args.v:
        np.set_printoptions(precision=5, suppress=True)
        print("cam means:\n", cam_mu)
    if args.save_traj:
        evaluation.export_tum(args.save_traj, cam_mu)
        print(f"trajectory written to {args.save_traj}", file=sys.stderr)
    if args.checkpoint:
        checkpoint.save_checkpoint(args.checkpoint, state, graph,
                                   step=args.n_iters, cfg=cfg)
        print(f"checkpoint written to {args.checkpoint}", file=sys.stderr)

    if args.gn_check:
        res = gn.solve_problem(problem, cfg, dev, n_lm_iters=30)
        ate = evaluation.ate_rmse(cam_mu, res.cam.cpu().numpy())
        print(f"GN baseline: reproj_err {float(res.reproj_err[-1]):.5f} px, "
              f"ATE(GBP vs GN) {ate:.6f} m", file=sys.stderr)
    return 0


def _profiler_activities(dev: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _per_camera_intr(intr: torch.Tensor, graph, problem) -> np.ndarray:
    """[C, 3] per-camera intrinsics from the per-edge [3, E] planes (every
    edge of a camera carries the same value; unobserved cameras keep their
    previous estimate)."""
    out = np.asarray(problem.intrinsics).copy()
    ci = graph.cam_idx[:problem.n_edges].cpu().numpy()
    cams, first = np.unique(ci, return_index=True)
    out[cams] = intr[:, :problem.n_edges].cpu().numpy()[:, first].T
    return out


def _polish_problem(problem, cfg: GBPConfig, device):
    """(exact-edge graph, annealed GN priors) for the warm-started LM pass:
    the MAP objective the GBP fixed point targets."""
    graph1 = build_graph(problem,
                         dataclasses.replace(cfg, edge_pad_multiple=1),
                         device)
    return graph1, gn.problem_priors(problem, cfg, graph1)


if __name__ == "__main__":
    sys.exit(main())
