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

``--devices N`` runs N ranks (parallel/launch.py), the edges split over
them (parallel/sharding.py); rank 0 prints and writes what the
single-device run writes, and its lines are the single-device run's up to
the order of the per-variable sums.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import parallel
from ..config import GBPConfig
from ..core import build_graph, gbp, init_state
from ..core import gauss_newton as gn
from ..core.intrinsics import refit_intrinsics
from ..utils import analysis, balio, checkpoint, evaluation, priors
from . import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="GBP bundle adjustment (batch) on CUDA devices")
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
    dev = common.select_device()
    if args.devices > 1:
        common.check_devices(args.devices, dev)
        return parallel.run(_rank_main, args.devices, (args,), dev.type)[0]
    return _solve(args, dev)


def _rank_main(rank: parallel.Rank, args) -> int:
    """One rank of ``--devices N``: the edges split over the ranks
    (parallel/sharding.py)."""
    return _solve(args, rank.device, rank.group)


def _solve(args, dev: torch.device, group=None) -> int:
    """The driver on ``dev``; with ``group``, as one rank of the
    edge-sharded solve. Every rank runs the solve and its collectives;
    rank 0 alone prints, checks the host oracle, polishes, exports and
    writes checkpoints, on the whole state gathered from the ranks (as
    the JAX driver runs them unsharded)."""
    lead = group is None or dist.get_rank(group) == 0

    def note(msg):
        if lead:
            print(msg, file=sys.stderr)

    # coarse_groups=16: the per-group rigid coarse correction at the
    # accelerator's chunk boundaries (the JAX driver's default)
    cfg, init_cfg = common.config_from_args(args, default_coarse_groups=16)

    problem = balio.load_bal(args.bal_file)
    if cfg.coarse_groups > problem.n_keyframes:
        cfg = dataclasses.replace(cfg, coarse_groups=problem.n_keyframes)
    problem = priors.apply_init_noise(problem, init_cfg,
                                      k_anchor=cfg.num_anchor_cams)
    note(f"{args.bal_file}: {problem.n_keyframes} keyframes, "
         f"{problem.n_points} landmarks, {problem.n_edges} edges")

    graph = build_graph(problem, cfg, dev)
    if args.resume:
        state, g2, meta = checkpoint.load_checkpoint(args.resume, dev)
        graph = common.resume_graph(graph, g2)
        start_iter = meta.get("step", 0)
        note(f"resumed from {args.resume} at iter {start_iter}")
    else:
        state = init_state(problem, cfg, dev)
        start_iter = 0

    if args.refine_intrinsics and problem.intrinsics is None:
        note("error: --refine_intrinsics needs a Snavely/BAL problem "
             "(per-camera intrinsics); this file uses the shared "
             "pinhole model")
        return 2

    # the graph the solve runs: the rank's block when sharded (a
    # checkpoint keeps the whole graph, in the global layout)
    run_graph = graph
    if group is not None:
        solver = parallel.make_sharded_solver(group, cfg)
        run_graph, state = solver.prepare(graph, state)

    def whole(st):
        return st if group is None else solver.gather(st, graph.n_edges)

    n_refits = [0, 0]               # accepted, attempted
    prof = common.start_profile(args, dev, lead)

    t0 = time.perf_counter()
    if start_iter == 0:
        state = gbp.initialise(state, run_graph, cfg, group)
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
        state, diag = gbp.run_gbp(state, run_graph, cfg, n, iter_offset=i,
                                  verbose_means=args.v, group=group)
        errs = diag.reproj_err.cpu().numpy()
        costs = diag.cost.cpu().numpy()
        relins = diag.n_relins.cpu().numpy()
        robusts = diag.n_robust.cpu().numpy()
        v_means = diag.cam_means.cpu().numpy() if args.v else None
        if t_first_chunk is None:
            t_first_chunk = time.perf_counter()   # kernel build happened here
        for j in range(n if lead else 0):
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
        # Every rank holds the beliefs whole.
        if lead:
            h_err, _ = evaluation.numpy_reprojection_error(
                *analysis.belief_means(state), problem)
            dev_err = float(errs[-1])
            if not abs(h_err - dev_err) <= max(0.25, 0.05 * abs(dev_err)):
                note(f"WARNING: host oracle disagrees at iter {i}: "
                     f"device {dev_err:.5f} px vs host {h_err:.5f} px")
        if args.refine_intrinsics and i < args.n_iters:
            # block-coordinate intrinsics step, after the oracle check so
            # that it saw the intrinsics the chunk ran under; every rank
            # takes the same decision (its sums and costs are all-reduced)
            new_intr, acc = refit_intrinsics(state, run_graph, cfg, group)
            n_refits[1] += 1
            if bool(acc):
                run_graph = dataclasses.replace(run_graph, intr=new_intr)
                # the stored potentials were linearised under the old
                # intrinsics: refresh them all at the current means
                state = gbp.linearise_all(state, run_graph, cfg)
                n_refits[0] += 1
                if group is not None:
                    new_intr = parallel.sharding.gather_cols(
                        new_intr, group)[:, :graph.n_edges]
                graph = dataclasses.replace(graph, intr=new_intr)
                problem.intrinsics = _per_camera_intr(new_intr, graph,
                                                      problem)
        if args.checkpoint and args.checkpoint_every and (
                i % args.checkpoint_every < chunk):
            full = whole(state)
            if lead:
                checkpoint.save_checkpoint(args.checkpoint, full, graph,
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
    note(msg + ")")

    if args.refine_intrinsics:
        note(f"intrinsics refits: {n_refits[0]}/{n_refits[1]} accepted")

    if args.checkpoint:
        state = whole(state)
    if not lead:
        return 0
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
        note(f"polish: reproj {float(res.reproj_err[-1]):.5f} px, "
             f"max camera movement {moved:.5f} m")
    common.end_profile(prof, args, note)
    # the independent host oracle at the end of the solve (--bad_assoc:
    # the reference's skip list)
    bad = common.parse_bad_assoc(args.bad_assoc)
    o_err, o_cost = evaluation.numpy_reprojection_error(
        cam_mu, lmk_mu, problem, bad_associations=bad or None)
    excl = f"  ({len(bad)} bad associations excluded)" if bad else ""
    note(f"host oracle: reproj_err {o_err:.5f} px  cost {o_cost:.4f}{excl}")
    if args.v:
        np.set_printoptions(precision=5, suppress=True)
        print("cam means:\n", cam_mu)
    if args.save_traj:
        evaluation.export_tum(args.save_traj, cam_mu)
        note(f"trajectory written to {args.save_traj}")
    if args.checkpoint:
        checkpoint.save_checkpoint(args.checkpoint, state, graph,
                                   step=args.n_iters, cfg=cfg)
        note(f"checkpoint written to {args.checkpoint}")

    if args.gn_check:
        res = gn.solve_problem(problem, cfg, dev, n_lm_iters=30)
        ate = evaluation.ate_rmse(cam_mu, res.cam.cpu().numpy())
        note(f"GN baseline: reproj_err {float(res.reproj_err[-1]):.5f} px, "
             f"ATE(GBP vs GN) {ate:.6f} m")
    return 0


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
