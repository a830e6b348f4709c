"""Incremental SLAM driver: the PyTorch counterpart of
``gbp_poplar_tpu/drivers/slam.py``, with the same flags, defaults and
lines.

    python -m gbp_poplar_tpu_torch.drivers.slam --bal_file fr1desk \
        --iters_between_kfs 700
    GBP_PLATFORM=cpu python -m gbp_poplar_tpu_torch.drivers.slam --bal_file f.txt

Keyframes activate one at a time (core/slam.py), every
``--iters_between_kfs`` sweeps. The defaults are the JAX driver's: the
damped Gauss-Newton schedule (``--schedule gn``), the one-sided depth
guard with the settled-edge rescue after 300 sweeps (``--rescue_iters``),
drift relinearisation 0.05 and Lambda damping, no coarse groups. Each
segment's per-sweep lines are printed after the segment. Checkpoints are
written after a keyframe's insertion, with the keyframe (``kf``) and
``devices`` in their metadata, so ``--resume`` continues with the next
segment bit-exactly.

``--devices N`` runs N ranks (parallel/launch.py), each owning a block of
the landmark map and its edges (parallel/map_sharding.py): the JAX
driver's map-partitioned mode, with its one difference from a single
device, the new landmarks' depth as a mean over the ranks instead of a
median. Its checkpoints hold the partitioned layout whole, with
``devices`` in their metadata, and resume at the same ``--devices`` (a
JAX driver's too); another count exits with 2.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import parallel
from ..core import build_graph, gauss_newton as gn, init_state, slam
from ..utils import analysis, balio, checkpoint, evaluation
from ..utils import flags as flags_lib, priors
from . import common
from .ba import _polish_problem


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Incremental GBP SLAM on CUDA devices")
    common.add_common_args(p)
    p.add_argument("--iters_between_kfs", type=int, default=700)
    p.add_argument("--polish", action="store_true",
                   help="final global-BA refinement: a warm-started "
                        "Levenberg-Marquardt/Schur pass on the batch MAP "
                        "objective (annealed priors; the incremental "
                        "handoff priors are replaced); the exported "
                        "trajectory uses the polished means")
    # the damped Gauss-Newton schedule is the incremental default, as in
    # the JAX driver; --schedule reference restores the lazy one
    p.set_defaults(schedule="gn")
    return p


def config_from_args(args):
    """(GBPConfig, InitConfig) of the parsed flags with the slam driver's
    defaults. Drift relinearisation and Lambda damping keep late keyframes
    from oscillating; the one-sided depth guard keeps insertion's
    behind-camera transients from being adopted, and the rescue lets edges
    settled for 300 sweeps recapture a landmark deadlocked behind a camera
    (the JAX driver's reasons and defaults)."""
    return common.config_from_args(
        args, default_relin_drift=0.05, default_lambda_damping=True,
        relin_behind_camera=False, default_rescue_iters=300)


def save_segment(path: str, state, graph, cfg, k: int, ibk: int,
                 devices: int = 1) -> None:
    """Checkpoint the state after segment ``k`` and keyframe k+1's
    insertion: step ``k * ibk``, and ``kf`` (where a resume starts) and
    ``devices`` in the metadata."""
    checkpoint.save_checkpoint(path, state, graph, step=k * ibk, cfg=cfg)
    _amend_meta(path, kf=k + 1, devices=devices)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = common.select_device()
    if args.devices > 1:
        common.check_devices(args.devices, dev)
        return parallel.run(_rank_main, args.devices, (args,), dev.type)[0]
    return _solve(args, dev)


def _rank_main(rank: parallel.Rank, args) -> int:
    """One rank of ``--devices N``: the landmark map split over the ranks
    (parallel/map_sharding.py)."""
    return _solve(args, rank.device, rank.group)


def _solve(args, dev: torch.device, group=None) -> int:
    """The driver on ``dev``; with ``group``, as one rank of the
    map-partitioned solve, whose checkpoints hold the partitioned layout
    whole (the JAX driver's). Rank 0 alone prints, polishes, exports and
    writes checkpoints, on the state gathered from the ranks."""
    lead = group is None or dist.get_rank(group) == 0

    def note(msg):
        if lead:
            print(msg, file=sys.stderr)

    cfg, init_cfg = config_from_args(args)

    problem = balio.load_bal(args.bal_file)
    # refused before any init helper (av_depth_init is pinhole-only)
    if problem.intrinsics is not None:
        note("error: incremental SLAM needs a temporally ordered TUM-"
             "variant sequence; BAL-dataset (Snavely-model) problems have "
             "no keyframe order — use the batch `ba` driver")
        return 2
    problem = priors.apply_init_noise(problem, init_cfg,
                                      k_anchor=cfg.num_anchor_cams)
    ibk = args.iters_between_kfs
    note(f"{args.bal_file}: {problem.n_keyframes} keyframes, "
         f"{problem.n_points} landmarks, {problem.n_edges} edges "
         f"({ibk} iters/keyframe)")

    graph = build_graph(problem, cfg, dev)
    start_kf = 1
    partitioned = False
    if args.resume:
        state, g2, meta = checkpoint.load_checkpoint(args.resume, dev)
        ck_devices = meta.get("devices", 1)
        if ck_devices != args.devices:
            note(f"error: checkpoint was written with --devices "
                 f"{ck_devices}, run has --devices {args.devices}")
            return 2
        # a map-sharded checkpoint holds the partitioned layout, whose
        # graph is the checkpoint's own
        partitioned = ck_devices > 1
        graph = g2 if partitioned else common.resume_graph(graph, g2)
        start_kf = meta.get("kf", meta.get("step", 0) // ibk + 1)
        note(f"resumed from {args.resume} at keyframe {start_kf}")
    else:
        flags = flags_lib.create_flags(problem, cfg.steps)
        state = init_state(problem, cfg, dev, flags=flags)

    run_graph, steps = graph, {}
    if group is not None:
        # the rank's block; checkpoints keep the partitioned layout whole
        solver = parallel.make_map_sharded_solver(group, cfg)
        if not partitioned:
            graph, state = parallel.partition_by_landmark(graph, state,
                                                          args.devices)
        run_graph, state = solver.prepare(graph, state, partitioned=True)
        # the JAX driver's explicit warm-up is run_gbp's own at offset 0
        steps = dict(
            runner=lambda s: solver.run(s, run_graph, ibk),
            inserter=lambda s, k: solver.insert_keyframe(s, run_graph, k,
                                                         args.avdepth),
            initialiser=lambda s: solver.initialise(s, run_graph))

    def whole(st):
        return st if group is None else solver.gather(st)

    step = {"i": (start_kf - 1) * ibk, "since_save": 0, "t_first": None}

    def progress(k, diag):
        errs = diag.reproj_err.cpu().numpy()
        costs = diag.cost.cpu().numpy()
        relins = diag.n_relins.cpu().numpy()
        robusts = diag.n_robust.cpu().numpy()
        if step["t_first"] is None:
            step["t_first"] = time.perf_counter()   # kernel build happened
        stride = max(1, args.print_every)
        for j in range(0, errs.shape[0] if lead else 0, stride):
            common.print_iteration(step["i"] + j, errs[j], costs[j],
                                   int(relins[j]), int(robusts[j]))
        step["i"] += errs.shape[0]
        if k + 1 < problem.n_keyframes:
            note(f"-- keyframe {k + 1} inserted --")

    def segment_callback(k, st):
        if args.v and lead:
            # the belief stream at segment cadence (every rank holds the
            # keyframes whole)
            v_cam, _ = analysis.belief_means(st)
            np.set_printoptions(precision=5, suppress=True)
            print(f"beliefs (cam means) after keyframe {k}:\n{v_cam}",
                  flush=True)
        if not (args.checkpoint and args.checkpoint_every):
            return
        step["since_save"] += ibk
        if step["since_save"] >= args.checkpoint_every:
            step["since_save"] = 0
            full = whole(st)
            if lead:
                save_segment(args.checkpoint, full, graph, cfg, k, ibk,
                             args.devices)

    prof = common.start_profile(args, dev, lead)
    t0 = time.perf_counter()
    result = slam.solve_slam(
        state, run_graph, cfg,
        n_keyframes=problem.n_keyframes, iters_between_kfs=ibk,
        av_depth=args.avdepth, progress=progress, start_kf=start_kf,
        segment_callback=segment_callback, **steps)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_end = time.perf_counter()
    dt = t_end - t0
    total_iters = (problem.n_keyframes - start_kf) * ibk
    msg = f"total {dt:.3f}s, {total_iters / dt:.1f} sweeps/s"
    if total_iters > ibk and t_end > step["t_first"]:
        msg += (f" (incl. kernel build; steady-state "
                f"{(total_iters - ibk) / (t_end - step['t_first']):.1f} "
                "sweeps/s)")
    note(msg)

    final = whole(result.state)
    if not lead:
        return 0
    cam_mu, lmk_mu = analysis.belief_means(final)
    # a partitioned landmark axis is the global order and then the dummy
    # landmarks: the problem's landmarks are its first n_points
    lmk_mu = lmk_mu[:problem.n_points]
    if args.polish:
        # warm-started LM/Schur against the batch annealed-prior objective:
        # a standard post-SLAM global bundle adjustment
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
    # the independent host oracle (--bad_assoc: the reference's skip list)
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
        save_segment(args.checkpoint, final, graph, cfg,
                     problem.n_keyframes - 1, ibk, args.devices)
        note(f"checkpoint written to {args.checkpoint}")
    if result.reproj_err.shape[0]:
        final_err = result.reproj_err[-1, -10:].mean()
        note(f"final reprojection error: {final_err:.5f} px")
    return 0


def _amend_meta(path: str, **extra) -> None:
    """Add driver-level keys to a checkpoint's metadata (atomically)."""
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    meta = json.loads(bytes(data[checkpoint._META_KEY]).decode())
    meta.update(extra)
    data[checkpoint._META_KEY] = np.frombuffer(json.dumps(meta).encode(),
                                               dtype=np.uint8)
    tmp = path + ".tmp"
    np.savez(tmp, **data)
    os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)


if __name__ == "__main__":
    sys.exit(main())
