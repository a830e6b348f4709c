#!/usr/bin/env python3
"""Drive the PyTorch port (gbp_poplar_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
the final ``ok`` line:
  1. environment: torch/CUDA versions, the card's name and power limit;
     a CUDA device is required;
  2. build the hand-written kernels (csrc/*.cu) with nvcc, one process per
     source, and print each kernel's registers and spills and the launch
     shapes of H1 and H4;
  3. the fused path's kernels against their plain PyTorch versions on the
     card: the table build (H2: each kind alone and both in one launch)
     and the segmented sum (H3) on random inputs and at the Ladybug shape;
     one fused sweep (H1) on the small pinhole problem, the Snavely problem
     and the Ladybug-shape state after initialise + 20 sweeps; the
     telemetry sums (H6) on that state, without and with 1,000 edges
     marked bad, and on a copy with singular beliefs; then each kernel's
     time beside its plain version's, its bound (the larger of its bytes
     over 3.35 TB/s and its operations, tallied by tools/count_edge_ops,
     over the card's float32 and special-function rates) and, for H3, the
     one library call that computes the same function
     (``torch.index_add``), per variable kind; H2 per kind and both kinds,
     and H6 (one launch a call), by the profiler's device time beside the
     events' time per host call, H6's time against its grid (one block,
     one and two waves of the blocks the card holds at once) and its host
     time a call, set up once as run_gbp sets it up and set up per call;
  4. the fused main path at the Ladybug shape (synthetic_problem_large(
     1723, 156000, 7): 1,092,000 edges, 1,092,608 padded), reference
     schedule (accel_every=0): build_graph / init_state on the card,
     initialise, run_gbp(200) with diagnostics, the launch counts of every
     kernel (exact: a sweep's post-sweep tables serve H6 and the next
     sweep), the same 200 sweeps with kernels="reference", ms/sweep of
     both, with and without diagnostics, one diagnostics call's aten
     operations and device launches by the profiler (plain version and
     H2 + H6) and a run_gbp sweep's with and without diagnostics (per
     sweep, and per solve), and peak device memory; then ``solve_ba`` on
     the small pinhole problem with the library defaults (``GBPConfig()``);
  5. the Venice shape (synthetic_problem_large(1778, 994000, 5): 4,970,000
     edges, the shape of BAL Venice-1778) with its cameras relabelled by a
     random permutation, as in an unordered photo collection, and its
     landmarks perturbed by N(0, 5 cm): the gather (H5) against
     index_select on its camera and landmark indices (bit-identical); one
     unfused sweep (H4) against its plain version on the pinhole and
     Snavely problems and on the Venice state after initialise + 20
     sweeps, and against the fused sweep (H1) on that state; H6 on that
     state, without and with 1,000 edges marked bad;
  6. the unfused main path at the Venice shape: GBPConfig(fused=False),
     every other default (accelerator every 50 sweeps from sweep 150),
     300 sweeps with diagnostics: the error at marks, the accelerator's
     steps, the launch counts, peak device memory;
  7. the same solve with kernels="reference" and with fused=True: the
     final errors must agree;
  8. times at the Venice shape: H4 and H5 beside their plain versions
     and bounds (H5's plain version, ``index_select``, is its library
     call), H1, H2 (per kind, and H2 against its plain version on the
     Venice state) and H3 per variable kind with their bounds and H3's
     ``index_add``, ms/sweep of both pipelines with and without the
     accelerator, the accelerator's cost per chunk and one step's time
     with its device busy time, and the cost sums (H8) of two mean sets
     against their plain version there;
  9. the coarse corrector at the Ladybug shape (cameras in their generated
     order): GBPConfig(coarse_groups=16), 400 sweeps, each boundary's
     accelerator and coarse decisions, equal to kernels="reference"'s up
     to the first tie, the final error against it; on the solved state the
     coarse step's per-edge terms (H7) per plane against their plain
     version, their group sums (H3) against the plain sums, the cost sums
     (H8) at 2 and 3 mean sets with and without 1,000 bad edges, each
     again to the bit, both kernels' times beside their plain versions'
     and bounds, the landmark prior terms' time; one coarse step's and its
     increment's time, kernels and plain, with the device's busy time and
     the increment's launches; and the group sums of random terms (H3 over
     group-keyed segments) against their plain version;
  10. the ba driver in process (``drivers.ba.main``) at the Ladybug shape
     written as a BAL file, with its defaults (coarse corrector over 16
     groups, LM polish): 600 sweeps with checkpoints, trajectory and the
     GN check; a resume to 1,000; the same 1,000 sweeps uninterrupted,
     whose lines the resumed ones must equal; launch counts per run;
  11. the driver's polish (15 warm-started LM/Schur iterations) at the
     Venice shape from the means phase 6 left: per-iteration cost and
     decision, ms per LM iteration, peak device memory; then the
     preconditioner's census along it (ROADMAP C3: the non-finite inverses
     of S's diagonal blocks per iteration, by cholesky_ex and by the
     unrolled inv6x6, on the card and on a CPU copy);
  12. incremental SLAM at the TUM fr1desk shape (synthetic_problem_large(
     62, 1900, 7): 13,300 edges, 13,312 padded) with the slam driver's
     config (relinearise every sweep, the one-sided depth guard, the
     rescue after 300 sweeps), 700 sweeps per keyframe: (a) 7 segments
     with diagnostics, the error at each insertion, the first 3 against
     kernels="reference", run twice to the same bits; (b) one sweep right
     after an insertion, H1 and H4 bit-identical to their plain versions
     and to each other under the gn flags, and H6 on that state; (c) the
     driver's checkpoint at keyframe 6 resumed with start_kf, its
     diagnostics equal to (a)'s to the bit; (d) all 62
     keyframes without diagnostics by the benchmark's SLAM row
     (tools/bench.bench_slam, the slam driver's config, after one warm-up
     segment): sweeps/s including insertion, the
     final error (< 3.0 px) beside the JAX package's, ms/sweep with and
     without diagnostics and H6's host time a call (``[diag]`` line); (e)
     the slam driver in process at 150 sweeps per
     keyframe with --polish, --save_traj and --checkpoint, its resume from
     the final checkpoint to the same trajectory, steady-state sweeps/s
     with diagnostics and the same solve's without;
  13. the library around the solver, on the states and the file earlier
     phases left (``[utils]`` lines): (a) ``weaken_priors`` through H3 on
     the Ladybug state after initialise (phase 4) and the Venice state
     after initialise + 20 sweeps (phase 5, cameras shuffled), against
     kernels="reference"; (b) ``recenter_priors`` on the card against a
     CPU copy, to the bit; (c) a bad-association mask of 1,000 random
     edges at the Ladybug shape against the host oracle; (d)
     ``dump_edge`` on the card against a CPU copy, and ``print_edge``;
     (e) the KL helpers between two consecutive sweeps' states on the card
     against a CPU copy; (f) the native BAL parser against the NumPy one
     on phase 10's file, both load times;
  14. the sharded solvers (``[shard]`` lines; parallel/): (a) the
     edge-sharded solver over NCCL at world size 1 at the Ladybug shape,
     initialise + 20 sweeps, against the single-device run to the bit;
     ms/sweep without diagnostics of one device, the edge-sharded and the
     map-sharded solver at world size 1, in turns, and each mode's
     all-reduce alone; (b) two gloo ranks sharing the card, edge-sharded at
     the Ladybug shape (546,304 edges a rank) and map-sharded at the
     fr1desk shape: initialise + one sweep of each pipeline in each, the
     edge fields bit-identical to the single-device sweep, the beliefs
     within 1e-5 of sum |terms| and the five telemetry sums over both ranks
     (H6 and plain) against one device's, then the ba driver's config for
     400 sweeps edge-sharded, its final error within 0.005 px of phase 9's,
     and the time of the per-sweep all-reduce (5.80 MB at this shape, 6.7
     KB for the fr1desk shape's camera sums); (c) the slam driver's ranks
     at --devices 2 (map-sharded, two gloo ranks on the card) at the
     fr1desk shape, 50 sweeps a keyframe (phase 12 (e) runs 150), --polish
     and --checkpoint, the final error below 3.0 px beside phase 12 (e)'s,
     and ``drivers.slam.main``'s resume from the final checkpoint to the
     same trajectory. Every rank reports its launch counts, and every rank
     must have launched H1-H3 and H6 on the card (H4 and H5 too in (b)).
     The times of (b) and (c) come from two ranks contending for one card:
     they are not scaling numbers;
  15. the tools around the solver (``[tools]`` lines; entry.py, tools/):
     (a) ``entry()`` on the card, its sweep against kernels="reference"
     (edge fields to the bit, beliefs within H3's bound), and
     ``dryrun_multichip(2)`` (two gloo ranks on the card); (b)
     ``validate_scale``'s protocol at the Ladybug shape (500 sweeps of
     GBPConfig(), the 15-iteration polish and the cold LM: polished/GN
     cost within 1e-4 of 1, ATE(polished, GN) below 1 mm; the polish's
     C3 census), then at the Venice shape, or, past 600 s into the
     script, its polish-vs-GN half on phase 6's means; (c)
     ``memory_ledger`` (per field tallies, peak device memory per stage)
     at the Venice shape with the ba driver's config, then at BAL
     Final-13682's 28,987,644 observations (pk past 2^31 elements): 50
     sweeps with diagnostics, a coarse step and 3 polish iterations, the
     first sweep's last 1M edges against the plain sweep, the error
     falling, beside the host oracle at the generated means (halved
     until a point runs; at least one point past 2^31 elements must);
     (d) ``profile_sweep`` at the Ladybug shape, fused with and without
     diagnostics and unfused: each kernel's device time inside
     ``run_gbp`` beside its events' time alone (ROADMAP B5, B6);
  16. the measurement tools (``[bench]`` lines; tools/bench.py and the
     scripts' counterparts): (a) ``tools/bench.main()`` at its full
     workload on a synthetic BAL file of TUM fr1xyz's size, with the
     Ladybug and Venice rows and every guard, its JSON line printed under
     ``[bench]``; (b) the SLAM row, phase 12 (d)'s ``bench_slam``; (c)
     ``bench_sweep scale`` (the absent sequences skipped by name, the
     synthetic ladder with its sanity solves) and ``venice
     --production``; (d) ``bench_ablate`` at the Ladybug shape, ``full``
     beside (a)'s raw chain; (e) ``count_edge_ops`` on the card, with H1's
     operations bound at the Ladybug shape below its bytes bound; (f)
     ``bench_scaling`` in both modes at the cards present (N = 1 on one
     card) and ``scaling_model`` from (a)'s T1, the payload of one sweep
     on two gloo CPU ranks and an NCCL all-reduce's cost a call at world
     size 1 on the card (phase 14 (a)'s timer, ``bench_scaling.
     all_reduce_ms``). H1-H5
     must each launch on the card in the phase;
  17. the sequence-level tools (``[seq]`` lines; the JAX package's TUM
     scripts' counterparts), each at its script's budget on perturbed
     synthetic BAL files of the three TUM sequences' shapes (fr2robot2's
     (20, 862, 4), fr1xyz's (42, 2194, 6), fr1desk's (62, 1900, 7)), named
     by the shape: (a) ``validate_sequences`` on all three (1,000 sweeps,
     the GN oracle's 40 LM iterations, SLAM at 300 sweeps a keyframe);
     (b) ``diagnose_accuracy`` at the fr1desk shape (1,500 sweeps), whose
     LM polish of the GBP point must reach the cold GN's MAP cost within
     1e-4 and its trajectory within 1 mm (ATE); (c) ``exp_ate_grid`` at
     the fr1xyz shape (1,500 sweeps; ``base``, ``fused=0``,
     ``relin_drift_threshold=0``, ``accel_every=0``), ``base`` and
     ``fused=0`` within 1e-3 px; (d) ``exp_drift_phase`` at the fr1desk
     shape (1,500 sweeps, 300 in phase 1); (e) ``tune_schedule`` on all
     three (1,000 sweeps; ``reference``, ``gn``, ``drift``). Every error,
     cost and ATE must be finite, and H1-H6 must each launch on the card
     in the phase. The TUM guards (< 1.0 px, ATE < 0.01 m) are the real
     sequences' and do not apply to synthetic files.

The last lines are one JSON object of per-kernel results (launches on
the main paths, largest difference from the plain version, kernel, plain
and library ms, the bound and what bounds it), the card's
``name, power.limit`` as nvidia-smi prints it, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time

LADYBUG_SHAPE = (1723, 156000, 7)      # keyframes, landmarks, obs/landmark
# BAL Venice-1778 (1,778 cameras, 993,923 points, 5,001,946 observations)
# as the JAX package's bench.py sizes it
VENICE_SHAPE = (1778, 994000, 5)
# Initial landmark perturbation (the ba driver's --ltn, metres): the
# generator's means are the ground truth, and a solve from the truth has
# nothing to fall from; 5 cm at 4-8 m depth starts at about 5.6 px.
LMK_NOISE = 0.05
LADYBUG_SWEEPS = 200
VENICE_SWEEPS = 300
TIMED_SWEEPS = 20

# Tolerances, kernel against plain version on the same card. The library
# is built with -fmad=false and IEEE divide/sqrt, the same rounding as
# PyTorch's separate elementwise kernels, so the outputs are expected to
# agree to the last bit except where the two take a borderline decision
# differently; the bounds leave room for that and nothing else.
TABLE_RTOL = 1e-5          # table means, relative to 1 + |mean|
REDUCE_RTOL = 1e-5         # sums, relative to the sum of |terms| (kernel and
                           # plain version each add in their own fixed order)
SWEEP_RTOL = 1e-4          # edge fields, relative to 1 + max |field|
SWEEP_FLIP_FRAC = 1e-3     # lanes whose discrete outputs may differ
MAIN_AGREE_PX = 0.05       # final error: kernels vs reference, px ...
MAIN_AGREE_REL = 0.02      # ... or this fraction, whichever is larger
# the coarse step's per-edge terms (H7), per plane, relative to the plane's
# largest magnitude: the plain version's rotation matrix (ops/lie's matrix
# form) and the kernel's (planes.cuh's unrolled form) round apart, and the
# Jacobian's rotation block carries about an ulp of R over |w| (|w| down
# to 1.3e-3 at the Ladybug shape), which b_c^T b_l can cancel
COARSE_RTOL = 1e-3
# the cost sums (H8), relative to the sum of |loss| (float64 against the
# plain version's float32 sum)
COST_RTOL = 1e-6
# a chunk-boundary decision whose two best MAP costs lie within this
# fraction of each other is a tie that two runs may break apart
DECISION_TIE_RTOL = 1e-6

# the coarse corrector and the ba driver (phases 9-11), at the ba driver's
# defaults: 16 keyframe groups, an accelerator step every 50 sweeps from
# sweep 150, spans of 200 sweeps, 15 polish iterations
COARSE_GROUPS = 16
COARSE_SWEEPS = 400
DRIVER_SWEEPS = (600, 1000)      # run 1, then resumed / uninterrupted
CHECKPOINT_EVERY = 200
POLISH_ITERS = 15

# incremental SLAM (phase 12) at the TUM fr1desk shape: 62 keyframes and
# about 13.3k edges, keyframe-local visibility; the slam driver's config
# and its cadence of 700 sweeps per keyframe
SLAM_SHAPE = (62, 1900, 7)
SLAM_IBK = 700
SLAM_SEGMENTS = 7          # (a): keyframes 0..7; the checkpoint at kf 6
SLAM_REF_SEGMENTS = 3      # (a): the plain versions, about 12 ms a sweep
SLAM_CKPT_KF = 6
SLAM_DRIVER_IBK = 150      # (e): the driver, 150 sweeps per keyframe
SLAM_TIMED = 200
# the JAX package's final error at SLAM_SHAPE, 700 sweeps per keyframe,
# landmarks perturbed by LMK_NOISE, on a CPU (scripts/
# slam_reference_error.py): for information, not a bound
JAX_SLAM_FINAL_ERR = 0.813590

# the library utilities (phase 13)
UTILS_BAD_IDS = 1000       # (c): random original edge ids marked bad
                           # (also H6's masked cases, phases 3, 5, 12)
BAD_ORACLE_PX = 1e-3       # (c): masked error against the host oracle
KL_GAP_FACTOR = 4.0        # (e): card vs CPU, against float32's own gap


# the sharded solvers (phase 14)
SHARD_NCCL_SWEEPS = 20     # (a): NCCL at world size 1 against one device
SHARD_SWEEPS = COARSE_SWEEPS   # (b): the ba driver's config, as phase 9
SHARD_AGREE_PX = 0.005     # (b): its final error against phase 9's
# (c): the slam driver's two ranks. Cut from phase 12 (e)'s 150 sweeps a
# keyframe to 50: two ranks sharing an H100 ran 61.0 sweeps/s, so (c)
# took 164 s at 150 (PERF.md)
SHARD_SLAM_IBK = 50
SHARD_TIMED = 20           # (b): all-reduces timed
SHARD_TIMED_SWEEPS = 50    # (a): sweeps timed per reading

# the tools (phase 15; gbp_poplar_tpu_torch/tools)
TOOLS_SWEEPS = 500         # (b): validate_scale's GBP solve (the JAX script's)
POLISH_RATIO_TOL = 1e-4    # (b): polished/GN MAP cost ratio within this of 1
POLISH_ATE_M = 1e-3        # (b): ATE(polished, GN) below this (m)
TOOLS_VENICE_BY_S = 600    # (b): the whole protocol at Venice only if the
                           # script reaches it within this many seconds
# (c): BAL Final-13682's 28,987,644 observations at Ladybug's 7 a landmark
# (so 4,141,092 landmarks, fewer than the file's 4,456,117 points): pk
# [109, E] passes 2^31 elements from about 19.7M edges
CAPACITY_SHAPE = (13682, 4141092, 7)
CAPACITY_SWEEPS = 50
CAPACITY_POLISH = 3
CAPACITY_SLICE = 1 << 20   # the first sweep's last edges held against plain
ORACLE_RTOL = 1e-3         # the error after initialise, card vs float64 host
PROFILE_SWEEPS = 50        # (d): sweeps traced per profile

# the measurement tools (phase 16; tools/bench.py and the scripts): the
# headline on a synthetic BAL file of TUM fr1xyz's size (42 keyframes,
# 2,194 landmarks, 12,908 observations; here 13,164)
BENCH_TUM_SHAPE = (42, 2194, 6)

# the sequence-level tools (phase 17; tools/validate_sequences,
# diagnose_accuracy, exp_ate_grid, exp_drift_phase, tune_schedule), each at
# its JAX script's budget, on perturbed synthetic BAL files of the three
# TUM sequences' shapes (named by the shape, never by the sequence):
# fr2robot2's 20 keyframes and 862 landmarks at 4 observations (3,448
# edges against the sequence's 3,551), fr1xyz's (BENCH_TUM_SHAPE) and
# fr1desk's (SLAM_SHAPE)
FR2ROBOT2_SHAPE = (20, 862, 4)
SEQ_SHAPES = (FR2ROBOT2_SHAPE, BENCH_TUM_SHAPE, SLAM_SHAPE)
SEQ_DIAGNOSE_SWEEPS = 1500
SEQ_GRID_SWEEPS = 1500
SEQ_GRID_SPECS = ("base", "fused=0", "relin_drift_threshold=0",
                  "accel_every=0")
SEQ_GRID_AGREE_PX = 1e-3   # base against fused=0
SEQ_DRIFT = (1500, 300)    # sweeps in all, in phase 1
SEQ_TUNE_SWEEPS = 1000
SEQ_TUNE_SETS = ("reference",
                 "gn:relin_every_iter=1,lambda_damping=1,eta_damping=0.7",
                 "drift:relin_drift_threshold=0.05")

# The card's peak HBM3 bytes/s (H100 SXM, NVIDIA's data sheet). A
# kernel's bound is the larger of its bytes over this and its operations
# over the card's rates (tools/count_edge_ops.card_rates: float32 lanes and
# special-function results per SM per clock, times the card's SMs and
# maximum clock).
HBM_BYTES_PER_S = 3.35e12


def count_ops(fn) -> tuple[float, float]:
    """(one-class, transcendental) float operations of ``fn()`` (a plain
    version on its real inputs): tools/count_edge_ops.tally, the elements
    each aten operation writes, by class (views, packing and data movement
    count none)."""
    from gbp_poplar_tpu_torch.tools import count_edge_ops

    ones, trans = count_edge_ops.tally(fn)
    return sum(ones.values()), sum(trans.values())


def least_ms(n_bytes: float, n_ops: tuple) -> tuple[float, str]:
    """The least time (ms) the card could take for work that moves
    ``n_bytes`` (each input read once, each output written once) and does
    ``n_ops`` = (one-class, transcendental) operations (``count_ops``'s
    pair), and which of the two bounds it."""
    from gbp_poplar_tpu_torch.tools import count_edge_ops

    one, trans = n_ops
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = count_edge_ops.ops_ms(one, trans, count_edge_ops.card_rates())
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def sweep_bytes(graph, gathered: bool) -> int:
    """Bytes one sweep must move: the packed state, counter and flag read
    and written, the per-edge constants read, and the belief tables (H1)
    or the gathered belief planes (H4) read once."""
    from gbp_poplar_tpu_torch.core import factor_graph as fg
    from gbp_poplar_tpu_torch.ops.table_kernel import CAM_WIDTH, LMK_WIDTH

    per_edge = (2 * 4 * fg.EDGE_PACK_ROWS + 2 * 4 + 2 * 1   # pk, dc, rb
                + 4 + 2 * 4 + 4                             # active, meas
                + (12 if graph.intr is not None else 0))
    if gathered:
        return graph.n_edges * (per_edge + 4 * (fg.CAM_COMP + fg.LMK_COMP))
    return (graph.n_edges * (per_edge + 8)                  # cam/lmk ids
            + 4 * (graph.n_keyframes * CAM_WIDTH
                   + graph.n_points * LMK_WIDTH))


def reduce_work(seg, comp: int) -> tuple[int, tuple[int, int]]:
    """(bytes, (one-class, transcendental) operations) of one segmented
    sum with a prior: the listed edges' rows and their index (the
    permutation, or the CSR offsets of a contiguous kind) read once, the
    prior read and the sums written; one add an element."""
    n, v = seg.var.shape[0], seg.n_var
    index = 4 * n if seg.perm is not None else 4 * (v + 1)
    return 4 * comp * n + index + 2 * 4 * comp * v, (comp * (n + v), 0)


def time_reduce_sides(state, graph, n_real: int, card: str) -> float:
    """H3 per variable kind on the state's message rows: the kernel, its
    bound, and the one library call that computes the same function
    (``torch.index_add`` of the rows into the prior by the edges' variable
    ids); prints a line per side and returns the library's time for both
    sides (ms)."""
    import torch

    from gbp_poplar_tpu_torch.ops import _cuda, reduce_kernel

    lib_total = 0.0
    for label, rows, seg, prior, ids in (
            ("cameras", state.pk[54:81], graph.cam_seg, state.cam_prior,
             graph.cam_idx[:n_real]),
            ("landmarks", state.pk[81:90], graph.lmk_seg, state.lmk_prior,
             graph.lmk_idx[:n_real])):
        ms = cuda_ms(lambda: reduce_kernel.segment_sum(rows, seg, prior),
                     TIMED_SWEEPS)
        lib = cuda_ms(lambda: torch.index_add(prior, 1, ids, rows[:, :n_real]),
                      TIMED_SWEEPS)
        lib_total += lib
        b, by = least_ms(*reduce_work(seg, rows.shape[0]))
        if seg.plan is not None:
            smem = _cuda.library().gbp_reduce_chunks_smem(seg.plan.chunk)
            how = (f"permuted segments, two passes over {seg.plan.n_chunks}"
                   f" chunks of {seg.plan.chunk} edges, {seg.plan.n_runs} "
                   f"runs ({smem} B of shared memory per pass-1 block)")
        else:
            how = "contiguous segments, one pass"
        print(f"[time] reduce {label}: kernel {ms:.4f} ms, library "
              f"index_add {lib:.4f} ms; bound {b:.4f} ms by {by} "
              f"({b / ms:.0%} of it reached) at {n_real} edges, "
              f"{seg.n_var} variables, {how} ({card})")
    return lib_total


def device_ms(fn, reps: int, kernel: str, per_call: bool = False) -> float:
    """Mean device time (ms) per launch of the kernels whose names contain
    ``kernel`` (``per_call``: per call of ``fn``, all its launches), over
    ``reps`` calls of ``fn()``, by torch.profiler, after one warm-up call:
    the kernel's own time, whatever the host's pace. A window whose kernel
    records the profiler lost (seen once on an H100, PERF.md) is profiled
    again, up to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages()
               if kernel in ev.key and ev.device_time_total > 0]
        if evs:
            break
    check(bool(evs), f"the profiler saw no {kernel} launch")
    return (sum(ev.device_time_total for ev in evs)
            / (reps if per_call else sum(ev.count for ev in evs)) / 1e3)


def time_tables(cam_bel, lmk_bel, where: str, card: str):
    """H2 at one shape: the cameras alone, the landmarks alone and both in
    one launch, each by the profiler's device time per launch and by CUDA
    events per host call (back to back, so at these sizes the events may
    time the host's launches), beside its bound; prints a line each.
    Returns the device time, the plain version's time (events), the bound
    and what bounds it, all for both kinds in one launch."""
    from gbp_poplar_tpu_torch.ops import table_kernel as tk

    n_c, n_l = cam_bel.shape[1], lmk_bel.shape[1]
    no_c, no_l = cam_bel[:, :0], lmk_bel[:, :0]      # a kind with no blocks
    cases = (
        ("cameras",
         lambda r=False: tk.build_tables(cam_bel, no_l, reference=r),
         4 * 63 * n_c),
        ("landmarks",
         lambda r=False: tk.build_tables(no_c, lmk_bel, reference=r),
         4 * 25 * n_l),
        ("both kinds, one launch",
         lambda r=False: tk.build_tables(cam_bel, lmk_bel, reference=r),
         4 * 63 * n_c + 4 * 25 * n_l))
    for label, fn, n_bytes in cases:
        dev = device_ms(fn, TIMED_SWEEPS, "table_kernel")
        ev = cuda_ms(fn, TIMED_SWEEPS)
        b, by = least_ms(n_bytes, count_ops(lambda: fn(True)))
        print(f"[time] table {label} at {where} ({n_c} cameras, {n_l} "
              f"landmarks): device {dev:.4f} ms per launch (profiler), "
              f"events {ev:.4f} ms per host call; bound {b:.4f} ms by {by} "
              f"({b / dev:.0%} of it reached) ({card})")
    return dev, cuda_ms(lambda: fn(True), 5), b, by


def sweep_runs(cfg, n_iters: int, iter_offset: int = 0) -> int:
    """How many runs of sweeps ``run_gbp(..., n_iters, iter_offset=...)``
    makes (the annealed sweeps, the dead accelerator chunks, each live
    chunk, the leftover sweeps; each with at least one sweep): the first
    sweep of a run builds its own tables, every later one reads the tables
    built after the sweep before it. Mirrors run_gbp's schedule."""
    warm = min(n_iters, max(0, 2 * cfg.steps - iter_offset))
    runs = [warm]
    left, off2, ce = n_iters - warm, iter_offset + warm, cfg.accel_every
    if ce > 0 and left >= 2 * ce:
        n_chunks = left // ce
        n_dead = min(n_chunks,
                     max(0, -(-(cfg.accel_start - ce - off2) // ce)))
        if n_dead:
            runs += [(n_dead - 1) * ce, ce]
        runs += [ce] * (n_chunks - n_dead)
        left -= n_chunks * ce
    runs.append(left)
    return sum(1 for r in runs if r > 0)


def telemetry_host_us(state, graph, cfg) -> tuple[float, float, float]:
    """H6's cost a call at this state's shape, on tables built here, in
    microseconds: the launch as run_gbp makes it after each sweep (set up
    once, ops/diag_kernel.DiagLaunch) by the host clock (the host's own
    work alone) and by CUDA events back to back (the host's pace or the
    device's, whichever is slower), and one ``edge_sums`` call (set up per
    call) by events back to back."""
    import torch

    from gbp_poplar_tpu_torch.ops import diag_kernel, table_kernel

    reps = 200
    n = cfg.num_undamped_iters
    tables = table_kernel.build_tables(state.cam_bel, state.lmk_bel)
    rows = torch.empty((reps, 5), dtype=torch.float64, device=state.pk.device)
    launch = diag_kernel.DiagLaunch(state, graph, n, rows)
    launch(state, tables, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for j in range(reps):
        launch(state, tables, j)
    host = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()

    def all_rows():
        for j in range(reps):
            launch(state, tables, j)

    events = cuda_ms(all_rows, 1) / reps * 1e3
    one = cuda_ms(lambda: diag_kernel.edge_sums(state, graph, n,
                                                tables=tables), reps) * 1e3
    return host, events, one


def h6_by_edges(state, graph, cfg, tables, counts) -> list[float]:
    """H6's device time a call (profiler) on the first n edges of
    ``graph`` for each n of ``counts``: how its time grows with its grid
    (one block per 1,024 edges), from one block alone to whole waves of
    the blocks the card holds at once."""
    from types import SimpleNamespace

    from gbp_poplar_tpu_torch.ops import diag_kernel

    out = []
    for n in counts:
        st = SimpleNamespace(pk=state.pk, active=state.active[:n],
                             damping_count=state.damping_count[:n],
                             robust=state.robust[:n])
        g = SimpleNamespace(
            n_edges=n, n_keyframes=graph.n_keyframes, n_points=graph.n_points,
            cam_idx=graph.cam_idx[:n], lmk_idx=graph.lmk_idx[:n],
            meas=graph.meas[:, :n].contiguous(), intr=None, k=graph.k)
        out.append(device_ms(lambda: diag_kernel.edge_sums(
            st, g, cfg.num_undamped_iters, tables=tables), TIMED_SWEEPS,
            "diag_sums", per_call=True))
    return out


def diag_bytes(graph, bad) -> int:
    """Bytes H6 must move: per edge its two ids, measurement, activity,
    damping counter and robust flag (and intrinsics, bad flag), per
    variable the mean and flag of its table row, the five float64
    results."""
    per_edge = (4 + 4 + 8 + 4 + 4 + 1 + (12 if graph.intr is not None else 0)
                + (1 if bad is not None else 0))
    return (graph.n_edges * per_edge + 4 * 7 * graph.n_keyframes
            + 4 * 4 * graph.n_points + 8 * 5)


def bad_edges(prob, cfg, dev):
    """An [E] mask of UTILS_BAD_IDS random original edges (seed 13), as
    ``factor_graph.bad_edge_mask`` builds it."""
    import numpy as np
    import torch

    from gbp_poplar_tpu_torch.core import factor_graph as fg

    ids = np.random.default_rng(13).choice(prob.n_edges, UTILS_BAD_IDS,
                                           replace=False)
    return torch.as_tensor(fg.bad_edge_mask(prob, ids, cfg), device=dev)


def singular_beliefs(state, graph):
    """A copy of ``state`` with singular beliefs: 50 observed landmarks'
    Lambda zeroed (their means overflow) and camera 3's eta NaN."""
    st = state.clone()
    seen = graph.lmk_idx[state.active > 0].unique()
    st.lmk_bel[3:, seen[:50]] = 0.0
    st.cam_bel[0, 3] = float("nan")
    return st


def diag_cases(label, state, graph, cfg, bad) -> float:
    """H6 (ops/diag_kernel.edge_sums) against its plain version on
    ``state``, without and with the mask ``bad``: the counts equal, the
    float sums within REDUCE_RTOL of the sum of |terms| (the sums
    themselves: the terms are >= 0), the same bits on a rerun. Returns
    the largest difference of a float sum."""
    import torch

    from gbp_poplar_tpu_torch.ops import diag_kernel

    n = cfg.num_undamped_iters
    worst = 0.0
    for mask in (None, bad):
        k = diag_kernel.edge_sums(state, graph, n, mask)
        r = diag_kernel.edge_sums(state, graph, n, mask, reference=True)
        again = torch.equal(k, diag_kernel.edge_sums(state, graph, n, mask))
        counts = same(k[[0, 3, 4]], r[[0, 3, 4]])
        diff = (k[1:3] - r[1:3]).abs()
        rel = (diff / r[1:3].clamp_min(1e-30)).max().item()
        worst = max(worst, diff.max().item())
        print(f"[H6] {label}"
              + ("" if mask is None else f", {int(mask.sum())} edges bad")
              + f": {int(r[0])} valid edges, {int(r[3])} relinearised, "
              f"{int(r[4])} robust, counts equal: {counts}; sum of norms "
              f"{k[1].item():.6f} (plain {r[1].item():.6f}), cost "
              f"{k[2].item():.6f} (plain {r[2].item():.6f}), max relative "
              f"to sum |terms| {rel:.3e} (bound {REDUCE_RTOL}); "
              f"bit-identical on rerun: {again}")
        check(counts and again and rel <= REDUCE_RTOL,
              f"H6 {label}: kernel and plain version differ")
    return worst


def op_counts(fn) -> tuple[int, int]:
    """(top-level aten operations, device launches) of one call of
    ``fn()``, by torch.profiler, after a warm-up call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = prof.events()
    aten = sum(1 for ev in evs if ev.device_type == DeviceType.CPU
               and ev.cpu_parent is None and ev.name.startswith("aten::"))
    launches = sum(1 for ev in evs if ev.device_type == DeviceType.CUDA)
    return aten, launches


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events,
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def same(a, b) -> bool:
    """Bitwise-equal values, NaN matching NaN."""
    import torch

    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def shuffle_cameras(prob, seed: int = 0):
    """The problem with its cameras relabelled by a random permutation (new
    id of camera c: perm[c]): the ids of an unordered photo collection
    follow no sequence."""
    import numpy as np

    perm = np.random.default_rng(seed).permutation(prob.n_keyframes)

    def moved(x):
        if x is None:
            return None
        out = np.empty_like(x)
        out[perm] = x
        return out

    return dataclasses.replace(
        prob, cam_idx=perm[prob.cam_idx].astype(prob.cam_idx.dtype),
        cam_means=moved(prob.cam_means), intrinsics=moved(prob.intrinsics))


def agree(label: str, err, err_r) -> None:
    """Final errors of the kernels' run and the plain run within the
    MAIN_AGREE bounds."""
    import numpy as np

    gap = abs(float(err[-1]) - float(err_r[-1]))
    bound = max(MAIN_AGREE_PX, MAIN_AGREE_REL * float(err_r[-1]))
    print(f"{label} reference: error {err_r[-1]:.4f} px after {len(err_r)} "
          f"sweeps; |kernels - reference| {gap:.6f} px (bound {bound:.4f}), "
          f"largest per-sweep difference {np.abs(err - err_r).max():.6f} px")
    check(bool(np.isfinite(err_r).all()) and gap <= bound,
          f"{label} kernels and reference disagree")


def coarse_bytes(graph, n_real: int) -> int:
    """Bytes H7 must move: per real edge its two ids, measurement,
    variance and activity (and intrinsics) read and its 90 terms written;
    per camera its mean and basis, per landmark its mean, read once."""
    per_edge = 4 + 4 + 8 + 4 + 4 + (12 if graph.intr is not None else 0)
    return (n_real * (per_edge + 4 * 90) + 4 * (6 + 36) * graph.n_keyframes
            + 4 * 3 * graph.n_points)


def cost_bytes(graph, n_sets: int, bad) -> int:
    """Bytes H8 must move: per edge its two ids, measurement, variance and
    activity (and intrinsics, bad flag); per set each variable's mean; the
    sums written."""
    per_edge = (4 + 4 + 8 + 4 + 4 + (12 if graph.intr is not None else 0)
                + (1 if bad is not None else 0))
    return (graph.n_edges * per_edge
            + n_sets * 4 * (6 * graph.n_keyframes + 3 * graph.n_points)
            + 4 * n_sets)


def decision_tie(st) -> bool:
    """Whether a boundary's decisions rest on a tie: the accelerator's jump
    (gain > 0) or the coarse step's best scale within DECISION_TIE_RTOL of
    its runner-up."""
    cur = abs(st.cost_cur.item())
    if st.gain.item() > 0 and (abs(st.cost_cand.item() - st.cost_cur.item())
                               <= DECISION_TIE_RTOL * cur):
        return True
    c = st.coarse
    vals = sorted([c.cost_cur.item(), *c.cost_cand.tolist()])
    return vals[1] - vals[0] <= DECISION_TIE_RTOL * abs(vals[0])


def decisions(st) -> tuple:
    """A boundary's decisions: the accelerator's jump applied, the coarse
    gain."""
    return (bool(st.accepted) and st.gain.item() > 0, st.coarse.gain.item())


def same_decisions(log, log_r) -> int:
    """The kernels' and the plain run's decisions at each boundary, equal up
    to the first tie in either run; returns the boundaries compared."""
    n = 0
    for (at, a), (at_r, b) in zip(log, log_r):
        check(at == at_r, "coarse path: the boundaries differ")
        if decision_tie(a) or decision_tie(b):
            print(f"[coarse] after sweep {at}: a tie (within "
                  f"{DECISION_TIE_RTOL:g}); decisions compared up to here")
            break
        check(decisions(a) == decisions(b),
              f"coarse path: the decisions after sweep {at} differ from "
              f"the plain run's: {decisions(a)} against {decisions(b)}")
        n += 1
    return n


def refit_case(dev):
    """The ba driver's --refine_intrinsics step through H8: one refit on a
    Snavely problem (40 keyframes, 1,500 points, focal lengths off by up to
    7 %) after 40 sweeps, its three MAP costs priced by H8 on the refit's
    candidate intrinsics, against the same refit with kernels="reference":
    the same decision, the new (f, k1, k2) within 1e-4; a graph whose
    intrinsics are a strided view prices to the bits of its contiguous
    copy."""
    import dataclasses

    import numpy as np
    import torch

    from gbp_poplar_tpu_torch.config import GBPConfig
    from gbp_poplar_tpu_torch.core import build_graph, gbp, init_state
    from gbp_poplar_tpu_torch.core.intrinsics import refit_intrinsics
    from gbp_poplar_tpu_torch.ops import cost_kernel
    from gbp_poplar_tpu_torch.utils import balio

    prob = balio.synthetic_problem_snavely(40, 1500, pixel_noise=0.3, seed=3)
    rng = np.random.default_rng(1)
    prob.intrinsics[:, 0] *= rng.uniform(0.93, 1.07, prob.n_keyframes)
    prob.intrinsics[:, 1] += rng.normal(0, 0.05, prob.n_keyframes)
    cfg = GBPConfig(accel_every=0)
    ref = dataclasses.replace(cfg, kernels="reference")
    graph = build_graph(prob, cfg, dev)
    s = gbp.initialise(init_state(prob, cfg, dev), graph, cfg)
    s, _ = gbp.run_gbp(s, graph, cfg, 40, with_diagnostics=False)
    before = cost_kernel.cost_sums.launches
    new_intr, acc = refit_intrinsics(s, graph, cfg)
    n_h8 = cost_kernel.cost_sums.launches - before
    want_intr, want_acc = refit_intrinsics(s, graph, ref)
    gap = ((new_intr - want_intr).abs()
           / (want_intr.abs() + 1e-1)).max().item()
    strided = dataclasses.replace(graph, intr=new_intr.T.contiguous().T)
    same = torch.equal(
        gbp.map_cost(s, strided, cfg),
        gbp.map_cost(s, dataclasses.replace(graph, intr=new_intr), cfg))
    print(f"[H8] refit_intrinsics on a Snavely problem ({graph.n_edges} "
          f"edges): accepted {bool(acc)} (plain {bool(want_acc)}), {n_h8} H8 "
          f"launches, new intrinsics against the plain refit's {gap:.3e} "
          f"relative to 0.1 + |value| (bound 1e-4); strided intrinsics "
          f"priced to the same bits: {same}")
    check(n_h8 == 3 and bool(acc) == bool(want_acc) and gap <= 1e-4
          and not strided.intr.is_contiguous() and same,
          "refit_intrinsics through H8 differs from its plain version")


def chunk_kernel_cases(prob, s, graph, cfg, card):
    """H7 and H8 against their plain versions on the state ``s`` (phase
    9's, after its solve): H7's planes per plane within COARSE_RTOL of the
    plane's largest magnitude with the same edges dropped, their group sums
    (H3) against the plain sums of the same planes and against the plain
    sums of the plain planes, both within REDUCE_RTOL of the sum of
    |terms|; H8
    at K = 2 and 3 sets of means, with and without 1,000 bad edges, within
    COST_RTOL of the sum of |loss|; both again to the bit; an intrinsics
    refit through H8 (``refit_case``). Then each
    kernel's time beside its plain version's and its bound, the landmark
    prior terms' time. Returns ({kernel: (ms, plain ms)}, {kernel: (bound,
    by, library)}, {kernel: largest difference})."""
    import torch

    from gbp_poplar_tpu_torch.core import coarse, gbp
    from gbp_poplar_tpu_torch.ops import coarse_kernel, cost_kernel
    from gbp_poplar_tpu_torch.ops import reduce_kernel

    n_real = graph.cam_seg.var.shape[0]
    cam_mu, lmk_mu = gbp._variable_means(s)
    s_cam = coarse._fin(coarse._cam_rigid_basis(coarse._fin(cam_mu.T)))

    def h7(reference=False):
        return coarse_kernel.coarse_edge_blocks(cam_mu, lmk_mu, s_cam, s,
                                                graph, cfg,
                                                reference=reference)

    k, r = h7(), h7(True)
    again = torch.equal(k, h7())
    dropped, dropped_r = (k == 0).all(dim=0), (r == 0).all(dim=0)
    scale = r.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    gap = ((k - r).abs() / scale).amax(dim=1)
    h7_err = (k - r).abs().max().item()
    print(f"[H7] Ladybug after {COARSE_SWEEPS} sweeps, {COARSE_GROUPS} "
          f"groups: {n_real} edges, {int(dropped_r.sum())} dropped (kernel "
          f"{int(dropped.sum())}); max |kernel - plain| per plane relative "
          f"to its largest magnitude {gap.max().item():.3e} (plane "
          f"{gap.argmax().item()}, bound {COARSE_RTOL:g}); bit-identical on "
          f"rerun: {again}")
    check(again and torch.equal(dropped, dropped_r)
          and gap.max().item() <= COARSE_RTOL, "H7 and its plain version "
          "differ")
    segs = coarse.group_segments(graph, COARSE_GROUPS)
    for key, seg in (("cam", segs.edge_cam), ("lmk", segs.edge_lmk),
                     ("pair", segs.edge_pair)):
        rows = coarse_kernel.ROWS[key]
        sums = reduce_kernel.segment_sum(k[rows], seg)
        twice = torch.equal(sums, reduce_kernel.segment_sum(h7()[rows], seg))
        size = reduce_kernel.segment_sum(r[rows].abs(), seg, reference=True)
        size = size.clamp_min(1e-30)
        plain_k = reduce_kernel.segment_sum(k[rows], seg, reference=True)
        plain_r = reduce_kernel.segment_sum(r[rows], seg, reference=True)
        rel_k = ((sums - plain_k).abs() / size).max().item()
        rel_r = ((sums - plain_r).abs() / size).max().item()
        print(f"[H7] group sums by {key} ({seg.n_var} segments), relative to "
              f"the sum of |terms|: H3 on H7's planes against the plain sum "
              f"of them {rel_k:.3e} (bound {REDUCE_RTOL}), against the plain "
              f"sum of the plain planes {rel_r:.3e} (bound {REDUCE_RTOL}); "
              f"H7 + H3 bit-identical on rerun: {twice}")
        check(twice and max(rel_k, rel_r) <= REDUCE_RTOL,
              f"H7's group sums by {key} differ")

    rng = torch.Generator(device=cam_mu.device).manual_seed(1)
    sets = [(cam_mu, lmk_mu)] + [
        (cam_mu + 1e-4 * torch.randn(cam_mu.shape, generator=rng,
                                     device=cam_mu.device),
         lmk_mu + 1e-2 * torch.randn(lmk_mu.shape, generator=rng,
                                     device=lmk_mu.device))
        for _ in range(2)]
    bad = bad_edges(prob, cfg, cam_mu.device)
    h8_err = 0.0
    for n_sets, mask in ((2, None), (3, bad), (3, None), (2, bad)):
        args = (s, graph, sets[:n_sets], cfg.huber_nstds, mask)
        got = cost_kernel.cost_sums(*args)
        want = cost_kernel.cost_sums(*args, reference=True)
        again = torch.equal(got, cost_kernel.cost_sums(*args))
        rel = ((got - want).abs() / want.abs()).max().item()
        h8_err = max(h8_err, (got - want).abs().max().item())
        print(f"[H8] K={n_sets}" + ("" if mask is None else
                                    f", {int(mask.sum())} edges bad")
              + f": sums {[f'{x:.6f}' for x in got.tolist()]} (plain "
              f"{[f'{x:.6f}' for x in want.tolist()]}), max relative to the "
              f"sum of |loss| {rel:.3e} (bound {COST_RTOL:g}); bit-identical "
              f"on rerun: {again}")
        check(again and rel <= COST_RTOL, "H8 and its plain version differ")
    refit_case(cam_mu.device)

    times = {"coarse": (cuda_ms(h7, TIMED_SWEEPS), cuda_ms(lambda: h7(True),
                                                          3))}
    two = sets[:2]
    times["cost"] = (
        cuda_ms(lambda: cost_kernel.cost_sums(s, graph, two,
                                              cfg.huber_nstds), TIMED_SWEEPS),
        cuda_ms(lambda: cost_kernel.cost_sums(s, graph, two, cfg.huber_nstds,
                                              reference=True), 3))
    yard = {
        "coarse": (*least_ms(coarse_bytes(graph, n_real),
                             count_ops(lambda: h7(True))), None),
        "cost": (*least_ms(cost_bytes(graph, 2, None), count_ops(
            lambda: cost_kernel.cost_sums(s, graph, two, cfg.huber_nstds,
                                          reference=True))), None)}
    for key, what in (("coarse", f"{n_real} real edges"),
                      ("cost", f"K = 2 sets, {graph.n_edges} padded edges")):
        (ms, plain), (b, by, _) = times[key], yard[key]
        print(f"[time] {key}: kernel {ms:.4f} ms, plain PyTorch {plain:.4f} "
              f"ms at {what}; bound {b:.4f} ms by {by} ({b / ms:.0%} of it "
              f"reached); one library call none ({card})")
    lmkr = coarse._fin(lmk_mu.T)
    s_lmk = coarse._lmk_rigid_basis(lmkr)
    prior_ms = cuda_ms(lambda: coarse.lmk_prior_terms(s, lmkr, s_lmk), 5)
    print(f"[coarse] the landmark prior terms (batched products over "
          f"{graph.n_points} landmarks): {prior_ms:.4f} ms ({card})")
    return times, yard, {"coarse": h7_err, "cost": h8_err}


def coarse_phase(prob, dev, reset_counts, read_counts, card):
    """Phase 9: run_gbp with the coarse corrector at the Ladybug shape,
    cameras in their generated order: every boundary's decisions, equal to
    kernels="reference"'s up to the first tie, the final error against
    it, H7 and H8 against their plain versions (``chunk_kernel_cases``),
    one coarse step's time, and the group sums (H3 over the group-keyed
    segments) against their plain version. Returns (launch counts, largest
    group-sum difference, the final error, the chunk kernels' times,
    bounds and largest differences)."""
    import numpy as np
    import torch

    from gbp_poplar_tpu_torch.config import GBPConfig
    from gbp_poplar_tpu_torch.core import build_graph, coarse, gbp, init_state

    cfg = GBPConfig(coarse_groups=COARSE_GROUPS)
    graph = build_graph(prob, cfg, dev)
    reset_counts()
    s = gbp.initialise(init_state(prob, cfg, dev), graph, cfg)
    err0 = gbp.reprojection_error(s, graph)[0].item()
    log = []
    s, diag = gbp.run_gbp(s, graph, cfg, COARSE_SWEEPS, accel_log=log)
    launches = read_counts()
    err = diag.reproj_err.cpu().numpy()

    def boundary_line(tag, n_at, st):
        c = st.coarse
        moved = bool(st.accepted) and st.gain.item() > 0
        print(f"[coarse] {tag}after sweep {n_at}: accelerator gain "
              f"{st.gain.item():.4f} {'applied' if moved else 'not applied'} "
              f"(MAP cost {st.cost_cur.item():.9e} -> candidate "
              f"{st.cost_cand.item():.9e}); coarse gain {c.gain.item():g} "
              f"(cost to beat {c.cost_cur.item():.9e}, scale 1 "
              f"{c.cost_cand[0].item():.9e}, scale 0.3 "
              f"{c.cost_cand[1].item():.9e})")

    for n_at, st in log:
        boundary_line("", n_at, st)
    n_coarse = sum(st.coarse.gain.item() > 0 for _, st in log)
    print(f"[coarse] kernels: error {err0:.4f} px after initialise -> "
          f"{err[-1]:.4f} px after {COARSE_SWEEPS} sweeps (min "
          f"{err.min():.4f}); {n_coarse} of {len(log)} coarse steps "
          f"applied; launches {launches}")
    check(bool(np.isfinite(err).all()) and err[-1] < err0,
          "coarse path: error did not fall")
    check([n for n, _ in log] == [160, 210, 260, 310, 360],
          "coarse path: the steps did not come at 160, 210, ..., 360")
    check(all(st.coarse is not None for _, st in log),
          "coarse path: an accelerator step without its coarse step")
    # H7 once a coarse step; H8 once an accelerator step (the current
    # means and the candidate) and once a coarse step (its two scales)
    check(launches["sweep"] == COARSE_SWEEPS
          and launches["table"] >= COARSE_SWEEPS
          and launches["reduce"] >= 2 * COARSE_SWEEPS
          and launches["coarse"] == len(log)
          and launches["cost"] == 2 * len(log),
          "coarse path did not go through H1, H2, H3 every sweep and H7, "
          "H8 every boundary")

    ref = dataclasses.replace(cfg, kernels="reference")
    s_r = gbp.initialise(init_state(prob, ref, dev), graph, ref)
    log_r = []
    _, diag_r = gbp.run_gbp(s_r, graph, ref, COARSE_SWEEPS, accel_log=log_r)
    for n_at, st in log_r:
        boundary_line("reference: ", n_at, st)
    n_same = same_decisions(log, log_r)
    print(f"[coarse] decisions equal to the reference's at {n_same} of "
          f"{len(log)} boundaries (up to the first tie)")
    agree("[coarse]", err, diag_r.reproj_err.cpu().numpy())
    del s_r, diag_r

    chunk = chunk_kernel_cases(prob, s, graph, cfg, card)

    degs = gbp._active_degrees(s, graph, cfg)
    for label, c in (("kernels", cfg), ("reference", ref)):
        st = s.clone()
        cost = gbp.map_cost(st, graph, c)
        step_ms = cuda_ms(lambda: gbp._coarse_step(st, graph, c, degs,
                                                   cost=cost), 5)
        def increment():
            return coarse.coarse_increment(st, graph, c,
                                           *gbp._variable_means(st))

        inc_ms = cuda_ms(increment, 5)
        print(f"[coarse] {label}: one coarse step {step_ms:.4f} ms (the "
              f"increment {inc_ms:.4f} ms) at {graph.n_edges} padded edges, "
              f"{COARSE_GROUPS} groups ({card})")
        # where the time goes: the device's busy time against the events'
        step_busy = busy_ms(lambda: gbp._coarse_step(st, graph, c, degs,
                                                     cost=cost), 3)
        inc_ops = op_counts(increment)
        print(f"[coarse] {label}: device busy {step_busy:.4f} ms of the "
              f"step, {busy_ms(increment, 3):.4f} ms of the increment "
              f"(profiler); the increment {inc_ops[0]} aten operations, "
              f"{inc_ops[1]} device launches ({card})")
        del st
    # H7 and H8 inside run_gbp: two live chunks, two boundaries
    from gbp_poplar_tpu_torch.tools import profile_sweep

    n_live = 2 * cfg.accel_every
    rp = profile_sweep.profile_run(s.clone(), graph, cfg, n_live,
                                   iter_offset=10 * cfg.accel_start)
    inside = {kernel_of(name): (us * n_live, n * n_live)
              for name, us, _, n in rp["kernels"]
              if kernel_of(name) in ("coarse", "cost")}
    check(set(inside) == {"coarse", "cost"},
          "coarse path: H7 or H8 missing from run_gbp's trace")
    print(f"[coarse] inside run_gbp ({n_live} live sweeps, profiler): "
          + ", ".join(f"{k} {us / n / 1e3:.4f} ms a launch ({n:.0f} "
                      f"launches)" for k, (us, n) in inside.items())
          + f"; device busy {rp['busy']:.1%} of the {rp['span_ms']:.3f} ms "
          f"span ({card})")

    segs = coarse.group_segments(graph, COARSE_GROUPS)
    x = torch.randn((graph.n_edges, 6, 6), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    worst = 0.0
    for label, seg in (("edges by camera group", segs.edge_cam),
                       ("edges by landmark group", segs.edge_lmk),
                       ("edges by group pair", segs.edge_pair)):
        k = coarse._group_sum(x, seg, ref=False)
        r = coarse._group_sum(x, seg, ref=True)
        scale = coarse._group_sum(x.abs(), seg, ref=True)
        diff = (k - r).abs()
        rel = (diff / (scale + 1e-30)).max().item()
        again = torch.equal(coarse._group_sum(x, seg, ref=False), k)
        print(f"[H3] coarse sums, {label} ({seg.n_var} segments): max "
              f"|kernel - plain| {diff.max().item():.3e} (relative to sum "
              f"|terms| {rel:.3e}, bound {REDUCE_RTOL}); bit-identical on "
              f"rerun: {again}")
        check(again and rel <= REDUCE_RTOL, f"coarse sums {label} differ")
        worst = max(worst, diff.max().item())
    return launches, worst, float(err[-1]), chunk


def driver_phase(raw, dev, reset_counts, read_counts, card, work):
    """Phase 10: the ba driver in process at the Ladybug shape with its
    defaults: a run with checkpoints, trajectory and the GN check, its
    resume, and the same sweeps uninterrupted, which the resumed lines
    must equal. The BAL file stays in ``work`` for phase 13. Returns
    (the launch counts of the three runs, the BAL file's path)."""
    import contextlib
    import io
    import os
    import tempfile

    import numpy as np
    import torch

    from gbp_poplar_tpu_torch.core import gauss_newton as gn
    from gbp_poplar_tpu_torch.drivers import ba
    from gbp_poplar_tpu_torch.utils import balio

    n1, n2 = DRIVER_SWEEPS
    timed = {}
    real_lm, real_problem = gn.solve_lm, gn.solve_problem

    def timing(label, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            timed.setdefault(label, []).append(time.perf_counter() - t0)
            return out
        return run

    def drive(*argv):
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = ba.main([str(a) for a in argv])
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        lines = [ln for ln in out.getvalue().splitlines()
                 if ln.startswith("iter")]
        err = err.getvalue()
        for ln in err.splitlines():
            print(f"[driver]   {ln}")
        n_run = int(argv[argv.index("--n_iters") + 1])
        first = int(lines[0].split()[1]) if lines else -1
        print(f"[driver]   exit {rc}, {len(lines)} iteration lines, {wall:.1f}"
              f" s wall, peak device memory {peak:.2f} GiB, launches "
              f"{counts}")
        check(rc == 0, "ba driver failed")
        swept = n_run - first
        check(len(lines) == swept and counts["sweep"] == swept
              and counts["table"] >= swept
              and counts["reduce"] >= 2 * swept,
              "ba driver did not go through H1, H2, H3 every sweep")
        return lines, err, counts

    def after(err, key):
        return err.split(key)[1].split()[0]

    launches = {}
    bal = os.path.join(work, "ladybug.txt")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        balio.save_bal(bal, raw)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        balio.load_bal(bal)
        t_parse = time.perf_counter() - t0
        print(f"[driver] Ladybug shape as a BAL file: "
              f"{os.path.getsize(bal) / 2**20:.1f} MiB, written in "
              f"{t_write:.2f} s, parsed by load_bal in {t_parse:.2f} s "
              f"(the native parser, its g++ build on first use included)")
        ckpt, traj = os.path.join(tmp, "c.npz"), os.path.join(tmp, "t.txt")
        base = ("--bal_file", bal, "--ltn", LMK_NOISE)
        gn.solve_lm = timing("polish", real_lm)
        gn.solve_problem = timing("gn_check", real_problem)
        try:
            print(f"[driver] run 1: {n1} sweeps, defaults, checkpoint every "
                  f"{CHECKPOINT_EVERY}, trajectory, --gn_check")
            lines1, err1, c1 = drive(*base, "--n_iters", n1, "--checkpoint",
                                     ckpt, "--checkpoint_every",
                                     CHECKPOINT_EVERY, "--save_traj", traj,
                                     "--gn_check")
            rows = np.loadtxt(traj)
            e_first, e_last = (float(lines1[i].split()[3]) for i in (0, -1))
            check(e_last < e_first, "ba driver: the error did not fall")
            check(rows.shape == (raw.n_keyframes, 8)
                  and bool(np.isfinite(rows).all()),
                  "ba driver: bad trajectory")
            check("polish: reproj" in err1 and "host oracle: reproj_err"
                  in err1 and "GN baseline" in err1,
                  "ba driver: no polish, host oracle or GN line")
            # solve_lm's first call is the polish, its second the GN check's
            t_polish = timed["polish"][0]
            lm_ms = t_polish / POLISH_ITERS * 1e3
            print(f"[driver] run 1: error {e_first:.4f} -> {e_last:.4f} px; "
                  f"polish {t_polish:.3f} s ({lm_ms:.1f} ms per LM "
                  f"iteration) to {after(err1, 'polish: reproj')} "
                  f"px; GN check {timed['gn_check'][0]:.3f} s, its error "
                  f"{after(err1, 'GN baseline: reproj_err')} px, ATE(GBP vs "
                  f"GN) {after(err1, 'ATE(GBP vs GN)')} m; host oracle "
                  f"{after(err1, 'host oracle: reproj_err')} px; "
                  f"{len(rows)} trajectory rows ({card})")
            print(f"[driver] run 2: resume at {n1}, to {n2}")
            lines2, _, c2 = drive(*base, "--resume", ckpt, "--n_iters", n2)
            print(f"[driver] run 3: {n2} sweeps uninterrupted")
            lines3, err3, c3 = drive(*base, "--n_iters", n2)
        finally:
            gn.solve_lm, gn.solve_problem = real_lm, real_problem
    check(lines2[0].split()[1] == str(n1),
          "resume did not start at run 1's end")
    same_lines = lines2 == lines3[n1:]
    print(f"[driver] resumed lines {n1}-{n2 - 1} equal the uninterrupted "
          f"run's: {same_lines}; steady state {after(err3, 'steady-state')} "
          f"sweeps/s over {n2} sweeps with per-sweep telemetry ({card})")
    check(same_lines, "resume is not bit-exact")
    for c in (c1, c2, c3):
        for k, n in c.items():
            launches[k] = launches.get(k, 0) + n
    return launches, bal


def lm_phase(prob, means, cfg, dev, reset_counts, read_counts, card):
    """Phase 11: the driver's polish (15 warm-started LM/Schur iterations,
    ``ba._polish_problem``) at the Venice shape, from the means the Venice
    main path left, then the preconditioner's census along it (ROADMAP
    C3). Returns the launch counts of the polish."""
    import numpy as np
    import torch

    from gbp_poplar_tpu_torch.core import gauss_newton as gn
    from gbp_poplar_tpu_torch.drivers import ba
    from gbp_poplar_tpu_torch.tools import validate_scale as vs

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2**30
    reset_counts()
    t0 = time.perf_counter()
    graph1, pri = ba._polish_problem(prob, cfg, dev)
    cam0 = torch.tensor(means[0], device=dev)
    lmk0 = torch.tensor(means[1], device=dev)
    cost0 = gn.map_cost(cam0, lmk0, graph1, pri, cfg).item()
    t_build = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = gn.solve_lm(cam0, lmk0, graph1, pri, cfg, n_lm_iters=POLISH_ITERS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    costs = res.cost.cpu().numpy()
    acc = res.accepted.cpu().numpy()
    errs = res.reproj_err.cpu().numpy()
    print(f"[lm] Venice shape: exact-edge graph and priors in {t_build:.2f} s;"
          f" MAP cost {cost0:.6e} at the start")
    for i, (c, a, e) in enumerate(zip(costs, acc, errs)):
        print(f"[lm]   iteration {i + 1}: cost {c:.6e}, "
              f"{'accepted' if a else 'rejected'}, error {e:.5f} px")
    print(f"[lm] {POLISH_ITERS} iterations in {dt:.3f} s: "
          f"{dt / POLISH_ITERS * 1e3:.2f} ms per LM iteration at "
          f"{graph1.n_edges} edges; peak device memory {peak:.2f} GiB "
          f"({base:.2f} GiB held before); launches {launches} ({card})")
    check(bool(torch.isfinite(res.cam).all() and torch.isfinite(res.lmk).all()
               and np.isfinite(costs).all()), "LM: non-finite result")
    check(costs[0] <= cost0 and bool(np.all(np.diff(costs) <= 0)),
          "LM: the cost rose")
    check(launches["reduce"] > 0, "LM did not go through H3")
    census_line("Venice", vs.precond_census(cam0, lmk0, graph1, pri, cfg,
                                            POLISH_ITERS), acc)
    return launches


def census_line(label, cen, polish_accepted) -> None:
    """Print ROADMAP C3's census of one polish (validate_scale.
    precond_census): the non-finite inverses of S's diagonal blocks per
    LM iteration, by the LM's cholesky_ex and by the unrolled inv6x6, on
    the card and on a CPU copy of the same blocks."""
    print(f"[lm] C3 census at the {label} shape, {cen['blocks']} blocks an "
          f"iteration over {len(cen['accepted'])} polish iterations: "
          f"non-finite inverses by cholesky_ex on the card "
          f"{cen['cholesky_ex_device']}, on the host {cen['cholesky_ex_cpu']};"
          f" by inv6x6 on the card {cen['unrolled_device']}, on the host "
          f"{cen['unrolled_cpu']}; accept decisions {cen['accepted']}")
    check(cen["accepted"] == [bool(a) for a in polish_accepted],
          f"C3 census at {label}: not the polish's trajectory")


def slam_phase(dev, reset_counts, read_counts, card, compare_sweeps):
    """Phase 12: incremental SLAM at the TUM fr1desk shape with the slam
    driver's config: (a) SLAM_SEGMENTS segments of SLAM_IBK sweeps with
    diagnostics, kernels against kernels="reference" on the first
    SLAM_REF_SEGMENTS; (b) one sweep right after an insertion, H1 and H4
    against their plain versions and each other, to the bit; (c) a
    checkpoint through the driver's save path at keyframe SLAM_CKPT_KF,
    resumed with start_kf: the diagnostics of the resumed segments equal
    (a)'s to the bit; (d) all 62 keyframes without diagnostics, sweeps/s
    including insertion and the final error, then ms/sweep with and
    without diagnostics; (e) the slam driver in process at SLAM_DRIVER_IBK
    sweeps per keyframe with --polish, --save_traj and --checkpoint, its
    resume from the final checkpoint (the same trajectory), and the same
    run without diagnostics. Returns (launch counts of the main paths,
    largest H1, H4 and H6 difference from plain, (e)'s final error)."""
    import tempfile

    import torch

    from gbp_poplar_tpu_torch.config import InitConfig
    from gbp_poplar_tpu_torch.core import build_graph, gbp, init_state, slam
    from gbp_poplar_tpu_torch.drivers import slam as slam_driver
    from gbp_poplar_tpu_torch.utils import balio, evaluation, flags, priors

    cfg, _ = slam_driver.config_from_args(
        slam_driver.build_parser().parse_args(["--bal_file", "-"]))
    raw = balio.synthetic_problem_large(*SLAM_SHAPE)
    # the generator's consistency: the oracle at the true means is about
    # 1.25 x the pixel noise (0.5 px)
    err_true, _ = evaluation.numpy_reprojection_error(raw.cam_means,
                                                      raw.lmk_means, raw)
    print(f"[slam] TUM fr1desk shape: synthetic_problem_large{SLAM_SHAPE}, "
          f"{raw.n_keyframes} keyframes, {raw.n_points} landmarks, "
          f"{raw.n_edges} edges; host oracle at the true means "
          f"{err_true:.5f} px (1.25 x 0.5 = 0.625 expected)")
    check(abs(err_true / 0.625 - 1.0) < 0.1, "SLAM shape: generator broken")
    prob = priors.apply_init_noise(raw, InitConfig(lmk_noise=LMK_NOISE,
                                                   seed=0))
    graph = build_graph(prob, cfg, dev)
    print(f"[slam] {graph.n_edges} padded edges; config: relin_every_iter="
          f"{cfg.relin_every_iter}, eta_damping {cfg.eta_damping}, "
          f"relin_behind_camera={cfg.relin_behind_camera}, rescue after "
          f"{cfg.behind_camera_rescue_iters} sweeps, accelerator every "
          f"{cfg.accel_every} sweeps from {cfg.accel_start}")

    def run(c, n_kf, ibk=SLAM_IBK, diags=True, problem=prob, g=graph,
            **kw):
        """solve_slam from a fresh SLAM state, timed (s), recording the
        accelerator's steps."""
        log = []

        def runner(s):
            return gbp.run_gbp(s, g, c, ibk, with_diagnostics=diags,
                               accel_log=log)

        state = init_state(problem, c, dev,
                           flags=flags.create_flags(problem, c.steps))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = slam.solve_slam(state, g, c, n_keyframes=n_kf,
                              iters_between_kfs=ibk, with_diagnostics=diags,
                              runner=runner, **kw)
        torch.cuda.synchronize()
        return res, log, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        return _slam_parts(run, tmp, raw, prob, graph, cfg, dev,
                           reset_counts, read_counts, card, compare_sweeps)


def _slam_parts(run, tmp, raw, prob, graph, cfg, dev, reset_counts,
                read_counts, card, compare_sweeps):
    """Phase 12's parts (a)-(e) (see slam_phase), files under ``tmp``."""
    import contextlib
    import io
    import os
    import re

    import numpy as np
    import torch

    from gbp_poplar_tpu_torch.config import InitConfig
    from gbp_poplar_tpu_torch.core import build_graph, gbp, slam
    from gbp_poplar_tpu_torch.drivers import common
    from gbp_poplar_tpu_torch.drivers import slam as slam_driver
    from gbp_poplar_tpu_torch.ops import planes, reduce_kernel, sweep_kernel
    from gbp_poplar_tpu_torch.ops import table_kernel
    from gbp_poplar_tpu_torch.tools import bench
    from gbp_poplar_tpu_torch.utils import balio, checkpoint, priors

    n_sweeps_all = (prob.n_keyframes - 1) * SLAM_IBK
    # (a) kernels against kernels="reference", the error at each insertion
    ckpt = os.path.join(tmp, "slam.npz")
    kept = {}

    def keep(k, st):
        if k == 2:
            kept["state"] = st.clone()       # right after keyframe 3's
        if k + 1 == SLAM_CKPT_KF:
            slam_driver.save_segment(ckpt, st, graph, cfg, k, SLAM_IBK)

    def progress(k, diag):
        print(f"[slam]   segment {k} (keyframes 0-{k}): error "
              f"{diag.reproj_err[0].item():.4f} -> "
              f"{diag.reproj_err[-1].item():.4f} px"
              + (f"; keyframe {k + 1} inserted" if k + 1 < SLAM_SEGMENTS + 1
                 else ""))

    reset_counts()
    res_k, log_k, wall_k = run(cfg, SLAM_SEGMENTS + 1, progress=progress,
                               segment_callback=keep)
    launches_a = read_counts()
    n_a = SLAM_SEGMENTS * SLAM_IBK
    live = sum(st.gain.item() > 0 and bool(st.accepted) for _, st in log_k)
    print(f"[slam] (a) kernels: {SLAM_SEGMENTS} segments of {SLAM_IBK} "
          f"sweeps with diagnostics in {wall_k:.1f} s ({n_a / wall_k:.1f} "
          f"sweeps/s); {len(log_k)} accelerator steps, {live} jumps "
          f"applied; launches {launches_a}")
    check(bool(np.isfinite(res_k.reproj_err).all()), "SLAM: non-finite error")
    check(len(log_k) > 0, "SLAM: no live accelerator step")
    # one table build a sweep (H6 and the next sweep read it), one more for
    # the first sweep of each of a segment's runs of sweeps
    check(launches_a["sweep"] == n_a
          and launches_a["table"] == n_a + SLAM_SEGMENTS * sweep_runs(
              cfg, SLAM_IBK)
          and launches_a["reduce"] >= 2 * n_a and launches_a["diag"] == n_a,
          "SLAM (a) did not go through H1, H2, H3, H6 every sweep")
    ref = dataclasses.replace(cfg, kernels="reference")
    res_r, _, wall_r = run(ref, SLAM_REF_SEGMENTS + 1)
    for seg in range(SLAM_REF_SEGMENTS):
        agree(f"[slam] (a) segment {seg + 1}", res_k.reproj_err[seg],
              res_r.reproj_err[seg])
    print(f"[slam] (a) reference: {SLAM_REF_SEGMENTS} segments in "
          f"{wall_r:.1f} s")
    # the plain run again: its sums add in a fixed order on the card too
    res_r2, _, _ = run(ref, SLAM_REF_SEGMENTS + 1)
    bits = all(np.array_equal(getattr(res_r, f), getattr(res_r2, f),
                              equal_nan=True)
               for f in ("reproj_err", "cost", "n_relins", "n_robust"))
    print(f"[slam] (a) reference run twice: the per-sweep diagnostics of "
          f"all {SLAM_REF_SEGMENTS} segments equal to the bit: {bits}")
    check(bits, "SLAM (a): the plain run does not repeat")
    del res_r2

    # (b) one sweep under the gn flags right after an insertion
    st = kept.pop("state")
    ct, lt = table_kernel.build_tables(st.cam_bel, st.lmk_bel, reference=True)
    bc = reduce_kernel.gather(st.cam_bel, graph.cam_idx, reference=True)
    bl = reduce_kernel.gather(st.lmk_bel, graph.lmk_idx, reference=True)
    s1, s1r, s4, s4r = st.clone(), st.clone(), st.clone(), st.clone()
    sweep_kernel.sweep(s1, graph, ct, lt, cfg)
    sweep_kernel.sweep(s1r, graph, ct, lt, cfg, reference=True)
    sweep_kernel.sweep_planes(s4, graph, bc, bl, cfg)
    sweep_kernel.sweep_planes(s4r, graph, bc, bl, cfg, reference=True)
    label = "SLAM, after keyframe 3's insertion, gn flags"
    h1_err = compare_sweeps("H1", label, graph, s1, s1r, "plain")
    h4_err = compare_sweeps("H4", label, graph, s4, s4r, "plain")
    h6_err = diag_cases("SLAM, after keyframe 3's insertion", st, graph, cfg,
                        bad_edges(prob, cfg, dev))
    y_cf, _ = planes.w2c_apply(list(s1r.mu[:6]), list(s1r.mu[6:]))
    act = st.active > 0
    behind = act & (y_cf[2] < -cfg.min_depth)
    settled = s1r.damping_count > cfg.behind_camera_rescue_iters
    relin = (s1r.lin_mu != st.lin_mu).any(dim=0)
    print(f"[slam] (b) {int(act.sum())} active edges, linearisation point "
          f"moved on {int(relin.sum())}, {int(behind.sum())} behind a camera "
          f"({int((behind & settled).sum())} settled); damping switched on "
          f"at {int((act & (st.damping_count == 0)).sum())}")
    for a, b, what in ((s1, s1r, "H1 and plain"), (s4, s4r, "H4 and plain"),
                       (s4, s1, "H4 and H1")):
        bits = all(same(getattr(a, f).float(), getattr(b, f).float())
                   for f in ("pk", "damping_count", "robust"))
        print(f"[slam] (b) {what} bit-identical: {bits}")
        check(bits, f"SLAM (b): {what} differ under the gn flags")
    del st, s1, s1r, s4, s4r, bc, bl, ct, lt

    # (c) the resume by keyframe from the driver's checkpoint
    state_c, g2, meta = checkpoint.load_checkpoint(ckpt, dev)
    graph_c = common.resume_graph(graph, g2)
    check(graph_c is graph and meta["kf"] == SLAM_CKPT_KF
          and meta["devices"] == 1, "SLAM (c): checkpoint metadata or graph")
    reset_counts()
    res_c = slam.solve_slam(state_c, graph_c, cfg, n_keyframes=SLAM_SEGMENTS
                            + 1, iters_between_kfs=SLAM_IBK,
                            start_kf=meta["kf"])
    launches_c = read_counts()
    n_c = SLAM_SEGMENTS + 1 - SLAM_CKPT_KF
    bits = all(np.array_equal(getattr(res_c, f),
                              getattr(res_k, f)[SLAM_CKPT_KF - 1:],
                              equal_nan=True)
               for f in ("reproj_err", "cost", "n_relins", "n_robust"))
    print(f"[slam] (c) resumed at keyframe {meta['kf']}: {n_c} segments, "
          f"diagnostics equal to the uninterrupted run's: {bits}; launches "
          f"{launches_c}")
    check(res_c.reproj_err.shape == (n_c, SLAM_IBK) and bits,
          "SLAM (c): the resume by keyframe is not bit-exact")
    del res_k, res_r, res_c, state_c

    # (d) the full sequence without diagnostics, insertion included: the
    # benchmark's SLAM row (tools/bench.bench_slam), whose schedule is the
    # slam driver's config, after its warm-up segment on a throwaway copy
    reset_counts()
    slam_row = bench.bench_slam(prob, SLAM_IBK, dev)
    launches_d = read_counts()
    check(slam_row["cfg"] == cfg, "bench_slam's config is not the slam "
          "driver's")
    err_d, graph = slam_row.pop("final_err_px"), slam_row.pop("graph")
    res_state = slam_row.pop("state")
    del slam_row["cfg"]
    slam_row["final_err_px"] = err_d
    print(f"[slam] (d) {prob.n_keyframes} keyframes x {SLAM_IBK} sweeps "
          f"(tools/bench.bench_slam): {slam_row['seconds']:.2f} s, "
          f"{slam_row['sweeps_per_sec']:.1f} sweeps/s incl. insertion; final "
          f"error {err_d:.6f} px (guard < 3.0; the JAX package at this shape "
          f"and cadence on a CPU: {JAX_SLAM_FINAL_ERR} px, scripts/"
          f"slam_reference_error.py); {slam_row['accel_steps']} accelerator "
          f"steps in the run; launches {launches_d} over bench_slam's warm-up "
          f"segment ({SLAM_IBK} sweeps) and the run ({n_sweeps_all} sweeps) "
          f"({card})")
    check(np.isfinite(err_d) and err_d < 3.0, "SLAM (d): final error guard")
    n_d = n_sweeps_all + SLAM_IBK
    check(launches_d["sweep"] == n_d and launches_d["table"] >= n_d
          and launches_d["reduce"] >= 2 * n_d
          and launches_d["sweep_planes"] == 0 and launches_d["gather"] == 0,
          "SLAM (d) did not go through H1, H2, H3 every sweep")
    # the sweep alone (accelerator off), with and without diagnostics
    s, c0 = res_state, dataclasses.replace(cfg, accel_every=0)
    rates = {}
    for diags in (False, True):
        gbp.run_gbp(s, graph, c0, 2, with_diagnostics=diags,
                    iter_offset=2 * c0.steps)
        rates[diags] = cuda_ms(lambda: gbp.run_gbp(
            s, graph, c0, SLAM_TIMED, with_diagnostics=diags,
            iter_offset=2 * c0.steps), 1) / SLAM_TIMED
    print(f"[slam] (d) anneal-free sweeps on the full graph, accelerator "
          f"off: {rates[False]:.4f} ms/sweep without diagnostics, "
          f"{rates[True]:.4f} with per-sweep diagnostics ({card})")
    host, events, one = telemetry_host_us(s, graph, cfg)
    print(f"[diag] fr1desk shape ({graph.n_edges} padded edges): "
          f"{rates[False]:.4f} ms/sweep without diagnostics, "
          f"{rates[True]:.4f} with them (+{rates[True] - rates[False]:.4f}"
          f"); H6 as run_gbp launches it (set up once a solve) {host:.2f} "
          f"us a call by the host clock, {events:.2f} us by events back to "
          f"back; set up per call (edge_sums) {one:.2f} us by events "
          f"({card})")
    del res_state, s

    # (e) the slam driver in process, and its resume from the final
    # checkpoint
    bal, traj = (os.path.join(tmp, "fr1desk_shape.txt"),
                 os.path.join(tmp, "t.txt"))
    balio.save_bal(bal, raw)
    base = ["--bal_file", bal, "--ltn", str(LMK_NOISE),
            "--iters_between_kfs", str(SLAM_DRIVER_IBK), "--polish"]

    def drive(*argv):
        out, err = io.StringIO(), io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = slam_driver.main(base + list(argv))
        counts = read_counts()
        lines = [ln for ln in out.getvalue().splitlines()
                 if ln.startswith("iter")]
        err = err.getvalue()
        for ln in err.splitlines():
            if not ln.startswith("-- keyframe"):
                print(f"[slam]   {ln}")
        print(f"[slam]   exit {rc}, {len(lines)} iteration lines, "
              f"{len(re.findall('inserted', err))} insertions; launches "
              f"{counts}")
        check(rc == 0, "slam driver failed")
        return lines, err, counts

    n_e = (raw.n_keyframes - 1) * SLAM_DRIVER_IBK
    lines1, err1, launches_e = drive("--save_traj", traj, "--checkpoint",
                                     ckpt)
    check(len(lines1) == n_e and launches_e["sweep"] == n_e
          and launches_e["table"] >= n_e and launches_e["reduce"] >= 2 * n_e,
          "slam driver did not go through H1, H2, H3 every sweep")
    with open(traj) as f:
        traj1 = f.read()
    _, err2, _ = drive("--save_traj", traj, "--resume", ckpt)
    with open(traj) as f:
        same_traj = f.read() == traj1
    steady = float(err1.split("steady-state ")[1].split()[0])
    # the driver's problem (the BAL file's rounding, the same noise)
    prob_e = priors.apply_init_noise(
        balio.load_bal(bal), InitConfig(lmk_noise=LMK_NOISE, seed=0))
    res_e, _, wall_e = run(cfg, None, ibk=SLAM_DRIVER_IBK, diags=False,
                           problem=prob_e,
                           g=build_graph(prob_e, cfg, dev))
    print(f"[slam] (e) driver: resumed from the final checkpoint "
          f"(keyframe {raw.n_keyframes}), the same trajectory: {same_traj}; "
          f"steady state {steady} sweeps/s with per-sweep diagnostics; "
          f"the same solve without diagnostics {n_e / wall_e:.1f} sweeps/s "
          f"(with them at {steady / (n_e / wall_e):.1%} of it) ({card})")
    check(same_traj and f"at keyframe {raw.n_keyframes}" in err2,
          "slam driver: resumed trajectory differs")
    del res_e
    final_e = float(err1.split("final reprojection error: ")[1].split()[0])
    return ([launches_a, launches_c, launches_d, launches_e],
            h1_err, h4_err, h6_err, final_e, slam_row)


def state_to(state, device):
    """A copy of a solver state on ``device`` (states held between phases
    wait on the host)."""
    return type(state)(**{f.name: getattr(state, f.name).to(device,
                                                              copy=True)
                          for f in dataclasses.fields(state)})


def utils_phase(held, bal, dev, reset_counts, read_counts, card):
    """Phase 13: the library around the solver on the states and the file
    earlier phases left (see the module docstring, (a)-(f)). Returns (the
    launch counts of (a), H3's largest difference from plain in (a))."""
    import contextlib
    import io
    import os

    import numpy as np
    import torch

    from gbp_poplar_tpu_torch.core import factor_graph as fg
    from gbp_poplar_tpu_torch.core import gbp
    from gbp_poplar_tpu_torch.native import balio_native
    from gbp_poplar_tpu_torch.ops import planes, reduce_kernel
    from gbp_poplar_tpu_torch.utils import analysis, balio, debug, evaluation

    t_phase = time.perf_counter()
    prob_l, graph_l, host_l, cfg_l = held["ladybug"]
    graph_v, host_v, cfg_v = held["venice"]
    cases = (("Ladybug after initialise", graph_l, state_to(host_l, dev),
              cfg_l),
             ("Venice after initialise + 20 sweeps", graph_v,
              state_to(host_v, dev), cfg_v))

    # (a) weaken_priors through H3, against kernels="reference"
    reset_counts()
    weak = [gbp.weaken_priors(dataclasses.replace(st), g, c)
            for _, g, st, c in cases]
    launches = read_counts()
    check(launches == {"sweep": 0, "table": 0, "reduce": 4,
                       "sweep_planes": 0, "gather": 0, "diag": 0,
                       "coarse": 0, "cost": 0},
          "(a) weaken_priors did not go through H3 once per kind")
    h3_err = 0.0
    for (label, g, st, c), wk in zip(cases, weak):
        wr = gbp.weaken_priors(dataclasses.replace(st), g,
                               dataclasses.replace(c, kernels="reference"))
        bits = all(torch.equal(getattr(wk, f), getattr(wr, f)) for f in
                   ("cam_prior", "lmk_prior", "cam_weaken", "lmk_weaken"))
        rels = []
        for bel, ref, rows, seg, prior in (
                (wk.cam_bel, wr.cam_bel, wk.pk[54:81], g.cam_seg,
                 wk.cam_prior),
                (wk.lmk_bel, wr.lmk_bel, wk.pk[81:90], g.lmk_seg,
                 wk.lmk_prior)):
            scale = reduce_kernel.segment_sum(rows.abs(), seg, prior.abs(),
                                              reference=True)
            diff = (bel - ref).abs()
            h3_err = max(h3_err, diff.max().item())
            rels.append((diff / (scale + 1e-30)).max().item())
        live = (int((st.cam_weaken > 0).sum()),
                int((st.lmk_weaken > 0).sum()))
        plan = g.cam_seg.plan
        how = ("one pass" if plan is None else f"two passes, "
               f"{plan.n_chunks} chunks, {plan.n_runs} runs")
        print(f"[utils] (a) weaken_priors, {label} (camera sums: {how}): "
              f"{live[0]} cameras and {live[1]} landmarks weakened; priors "
              f"and flags bit-identical to kernels=\"reference\": {bits}; "
              f"beliefs max |H3 - plain| relative to sum |terms| cam "
              f"{rels[0]:.3e}, lmk {rels[1]:.3e} (bound {REDUCE_RTOL})")
        check(bits and max(rels) <= REDUCE_RTOL,
              f"(a) weaken_priors, {label}: kernels and reference differ")
    print(f"[utils] (a) launches {launches}")
    del weak, cases
    torch.cuda.empty_cache()

    # (b) recenter_priors on the card against a CPU copy, at means moved
    # from the priors' own by N(0, 1 cm) (float64, as another solver's)
    rng = np.random.default_rng(15)
    new_mu = [m + rng.normal(0, 0.01, m.shape)
              for m in (prob_l.cam_means, prob_l.lmk_means)]
    on_card = gbp.recenter_priors(state_to(host_l, dev), *new_mu)
    on_cpu = gbp.recenter_priors(dataclasses.replace(host_l), *new_mu)
    gaps = [(getattr(on_card, f).cpu() - getattr(on_cpu, f)).abs().max()
            .item() for f in ("cam_prior", "lmk_prior")]
    bits = all(torch.equal(getattr(on_card, f).cpu(), getattr(on_cpu, f))
               for f in ("cam_prior", "lmk_prior"))
    moved = not torch.equal(on_cpu.cam_prior, host_l.cam_prior)
    print(f"[utils] (b) recenter_priors at new float64 means: "
          f"card and CPU bit-identical: {bits} (max |gap| cam "
          f"{gaps[0]:.3e}, lmk {gaps[1]:.3e}; tolerance 0); prior etas "
          f"moved: {moved}")
    check(bits and moved, "(b) recenter_priors: card and CPU differ")
    del on_card, on_cpu

    # (c) known-bad associations at the Ladybug shape
    s = state_to(host_l, dev)
    ids = np.random.default_rng(13).choice(prob_l.n_edges, UTILS_BAD_IDS,
                                           replace=False)
    mask = torch.as_tensor(fg.bad_edge_mask(prob_l, ids, cfg_l), device=dev)
    empty = torch.as_tensor(fg.bad_edge_mask(prob_l, [], cfg_l), device=dev)
    err, cost = gbp.reprojection_error(s, graph_l)
    err_e, cost_e = gbp.reprojection_error(s, graph_l, empty)
    m_all = gbp.map_cost(s, graph_l, cfg_l)
    m_e = gbp.map_cost(s, graph_l, cfg_l, empty)
    same_empty = (torch.equal(err, err_e) and torch.equal(cost, cost_e)
                  and torch.equal(m_all, m_e))
    err_b, cost_b = gbp.reprojection_error(s, graph_l, mask)
    # the MAP cost's data term, with the priors zeroed so that their
    # quadratic (~1e9 here) does not swamp the masked edges in float32
    s0 = dataclasses.replace(s, cam_prior=torch.zeros_like(s.cam_prior),
                             lmk_prior=torch.zeros_like(s.lmk_prior))
    m_data = gbp.map_cost(s0, graph_l, cfg_l)
    m_b = gbp.map_cost(s0, graph_l, cfg_l, mask)
    cam_mu, lmk_mu = analysis.belief_means(s)
    o_err, _ = evaluation.numpy_reprojection_error(
        cam_mu, lmk_mu, prob_l, bad_associations=ids)
    gap = abs(o_err - err_b.item())
    print(f"[utils] (c) {int(mask.sum())} edges marked bad of "
          f"{graph_l.n_edges}: an empty mask gives the unmasked error, "
          f"cost and MAP cost to the bit: {same_empty}; masked error "
          f"{err_b.item():.6f} px (unmasked {err.item():.6f}), host oracle "
          f"{o_err:.6f} (|gap| {gap:.2e}, bound {BAD_ORACLE_PX}); "
          f"0.5 sum |r|^2 {cost_b.item():.6e} masked < {cost.item():.6e}; "
          f"MAP data term {m_b.item():.6e} masked < {m_data.item():.6e}")
    check(same_empty and gap < BAD_ORACLE_PX and m_b < m_data
          and cost_b < cost, "(c) the bad-association mask")
    del s0

    # two consecutive sweeps' states for (d) and (e)
    prev = gbp.gbp_sweep(s, graph_l, cfg_l).clone()
    cur = gbp.gbp_sweep(s, graph_l, cfg_l)
    prev_cpu, cur_cpu = state_to(prev, "cpu"), state_to(cur, "cpu")

    # (d) dump_edge on the card against the CPU copy
    n_real = prob_l.n_edges
    edges = [0, 1, *np.random.default_rng(14).choice(n_real, 2).tolist(),
             n_real - 1]
    for e in edges:
        a = debug.dump_edge(cur, graph_l, e)
        b = debug.dump_edge(cur_cpu, graph_l, e)
        check(list(a) == list(b), "(d) dump_edge keys")
        for k, v in b.items():
            ok = type(a[k]) is type(v) and (
                np.array_equal(a[k], v, equal_nan=True)
                and a[k].dtype == v.dtype
                if isinstance(v, np.ndarray) else a[k] == v)
            check(ok, f"(d) dump_edge edge {e}: {k} differs")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        debug.print_edge(cur, graph_l, edges[2])
    lines = out.getvalue().splitlines()
    print(f"[utils] (d) dump_edge of edges {edges}: card equal to the CPU "
          f"copy in every field, to the bit; print_edge: {len(lines)} lines,"
          f" the first: {lines[0]}")

    # (e) KL helpers between the two sweeps' states, card against CPU
    t0 = time.perf_counter()
    kl_card = analysis.message_kl_trace(prev, cur)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    kl_cpu = analysis.message_kl_trace(prev_cpu, cur_cpu)
    t_cpu = time.perf_counter() - t0
    for side in ("to_cam", "to_lmk"):
        a, b = kl_card[side], kl_cpu[side]
        check(a.shape == b.shape == (graph_l.n_edges,), "(e) trace shape")
        flips = int((np.isfinite(a) != np.isfinite(b)).sum())
        print(f"[utils] (e) message_kl_trace {side}: finite on "
              f"{int(np.isfinite(a).sum())} of {a.shape[0]} edges on the "
              f"card, "
              f"{int(np.isfinite(b).sum())} on the CPU (differing on "
              f"{flips}, bound {SWEEP_FLIP_FRAC:g} of edges): a message's "
              f"precision has rank 2, so the KL is undefined where its "
              f"float32 rounding outweighs eps = 1e-6")
        check(flips <= SWEEP_FLIP_FRAC * a.shape[0] + 1,
              f"(e) message_kl_trace {side}: card and CPU differ")
    print(f"[utils] (e) message_kl_trace at {graph_l.n_edges} edges: card "
          f"{t_card:.3f} s, CPU {t_cpu:.3f} s")
    def bel_kl(a, b, kind, d, dtype=torch.float32):
        """symmetric_kl of one kind's beliefs in states a and b."""
        ga = [getattr(a, f"{kind}_{x}").to(dtype) for x in ("eta", "lam")]
        gb = [getattr(b, f"{kind}_{x}").to(dtype) for x in ("eta", "lam")]
        return analysis.symmetric_kl(
            ga[0].T, planes.unpack_sym_dense(ga[1], d),
            gb[0].T, planes.unpack_sym_dense(gb[1], d))

    for label, kind, d in (("cameras", "cam", 6), ("landmarks", "lmk", 3)):
        k_card = bel_kl(prev, cur, kind, d).cpu().double()
        k_cpu = bel_kl(prev_cpu, cur_cpu, kind, d).double()
        k_64 = bel_kl(prev_cpu, cur_cpu, kind, d, torch.float64)
        own = (k_cpu - k_64).abs().max().item()
        gap = (k_card - k_cpu).abs().max().item()
        finite = bool(torch.isfinite(k_card).all())
        print(f"[utils] (e) symmetric_kl of the {label}' beliefs between "
              f"the two sweeps: every value finite: {finite}; median "
              f"{k_64.median().item():.3e}; max |card - CPU| {gap:.3e} "
              f"(bound {KL_GAP_FACTOR:g} x float32's own max gap to "
              f"float64, {own:.3e})")
        check(finite and gap <= KL_GAP_FACTOR * own + 1e-30,
              f"(e) belief KL of the {label}: card and CPU differ")
    del s, prev, cur, prev_cpu, cur_cpu

    # (f) the native BAL parser on phase 10's file
    calls = balio_native.load.calls
    t0 = time.perf_counter()
    nat = balio.load_bal(bal)
    t_nat = time.perf_counter() - t0
    native_taken = balio_native.load.calls == calls + 1
    t0 = time.perf_counter()
    ref = balio.load_bal(bal, use_native=False)
    t_np = time.perf_counter() - t0
    check((nat.n_keyframes, nat.n_points, nat.n_edges)
          == (ref.n_keyframes, ref.n_points, ref.n_edges)
          and np.array_equal(nat.cam_idx, ref.cam_idx)
          and np.array_equal(nat.lmk_idx, ref.lmk_idx),
          "(f) native and NumPy parses differ in sizes or indices")
    for f in ("measurements", "cam_means", "lmk_means", "k"):
        np.testing.assert_allclose(getattr(nat, f), getattr(ref, f),
                                   err_msg=f"(f) {f}")
    bits = all(np.array_equal(getattr(nat, f), getattr(ref, f)) for f in
               ("measurements", "cam_means", "lmk_means", "k"))
    print(f"[utils] (f) {os.path.getsize(bal) / 2**20:.1f} MiB BAL file, "
          f"{nat.n_edges} edges: load_bal took the native path: "
          f"{native_taken}; native {t_nat:.3f} s, NumPy "
          f"(use_native=False) {t_np:.3f} s ({t_np / t_nat:.1f} x); equal "
          f"problems (values to the bit: {bits}) ({card})")
    check(native_taken, "(f) load_bal did not take the native path")
    print(f"[utils] phase 13 in {time.perf_counter() - t_phase:.1f} s")
    return launches, h3_err


def kernel_wrappers() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from gbp_poplar_tpu_torch.ops import coarse_kernel, cost_kernel
    from gbp_poplar_tpu_torch.ops import diag_kernel, reduce_kernel
    from gbp_poplar_tpu_torch.ops import sweep_kernel, table_kernel

    return {"sweep": sweep_kernel.sweep, "table": table_kernel.build_tables,
            "reduce": reduce_kernel.segment_sum,
            "sweep_planes": sweep_kernel.sweep_planes,
            "gather": reduce_kernel.gather, "diag": diag_kernel.edge_sums,
            "coarse": coarse_kernel.coarse_edge_blocks,
            "cost": cost_kernel.cost_sums}


def reset_kernel_counts() -> None:
    import torch

    torch.cuda.synchronize()
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_kernel_counts() -> dict:
    import torch

    torch.cuda.synchronize()
    return {k: fn.launches for k, fn in kernel_wrappers().items()}


def perturbed_problem(shape):
    """``synthetic_problem_large(*shape)``, landmarks perturbed by
    LMK_NOISE (seed 0), as phases 3-4, 9-10 and 12 build theirs."""
    from gbp_poplar_tpu_torch.config import InitConfig
    from gbp_poplar_tpu_torch.utils import balio, priors

    return priors.apply_init_noise(balio.synthetic_problem_large(*shape),
                                   InitConfig(lmk_noise=LMK_NOISE, seed=0))


def ladybug_problem():
    """The Ladybug-shape problem of phases 3-4 and 9-10."""
    return perturbed_problem(LADYBUG_SHAPE)


def map_placement(graph, n: int):
    """(order, dest) of the real edges in a landmark partition over ``n``
    ranks, worked out here apart from parallel/map_sharding.py: edge
    ``order[i]`` of the graph sits at column ``dest[i]`` of the
    partitioned layout (blocks of equal landmark ranges, the edges of each
    in their graph order, every block as long as the largest)."""
    import numpy as np

    from gbp_poplar_tpu_torch import parallel

    cam, lmk = graph.cam_idx.cpu().numpy(), graph.lmk_idx.cpu().numpy()
    lmk = lmk[:parallel.real_edge_count(cam, lmk)]
    shard = np.minimum(lmk // -(-graph.n_points // n), n - 1)
    counts = np.bincount(shard, minlength=n)
    order = np.argsort(shard, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)])
    dest = (shard[order] * counts.max() + np.arange(len(lmk))
            - starts[shard[order]])
    return order, dest


def nccl_rank(rank):
    """Phase 14 (a), the one NCCL rank (this process): the edge-sharded
    solver at the Ladybug shape, initialise + SHARD_NCCL_SWEEPS sweeps;
    then the times of ``one_rank_times``. Returns (state, diagnostics,
    launch counts, times)."""
    from gbp_poplar_tpu_torch import parallel
    from gbp_poplar_tpu_torch.config import GBPConfig
    from gbp_poplar_tpu_torch.core import build_graph, init_state

    prob = ladybug_problem()
    cfg = GBPConfig(accel_every=0, coarse_groups=0)
    solver = parallel.make_sharded_solver(rank.group, cfg)
    g, s = solver.prepare(build_graph(prob, cfg, rank.device),
                          init_state(prob, cfg, rank.device))
    reset_kernel_counts()
    s = solver.initialise(s, g)
    s, diag = solver.run(s, g, SHARD_NCCL_SWEEPS)
    counts = read_kernel_counts()
    return s, diag, counts, one_rank_times(rank, prob, cfg, s.clone(), g)


def one_rank_times(rank, prob, cfg, s_edge, g_edge) -> dict:
    """Phase 14 (a)'s times at world size 1, ms per sweep over
    SHARD_TIMED_SWEEPS anneal-free sweeps without diagnostics (``paced_ms``
    readings, then ``busy_ms``): one device without a process group, the
    edge-sharded solver (``s_edge``, ``g_edge``: its block after initialise
    + sweeps) and the map-sharded one, in the order one, edge, map, map,
    edge, one; then, per call, the all-reduce of each mode's per-sweep sums
    alone (edge: 27 C + 9 L floats; map: 27 C), in the order edge, map,
    map, edge."""
    import torch

    from gbp_poplar_tpu_torch import parallel
    from gbp_poplar_tpu_torch.core import build_graph, comm, gbp, init_state
    from gbp_poplar_tpu_torch.tools import bench_scaling, paced_ms

    dev, group = rank.device, rank.group
    off = 2 * cfg.steps
    g1 = build_graph(prob, cfg, dev)
    s1 = gbp.initialise(init_state(prob, cfg, dev), g1, cfg)
    msolver = parallel.make_map_sharded_solver(group, cfg)
    g_map, s_map = msolver.prepare(build_graph(prob, cfg, dev),
                                   init_state(prob, cfg, dev))
    s_map = msolver.initialise(s_map, g_map)
    runs = {"one": lambda: gbp.run_gbp(s1, g1, cfg, SHARD_TIMED_SWEEPS,
                                       with_diagnostics=False,
                                       iter_offset=off),
            "edge": lambda: gbp.run_gbp(s_edge, g_edge, cfg,
                                        SHARD_TIMED_SWEEPS,
                                        with_diagnostics=False,
                                        iter_offset=off, group=group),
            "map": lambda: gbp.run_gbp(s_map, g_map, cfg, SHARD_TIMED_SWEEPS,
                                       with_diagnostics=False,
                                       iter_offset=off, group=group,
                                       lmk_sharded=True)}
    out = {}
    for k in ("one", "edge", "map", "map", "edge", "one"):
        host, events = paced_ms(runs[k], 1, dev)
        out.setdefault(k, []).append(
            (host / SHARD_TIMED_SWEEPS, events / SHARD_TIMED_SWEEPS))
    for k, fn in runs.items():
        out[f"busy {k}"] = busy_ms(fn, 1) / SHARD_TIMED_SWEEPS
    payload = {"edge": [(27, g_edge.n_keyframes), (9, g_edge.n_points)],
               "map": [(27, g_map.n_keyframes)]}
    sums = {k: [torch.ones(sh, device=dev) for sh in v]
            for k, v in payload.items()}
    for k in ("edge", "map", "map", "edge"):
        out.setdefault(f"reduce {k}", []).append(
            bench_scaling.all_reduce_ms(group, sums[k], dev))
    for k in payload:
        out[f"busy reduce {k}"] = busy_ms(
            lambda: comm.all_sum(group, sums[k]),
            bench_scaling.ALL_REDUCE_REPS)
    out["bytes"] = {k: 4 * sum(a * b for a, b in v)
                    for k, v in payload.items()}
    return out


def busy_ms(fn, reps: int) -> float:
    """Device time (ms) per call of ``fn()`` over ``reps`` calls after a
    warm-up call: every kernel, copy and fill the profiler saw, summed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(ev.device_time_total for ev in prof.key_averages()) / reps / 1e3


def edge_shard_rank(rank):
    """Phase 14 (b), one of two gloo ranks sharing the card: the Ladybug
    shape edge-sharded and the fr1desk shape map-sharded; initialise + one
    sweep of each pipeline in each (rank 0, this process, keeps the
    gathered states on the card), then the ba driver's config for
    SHARD_SWEEPS sweeps edge-sharded; then the time of the per-sweep
    all-reduce at this shape and at the fr1desk shape's camera sums.
    Returns a dict; a spawned rank's is pickled, so it holds no state."""
    import torch

    from gbp_poplar_tpu_torch import parallel
    from gbp_poplar_tpu_torch.config import GBPConfig
    from gbp_poplar_tpu_torch.core import build_graph, comm, gbp, init_state

    prob = ladybug_problem()
    dev = rank.device
    out = {"device": str(dev)}

    def telemetry(mode, fused, s, g, cfg):
        """The five sums over both ranks' edges, by H6 and by the plain
        version (each rank's sums, then one float64 all-reduce)."""
        ref = dataclasses.replace(cfg, kernels="reference")
        sums = [gbp._diag_sums(s, g, c, group=rank.group).cpu()
                for c in (cfg, ref)]
        if rank.rank == 0:
            out[("diag", mode, fused)] = sums

    reset_kernel_counts()
    for fused in (True, False):
        cfg = GBPConfig(accel_every=0, coarse_groups=0, fused=fused)
        graph = build_graph(prob, cfg, dev)
        n_edges = graph.n_edges
        solver = parallel.make_sharded_solver(rank.group, cfg)
        g, s = solver.prepare(graph, init_state(prob, cfg, dev))
        del graph
        out["block"] = g.n_edges
        s = solver.sweep(solver.initialise(s, g), g)
        telemetry("edge", fused, s, g, cfg)
        full = solver.gather(s, n_edges)
        if rank.rank == 0:
            out[fused] = full
        del g, s, full
    slam_prob = perturbed_problem(SLAM_SHAPE)
    for fused in (True, False):
        cfg = GBPConfig(accel_every=0, coarse_groups=0, fused=fused)
        solver = parallel.make_map_sharded_solver(rank.group, cfg)
        g, s = solver.prepare(build_graph(slam_prob, cfg, dev),
                              init_state(slam_prob, cfg, dev))
        s = solver.sweep(solver.initialise(s, g), g)
        telemetry("map", fused, s, g, cfg)
        full = solver.gather(s)
        if rank.rank == 0:
            out[("map", fused)] = full
        del g, s, full
    cfg = GBPConfig(coarse_groups=COARSE_GROUPS)
    solver = parallel.make_sharded_solver(rank.group, cfg)
    g, s = solver.prepare(build_graph(prob, cfg, dev),
                          init_state(prob, cfg, dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = solver.initialise(s, g)
    s, diag = solver.run(s, g, SHARD_SWEEPS)
    out["err"] = diag.reproj_err.cpu().numpy()
    torch.cuda.synchronize()
    out["wall"] = time.perf_counter() - t0
    out["counts"] = read_kernel_counts()
    out["allreduce_ms"] = {}
    for label, shapes in (("ladybug", [(27, g.n_keyframes), (9, g.n_points)]),
                          ("fr1desk", [(27, SLAM_SHAPE[0])])):
        ts = [torch.ones(sh, device=dev) for sh in shapes]
        comm.all_sum(rank.group, ts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SHARD_TIMED):
            comm.all_sum(rank.group, ts)
        torch.cuda.synchronize()
        out["allreduce_ms"][label] = ((time.perf_counter() - t0)
                                      / SHARD_TIMED * 1e3,
                                      4 * sum(a * b for a, b in shapes))
    return out


def slam_driver_rank(rank, argv):
    """Phase 14 (c), one rank of the slam driver at --devices 2: what
    ``drivers.slam.main`` runs on each rank, with the rank's launch counts
    around it. Returns (exit code, counts, stdout, stderr); only rank 0
    prints."""
    import contextlib
    import io

    from gbp_poplar_tpu_torch.drivers import slam as slam_driver

    args = slam_driver.build_parser().parse_args(argv)
    out, err = io.StringIO(), io.StringIO()
    reset_kernel_counts()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = slam_driver._rank_main(rank, args)
    return rc, read_kernel_counts(), out.getvalue(), err.getvalue()


def shard_phase(dev, card, coarse_err, slam_e_err):
    """Phase 14: the sharded solvers on the card (``[shard]`` lines; see the
    module docstring). Returns the launch counts of its main paths, one
    dict per rank and run."""
    import contextlib
    import io
    import os
    import tempfile

    import numpy as np
    import torch

    from gbp_poplar_tpu_torch import parallel
    from gbp_poplar_tpu_torch.config import GBPConfig
    from gbp_poplar_tpu_torch.core import build_graph, factor_graph as fg
    from gbp_poplar_tpu_torch.core import gbp, init_state
    from gbp_poplar_tpu_torch.drivers import slam as slam_driver
    from gbp_poplar_tpu_torch.ops import reduce_kernel
    from gbp_poplar_tpu_torch.utils import balio

    t_phase = time.perf_counter()
    launches = []

    def on_card(counts, what):
        check(counts["sweep"] + counts["sweep_planes"] > 0
              and counts["table"] + counts["gather"] > 0
              and counts["reduce"] > 0 and counts["diag"] > 0,
              f"{what}: a rank did not launch H1/H4, H2/H5, H3 and H6")

    # (a) NCCL at world size 1 against the single-device run, to the bit
    (s, diag, counts, times), = parallel.run(nccl_rank, 1,
                                             device_type="cuda")
    on_card(counts, "(a)")
    launches.append(counts)
    prob = ladybug_problem()
    cfg = GBPConfig(accel_every=0, coarse_groups=0)
    graph = build_graph(prob, cfg, dev)
    s1 = gbp.initialise(init_state(prob, cfg, dev), graph, cfg)
    s1, diag1 = gbp.run_gbp(s1, graph, cfg, SHARD_NCCL_SWEEPS)
    bits = all(same(getattr(s, f).float(), getattr(s1, f).float())
               for f in ("pk", "damping_count", "robust", "cam_bel",
                         "lmk_bel"))
    bits = bits and all(same(a, b) for a, b in zip(diag, diag1)
                        if a is not None)
    print(f"[shard] (a) NCCL, world size 1, {graph.n_edges} edges: "
          f"initialise + {SHARD_NCCL_SWEEPS} sweeps equal to the "
          f"single-device run to the bit (state and diagnostics): {bits}; "
          f"error {diag.reproj_err[-1].item():.6f} px; launches {counts}")
    check(bits, "(a) NCCL at world size 1 differs from one device")
    del s, diag, s1, diag1

    def readings(k):
        return (" / ".join(f"{ev:.4f}" for _, ev in times[k])
                + " (host issue " + " / ".join(f"{h:.4f}" for h, _ in
                                               times[k])
                + f"; device busy {times['busy ' + k]:.4f})")

    print(f"[shard] (a) ms/sweep without diagnostics by events, "
          f"{SHARD_TIMED_SWEEPS} sweeps a reading in the order one, edge, "
          f"map, map, edge, one: one device (no process group) "
          f"{readings('one')}, edge-sharded {readings('edge')}, "
          f"map-sharded {readings('map')} (NCCL at world size 1; {card})")
    print(f"[shard] (a) the all-reduce alone, ms a call, in the order edge, "
          f"map, map, edge: edge's {times['bytes']['edge']} B "
          f"{readings('reduce edge')}, map's {times['bytes']['map']} B "
          f"{readings('reduce map')} (NCCL at world size 1, timed by "
          f"tools/bench_scaling.all_reduce_ms as phase 16 (f)'s latency; "
          f"{card})")
    check(all(np.isfinite(v).all() for k, v in times.items()
              if k != "bytes"), "(a) a time is not finite")

    # (b) gloo, two ranks sharing the card, edge-sharded
    t0 = time.perf_counter()
    res = parallel.run(edge_shard_rank, 2, device_type="cuda")
    wall_b = time.perf_counter() - t0
    for r, out in enumerate(res):
        on_card(out["counts"], f"(b) rank {r}")
        check(out["device"].startswith("cuda"), "(b) a rank off the card")
        launches.append(out["counts"])
    print(f"[shard] (b) gloo, 2 ranks on {res[0]['device']} and "
          f"{res[1]['device']}, {res[0]['block']} edges a rank; launches "
          f"rank 0 {res[0]['counts']}, rank 1 {res[1]['counts']}; "
          f"{wall_b:.1f} s with the spawned rank's start")
    def first_sweep(mode, problem, fused, pick):
        """The two ranks' initialise + one sweep (``pick``: the gathered
        edge and landmark columns in the single-device graph's order)
        against the single-device sweep."""
        c = GBPConfig(accel_every=0, coarse_groups=0, fused=fused)
        g = build_graph(problem, c, dev)
        s1 = gbp.gbp_sweep(gbp.initialise(init_state(problem, c, dev), g, c),
                           g, c)
        got = res[0][fused if mode == "edge" else (mode, fused)]
        cols, ref_cols, n_l = pick(g)
        bits = all(same(getattr(got, f)[..., cols].float(),
                        getattr(s1, f)[..., ref_cols].float())
                   for f in ("pk", "damping_count", "robust", "active"))
        rels = []
        for bel, prior, seg, rows in (
                ("cam_bel", s1.cam_prior, g.cam_seg, fg.MSG_CAM_ROWS),
                ("lmk_bel", s1.lmk_prior, g.lmk_seg, fg.MSG_LMK_ROWS)):
            scale = reduce_kernel.segment_sum(
                s1.pk[rows[0]:rows[1]].abs(), seg, prior.abs(),
                reference=True)
            gap = (getattr(got, bel)[:, :n_l if bel == "lmk_bel" else None]
                   - getattr(s1, bel)).abs()
            rels.append((gap / (scale + 1e-30)).max().item())
        label = (f"{mode}-sharded, "
                 + ("fused (H2 + H1)" if fused else "unfused (H5 + H4)"))
        print(f"[shard] (b) {label}, {g.n_edges} edges: initialise + one "
              f"sweep, edge fields bit-identical to the single-device "
              f"sweep: {bits}; beliefs max |2 ranks - 1| relative to sum "
              f"|terms| cam {rels[0]:.3e}, lmk {rels[1]:.3e} (bound "
              f"{REDUCE_RTOL})")
        check(bits and max(rels) <= REDUCE_RTOL,
              f"(b) {label}: the sharded sweep differs")
        # the telemetry over both ranks (H6 on each rank's tables, then the
        # all-reduce) against its plain version and against one device's
        one = gbp._diag_sums(s1, g, c).cpu()
        k, r = res[0][("diag", mode, fused)]
        counts = all(same(x[[0, 3, 4]], one[[0, 3, 4]]) for x in (k, r))
        rel = max(((x[1:3] - y[1:3]).abs() / y[1:3]).max().item()
                  for x, y in ((k, r), (k, one)))
        print(f"[shard] (b) {label}: the five sums over both ranks, H6 "
              f"and plain, counts equal to one device's: {counts}; float "
              f"sums within {rel:.3e} of the plain's and one device's "
              f"(bound {REDUCE_RTOL})")
        check(counts and rel <= REDUCE_RTOL,
              f"(b) {label}: the sharded telemetry differs")

    def whole(g):
        return slice(None), slice(None), None

    def by_landmark(g):
        order, dest = map_placement(g, 2)
        return (torch.as_tensor(dest, device=dev),
                torch.as_tensor(order, device=dev), g.n_points)

    slam_prob = perturbed_problem(SLAM_SHAPE)
    for fused in (True, False):
        first_sweep("edge", prob, fused, whole)
        first_sweep("map", slam_prob, fused, by_landmark)
    err = res[0]["err"]
    gap = abs(float(err[-1]) - coarse_err)
    print(f"[shard] (b) the ba driver's config (coarse corrector over "
          f"{COARSE_GROUPS} groups, the accelerator), {SHARD_SWEEPS} sweeps:"
          f" error {err[0]:.4f} -> {err[-1]:.6f} px, phase 9's single-device "
          f"run {coarse_err:.6f} px, |gap| {gap:.6f} (bound "
          f"{SHARD_AGREE_PX}); {res[0]['wall'] / SHARD_SWEEPS * 1e3:.3f} "
          f"ms/sweep with diagnostics, two ranks contending for one card, "
          f"not a scaling number ({card})")
    check(bool(np.isfinite(err).all()) and gap <= SHARD_AGREE_PX,
          "(b) the sharded solve's final error is off the single device's")
    for label, (ms, nbytes) in res[0]["allreduce_ms"].items():
        print(f"[shard] (b) all-reduce of the per-sweep sums at the "
              f"{label} shape: {nbytes} B ({nbytes / 1e6:.2f} MB), "
              f"{ms:.3f} ms a sweep over gloo, staged through the host "
              f"({card})")
    del res
    torch.cuda.empty_cache()

    # (c) the slam driver at --devices 2: map-sharded SLAM at the fr1desk
    # shape, its checkpoint and resume
    with tempfile.TemporaryDirectory() as tmp:
        bal = os.path.join(tmp, "fr1desk.txt")
        balio.save_bal(bal, balio.synthetic_problem_large(*SLAM_SHAPE))
        ckpt = os.path.join(tmp, "c.npz")
        trajs = [os.path.join(tmp, f"t{i}.txt") for i in (1, 2)]
        base = ["--bal_file", bal, "--ltn", str(LMK_NOISE),
                "--iters_between_kfs", str(SHARD_SLAM_IBK), "--polish",
                "--devices", "2"]
        t0 = time.perf_counter()
        res = parallel.run(slam_driver_rank, 2,
                           (base + ["--save_traj", trajs[0], "--checkpoint",
                                    ckpt],), device_type="cuda")
        wall_c = time.perf_counter() - t0
        rc, _, out, err = res[0]
        for ln in err.splitlines():
            if not ln.startswith("-- keyframe"):
                print(f"[shard]   {ln}")
        lines = [ln for ln in out.splitlines() if ln.startswith("iter")]
        n_c = (SLAM_SHAPE[0] - 1) * SHARD_SLAM_IBK
        check(all(r[0] == 0 for r in res) and len(lines) == n_c,
              "(c) the slam driver at --devices 2 failed")
        for r, (_, counts, _, _) in enumerate(res):
            on_card(counts, f"(c) rank {r}")
            check(counts["sweep"] == n_c, f"(c) rank {r}: not H1 every sweep")
            launches.append(counts)
        final = float(err.split("final reprojection error: ")[1].split()[0])
        out2, err2 = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out2), \
                contextlib.redirect_stderr(err2):
            rc2 = slam_driver.main(base + ["--save_traj", trajs[1],
                                           "--resume", ckpt])
        with open(trajs[0]) as a, open(trajs[1]) as b:
            same_traj = a.read() == b.read()
        print(f"[shard] (c) slam driver, --devices 2 (map-sharded, gloo, "
              f"both ranks on the card): {SLAM_SHAPE[0]} keyframes x "
              f"{SHARD_SLAM_IBK} sweeps in {wall_c:.1f} s with the spawned "
              f"rank's start; final error {final:.5f} px (bound 3.0; phase "
              f"12 (e)'s single-device run at {SLAM_DRIVER_IBK} sweeps a "
              f"keyframe {slam_e_err:.5f} px; the new landmarks' depth is a "
              f"mean over the ranks, not a median); "
              f"launches rank 0 {res[0][1]}, rank 1 {res[1][1]}; resumed "
              f"from the final checkpoint through drivers.slam.main: exit "
              f"{rc2}, the same trajectory: {same_traj} ({card})")
        check(final < 3.0, "(c) map-sharded SLAM: final error guard")
        check(rc2 == 0 and same_traj
              and f"at keyframe {SLAM_SHAPE[0]}" in err2.getvalue(),
              "(c) the resumed trajectory differs")
    print(f"[shard] phase 14 in {time.perf_counter() - t_phase:.1f} s")
    return launches


def kernel_of(name: str) -> str | None:
    """The wrapper key (``kernel_wrappers``) of a traced kernel's name."""
    for key, part in (("sweep_planes", "sweep_planes_kernel"),
                      ("sweep", "sweep_kernel"), ("table", "table_kernel"),
                      ("reduce", "reduce_"), ("gather", "gather_kernel"),
                      ("diag", "diag_sums"), ("coarse", "coarse_blocks"),
                      ("cost", "cost_sums")):
        if part in name:
            return key
    return None


def tools_phase(dev, card, prob_v, venice_means, t_script, ev, h6_alone,
                reset_counts, read_counts):
    """Phase 15: the tools around the solver (``[tools]`` lines). (a)
    ``entry()``'s sweep on the card against ``kernels="reference"``, and
    ``dryrun_multichip(2)``; (b) ``validate_scale`` at the Ladybug shape
    (and the Venice shape, or its polish-vs-GN half on phase 6's means);
    (c) ``memory_ledger`` at the Venice shape and at BAL Final-13682's
    observation count (halved until a point runs); (d) ``profile_sweep``
    at the Ladybug shape. ``ev``: phase 3's events ms of H1 and H3;
    ``h6_alone``: phase 3's H6 device ms. Returns the launch counts."""
    import numpy as np
    import torch

    from gbp_poplar_tpu_torch import entry as entry_mod
    from gbp_poplar_tpu_torch.config import GBPConfig
    from gbp_poplar_tpu_torch.core import build_graph, gbp, init_state
    from gbp_poplar_tpu_torch.core.factor_graph import (MSG_CAM_ROWS,
                                                        MSG_LMK_ROWS)
    from gbp_poplar_tpu_torch.ops import reduce_kernel
    from gbp_poplar_tpu_torch.tools import memory_ledger as ml
    from gbp_poplar_tpu_torch.tools import profile_sweep as ps
    from gbp_poplar_tpu_torch.tools import validate_scale as vs
    from gbp_poplar_tpu_torch.utils import balio, evaluation

    t_phase = time.perf_counter()
    reset_counts()
    # (a) entry(): its sweep against the plain versions on the same state
    fn, (state, graph) = entry_mod.entry()
    check(state.pk.device == dev, "entry() did not run on cuda:0")
    sk, sr = state.clone(), state.clone()
    fn(sk, graph)
    gbp.gbp_sweep(sr, graph, GBPConfig(kernels="reference"))
    edge_same = all(torch.equal(getattr(sk, f), getattr(sr, f))
                    for f in ("pk", "damping_count", "robust"))
    bel_same = all(torch.equal(getattr(sk, f), getattr(sr, f))
                   for f in ("cam_bel", "lmk_bel"))
    bel_rel = 0.0
    for bel, rows, seg, prior in (
            ("cam_bel", MSG_CAM_ROWS, graph.cam_seg, sr.cam_prior),
            ("lmk_bel", MSG_LMK_ROWS, graph.lmk_seg, sr.lmk_prior)):
        scale = reduce_kernel.segment_sum(
            sr.pk[rows[0]:rows[1]].abs(), seg, prior.abs(), reference=True)
        diff = (getattr(sk, bel) - getattr(sr, bel)).abs()
        bel_rel = max(bel_rel, float((diff / (scale + 1e-30)).max()))
    print(f"[tools] (a) entry() on {state.pk.device}: {graph.n_edges} padded "
          f"edges; its sweep against kernels=\"reference\": edge fields "
          f"bit-identical {edge_same}, beliefs bit-identical {bel_same} "
          f"(largest difference {bel_rel:.3e} of the sum of |terms|, H3's "
          f"bound {REDUCE_RTOL})")
    check(edge_same and bel_rel <= REDUCE_RTOL,
          "entry(): the sweep differs from its plain version")
    del fn, state, graph, sk, sr
    t0 = time.perf_counter()
    ranks = entry_mod.dryrun_multichip(2)
    print(f"[tools] (a) dryrun_multichip(2) in {time.perf_counter() - t0:.1f}"
          f" s: " + "; ".join(f"rank {r} {res}"
                              for r, res in enumerate(ranks)))
    check(len(ranks) == 2 and all(r["device"].startswith(dev.type)
                                  for r in ranks), "dry run: not on the card")

    # (b) validate_scale: the JAX script's protocol
    r = vs.validate(balio.synthetic_problem_large(*LADYBUG_SHAPE),
                    TOOLS_SWEEPS, device=dev)
    for line in vs.report(r):
        print(f"[tools] (b) Ladybug: {line}")
    census_line("Ladybug", r["census"], r["polish_accepted"])
    vals = [r[k] for k in ("gbp_err", "polish_err", "gn_err", "gbp_cost",
                           "polish_cost", "gn_cost", "ate_gbp")]
    check(bool(np.isfinite(vals).all())
          and abs(r["ratio_polish"] - 1.0) <= POLISH_RATIO_TOL
          and r["ate_polish"] < POLISH_ATE_M,
          "validate_scale at Ladybug: the polish did not reach the GN "
          "optimum")
    elapsed = time.perf_counter() - t_script
    if elapsed < TOOLS_VENICE_BY_S:
        rv = vs.validate(balio.synthetic_problem_large(*VENICE_SHAPE),
                         TOOLS_SWEEPS, device=dev, census=False)
        what = "Venice"
    else:
        rv = vs.compare_to_gn(prob_v, *venice_means, device=dev,
                              census=False)
        what = (f"Venice, polish vs GN on phase 6's means (the script was "
                f"{elapsed:.0f} s in)")
    for line in vs.report(rv):
        print(f"[tools] (b) {what}: {line}")
    check(bool(np.isfinite([rv[k] for k in ("polish_err", "gn_err",
                                            "polish_cost", "gn_cost")]).all()),
          "validate_scale at Venice: non-finite result")

    # (c) memory_ledger at the Venice shape, then at BAL Final-13682's size
    torch.cuda.empty_cache()
    print(f"[tools] (c) device memory held before the ledgers "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    rl = ml.ledger(VENICE_SHAPE, production=True, device=dev)
    for line in ml.report(rl):
        print(f"[tools] (c) Venice: {line}")
    check(not rl["oom"], "memory_ledger: the Venice shape ran out of memory")
    shape = CAPACITY_SHAPE
    while True:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        prob = balio.synthetic_problem_large(*shape)
        t_gen = time.perf_counter() - t0
        # the host oracle at the generated means: the generator's own
        # consistency (0.63 px at the Ladybug shape)
        gen_err = evaluation.numpy_reprojection_error(
            prob.cam_means, prob.lmk_means, prob)[0]
        print(f"[tools] (c) capacity: synthetic_problem_large{shape} "
              f"generated in {t_gen:.1f} s; host oracle at the generated "
              f"means {gen_err:.4f} px")
        rl = ml.ledger(shape, production=True, n_sweeps=CAPACITY_SWEEPS,
                       iter_offset=0, polish_iters=CAPACITY_POLISH,
                       slice_edges=CAPACITY_SLICE, device=dev, problem=prob,
                       oracle=True)
        del prob
        for line in ml.report(rl):
            print(f"[tools] (c) capacity: {line}")
        if not rl["oom"] or shape[1] < 1000:
            break
        print(f"[tools] (c) {rl['edges']} edges ran out of memory at stage "
              f"{rl['oom']['stage']}; halving the edges")
        shape = (max(shape[0] // 2, 2 * shape[2]), shape[1] // 2, shape[2])
    check(not rl["oom"], "memory_ledger: no point ran")
    check(rl["pk_elements"] >= 2**31,
          f"memory_ledger: no point with pk past 2^31 elements ran (largest "
          f"{rl['pk_elements']} elements)")
    check(rl["slice"]["ok"], "memory_ledger: the first sweep's last edges "
          "differ from the plain sweep")
    errs = np.asarray(rl["errs"])
    # H2's means and H6's sums past 2^31 elements of pk, against float64 on
    # the host at the same means
    gap = (abs(rl["err_initialise"] - rl["oracle_initialise"])
           / rl["oracle_initialise"])
    print(f"[tools] (c) capacity: card against host oracle at the belief "
          f"means after initialise: relative difference {gap:.2e} (bound "
          f"{ORACLE_RTOL})")
    check(gap <= ORACLE_RTOL, "memory_ledger: the card's error after "
          "initialise differs from the host oracle's")
    check(bool(np.isfinite(errs).all()) and errs[-1] < rl["err_initialise"],
          "memory_ledger: the error did not fall")

    # (d) profile_sweep at the Ladybug shape: fused with and without
    # diagnostics, unfused without
    prob = balio.synthetic_problem_large(*LADYBUG_SHAPE)
    cfg = GBPConfig(accel_every=0)
    graph = build_graph(prob, cfg, dev)
    per = {}
    for label, fused, diags in (("fused", True, False),
                                ("fused with diagnostics", True, True),
                                ("unfused", False, False)):
        c = GBPConfig(accel_every=0, fused=fused)
        state = gbp.initialise(init_state(prob, c, dev), graph, c)
        rp = ps.profile_run(state, graph, c, PROFILE_SWEEPS, diags)
        for line in ps.report(rp):
            print(f"[tools] (d) Ladybug, {label}: {line}")
        sums = {}
        for name, us, _, n in rp["kernels"]:
            key = kernel_of(name)
            if key is not None:
                a, b = sums.get(key, (0.0, 0.0))
                sums[key] = (a + us, b + n)
        per[label] = sums
        print(f"[tools] (d) Ladybug, {label}: per sweep inside run_gbp "
              f"(profiler) " + ", ".join(
                  f"{k} {us:.1f} us in {n:.2f} launches"
                  for k, (us, n) in sums.items())
              + f"; device busy {rp['busy']:.1%} ({card})")
        check("sweep" in sums or "sweep_planes" in sums,
              "profile_sweep: no sweep kernel in the trace")
    launches = read_counts()
    # H5 by events on the same state, beside its time inside run_gbp
    h5_ev = cuda_ms(lambda: (reduce_kernel.gather(state.cam_bel,
                                                  graph.cam_idx),
                             reduce_kernel.gather(state.lmk_bel,
                                                  graph.lmk_idx)),
                    TIMED_SWEEPS)
    f, d, u = (per[k] for k in ("fused", "fused with diagnostics",
                                "unfused"))

    def ms(side, key, launches=1):
        """ms of ``launches`` launches of a kernel, from its mean launch in
        the trace (the per-sweep sum would miss any launch the trace
        dropped)."""
        us, n = side[key]
        return us / n * launches / 1e3

    # a belief update is 3 launches of H3 at this shape (the cameras'
    # two passes, the landmarks' one), a sweep's gathers 2 of H5
    print(f"[tools] (d) B5, the Ladybug shape: H1 inside run_gbp "
          f"{ms(f, 'sweep'):.4f} ms a launch (profiler) against "
          f"{ev['sweep']:.4f} by events alone (phase 3); H3 "
          f"{ms(f, 'reduce', 3):.4f} ms a belief update against "
          f"{ev['reduce']:.4f}; H5 {ms(u, 'gather', 2):.4f} ms a sweep "
          f"(both kinds) against {h5_ev:.4f} by events here; H4 "
          f"{ms(u, 'sweep_planes'):.4f} ms ({card})")
    print(f"[tools] (d) B6: H6 inside a sweep {ms(d, 'diag'):.4f} ms a "
          f"launch (profiler) against {h6_alone:.4f} alone (phase 3); H2 "
          f"{ms(d, 'table'):.4f} ms a launch with diagnostics, "
          f"{ms(f, 'table'):.4f} without ({card})")
    print(f"[tools] launches in phase 15 (rank 0): {launches}; phase 15 in "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def _captured(fn, *args, **kwargs):
    """(fn's result, its stdout lines, its stderr lines): a tool's human
    lines, printed by the caller under its phase's prefix."""
    import contextlib
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        r = fn(*args, **kwargs)
    return r, out.getvalue().splitlines(), err.getvalue().splitlines()


def bench_main(path: str) -> tuple[int, list, list]:
    """tools/bench.main() at its full workload on the BAL file ``path``,
    with the Ladybug and Venice rows and without the sequences' rows:
    (return code, stdout lines, stderr lines)."""
    import os

    from gbp_poplar_tpu_torch.tools import bench

    env = {"GBP_BENCH_SEQ": path, "GBP_BENCH_EXTRA": "0",
           "GBP_BENCH_SCALE": "1", "GBP_BENCH_VENICE": "1"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return _captured(bench.main)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def bench_phase(dev, card, slam_row, reset_counts, read_counts):
    """Phase 16: the measurement tools on the card (``[bench]`` lines; see
    the module docstring, (a)-(f)). ``slam_row``: phase 12 (d)'s
    bench_slam row. Returns the phase's launch counts."""
    import os
    import tempfile
    from types import SimpleNamespace

    import torch

    from gbp_poplar_tpu_torch.tools import bench_ablate, bench_scaling
    from gbp_poplar_tpu_torch.tools import bench_sweep, count_edge_ops
    from gbp_poplar_tpu_torch.tools import scaling_model
    from gbp_poplar_tpu_torch.utils import balio

    t_phase = time.perf_counter()
    reset_counts()
    # (a) the benchmark's JSON line, its headline on a synthetic file at
    # TUM fr1xyz's size (not the sequence: the row names the file)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "synthetic_%dkf_%dlmk_%dobs.txt"
                            % BENCH_TUM_SHAPE)
        balio.save_bal(path, balio.synthetic_problem_large(*BENCH_TUM_SHAPE))
        t0 = time.perf_counter()
        rc, out, err = bench_main(path)
    for ln in err:
        print(f"[bench] (a)   {ln}")
    check(rc == 0, "tools/bench.main: a guard failed")
    data = json.loads(out[-1])
    check(set(data) == {"metric", "value", "unit", "vs_baseline", "extra"},
          "tools/bench.main: the JSON line's keys")
    check({"ladybug_ms_per_sweep", "ladybug_run_gbp_ms_per_sweep",
           "venice_ns_per_edge"} <= set(data["extra"]),
          "tools/bench.main: the scale rows are missing")
    print(f"[bench] {out[-1]}")
    print(f"[bench] (a) tools/bench.main in {time.perf_counter() - t0:.1f} s"
          f" ({card})")
    torch.cuda.empty_cache()

    # (b) the SLAM row: phase 12 (d)'s run of the same function
    print(f"[bench] (b) bench_slam at the TUM fr1desk shape, {SLAM_IBK} "
          f"sweeps a keyframe (phase 12 (d)): {slam_row['sweeps_per_sec']:.1f}"
          f" sweeps/s incl. insertion, final error "
          f"{slam_row['final_err_px']:.6f} px ({slam_row['device']})")

    # (c) bench_sweep: the size ladder, then Venice's production loop
    for names, production in ((["scale"], False), (["venice"], True)):
        _, out, err = _captured(bench_sweep.bench_names, names, production,
                                dev)
        for ln in out + err:
            print(f"[bench] (c) {ln}")
    torch.cuda.empty_cache()

    # (d) the ablation at the Ladybug shape (the tools' own problem)
    prob = balio.synthetic_problem_large(*LADYBUG_SHAPE)
    r, out, err = _captured(bench_ablate.ablate, prob, "ladybug", 50, dev)
    for ln in out + err:
        print(f"[bench] (d) {ln}")
    full, raw = r["ms"]["full"], data["extra"]["ladybug_ms_per_sweep"]
    print(f"[bench] (d) full {full:.4f} ms against the raw chain's "
          f"{raw:.4f} in (a): {full / raw - 1:+.1%} ({card})")

    # (e) the operation count, and its bound beside H1's bytes bound
    r = count_edge_ops.edge_ops(device=dev)
    for ln in count_edge_ops.report(r):
        print(f"[bench] (e) {ln}")
    graph_b = SimpleNamespace(n_edges=data["extra"]["ladybug_edges"],
                              intr=None, n_keyframes=prob.n_keyframes,
                              n_points=prob.n_points)
    b_bytes, _ = least_ms(sweep_bytes(graph_b, False), (0, 0))
    pm, n_e = r["modes"]["premu"], graph_b.n_edges
    b_ops = count_edge_ops.ops_ms(pm["one"] * n_e, pm["trans"] * n_e,
                                  count_edge_ops.card_rates())
    print(f"[bench] (e) H1 at the Ladybug shape: operations bound "
          f"{b_ops:.4f} ms, bytes bound {b_bytes:.4f} ms ({card})")
    check(b_ops < b_bytes, "H1's operations bound passed its bytes bound")

    # (f) bench_scaling at the cards present (N = 1 on one card), and the
    # scaling model from (a)'s T1 and the all-reduce measured here
    for mode in bench_scaling.MODES:
        _, out, err = _captured(bench_scaling.scaling, prob, "ladybug", 100,
                                mode, dev)
        for ln in out + err:
            print(f"[bench] (f) {ln}")
    _, out, err = _captured(scaling_model.model, "ladybug", prob, raw,
                            device=dev)
    for ln in out + err:
        print(f"[bench] (f) {ln}")
    del prob
    launches = read_counts()
    print(f"[bench] launches in phase 16: {launches}; phase 16 in "
          f"{time.perf_counter() - t_phase:.1f} s")
    check(all(launches[k] > 0 for k in ("sweep", "table", "reduce",
                                        "sweep_planes", "gather")),
          "phase 16 did not launch H1-H5 on the card")
    return launches


def seq_phase(card, reset_counts, read_counts):
    """Phase 17: the sequence-level tools on the card (``[seq]`` lines;
    see the module docstring, (a)-(e)). Returns the phase's launch
    counts."""
    import math
    import os
    import tempfile

    import numpy as np
    import torch

    from gbp_poplar_tpu_torch.tools import diagnose_accuracy as da
    from gbp_poplar_tpu_torch.tools import exp_ate_grid as eg
    from gbp_poplar_tpu_torch.tools import exp_drift_phase as ed
    from gbp_poplar_tpu_torch.tools import tune_schedule as ts
    from gbp_poplar_tpu_torch.tools import validate_sequences as vs
    from gbp_poplar_tpu_torch.utils import balio

    def finite(*xs) -> bool:
        return all(math.isfinite(float(x)) for x in xs)

    def show(part, lines):
        for ln in lines:
            print(f"[seq] ({part}) {ln}")

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    paths = {}
    for shape in SEQ_SHAPES:
        paths[shape] = os.path.join(tmp.name, "synthetic_%dkf_%dlmk_%dobs.txt"
                                    % shape)
        balio.save_bal(paths[shape], perturbed_problem(shape))
    desk, xyz = paths[SLAM_SHAPE], paths[BENCH_TUM_SHAPE]
    reset_counts()

    # (a) validate_sequences: GBP, the GN oracle and SLAM per file
    for shape, path in paths.items():
        t0 = time.perf_counter()
        r, out, err = _captured(vs.run_sequence, path)
        show("a", out + err)
        print(f"[seq] (a) {os.path.basename(path)} in "
              f"{time.perf_counter() - t0:.1f} s: GN cost {r['gn_cost']:.4f}")
        check(finite(*(r[k] for k in ("gbp_err", "gn_err", "ate",
                                      "slam_err", "ate_slam", "gn_cost"))),
              f"validate_sequences at {shape}: a non-finite result")
    torch.cuda.empty_cache()

    # (b) diagnose_accuracy at the fr1desk shape: its basin test
    t0 = time.perf_counter()
    r, out, err = _captured(da.diagnose, desk, SEQ_DIAGNOSE_SWEEPS)
    show("b", out + err)
    st, g = r["stats"], r["gn"]
    print(f"[seq] (b) LM polish of the GBP point against the cold GN: cost "
          f"ratio {g['polish_gn_ratio']:.7f} (bound 1 +- {POLISH_RATIO_TOL}),"
          f" ATE {g['polish_ate']:.6f} m (bound {POLISH_ATE_M}); in "
          f"{time.perf_counter() - t0:.1f} s ({card})")
    check(bool(np.isfinite(r["run"]["errs"]).all())
          and finite(st["res_mean"], st["drift_max"], g["gn_err"], g["ate"],
                     g["polish_cost"], *g["cost_gbp"], *g["cost_gn"]),
          "diagnose_accuracy: a non-finite result")
    check(abs(g["polish_gn_ratio"] - 1.0) <= POLISH_RATIO_TOL
          and g["polish_ate"] < POLISH_ATE_M,
          "diagnose_accuracy: the polish did not reach the GN optimum")
    torch.cuda.empty_cache()

    # (c) exp_ate_grid at the fr1xyz shape: fused=0 puts H5 and H4 on the
    # path
    prob = balio.load_bal(xyz)
    r, out, err = _captured(eg.grid, prob, SEQ_GRID_SWEEPS, SEQ_GRID_SPECS)
    show("c", out + err + eg.report(os.path.basename(xyz), prob,
                                    SEQ_GRID_SWEEPS, r))
    rows = {w["spec"]: w for w in r["rows"]}
    check(finite(r["gn_err"], r["gn_cost"], *(w[k] for w in r["rows"]
                                              for k in ("err", "ate",
                                                        "ratio"))),
          "exp_ate_grid: a non-finite result")
    gap = abs(rows["base"]["err"] - rows["fused=0"]["err"])
    print(f"[seq] (c) base against fused=0: {gap:.2e} px apart (bound "
          f"{SEQ_GRID_AGREE_PX})")
    check(gap <= SEQ_GRID_AGREE_PX, "exp_ate_grid: base and fused=0 differ")
    torch.cuda.empty_cache()

    # (d) exp_drift_phase at the fr1desk shape
    _, out, err = _captured(ed.main, [desk, *map(str, SEQ_DRIFT)])
    show("d", out + err)
    check(all("nan" not in ln for ln in out) and len(out) == 6,
          "exp_drift_phase: a schedule is missing or not finite")

    # (e) tune_schedule on the three files
    argv = ["--n_iters", str(SEQ_TUNE_SWEEPS)]
    for path in paths.values():
        argv += ["--seq", path]
    for v in SEQ_TUNE_SETS:
        argv += ["--set", v]
    _, out, err = _captured(ts.main, argv)
    show("e", out + err)
    check(all("nan" not in ln for ln in out)
          and len(out) == len(paths) * (len(SEQ_TUNE_SETS) + 2),
          "tune_schedule: a variant is missing or not finite")
    tmp.cleanup()
    launches = read_counts()
    print(f"[seq] launches in phase 17: {launches}; phase 17 in "
          f"{time.perf_counter() - t_phase:.1f} s")
    check(all(n > 0 for n in launches.values()),
          "phase 17 did not launch H1-H6 on the card")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    import gbp_poplar_tpu_torch  # noqa: F401  (sets TF32 off)
    from gbp_poplar_tpu_torch.config import GBPConfig, InitConfig
    from gbp_poplar_tpu_torch.core import build_graph, factor_graph as fg
    from gbp_poplar_tpu_torch.core import gbp, init_state
    from gbp_poplar_tpu_torch.ops import _cuda, cost_kernel, diag_kernel
    from gbp_poplar_tpu_torch.ops import reduce_kernel, sweep_kernel
    from gbp_poplar_tpu_torch.ops import table_kernel
    from gbp_poplar_tpu_torch.utils import analysis, balio, priors

    t_script = time.perf_counter()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = smi_line()
    reset_counts, read_counts = reset_kernel_counts, read_kernel_counts

    # ---- 1. environment ----
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__},"
          f" CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    print(f"[env] card: {card}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    _cuda.library()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {' '.join(_cuda.NVCC_FLAGS)}, one process per source)")
    with open(_cuda.ptxas_log) as f:
        for line in f:
            if "Compiling entry" in line or "spill" in line or "Used" in line:
                print("[build] " + line.strip())
    warps, stages, smem_h1, smem_h4 = _cuda.sweep_config()
    print(f"[build] H1 and H4 launch: one block per SM of {warps} warps, "
          f"{stages} stages of 32 edges per warp, {smem_h1} B (H1) and "
          f"{smem_h4} B (H4) of shared memory per block")

    # ---- 3. the fused path's kernels against their plain versions ----
    cfg = GBPConfig(accel_every=0, coarse_groups=0)
    rng = np.random.default_rng(0)

    def table_case(label, bel, d, k):
        r = table_kernel.build_table_reference(bel, d)
        comp = bel.shape[0]
        check(same(k[:, :comp], r[:, :comp]),
              f"table {label}: belief columns differ")
        check(same(k[:, comp + d:], r[:, comp + d:]),
              f"table {label}: valid flag or padding differ")
        diff = (k[:, comp:comp + d] - r[:, comp:comp + d]).abs()
        rel = (diff / (1.0 + r[:, comp:comp + d].abs())).max().item()
        print(f"[H2] {label}: max |kernel - plain| mean "
              f"{diff.max().item():.3e} (relative {rel:.3e}, bound "
              f"{TABLE_RTOL}), invalid rows {int((r[:, comp + d] == 0).sum())}")
        check(rel <= TABLE_RTOL, f"table {label}: means differ")
        return diff.max().item()

    def tables_case(label, cam_bel, lmk_bel):
        """Both kinds in one launch against the plain version and against
        the same kernel's launch for one kind, the other given no
        variables."""
        worst = 0.0
        launched = table_kernel.build_tables.launches
        both = table_kernel.build_tables(cam_bel, lmk_bel)
        check(table_kernel.build_tables.launches == launched + 1,
              f"tables {label}: not one launch")
        alone = (table_kernel.build_tables(cam_bel, lmk_bel[:, :0])[0],
                 table_kernel.build_tables(cam_bel[:, :0], lmk_bel)[1])
        for (bel, d), k, a in zip(((cam_bel, 6), (lmk_bel, 3)), both, alone):
            worst = max(worst, table_case(f"{label} d={d}", bel, d, k))
            check(same(k, a),
                  f"tables {label} d={d}: one launch differs from one kind")
        print(f"[H2] {label}: both kinds in one launch equal to the one-kind "
              f"launches")
        return worst

    def random_beliefs(d, n):
        comp = d + d * (d + 1) // 2
        eta = rng.normal(0, 1, (d, n))
        a = rng.normal(0, 1, (n, d, d))
        lam = a @ a.transpose(0, 2, 1) + 0.5 * np.eye(d)
        packed = np.stack([lam[:, i, j] for i in range(d) for j in range(i + 1)])
        bel = np.concatenate([eta, packed]).astype(np.float32)
        bel[d:, 7] = 0.0                     # singular -> invalid
        bel[0, 11] = np.nan                  # poisoned -> invalid
        check(bel.shape[0] == comp, "belief layout")
        return torch.tensor(bel, device=dev)

    h2_err = tables_case(f"random n={LADYBUG_SHAPE[0]}/{LADYBUG_SHAPE[1]}",
                         random_beliefs(6, LADYBUG_SHAPE[0]),
                         random_beliefs(3, LADYBUG_SHAPE[1]))

    def reduce_case(label, planes, seg, prior):
        k = reduce_kernel.segment_sum(planes, seg, prior)
        r = reduce_kernel.segment_sum(planes, seg, prior, reference=True)
        scale = reduce_kernel.segment_sum(planes.abs(), seg, prior.abs(),
                                          reference=True)
        diff = (k - r).abs()
        rel = (diff / (scale + 1e-30)).max().item()
        again = reduce_kernel.segment_sum(planes, seg, prior)
        check(torch.equal(k, again), f"reduce {label}: not deterministic")
        print(f"[H3] {label}: max |kernel - plain| {diff.max().item():.3e} "
              f"(relative to sum |terms| {rel:.3e}, bound {REDUCE_RTOL}); "
              f"bit-identical on rerun")
        check(rel <= REDUCE_RTOL, f"reduce {label}: sums differ")
        return diff.max().item()

    raw_l = balio.synthetic_problem_large(*LADYBUG_SHAPE)
    prob_l = priors.apply_init_noise(raw_l, InitConfig(lmk_noise=LMK_NOISE,
                                                       seed=0))
    graph_l = build_graph(prob_l, cfg, dev)
    e_l = graph_l.n_edges
    print(f"[main] Ladybug shape: {prob_l.n_keyframes} keyframes, "
          f"{prob_l.n_points} landmarks, {prob_l.n_edges} edges "
          f"({e_l} padded), landmarks perturbed by N(0, {LMK_NOISE} m)")
    h3_err = 0.0
    pk_rand = torch.tensor(rng.normal(0, 1, (36, e_l)).astype(np.float32),
                           device=dev)
    for label, rows, seg, n_var in (
            ("random cam", pk_rand[:27], graph_l.cam_seg, graph_l.n_keyframes),
            ("random lmk", pk_rand[27:], graph_l.lmk_seg, graph_l.n_points)):
        prior = torch.tensor(rng.normal(0, 1, (rows.shape[0], n_var))
                             .astype(np.float32), device=dev)
        h3_err = max(h3_err, reduce_case(label, rows, seg, prior))

    def compare_sweeps(tag, label, graph, sk, sr, against):
        """Field-by-field comparison of two swept states; returns the
        largest absolute difference of the worst field."""
        flip = ((sk.damping_count != sr.damping_count)
                | (sk.robust != sr.robust))
        n_flip = int(flip.sum())
        keep = ~flip
        worst, worst_rel, worst_field = 0.0, 0.0, ""
        for fname, (a, b) in fg.EDGE_PACK_OFFSETS.items():
            kf, rf = sk.pk[a:b][:, keep], sr.pk[a:b][:, keep]
            same_nan = torch.isnan(kf) == torch.isnan(rf)
            check(bool(same_nan.all()), f"{tag} {label}: NaN pattern {fname}")
            diff = torch.nan_to_num((kf - rf).abs(), nan=0.0)
            err = diff.max().item() if diff.numel() else 0.0
            scale = 1.0 + torch.nan_to_num(rf.abs(), nan=0.0).max().item()
            if err / scale > worst_rel:
                worst, worst_rel, worst_field = err, err / scale, fname
        relins = int((sr.damping_count == -cfg.num_undamped_iters).sum())
        print(f"[{tag}] {label}: {graph.n_edges} edges, {relins} "
              f"relinearised, {int(sr.robust.sum())} robust; lanes with "
              f"differing decisions {n_flip} (bound {SWEEP_FLIP_FRAC:g} of "
              f"edges); worst field {worst_field or '-'}: max |kernel - "
              f"{against}| {worst:.3e} (relative {worst_rel:.3e}, bound "
              f"{SWEEP_RTOL})")
        check(n_flip <= SWEEP_FLIP_FRAC * graph.n_edges + 1,
              f"{tag} {label}: too many decision flips")
        check(worst_rel <= SWEEP_RTOL, f"{tag} {label}: fields differ")
        return worst

    def sweep_case(label, state, graph):
        ct, lt = table_kernel.build_tables(state.cam_bel, state.lmk_bel,
                                           reference=True)
        sk, sr = state.clone(), state.clone()
        sweep_kernel.sweep(sk, graph, ct, lt, cfg)
        sweep_kernel.sweep(sr, graph, ct, lt, cfg, reference=True)
        return compare_sweeps("H1", label, graph, sk, sr, "plain")

    small = (("pinhole synthetic_problem", balio.synthetic_problem(
                 n_keyframes=6, n_points=60, seed=0, pixel_noise=0.5)),
             ("Snavely synthetic_problem_snavely",
              balio.synthetic_problem_snavely(pixel_noise=0.5)))
    h1_err = 0.0
    for label, prob in small:
        g = build_graph(prob, cfg, dev)
        s = gbp.initialise(init_state(prob, cfg, dev), g, cfg)
        s, _ = gbp.run_gbp(s, g, cfg, 6, with_diagnostics=False)
        h1_err = max(h1_err, sweep_case(label, s, g))

    state_l = gbp.initialise(init_state(prob_l, cfg, dev), graph_l, cfg)
    state_l, _ = gbp.run_gbp(state_l, graph_l, cfg, 20,
                             with_diagnostics=False)
    h1_err = max(h1_err, sweep_case("Ladybug after initialise + 20 sweeps",
                                    state_l, graph_l))
    h2_err = max(h2_err, tables_case("Ladybug state", state_l.cam_bel,
                                     state_l.lmk_bel))
    h3_err = max(h3_err, reduce_case(
        "Ladybug state cam", state_l.pk[54:81], graph_l.cam_seg,
        state_l.cam_prior))
    h3_err = max(h3_err, reduce_case(
        "Ladybug state lmk", state_l.pk[81:90], graph_l.lmk_seg,
        state_l.lmk_prior))
    # the telemetry sums (H6) on the same state, without and with a mask
    # of bad edges, and with singular beliefs
    bad_l = bad_edges(prob_l, cfg, dev)
    h6_err = diag_cases("Ladybug after initialise + 20 sweeps", state_l,
                        graph_l, cfg, bad_l)
    h6_err = max(h6_err, diag_cases(
        "Ladybug, singular beliefs", singular_beliefs(state_l, graph_l),
        graph_l, cfg, bad_l))

    # each kernel's time beside its plain version's, at the Ladybug shape
    st_k, st_r = state_l.clone(), state_l.clone()
    ct, lt = table_kernel.build_tables(state_l.cam_bel, state_l.lmk_bel)
    # H2 by the profiler's device time (its events' time is the host's)
    h2_ms, h2_plain, h2_b, h2_by = time_tables(
        state_l.cam_bel, state_l.lmk_bel, "the Ladybug shape", card)
    # H6 by the profiler's device time, one launch a call, on the tables
    # of this state
    def h6(reference=False):
        return diag_kernel.edge_sums(state_l, graph_l, cfg.num_undamped_iters,
                                     tables=(ct, lt), reference=reference)

    h6_ms = device_ms(h6, TIMED_SWEEPS, "diag_sums", per_call=True)
    h6_launch = device_ms(h6, TIMED_SWEEPS, "diag_sums")
    h6_ops = op_counts(h6)
    host, events, one = telemetry_host_us(state_l, graph_l, cfg)
    print(f"[time] diag at the Ladybug shape: device {h6_ms:.4f} ms per "
          f"call, {h6_launch:.4f} per launch (profiler), {h6_ops[1]} device "
          f"launch(es) a call; events {cuda_ms(h6, TIMED_SWEEPS):.4f} ms per "
          f"host call; host: as run_gbp launches it (set up once a solve) "
          f"{host:.2f} us a call by the host clock, {events:.2f} us by "
          f"events back to back, set up per call {one:.2f} us by events "
          f"({card})")
    check(h6_ops[1] == 1, "H6: an edge_sums call is not one device launch")
    # its time against its grid: one block alone, then one and two waves
    # of the blocks the card holds at once at 4 blocks an SM (its
    # registers allow 4 blocks of 256 threads; [build] lines)
    wave = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    counts = (1024, wave * 1024, 2 * wave * 1024)
    by_edges = h6_by_edges(state_l, graph_l, cfg, (ct, lt), counts)
    print("[time] diag by grid at the Ladybug shape (profiler): "
          + ", ".join(f"{n // 1024} blocks {ms:.4f} ms"
                      for n, ms in zip(counts, by_edges))
          + f", all {-(-e_l // 1024)} blocks {h6_ms:.4f} ms ({card})")
    times = {
        "diag": (h6_ms, cuda_ms(lambda: h6(True), 5)),
        "sweep": (
            cuda_ms(lambda: sweep_kernel.sweep(st_k, graph_l, ct, lt, cfg),
                    TIMED_SWEEPS),
            cuda_ms(lambda: sweep_kernel.sweep(st_r, graph_l, ct, lt, cfg,
                                               reference=True), 3)),
        "table": (h2_ms, h2_plain),
        "reduce": (
            cuda_ms(lambda: gbp.update_beliefs(st_k, graph_l, cfg),
                    TIMED_SWEEPS),
            cuda_ms(lambda: gbp.update_beliefs(
                st_r, graph_l, dataclasses.replace(cfg, kernels="reference")),
                5)),
    }
    # the yardsticks: each kernel's bound at these inputs and, where one
    # PyTorch call computes the same function, that call's time (H3:
    # torch.index_add of the edges' rows into the prior by variable id)
    cam_w = reduce_work(graph_l.cam_seg, 27)
    lmk_w = reduce_work(graph_l.lmk_seg, 9)
    n_real = graph_l.cam_seg.var.shape[0]
    yard = {
        "sweep": (*least_ms(sweep_bytes(graph_l, False), count_ops(
            lambda: sweep_kernel.sweep(st_r, graph_l, ct, lt, cfg,
                                       reference=True))), None),
        "table": (h2_b, h2_by, None),
        "reduce": (*least_ms(cam_w[0] + lmk_w[0],
                             (cam_w[1][0] + lmk_w[1][0], 0)),
                   time_reduce_sides(st_k, graph_l, n_real, card)),
        "diag": (*least_ms(diag_bytes(graph_l, None),
                           count_ops(lambda: h6(True))), None),
    }
    for k, (ms, plain) in times.items():
        b, by, lib = yard[k]
        print(f"[time] {k}: kernel {ms:.4f} ms, plain PyTorch {plain:.4f} ms "
              f"per sweep at {e_l} padded edges; bound {b:.4f} ms by {by} "
              f"({b / ms:.0%} of it reached); one library call "
              f"{'none' if lib is None else f'{lib:.4f} ms'} ({card})")
    del st_k, st_r, ct, lt, state_l

    # ---- 4. the fused main path at the Ladybug shape ----
    ref_cfg = dataclasses.replace(cfg, kernels="reference")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    s0 = init_state(prob_l, cfg, dev)
    s = gbp.initialise(s0, graph_l, cfg)
    # phase 13 reads this state (after initialise) from the host
    held = {"ladybug": (prob_l, graph_l, state_to(s, "cpu"), cfg)}
    err0 = gbp.reprojection_error(s, graph_l)[0].item()
    s, diag = gbp.run_gbp(s, graph_l, cfg, LADYBUG_SWEEPS)
    launches_l = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    err = diag.reproj_err.cpu().numpy()
    marks = [i for i in (0, 9, 19, 49, 99, 149) if i < LADYBUG_SWEEPS]
    print("[main] kernels: error by sweep "
          + ", ".join(f"{i + 1}: {err[i]:.4f}" for i in marks) + " px")
    print(f"[main] kernels: error {err0:.4f} px after initialise -> "
          f"{err[-1]:.4f} px after {LADYBUG_SWEEPS} sweeps (min "
          f"{err.min():.4f}, relinearised at the end {int(diag.n_relins[-1])},"
          f" robust {int(diag.n_robust[-1])}); peak device memory "
          f"{peak_gib:.2f} GiB")
    print(f"[main] launches in the Ladybug main path: {launches_l}")
    check(bool(np.isfinite(err).all()), "main path: non-finite error")
    check(err[-1] < err0, "main path: error did not fall")
    # a sweep's tables are built once, after it: H6 reads them and so does
    # the next sweep; the first sweep of each run of sweeps builds its own,
    # and the error after initialise adds one build and one H6 launch
    check(launches_l == {"sweep": LADYBUG_SWEEPS,
                         "table": LADYBUG_SWEEPS + 1
                                  + sweep_runs(cfg, LADYBUG_SWEEPS),
                         "reduce": 2 * LADYBUG_SWEEPS + 2, "sweep_planes": 0,
                         "gather": 0, "diag": LADYBUG_SWEEPS + 1,
                         "coarse": 0, "cost": 0},
          "main path did not go through every kernel once per sweep")

    s_r = gbp.initialise(init_state(prob_l, ref_cfg, dev), graph_l, ref_cfg)
    s_r, diag_r = gbp.run_gbp(s_r, graph_l, ref_cfg, LADYBUG_SWEEPS)
    err_r = diag_r.reproj_err.cpu().numpy()
    gap = abs(float(err[-1]) - float(err_r[-1]))
    bound = max(MAIN_AGREE_PX, MAIN_AGREE_REL * float(err_r[-1]))
    print(f"[main] reference: error {err_r[-1]:.4f} px after "
          f"{LADYBUG_SWEEPS} sweeps; |kernels - reference| {gap:.4f} px "
          f"(bound {bound:.4f})")
    check(bool(np.isfinite(err_r).all()) and gap <= bound,
          "main path: kernels and reference disagree")

    # ms/sweep, anneal-free sweeps without diagnostics, after warm-up
    for label, c, st in (("kernels", cfg, s), ("reference", ref_cfg, s_r)):
        gbp.run_gbp(st, graph_l, c, 2, with_diagnostics=False,
                    iter_offset=2 * c.steps)
        n = TIMED_SWEEPS if label == "kernels" else 5
        ms = cuda_ms(lambda: gbp.run_gbp(st, graph_l, c, n,
                                         with_diagnostics=False,
                                         iter_offset=2 * c.steps), 1) / n
        print(f"[main] {label}: {ms:.4f} ms/sweep at {e_l} padded edges "
              f"({card})")

    # the main path as run above: with per-sweep diagnostics (H2 and H6)
    diag_ms = cuda_ms(lambda: gbp.run_gbp(s, graph_l, cfg, TIMED_SWEEPS,
                                          iter_offset=2 * cfg.steps),
                      1) / TIMED_SWEEPS
    print(f"[main] kernels with diagnostics: {diag_ms:.4f} ms/sweep "
          f"({card})")
    # one diagnostics call as the profiler sees it: the plain version (the
    # arithmetic every card path ran before H6) against H2 + H6
    before = op_counts(lambda: gbp.diagnostics(s, graph_l, ref_cfg))
    after = op_counts(lambda: gbp.diagnostics(s, graph_l, cfg))
    # and what a sweep of run_gbp pays for them (its rows fill one buffer):
    # runs of n and 2n sweeps part the per-sweep count from the per-solve
    # one (the first sweep's tables, the ticket, the rows' conversions)
    runs = {(d, k): op_counts(lambda: gbp.run_gbp(
        s, graph_l, cfg, k * TIMED_SWEEPS, with_diagnostics=d,
        iter_offset=2 * cfg.steps)) for d in (False, True) for k in (1, 2)}
    slope = {d: [(runs[d, 2][i] - runs[d, 1][i]) / TIMED_SWEEPS
                 for i in (0, 1)] for d in (False, True)}
    fixed = {d: [runs[d, 1][i] - slope[d][i] * TIMED_SWEEPS for i in (0, 1)]
             for d in (False, True)}
    print(f"[diag] one diagnostics call at the Ladybug shape, by "
          f"torch.profiler: plain version {before[0]} aten operations (top "
          f"level) and {before[1]} device launches; H2 + H6 {after[0]} aten "
          f"operations and {after[1]} device launches; run_gbp over "
          f"{TIMED_SWEEPS} sweeps, per sweep without diagnostics "
          f"{runs[False, 1][0] / TIMED_SWEEPS:.2f} aten operations and "
          f"{runs[False, 1][1] / TIMED_SWEEPS:.2f} device launches, with them "
          f"{runs[True, 1][0] / TIMED_SWEEPS:.2f} and "
          f"{runs[True, 1][1] / TIMED_SWEEPS:.2f}; each further sweep "
          f"without diagnostics {slope[False][0]:.2f} aten operations and "
          f"{slope[False][1]:.2f} device launches, with them "
          f"{slope[True][0]:.2f} and {slope[True][1]:.2f}; per solve "
          f"besides {fixed[False][0]:.0f} and {fixed[False][1]:.0f} without,"
          f" {fixed[True][0]:.0f} and {fixed[True][1]:.0f} with them")
    check(slope[True][1] <= slope[False][1] + 1,
          "run_gbp: diagnostics add more than one device launch a sweep")
    del s, s_r, s0, graph_l, diag, diag_r
    torch.cuda.empty_cache()

    # the one-call entry point with the library defaults (GBPConfig():
    # fused sweep, accelerator every 50 sweeps from sweep 150)
    _, _, e_s = gbp_poplar_tpu_torch.solve_ba(small[0][1], n_iters=200,
                                              device=dev)
    print(f"[main] solve_ba(pinhole problem) with GBPConfig(): error "
          f"{e_s[0]:.4f} -> {e_s[-1]:.4f} px in {len(e_s)} sweeps")
    check(bool(np.isfinite(e_s).all()) and e_s[-1] < e_s[0],
          "solve_ba with the default config failed")

    # ---- 5. the Venice shape: H5 and H4 against their plain versions ----
    cfg_u = GBPConfig(fused=False)
    t0 = time.perf_counter()
    prob_v = priors.apply_init_noise(
        shuffle_cameras(balio.synthetic_problem_large(*VENICE_SHAPE)),
        InitConfig(lmk_noise=LMK_NOISE, seed=0))
    graph_v = build_graph(prob_v, cfg_u, dev)
    e_v = graph_v.n_edges
    print(f"[venice] Venice shape: {prob_v.n_keyframes} cameras (ids "
          f"shuffled), {prob_v.n_points} landmarks, {prob_v.n_edges} edges "
          f"({e_v} padded), landmarks perturbed by N(0, {LMK_NOISE} m); "
          f"problem and graph built in {time.perf_counter() - t0:.1f} s")

    state_v = gbp.initialise(init_state(prob_v, cfg_u, dev), graph_v, cfg_u)
    h5_err = 0.0
    for label, src, idx in (("cameras", state_v.cam_bel, graph_v.cam_idx),
                            ("landmarks", state_v.lmk_bel, graph_v.lmk_idx)):
        k = reduce_kernel.gather(src, idx)
        r = reduce_kernel.gather(src, idx, reference=True)
        h5_err = max(h5_err, (k - r).abs().max().item())
        print(f"[H5] Venice {label}: [{src.shape[0]}, {src.shape[1]}] -> "
              f"[{k.shape[0]}, {k.shape[1]}], bit-identical to index_select:"
              f" {same(k, r)}")
        check(same(k, r), f"gather {label}: differs from index_select")

    def sweep_planes_case(label, state, graph, c):
        bc = reduce_kernel.gather(state.cam_bel, graph.cam_idx,
                                  reference=True)
        bl = reduce_kernel.gather(state.lmk_bel, graph.lmk_idx,
                                  reference=True)
        sk, sr = state.clone(), state.clone()
        sweep_kernel.sweep_planes(sk, graph, bc, bl, c)
        sweep_kernel.sweep_planes(sr, graph, bc, bl, c, reference=True)
        return compare_sweeps("H4", label, graph, sk, sr, "plain")

    h4_err = 0.0
    for label, prob in small:
        g = build_graph(prob, cfg_u, dev)
        s = gbp.initialise(init_state(prob, cfg_u, dev), g, cfg_u)
        s, _ = gbp.run_gbp(s, g, cfg_u, 6, with_diagnostics=False)
        h4_err = max(h4_err, sweep_planes_case(label, s, g, cfg_u))
    state_v, _ = gbp.run_gbp(state_v, graph_v, cfg_u, 20,
                             with_diagnostics=False)
    held["venice"] = (graph_v, state_to(state_v, "cpu"), cfg_u)
    h6_err = max(h6_err, diag_cases(
        "Venice after initialise + 20 sweeps (cameras shuffled)", state_v,
        graph_v, cfg_u, bad_edges(prob_v, cfg_u, dev)))
    h4_err = max(h4_err, sweep_planes_case(
        "Venice after initialise + 20 sweeps", state_v, graph_v, cfg_u))
    # H4 (gathered planes, per-edge means) against H1 (tables) on the same
    # state, each with its own kernels: no difference expected
    s4, s1 = state_v.clone(), state_v.clone()
    sweep_kernel.sweep_planes(
        s4, graph_v, reduce_kernel.gather(state_v.cam_bel, graph_v.cam_idx),
        reduce_kernel.gather(state_v.lmk_bel, graph_v.lmk_idx), cfg_u)
    sweep_kernel.sweep(s1, graph_v, *table_kernel.build_tables(
        state_v.cam_bel, state_v.lmk_bel), cfg_u)
    compare_sweeps("H4", "Venice, H4 on gathered planes vs H1 on tables",
                   graph_v, s4, s1, "H1")
    h4_vs_h1 = all(torch.equal(getattr(s4, f), getattr(s1, f))
                   for f in ("pk", "damping_count", "robust"))
    print(f"[H4] Venice: H4 and H1 bit-identical on the same state: "
          f"{h4_vs_h1}")
    check(h4_vs_h1, "H4 and H1 differ on the Venice state")
    del s4, s1

    # ---- 6. the unfused main path at the Venice shape ----
    del state_v
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    s = gbp.initialise(init_state(prob_v, cfg_u, dev), graph_v, cfg_u)
    err0 = gbp.reprojection_error(s, graph_v)[0].item()
    accel_log = []
    t0 = time.perf_counter()
    s, diag = gbp.run_gbp(s, graph_v, cfg_u, VENICE_SWEEPS,
                          accel_log=accel_log)
    launches_v = read_counts()
    wall = time.perf_counter() - t0
    peak_v = torch.cuda.max_memory_allocated() / 2**30
    err = diag.reproj_err.cpu().numpy()
    marks = [i for i in (0, 9, 49, 99, 149, 159, 199, 209, 249, 259, 299)
             if i < VENICE_SWEEPS]
    print("[venice] unfused kernels: error by sweep "
          + ", ".join(f"{i + 1}: {err[i]:.4f}" for i in marks) + " px")
    for n_at, st in accel_log:
        print(f"[venice] accelerator after sweep {n_at}: gain "
              f"{st.gain.item():.4f}, "
              f"{'accepted' if bool(st.accepted) else 'rejected'} (MAP cost "
              f"{st.cost_cur.item():.6e} -> candidate "
              f"{st.cost_cand.item():.6e})")
    n_jumps = sum(bool(st.accepted) and st.gain.item() > 0
                  for _, st in accel_log)
    print(f"[venice] unfused kernels: error {err0:.4f} px after initialise "
          f"-> {err[-1]:.4f} px after {VENICE_SWEEPS} sweeps (min "
          f"{err.min():.4f}); {n_jumps} accelerator jumps accepted of "
          f"{len(accel_log)} steps; {wall:.1f} s wall with diagnostics; "
          f"peak device memory {peak_v:.2f} GiB")
    print(f"[venice] launches in the Venice main path: {launches_v}")
    check(bool(np.isfinite(err).all()), "Venice main path: non-finite error")
    check(err[-1] < err0, "Venice main path: error did not fall")
    check([n for n, _ in accel_log] == [160, 210, 260],
          "Venice main path: the accelerator did not step at 160, 210, 260")
    # 10 annealed sweeps, then chunks of 50: chunk 1 plain, chunk 2 dead
    # but averaging its means, chunks 3-5 live, 40 plain sweeps; tables
    # (H2, both kinds in one launch) after every sweep for H6, which the
    # 200 averaged sweeps' means read too, and once for the error after
    # initialise; reductions (H3) also at initialise and for the
    # accelerator's active degrees; each accelerator step prices its two
    # mean sets in one launch of H8
    check(launches_v == {"sweep": 0, "table": VENICE_SWEEPS + 1,
                         "reduce": 2 * VENICE_SWEEPS + 4,
                         "sweep_planes": VENICE_SWEEPS,
                         "gather": 2 * VENICE_SWEEPS,
                         "diag": VENICE_SWEEPS + 1, "coarse": 0,
                         "cost": len(accel_log)},
          "Venice main path did not go through H5, H4, H3 and H6 every "
          "sweep and H8 every accelerator step")

    # ---- 7. agreement at the Venice shape ----
    ends = {}
    for label, c in (("reference", dataclasses.replace(cfg_u,
                                                       kernels="reference")),
                     ("fused", dataclasses.replace(cfg_u, fused=True))):
        s_x = gbp.initialise(init_state(prob_v, c, dev), graph_v, c)
        s_x, d_x = gbp.run_gbp(s_x, graph_v, c, VENICE_SWEEPS)
        e_x = d_x.reproj_err.cpu().numpy()
        ends[label] = e_x
        gap = abs(float(err[-1]) - float(e_x[-1]))
        bound = max(MAIN_AGREE_PX, MAIN_AGREE_REL * float(e_x[-1]))
        print(f"[venice] {label}: error {e_x[-1]:.4f} px after "
              f"{VENICE_SWEEPS} sweeps; |unfused kernels - {label}| "
              f"{gap:.6f} px (bound {bound:.4f}), largest per-sweep "
              f"difference {np.abs(e_x - err).max():.6f} px")
        check(bool(np.isfinite(e_x).all()) and gap <= bound,
              f"Venice main path: kernels and {label} disagree")
        del s_x, d_x

    # ---- 8. times at the Venice shape ----
    bc = reduce_kernel.gather(s.cam_bel, graph_v.cam_idx)
    bl = reduce_kernel.gather(s.lmk_bel, graph_v.lmk_idx)
    st_k, st_r = s.clone(), s.clone()
    times["sweep_planes"] = (
        cuda_ms(lambda: sweep_kernel.sweep_planes(st_k, graph_v, bc, bl,
                                                  cfg_u), TIMED_SWEEPS),
        cuda_ms(lambda: sweep_kernel.sweep_planes(st_r, graph_v, bc, bl,
                                                  cfg_u, reference=True), 3))
    times["gather"] = (
        cuda_ms(lambda: (reduce_kernel.gather(s.cam_bel, graph_v.cam_idx),
                         reduce_kernel.gather(s.lmk_bel, graph_v.lmk_idx)),
                TIMED_SWEEPS),
        cuda_ms(lambda: (
            reduce_kernel.gather(s.cam_bel, graph_v.cam_idx, reference=True),
            reduce_kernel.gather(s.lmk_bel, graph_v.lmk_idx, reference=True)),
                TIMED_SWEEPS))
    gather_bytes = 4 * (27 * graph_v.n_keyframes + 9 * graph_v.n_points
                        + 2 * e_v + 36 * e_v)
    # H5's plain version is the library call that computes its function
    yard["sweep_planes"] = (*least_ms(sweep_bytes(graph_v, True), count_ops(
        lambda: sweep_kernel.sweep_planes(st_r, graph_v, bc, bl, cfg_u,
                                          reference=True))), None)
    yard["gather"] = (*least_ms(gather_bytes, (0, 0)), times["gather"][1])
    for k in ("sweep_planes", "gather"):
        b, by, lib = yard[k]
        print(f"[time] {k}: kernel {times[k][0]:.4f} ms, plain PyTorch "
              f"{times[k][1]:.4f} ms per sweep at {e_v} padded edges; bound "
              f"{b:.4f} ms by {by} ({b / times[k][0]:.0%} of it reached); "
              f"one library call "
              f"{'none' if lib is None else f'{lib:.4f} ms'} ({card})")
    print(f"[time] gather library: index_select {times['gather'][1]:.4f} ms "
          f"for both kinds at {e_v} padded edges ({card})")
    # H2 and H1 on the same Venice state (the fused pipeline's table
    # build and sweep), and H3 per side with the cameras shuffled
    h2_err = max(h2_err, tables_case("Venice state", s.cam_bel, s.lmk_bel))
    time_tables(s.cam_bel, s.lmk_bel, "the Venice shape", card)
    ct, lt = table_kernel.build_tables(s.cam_bel, s.lmk_bel)
    h1_v = cuda_ms(lambda: sweep_kernel.sweep(st_k, graph_v, ct, lt, cfg_u),
                   TIMED_SWEEPS)
    b, by = least_ms(sweep_bytes(graph_v, False), (0, 0))
    print(f"[time] sweep at the Venice shape: kernel {h1_v:.4f} ms; bound "
          f"{b:.4f} ms by {by} ({b / h1_v:.0%} of it reached) at {e_v} "
          f"padded edges ({card})")
    time_reduce_sides(st_k, graph_v, graph_v.cam_seg.var.shape[0], card)
    # H3 against its plain version at this shape: the cameras' shuffled
    # segments go by the chunk plan, the landmarks' by the one-pass kernel
    h3_err = max(h3_err, reduce_case(
        "Venice state cam (shuffled)", s.pk[54:81], graph_v.cam_seg,
        s.cam_prior))
    h3_err = max(h3_err, reduce_case(
        "Venice state lmk", s.pk[81:90], graph_v.lmk_seg, s.lmk_prior))
    del st_k, st_r, bc, bl, ct, lt

    n_acc = 2 * cfg_u.accel_every
    for label, fused in (("unfused", False), ("fused", True)):
        c = dataclasses.replace(cfg_u, fused=fused)
        c0 = dataclasses.replace(c, accel_every=0)
        st = s.clone()
        gbp.run_gbp(st, graph_v, c0, 2, with_diagnostics=False,
                    iter_offset=2 * c.steps)
        plain_ms = cuda_ms(lambda: gbp.run_gbp(
            st, graph_v, c0, TIMED_SWEEPS, with_diagnostics=False,
            iter_offset=2 * c.steps), 1) / TIMED_SWEEPS
        # two live chunks: every sweep averages its means, two steps
        acc_ms = cuda_ms(lambda: gbp.run_gbp(
            st, graph_v, c, n_acc, with_diagnostics=False,
            iter_offset=10 * c.accel_start), 1) / n_acc
        print(f"[venice] {label}: {plain_ms:.4f} ms/sweep without the "
              f"accelerator, {acc_ms:.4f} ms/sweep with it live (chunk cost "
              f"{(acc_ms - plain_ms) * c.accel_every:.3f} ms per "
              f"{c.accel_every} sweeps) at {e_v} padded edges ({card})")
        del st
    degs = gbp._active_degrees(s, graph_v, cfg_u)
    cam_mu, lmk_mu = gbp._variable_means(s)
    snap = (cam_mu, lmk_mu, torch.full_like(cam_mu, 1e-4))
    avg = (cam_mu + 1e-4, lmk_mu)
    st = s.clone()
    step_ms = cuda_ms(lambda: gbp._accel_step(st, snap, avg, graph_v, cfg_u,
                                              degs), 5)
    means_ms = cuda_ms(lambda: gbp._sanitized_means(st, cfg_u), TIMED_SWEEPS)
    step_busy = busy_ms(lambda: gbp._accel_step(st, snap, avg, graph_v, cfg_u,
                                                degs), 3)
    print(f"[venice] accelerator: one step {step_ms:.4f} ms (device busy "
          f"{step_busy:.4f} ms of it, profiler), the means a chunk averages "
          f"{means_ms:.4f} ms per sweep ({card})")
    del st
    # H8 as the accelerator step calls it (the current means and a
    # candidate), the cameras in no order
    two = [(cam_mu, lmk_mu), (cam_mu + 1e-4, lmk_mu)]
    got = cost_kernel.cost_sums(s, graph_v, two, cfg_u.huber_nstds)
    want = cost_kernel.cost_sums(s, graph_v, two, cfg_u.huber_nstds,
                                 reference=True)
    rel = ((got - want).abs() / want.abs()).max().item()
    again = torch.equal(got, cost_kernel.cost_sums(s, graph_v, two,
                                                   cfg_u.huber_nstds))
    h8_v = cuda_ms(lambda: cost_kernel.cost_sums(s, graph_v, two,
                                                 cfg_u.huber_nstds),
                   TIMED_SWEEPS)
    b, by = least_ms(cost_bytes(graph_v, 2, None), (0, 0))
    print(f"[H8] Venice (cameras shuffled), K=2: max relative to the sum of "
          f"|loss| {rel:.3e} (bound {COST_RTOL:g}); bit-identical on rerun: "
          f"{again}; kernel {h8_v:.4f} ms, bytes bound {b:.4f} ms "
          f"({b / h8_v:.0%} of it reached) at {e_v} padded edges ({card})")
    check(again and rel <= COST_RTOL, "H8 at the Venice shape differs")

    # phase 11 polishes the means phase 6 left; the Venice state and graph
    # are freed before the Ladybug phases
    venice_means = analysis.belief_means(s)
    del s, graph_v, degs, cam_mu, lmk_mu, snap, avg
    torch.cuda.empty_cache()
    launches_c, h3_group_err, coarse_err, chunk = coarse_phase(
        prob_l, dev, reset_counts, read_counts, card)
    h3_err = max(h3_err, h3_group_err)
    times.update(chunk[0])
    yard.update(chunk[1])
    work = tempfile.TemporaryDirectory()     # phase 10's BAL file
    launches_d, bal = driver_phase(raw_l, dev, reset_counts, read_counts,
                                   card, work.name)
    del raw_l, prob_l
    launches_lm = lm_phase(prob_v, venice_means, cfg_u, dev, reset_counts,
                           read_counts, card)
    launches_s, h1_slam, h4_slam, h6_slam, slam_e_err, slam_row = slam_phase(
        dev, reset_counts, read_counts, card, compare_sweeps)
    h1_err, h4_err = max(h1_err, h1_slam), max(h4_err, h4_slam)
    h6_err = max(h6_err, h6_slam)
    launches_u, h3_utils = utils_phase(held, bal, dev, reset_counts,
                                       read_counts, card)
    h3_err = max(h3_err, h3_utils)
    del held
    work.cleanup()
    torch.cuda.empty_cache()
    launches_x = shard_phase(dev, card, coarse_err, slam_e_err)
    launches_t = tools_phase(dev, card, prob_v, venice_means, t_script,
                             {k: times[k][0] for k in ("sweep", "reduce")},
                             h6_ms, reset_counts, read_counts)
    del prob_v, venice_means
    torch.cuda.empty_cache()
    launches_b = bench_phase(dev, card, slam_row, reset_counts, read_counts)
    torch.cuda.empty_cache()
    launches_q = seq_phase(card, reset_counts, read_counts)

    replaces = {
        "sweep": ("gbp_poplar_tpu_torch/csrc/sweep.cu",
                  "gbp_poplar_tpu/ops/sweep_kernel.py:274", h1_err),
        "table": ("gbp_poplar_tpu_torch/csrc/table.cu",
                  "gbp_poplar_tpu/ops/table_kernel.py:41", h2_err),
        "reduce": ("gbp_poplar_tpu_torch/csrc/reduce.cu",
                   "gbp_poplar_tpu/ops/reduce_kernel.py:171", h3_err),
        "sweep_planes": ("gbp_poplar_tpu_torch/csrc/sweep.cu",
                         "gbp_poplar_tpu/ops/sweep_kernel.py:43", h4_err),
        "gather": ("gbp_poplar_tpu_torch/csrc/gather.cu",
                   "gbp_poplar_tpu/ops/reduce_kernel.py:439", h5_err),
        "diag": ("gbp_poplar_tpu_torch/csrc/diag.cu",
                 "gbp_poplar_tpu/core/gbp.py:1027", h6_err),
        "coarse": ("gbp_poplar_tpu_torch/csrc/coarse.cu",
                   "gbp_poplar_tpu/core/coarse.py:86", chunk[2]["coarse"]),
        "cost": ("gbp_poplar_tpu_torch/csrc/cost.cu",
                 "gbp_poplar_tpu/core/gbp.py:1094", chunk[2]["cost"]),
    }
    launches = {k: sum(run[k] for run in (launches_l, launches_v, launches_c,
                                          launches_d, launches_lm,
                                          *launches_s, launches_u,
                                          *launches_x, launches_t,
                                          launches_b, launches_q))
                for k in replaces}
    check(all(n > 0 for n in launches.values()),
          "a kernel was never launched by the main paths")
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": err_k,
         "ms": times[k][0], "plain_ms": times[k][1], "bound_ms": yard[k][0],
         "bound_by": yard[k][1], "library_ms": yard[k][2]}
        for k, (src, rep, err_k) in replaces.items()]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
