#!/usr/bin/env python3
"""Drive the PyTorch port (gbp_poplar_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
the final ``ok`` line:
  1. environment: torch/CUDA versions, the card's name and power limit;
     a CUDA device is required;
  2. build the hand-written kernels (csrc/*.cu) with nvcc, one process per
     source, and print each kernel's registers and spills and H1's launch
     shape;
  3. the fused path's kernels against their plain PyTorch versions on the
     card: the table build (H2) and the segmented sum (H3) on random inputs
     and at the Ladybug shape; one fused sweep (H1) on the small pinhole
     problem, the Snavely problem and the Ladybug-shape state after
     initialise + 20 sweeps; then each kernel's time beside its plain
     version's, its bound (the larger of its bytes over 3.35 TB/s and its
     operations over 67 TFLOP/s) and, for H3, the one library call that
     computes the same function (``torch.index_add``), per variable kind;
  4. the fused main path at the Ladybug shape (synthetic_problem_large(
     1723, 156000, 7): 1,092,000 edges, 1,092,608 padded), reference
     schedule (accel_every=0): build_graph / init_state on the card,
     initialise, run_gbp(200) with diagnostics, the launch counts of every
     kernel, the same 200 sweeps with kernels="reference", ms/sweep of
     both, and peak device memory; then ``solve_ba`` on the small pinhole
     problem with the library defaults (``GBPConfig()``);
  5. the Venice shape (synthetic_problem_large(1778, 994000, 5): 4,970,000
     edges, the shape of BAL Venice-1778) with its cameras relabelled by a
     random permutation, as in an unordered photo collection, and its
     landmarks perturbed by N(0, 5 cm): the gather (H5) against
     index_select on its camera and landmark indices (bit-identical); one
     unfused sweep (H4) against its plain version on the pinhole and
     Snavely problems and on the Venice state after initialise + 20
     sweeps, and against the fused sweep (H1) on that state;
  6. the unfused main path at the Venice shape: GBPConfig(fused=False),
     every other default (accelerator every 50 sweeps from sweep 150),
     300 sweeps with diagnostics: the error at marks, the accelerator's
     steps, the launch counts, peak device memory;
  7. the same solve with kernels="reference" and with fused=True: the
     final errors must agree;
  8. times at the Venice shape: H4 and H5 beside their plain versions
     and bounds (H5's plain version, ``index_select``, is its library
     call), H1 and H3 per variable kind with their bounds and H3's
     ``index_add``, ms/sweep of both pipelines with and without the
     accelerator, and the accelerator's cost per chunk;
  9. the coarse corrector at the Ladybug shape (cameras in their generated
     order): GBPConfig(coarse_groups=16), 400 sweeps, each boundary's
     accelerator and coarse decisions, the final error against
     kernels="reference", one coarse step's time, and the group sums (H3
     over group-keyed segments) against their plain version;
  10. the ba driver in process (``drivers.ba.main``) at the Ladybug shape
     written as a BAL file, with its defaults (coarse corrector over 16
     groups, LM polish): 600 sweeps with checkpoints, trajectory and the
     GN check; a resume to 1,000; the same 1,000 sweeps uninterrupted,
     whose lines the resumed ones must equal; launch counts per run;
  11. the driver's polish (15 warm-started LM/Schur iterations) at the
     Venice shape from the means phase 6 left: per-iteration cost and
     decision, ms per LM iteration, peak device memory.

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
REDUCE_RTOL = 1e-5         # sums, relative to the sum of |terms| (the plain
                           # version adds with atomics in run-dependent order)
SWEEP_RTOL = 1e-4          # edge fields, relative to 1 + max |field|
SWEEP_FLIP_FRAC = 1e-3     # lanes whose discrete outputs may differ
MAIN_AGREE_PX = 0.05       # final error: kernels vs reference, px ...
MAIN_AGREE_REL = 0.02      # ... or this fraction, whichever is larger

# the coarse corrector and the ba driver (phases 9-11), at the ba driver's
# defaults: 16 keyframe groups, an accelerator step every 50 sweeps from
# sweep 150, spans of 200 sweeps, 15 polish iterations
COARSE_GROUPS = 16
COARSE_SWEEPS = 400
DRIVER_SWEEPS = (600, 1000)      # run 1, then resumed / uninterrupted
CHECKPOINT_EVERY = 200
POLISH_ITERS = 15


# The card's peaks (H100 SXM, NVIDIA's data sheet): HBM3 bytes/s and
# float32 operations/s outside the tensor cores. A kernel's bound is the
# larger of its bytes and its operations over these.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# aten operations counted as one float32 operation per output element when
# the plain versions are run under count_ops (data movement is not counted)
_COUNTED_OPS = {
    "add", "sub", "mul", "div", "neg", "sqrt", "rsqrt", "reciprocal",
    "where", "eq", "ne", "lt", "le", "gt", "ge", "abs", "sin", "cos",
    "logical_and", "logical_or", "logical_not", "bitwise_and", "bitwise_or",
    "bitwise_not", "isfinite", "isnan", "isinf", "clamp", "clamp_min",
    "clamp_max", "minimum", "maximum", "square", "pow", "sum", "prod",
    "exp", "log", "sign", "sgn", "masked_fill", "lerp",
}


def count_ops(fn) -> int:
    """Float operations of ``fn()`` (a plain version on its real inputs):
    the elements written by each counted elementwise aten operation."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            if name in _COUNTED_OPS:
                for t in (out if isinstance(out, (tuple, list)) else (out,)):
                    if hasattr(t, "numel"):
                        Count.n += t.numel()
            return out

    with Count():
        fn()
    return Count.n


def least_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time (ms) the card could take for work that moves
    ``n_bytes`` (each input read once, each output written once) and does
    ``n_ops`` float32 operations, and which of the two bounds it."""
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / FP32_OPS_PER_S * 1e3
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


def reduce_work(seg, comp: int) -> tuple[int, int]:
    """(bytes, operations) of one segmented sum with a prior: the listed
    edges' rows and their index (the permutation, or the CSR offsets of a
    contiguous kind) read once, the prior read and the sums written."""
    n, v = seg.var.shape[0], seg.n_var
    index = 4 * n if seg.perm is not None else 4 * (v + 1)
    return 4 * comp * n + index + 2 * 4 * comp * v, comp * (n + v)


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


def coarse_phase(prob, dev, reset_counts, read_counts, card):
    """Phase 9: run_gbp with the coarse corrector at the Ladybug shape,
    cameras in their generated order: every boundary's decisions, the
    final error against kernels="reference", one coarse step's time, and
    the group sums (H3 over the group-keyed segments) against their plain
    version. Returns (launch counts, largest group-sum difference)."""
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
    for n_at, st in log:
        c = st.coarse
        moved = bool(st.accepted) and st.gain.item() > 0
        print(f"[coarse] after sweep {n_at}: accelerator gain "
              f"{st.gain.item():.4f} {'applied' if moved else 'not applied'} "
              f"(MAP cost {st.cost_cur.item():.9e} -> candidate "
              f"{st.cost_cand.item():.9e}); coarse gain {c.gain.item():g} "
              f"(cost to beat {c.cost_cur.item():.9e}, scale 1 "
              f"{c.cost_cand[0].item():.9e}, scale 0.3 "
              f"{c.cost_cand[1].item():.9e})")
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
    check(launches["sweep"] == COARSE_SWEEPS
          and launches["table"] >= 2 * COARSE_SWEEPS
          and launches["reduce"] >= 2 * COARSE_SWEEPS,
          "coarse path did not go through H1, H2, H3 every sweep")

    ref = dataclasses.replace(cfg, kernels="reference")
    s_r = gbp.initialise(init_state(prob, ref, dev), graph, ref)
    _, diag_r = gbp.run_gbp(s_r, graph, ref, COARSE_SWEEPS)
    agree("[coarse]", err, diag_r.reproj_err.cpu().numpy())
    del s_r, diag_r

    degs = gbp._active_degrees(s, graph, cfg)
    st = s.clone()
    cost = gbp.map_cost(st, graph, cfg)
    step_ms = cuda_ms(lambda: gbp._coarse_step(st, graph, cfg, degs,
                                               cost=cost), 5)
    inc_ms = cuda_ms(lambda: coarse.coarse_increment(
        st, graph, cfg, *gbp._variable_means(st)), 5)
    print(f"[coarse] one coarse step {step_ms:.4f} ms (the increment "
          f"{inc_ms:.4f} ms) at {graph.n_edges} padded edges, "
          f"{COARSE_GROUPS} groups ({card})")
    del st

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
    return launches, worst


def driver_phase(raw, dev, reset_counts, read_counts, card):
    """Phase 10: the ba driver in process at the Ladybug shape with its
    defaults: a run with checkpoints, trajectory and the GN check, its
    resume, and the same sweeps uninterrupted, which the resumed lines
    must equal. Returns the launch counts of the three runs."""
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
              and counts["table"] >= 2 * swept
              and counts["reduce"] >= 2 * swept,
              "ba driver did not go through H1, H2, H3 every sweep")
        return lines, err, counts

    def after(err, key):
        return err.split(key)[1].split()[0]

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        bal = os.path.join(tmp, "ladybug.txt")
        t0 = time.perf_counter()
        balio.save_bal(bal, raw)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        balio.load_bal(bal)
        t_parse = time.perf_counter() - t0
        print(f"[driver] Ladybug shape as a BAL file: "
              f"{os.path.getsize(bal) / 2**20:.1f} MiB, written in "
              f"{t_write:.2f} s, parsed in {t_parse:.2f} s")
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
    return launches


def lm_phase(prob, means, cfg, dev, reset_counts, read_counts, card):
    """Phase 11: the driver's polish (15 warm-started LM/Schur iterations,
    ``ba._polish_problem``) at the Venice shape, from the means the Venice
    main path left. Returns the launch counts."""
    import numpy as np
    import torch

    from gbp_poplar_tpu_torch.core import gauss_newton as gn
    from gbp_poplar_tpu_torch.drivers import ba

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
    from gbp_poplar_tpu_torch.ops import _cuda, reduce_kernel, sweep_kernel
    from gbp_poplar_tpu_torch.ops import table_kernel
    from gbp_poplar_tpu_torch.utils import analysis, balio, priors

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = smi_line()
    wrappers = {"sweep": sweep_kernel.sweep, "table": table_kernel.build_table,
                "reduce": reduce_kernel.segment_sum,
                "sweep_planes": sweep_kernel.sweep_planes,
                "gather": reduce_kernel.gather}

    def reset_counts():
        torch.cuda.synchronize()
        for fn in wrappers.values():
            fn.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        return {k: fn.launches for k, fn in wrappers.items()}

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
    warps, stages, smem = _cuda.sweep_config()
    print(f"[build] H1 launch: one block per SM of {warps} warps, {stages} "
          f"stages of 32 edges per warp, {smem} B of shared memory per block")

    # ---- 3. the fused path's kernels against their plain versions ----
    cfg = GBPConfig(accel_every=0, coarse_groups=0)
    rng = np.random.default_rng(0)

    def table_case(label, bel, d):
        k = table_kernel.build_table(bel, d)
        r = table_kernel.build_table(bel, d, reference=True)
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

    h2_err = 0.0
    for d, n in ((6, LADYBUG_SHAPE[0]), (3, LADYBUG_SHAPE[1])):
        h2_err = max(h2_err, table_case(f"random d={d} n={n}",
                                        random_beliefs(d, n), d))

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
        ct = table_kernel.build_table(state.cam_bel, 6, reference=True)
        lt = table_kernel.build_table(state.lmk_bel, 3, reference=True)
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
    for d, bel in ((6, state_l.cam_bel), (3, state_l.lmk_bel)):
        h2_err = max(h2_err, table_case(f"Ladybug state d={d}", bel, d))
    h3_err = max(h3_err, reduce_case(
        "Ladybug state cam", state_l.pk[54:81], graph_l.cam_seg,
        state_l.cam_prior))
    h3_err = max(h3_err, reduce_case(
        "Ladybug state lmk", state_l.pk[81:90], graph_l.lmk_seg,
        state_l.lmk_prior))

    # each kernel's time beside its plain version's, at the Ladybug shape
    st_k, st_r = state_l.clone(), state_l.clone()
    ct = table_kernel.build_table(state_l.cam_bel, 6)
    lt = table_kernel.build_table(state_l.lmk_bel, 3)
    times = {
        "sweep": (
            cuda_ms(lambda: sweep_kernel.sweep(st_k, graph_l, ct, lt, cfg),
                    TIMED_SWEEPS),
            cuda_ms(lambda: sweep_kernel.sweep(st_r, graph_l, ct, lt, cfg,
                                               reference=True), 3)),
        "table": (
            cuda_ms(lambda: (table_kernel.build_table(state_l.cam_bel, 6),
                             table_kernel.build_table(state_l.lmk_bel, 3)),
                    TIMED_SWEEPS),
            cuda_ms(lambda: (
                table_kernel.build_table(state_l.cam_bel, 6, reference=True),
                table_kernel.build_table(state_l.lmk_bel, 3,
                                         reference=True)), 5)),
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
        "table": (*least_ms(4 * 63 * graph_l.n_keyframes
                         + 4 * 25 * graph_l.n_points, count_ops(
            lambda: (table_kernel.build_table(state_l.cam_bel, 6,
                                              reference=True),
                     table_kernel.build_table(state_l.lmk_bel, 3,
                                              reference=True)))), None),
        "reduce": (*least_ms(cam_w[0] + lmk_w[0], cam_w[1] + lmk_w[1]),
                   time_reduce_sides(st_k, graph_l, n_real, card)),
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
    check(launches_l == {"sweep": LADYBUG_SWEEPS, "table": 2 * LADYBUG_SWEEPS,
                         "reduce": 2 * LADYBUG_SWEEPS + 2, "sweep_planes": 0,
                         "gather": 0},
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

    # the main path as run above: with per-sweep diagnostics (plain
    # PyTorch: per-variable means, projection, reductions)
    diag_ms = cuda_ms(lambda: gbp.run_gbp(s, graph_l, cfg, TIMED_SWEEPS,
                                          iter_offset=2 * cfg.steps),
                      1) / TIMED_SWEEPS
    print(f"[main] kernels with diagnostics: {diag_ms:.4f} ms/sweep "
          f"({card})")
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
    h4_err = max(h4_err, sweep_planes_case(
        "Venice after initialise + 20 sweeps", state_v, graph_v, cfg_u))
    # H4 (gathered planes, per-edge means) against H1 (tables) on the same
    # state, each with its own kernels: no difference expected
    s4, s1 = state_v.clone(), state_v.clone()
    sweep_kernel.sweep_planes(
        s4, graph_v, reduce_kernel.gather(state_v.cam_bel, graph_v.cam_idx),
        reduce_kernel.gather(state_v.lmk_bel, graph_v.lmk_idx), cfg_u)
    sweep_kernel.sweep(s1, graph_v, table_kernel.build_table(state_v.cam_bel,
                                                             6),
                       table_kernel.build_table(state_v.lmk_bel, 3), cfg_u)
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
    # (H2) only for the 200 averaged sweeps' means; reductions (H3) also
    # at initialise and for the accelerator's active degrees
    check(launches_v == {"sweep": 0, "table": 400,
                         "reduce": 2 * VENICE_SWEEPS + 4,
                         "sweep_planes": VENICE_SWEEPS,
                         "gather": 2 * VENICE_SWEEPS},
          "Venice main path did not go through H5, H4 and H3 every sweep")

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
    yard["gather"] = (*least_ms(gather_bytes, 0), times["gather"][1])
    for k in ("sweep_planes", "gather"):
        b, by, lib = yard[k]
        print(f"[time] {k}: kernel {times[k][0]:.4f} ms, plain PyTorch "
              f"{times[k][1]:.4f} ms per sweep at {e_v} padded edges; bound "
              f"{b:.4f} ms by {by} ({b / times[k][0]:.0%} of it reached); "
              f"one library call "
              f"{'none' if lib is None else f'{lib:.4f} ms'} ({card})")
    print(f"[time] gather library: index_select {times['gather'][1]:.4f} ms "
          f"for both kinds at {e_v} padded edges ({card})")
    # H1 on the same Venice state (the fused pipeline's sweep), and H3 per
    # side with the cameras shuffled
    ct = table_kernel.build_table(s.cam_bel, 6)
    lt = table_kernel.build_table(s.lmk_bel, 3)
    h1_v = cuda_ms(lambda: sweep_kernel.sweep(st_k, graph_v, ct, lt, cfg_u),
                   TIMED_SWEEPS)
    b, by = least_ms(sweep_bytes(graph_v, False), 0)
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
    print(f"[venice] accelerator: one step {step_ms:.4f} ms, the means a "
          f"chunk averages {means_ms:.4f} ms per sweep ({card})")
    del st

    # phase 11 polishes the means phase 6 left; the Venice state and graph
    # are freed before the Ladybug phases
    venice_means = analysis.belief_means(s)
    del s, graph_v, degs, cam_mu, lmk_mu, snap, avg
    torch.cuda.empty_cache()
    launches_c, h3_group_err = coarse_phase(prob_l, dev, reset_counts,
                                            read_counts, card)
    h3_err = max(h3_err, h3_group_err)
    launches_d = driver_phase(raw_l, dev, reset_counts, read_counts, card)
    del raw_l, prob_l
    launches_lm = lm_phase(prob_v, venice_means, cfg_u, dev, reset_counts,
                           read_counts, card)

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
    }
    launches = {k: sum(run[k] for run in (launches_l, launches_v, launches_c,
                                          launches_d, launches_lm))
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
