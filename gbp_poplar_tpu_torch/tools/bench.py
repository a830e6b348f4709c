"""Headline benchmark: synchronous GBP sweeps/s on a TUM sequence, with
guarded extra rows (two more sequences, incremental-SLAM throughput, the
Ladybug- and Venice-shaped synthetics), so that neither the scale story nor
a sequence's convergence can regress silently.

    python -m gbp_poplar_tpu_torch.tools.bench            # on cuda:0
    GBP_PLATFORM=cpu GBP_BENCH_SEQ=tiny.txt GBP_BENCH_SWEEPS=20 \\
        GBP_BENCH_GUARD_ITERS=80 GBP_BENCH_EXTRA=0 GBP_BENCH_SCALE=0 \\
        python -m gbp_poplar_tpu_torch.tools.bench

The counterpart of the JAX package's ``bench.py``, with its workload, its
guards and its output: the human lines on stderr, then ONE JSON line on
stdout,
  {"metric": ..., "value": N, "unit": "sweeps/s", "vs_baseline": N,
   "extra": {"err_at_guard_px": ..., "ladybug_ms_per_sweep": ..., ...}}
with the JAX script's keys. The environment hooks are the JAX script's:
``GBP_BENCH_SEQ`` (a sequence name or a BAL file; default fr1xyz),
``GBP_BENCH_SWEEPS``, ``GBP_BENCH_GUARD_ITERS``, ``GBP_BENCH_GUARD_PX``,
``GBP_BENCH_EXTRA=0`` (no fr2robot2, fr1desk and SLAM rows),
``GBP_BENCH_SCALE=0`` (no Ladybug and Venice rows), ``GBP_BENCH_VENICE=0``
and ``GBP_BENCH_SLAM_IBK`` (sweeps per keyframe, default 700).

Guards (each must pass, or ``main`` prints why and returns 1):
  - the headline sequence: mean reprojection error < GUARD_PX after
    GUARD_ITERS solver iterations (the timed sweep is the real solver);
  - fr2robot2 at 2 px, fr1desk at GUARD_PX, the SLAM run below 3 px;
  - the Ladybug and Venice shapes: the error finite and lower after every
    timed run than before it (real sweeps on real state), and the Venice
    raw chain at most VENICE_NS_PER_EDGE_GUARD ns an edge.

Every row runs on the drivers' device (``tools.resolve_device``) unless
``device`` is given, and names it (nvidia-smi's ``name, power.limit``).
The solver updates its state in place, so each timed repetition starts
from a clone of the same state, made outside the timed window
(``tools.time_reps``); the fastest repetition counts, as in the JAX
script. The Ladybug row times two programs: the raw chain of ``gbp_sweep``
calls (each builds its own belief tables, H2) and the production
``run_gbp`` without diagnostics from ``accel_start``, whose accelerator
steps are live and which reuses each sweep's post-sweep tables, so the
raw chain may be the slower. The production row's events span the
accelerator's host-bound steps, which a user waits for too.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from ..config import GBPConfig
from ..core import build_graph, gbp, init_state, slam
from ..utils import balio
from ..utils import flags as flags_lib
from . import device_label, resolve_device, synchronize, time_reps

# The paper the reference implements (arXiv:2003.03134) reports bundle
# adjustment converging in tens of milliseconds over hundreds of GBP
# iterations on one Graphcore GC2 IPU: of order 1e3 sweeps/s on fr1-scale
# graphs. An order-of-magnitude anchor from the IPU, not a measurement of
# this port; vs_baseline > 1 means faster than that estimate.
BASELINE_SWEEPS_PER_SEC = 1000.0
SEQ = "fr1xyz"
N_SWEEPS = 3000
GUARD_ITERS = 500
GUARD_PX = 3.0
# the shape of BAL Ladybug-1723: keyframes, landmarks, observations per
# landmark (1,092,000 edges)
LADYBUG_SHAPE = (1723, 156000, 7)
LADYBUG_K = 100
# the shape of BAL Venice-1778 (4,970,000 edges), in the generator's camera
# order (chip_smoke.py's Venice phases shuffle the cameras: another row)
VENICE_SHAPE = (1778, 994000, 5)
VENICE_K = 30
# The Venice raw chain's limit, ns an edge: twice the slowest measured
# (0.491, chip_smoke.py phase 16 on an NVIDIA H100 80GB HBM3 at 700.00 W;
# PERF.md)
VENICE_NS_PER_EDGE_GUARD = 0.98
SLAM_SEQ = "fr2robot2"
SLAM_IBK = 700
SLAM_GUARD_PX = 3.0


class GuardFailed(RuntimeError):
    """A benchmark guard did not hold: the measured run is not the
    solver's real work, or it regressed."""


def _err(state, graph) -> float:
    return float(gbp.reprojection_error(state, graph)[0])


def initialised(problem, cfg: GBPConfig, dev):
    """(graph, state after ``initialise``) of ``problem`` on ``dev``."""
    graph = build_graph(problem, cfg, dev)
    state = gbp.initialise(init_state(problem, cfg, dev), graph, cfg)
    synchronize(dev)
    return graph, state


def bench_tum(seq: str, n_sweeps: int = N_SWEEPS,
              guard_iters: int = GUARD_ITERS, guard_px: float = GUARD_PX,
              device=None) -> dict:
    """Sweeps/s of ``initialise`` + ``run_gbp(n_sweeps)`` without
    diagnostics on the sequence (a name or a BAL file), after the
    convergence guard: ``solve`` with diagnostics for ``guard_iters``
    iterations must end below ``guard_px``."""
    dev = resolve_device(device)
    cfg = GBPConfig()
    problem = balio.load_bal(seq)
    graph = build_graph(problem, cfg, dev)
    state0 = init_state(problem, cfg, dev)

    _, diag = gbp.solve(state0.clone(), graph, cfg, n_iters=guard_iters)
    err = float(diag.reproj_err[-1])
    if not err < guard_px:
        raise GuardFailed(f"CONVERGENCE GUARD FAILED ({seq}): err={err}")

    def hot(s):
        s = gbp.initialise(s, graph, cfg)
        gbp.run_gbp(s, graph, cfg, n_sweeps, with_diagnostics=False)
        return s

    dt, _ = time_reps(hot, state0)
    label = device_label(dev)
    print(f"{seq}: {problem.n_edges} edges, err@{guard_iters}={err:.3f}px, "
          f"{dt * 1e3 / n_sweeps:.3f} ms/sweep ({label})", file=sys.stderr)
    return {"seq": seq, "edges": problem.n_edges, "sweeps": n_sweeps,
            "seconds": dt, "sweeps_per_sec": n_sweeps / dt,
            "err_at_guard_px": err, "device": label}


def sweep_chain(graph, cfg: GBPConfig, k: int):
    """The raw chain: ``fn(state)`` running ``k`` ``gbp_sweep`` calls."""
    def chain(s):
        for _ in range(k):
            s = gbp.gbp_sweep(s, graph, cfg)
        return s
    return chain


def _guard_down(what: str, err0: float, errs: list) -> None:
    if not all(np.isfinite(e) and e < err0 for e in errs):
        raise GuardFailed(f"{what} GUARD FAILED: err {err0} -> {errs}")


def bench_ladybug(k: int = LADYBUG_K, shape=LADYBUG_SHAPE,
                  device=None) -> dict:
    """ms/sweep of the raw chain of ``k`` ``gbp_sweep`` calls and of the
    production ``run_gbp(k, with_diagnostics=False, iter_offset=
    accel_start)`` on ``synthetic_problem_large(*shape)`` after
    ``initialise``; guards that every timed run leaves a finite, lower
    error. ``rep_errs`` and ``run_errs``: the error after each timed run
    (the same state each time, so the same number); ``state_kept``: the
    initialised state's error is unchanged after all of them."""
    dev = resolve_device(device)
    cfg = GBPConfig()
    graph, state = initialised(balio.synthetic_problem_large(*shape), cfg,
                                dev)
    err0 = _err(state, graph)

    def err(s):
        return _err(s, graph)

    dt, errs = time_reps(sweep_chain(graph, cfg, k), state, after=err)
    _guard_down("LADYBUG", err0, errs)
    ms = dt * 1e3 / k
    label = device_label(dev)
    print(f"ladybug: {graph.n_edges} edges, err {err0:.2f} -> {errs[-1]:.2f}"
          f" px after {k} sweeps, {ms:.3f} ms/sweep ({label})",
          file=sys.stderr)

    def run(s):
        return gbp.run_gbp(s, graph, cfg, k, with_diagnostics=False,
                           iter_offset=cfg.accel_start)[0]

    dt_run, run_errs = time_reps(run, state, after=err)
    _guard_down("LADYBUG RUN", err0, run_errs)
    run_ms = dt_run * 1e3 / k
    print(f"ladybug production run_gbp: {run_ms:.3f} ms/sweep ({label})",
          file=sys.stderr)
    return {"ms_per_sweep": ms, "run_gbp_ms_per_sweep": run_ms,
            "edges": graph.n_edges, "err0": err0, "err_px": errs[-1],
            "rep_errs": errs, "run_errs": run_errs,
            "state_kept": err(state) == err0, "device": label}


def bench_venice(k: int = VENICE_K, shape=VENICE_SHAPE,
                 device=None) -> dict:
    """ms/sweep of the raw chain of ``k`` sweeps (two timed runs) on
    ``synthetic_problem_large(*shape)``; guards that the error falls and
    that a sweep takes at most VENICE_NS_PER_EDGE_GUARD ns an edge."""
    dev = resolve_device(device)
    cfg = GBPConfig()
    graph, state = initialised(balio.synthetic_problem_large(*shape), cfg,
                                dev)
    err0 = _err(state, graph)
    dt, errs = time_reps(sweep_chain(graph, cfg, k), state, reps=2,
                         after=lambda s: _err(s, graph))
    ms = dt * 1e3 / k
    ns_edge = ms * 1e6 / graph.n_edges
    label = device_label(dev)
    print(f"venice: {graph.n_edges} edges, err {err0:.2f} -> {errs[-1]:.2f} "
          f"px after {k} sweeps, {ms:.3f} ms/sweep ({ns_edge:.3f} ns/edge) "
          f"({label})", file=sys.stderr)
    _guard_down("VENICE", err0, errs)
    if not ns_edge <= VENICE_NS_PER_EDGE_GUARD:
        raise GuardFailed(f"VENICE PERF GUARD FAILED: {ns_edge:.3f} ns/edge "
                          f"> {VENICE_NS_PER_EDGE_GUARD}")
    return {"ms_per_sweep": ms, "edges": graph.n_edges,
            "ns_per_edge": ns_edge, "err0": err0, "err_px": errs[-1],
            "device": label}


def slam_config(ibk: int) -> GBPConfig:
    """The slam driver's damped Gauss-Newton schedule at ``ibk`` sweeps a
    keyframe, as the JAX benchmark sets it."""
    return GBPConfig(relin_every_iter=True, eta_damping=0.7,
                     lambda_damping=True, iters_before_damping=0,
                     relin_behind_camera=False,
                     behind_camera_rescue_iters=300, iters_between_kfs=ibk)


def bench_slam(seq, ibk: int = SLAM_IBK, device=None) -> dict:
    """Sweeps/s of incremental SLAM over the whole sequence (a name, a BAL
    file or a BAProblem) at ``ibk`` sweeps a keyframe, insertion and the
    host's work per segment included: what a SLAM user waits for. The
    three steps run once first on a throwaway copy. Guards the final
    error below 3 px. Returns the numbers (``accel_steps``: the
    accelerator steps of the timed run), and the final ``state``, its
    ``graph`` and ``cfg`` for a caller that measures more on them."""
    dev = resolve_device(device)
    cfg = slam_config(ibk)
    problem = seq if isinstance(seq, balio.BAProblem) else balio.load_bal(seq)
    name = "problem" if isinstance(seq, balio.BAProblem) else seq
    graph = build_graph(problem, cfg, dev)
    state0 = init_state(problem, cfg, dev,
                        flags=flags_lib.create_flags(problem, cfg.steps))

    steps = []

    def runner(s):
        return gbp.run_gbp(s, graph, cfg, ibk, with_diagnostics=False,
                           accel_log=steps)

    def inserter(s, k):
        return slam.insert_keyframe(s, graph, cfg, k, 1.0)

    def initialiser(s):
        return gbp.initialise(s, graph, cfg)

    w, _ = runner(initialiser(state0.clone()))
    inserter(w, 1)
    del w
    steps.clear()
    synchronize(dev)

    t0 = time.perf_counter()
    res = slam.solve_slam(state0, graph, cfg,
                          n_keyframes=problem.n_keyframes,
                          iters_between_kfs=ibk, with_diagnostics=False,
                          runner=runner, inserter=inserter,
                          initialiser=initialiser)
    synchronize(dev)
    dt = time.perf_counter() - t0
    n_sweeps = (problem.n_keyframes - 1) * ibk
    err = _err(res.state, graph)
    if not (np.isfinite(err) and err < SLAM_GUARD_PX):
        raise GuardFailed(f"SLAM GUARD FAILED ({name}): final err={err}")
    label = device_label(dev)
    print(f"slam {name}: {problem.n_keyframes} kf x {ibk} iters, "
          f"{n_sweeps / dt:.1f} sweeps/s incl. insertion, final err "
          f"{err:.6f} px ({label})", file=sys.stderr)
    return {"seq": name, "keyframes": problem.n_keyframes, "ibk": ibk,
            "sweeps": n_sweeps, "seconds": dt,
            "sweeps_per_sec": n_sweeps / dt, "final_err_px": err,
            "accel_steps": len(steps), "device": label, "state": res.state,
            "graph": graph, "cfg": cfg}


def main() -> int:
    """The benchmark with the environment hooks; prints the JSON line and
    returns 0, or prints the failed guard and returns 1."""
    seq = os.environ.get("GBP_BENCH_SEQ", SEQ)
    n_sweeps = int(os.environ.get("GBP_BENCH_SWEEPS", N_SWEEPS))
    guard_iters = int(os.environ.get("GBP_BENCH_GUARD_ITERS", GUARD_ITERS))
    guard_px = float(os.environ.get("GBP_BENCH_GUARD_PX", GUARD_PX))
    with_extra = os.environ.get("GBP_BENCH_EXTRA", "1") != "0"
    with_scale = os.environ.get("GBP_BENCH_SCALE", "1") != "0"
    dev = resolve_device()

    try:
        head = bench_tum(seq, n_sweeps, guard_iters, guard_px, dev)
        extra = {"err_at_guard_px": round(head["err_at_guard_px"], 3)}
        if with_extra:
            r2 = bench_tum("fr2robot2", n_sweeps, guard_iters,
                           min(guard_px, 2.0), dev)
            extra["fr2robot2_sweeps_per_sec"] = round(r2["sweeps_per_sec"], 2)
            extra["fr2robot2_err_at_guard_px"] = round(r2["err_at_guard_px"],
                                                       3)
            # fr1desk: the sequence with a known float32-bistable failure
            # mode; a schedule change that re-breaks it must show
            dk = bench_tum("fr1desk", n_sweeps, guard_iters, guard_px, dev)
            extra["fr1desk_sweeps_per_sec"] = round(dk["sweeps_per_sec"], 2)
            extra["fr1desk_err_at_guard_px"] = round(dk["err_at_guard_px"], 3)
            ibk = int(os.environ.get("GBP_BENCH_SLAM_IBK", SLAM_IBK))
            sl = bench_slam(SLAM_SEQ, ibk, dev)
            extra["slam_fr2robot2_sweeps_per_sec"] = round(
                sl["sweeps_per_sec"], 2)
            extra["slam_fr2robot2_final_err_px"] = round(sl["final_err_px"],
                                                         3)
            del sl
        if with_scale:
            lb = bench_ladybug(LADYBUG_K, device=dev)
            extra["ladybug_ms_per_sweep"] = round(lb["ms_per_sweep"], 4)
            extra["ladybug_run_gbp_ms_per_sweep"] = round(
                lb["run_gbp_ms_per_sweep"], 4)
            extra["ladybug_edges"] = int(lb["edges"])
            extra["ladybug_ns_per_edge"] = round(
                lb["ms_per_sweep"] * 1e6 / lb["edges"], 3)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            if os.environ.get("GBP_BENCH_VENICE", "1") != "0":
                vn = bench_venice(VENICE_K, device=dev)
                extra["venice_ms_per_sweep"] = round(vn["ms_per_sweep"], 4)
                extra["venice_edges"] = int(vn["edges"])
                extra["venice_ns_per_edge"] = round(vn["ns_per_edge"], 3)
    except GuardFailed as e:
        print(e, file=sys.stderr)
        return 1

    sps = head["sweeps_per_sec"]
    # a file's metric is named after the file, not its directory
    name = (os.path.splitext(os.path.basename(seq))[0]
            if os.path.isfile(seq) else seq)
    print(json.dumps({
        "metric": f"gbp_sweeps_per_sec_{name}",
        "value": round(sps, 2),
        "unit": "sweeps/s",
        "vs_baseline": round(sps / BASELINE_SWEEPS_PER_SEC, 3),
        "extra": extra,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
