"""Tools around the solver: the port's counterparts of the JAX package's
sequence-free scripts, each a module with a function that returns its
numbers as a dict and a ``main(argv)`` for ``python -m``:

  - ``validate_scale``: GBP against the Levenberg-Marquardt oracle at
    1M+ edges (MAP cost ratios, ATE, the LM preconditioner's census);
  - ``memory_ledger``: the device memory of every graph and state tensor
    by field, and the peak per stage of a solve;
  - ``profile_sweep``: device time per kernel inside ``run_gbp`` by
    ``torch.profiler``, and the device's busy share;

and of the measurement scripts (the yardstick of a benchmark):

  - ``bench``: the headline sweeps/s with its guarded extra rows (a TUM
    file, the Ladybug and Venice shapes, incremental SLAM), one JSON line;
  - ``bench_sweep``: ms/sweep of the raw sweep chain or ``run_gbp`` at a
    named problem, and the problem-size ladder;
  - ``count_edge_ops``: the sweep body's operations per edge by class, and
    the card's bound on them;
  - ``bench_ablate``: the sweep's parts (tables + H1 + H3, H4, H5, H3)
    timed alone and in pairs;
  - ``bench_scaling``: sweeps/s of the sharded solvers at 1, 2, 4, ...
    cards;
  - ``scaling_model``: the predicted efficiency at N cards from the
    measured all-reduce payload, sweep time and per-call latency;

and of the sequence-level validation scripts (a TUM sequence by name,
under ``GBP_SEQUENCES_DIR``, or any BAL file):

  - ``validate_sequences``: batch GBP, the GN oracle and incremental SLAM
    per sequence (the accuracy and agreement table);
  - ``diagnose_accuracy``: the final per-edge state of a solve, and its
    comparison with the GN oracle (MAP cost split, the LM polish's basin
    test);
  - ``exp_ate_grid``: config variants against the GN oracle;
  - ``exp_drift_phase``: the two-phase drift-relinearisation schedules;
  - ``tune_schedule``: schedule variants and their error traces;

with ``seq_common`` (their ``k=v`` override parser, the MAP objective
split into robust and prior parts, the cold GN oracle).

Each runs on the drivers' device (``drivers.common.select_device``:
``cuda:0``, the CPU only under ``GBP_PLATFORM=cpu``, an error without a
card) unless the caller passes ``device``.
"""

from __future__ import annotations

import math
import subprocess
import time

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, or the drivers' device when None."""
    if device is None:
        from ..drivers.common import select_device
        return select_device()
    return torch.device(device)


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(dev: torch.device, fn):
    """(fn(), seconds on the host clock), the device synchronised before
    each clock read."""
    synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    synchronize(dev)
    return out, time.perf_counter() - t0


def device_label(dev: torch.device) -> str:
    """What a measurement ran on: nvidia-smi's ``name, power.limit`` of a
    card (its torch name if nvidia-smi cannot be run), or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(dev.index or 0)],
            capture_output=True, text=True, timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return torch.cuda.get_device_name(dev)


def paced_ms(fn, reps: int, dev: torch.device) -> tuple[float, float]:
    """(host, device) ms per call of ``fn()`` over ``reps`` calls after a
    warm-up call: the host's time to issue them (no synchronise inside)
    and, on a card, the CUDA events' time from the first one's start to
    the last one's end (on the CPU the host's time again). Equal times:
    the host sets the pace."""
    fn()
    synchronize(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = (time.perf_counter() - t0) / reps * 1e3
        return host, host
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    host = time.perf_counter() - t0
    stop.synchronize()
    return host / reps * 1e3, start.elapsed_time(stop) / reps


def time_reps(fn, state, reps: int = 3, after=None) -> tuple[float, list]:
    """Seconds of the fastest of ``reps`` calls ``fn(s)``, after one
    warm-up call. The solver updates its state in place, so every call
    (the warm-up too) gets its own ``state.clone()``, made outside the
    timed window, and ``state`` itself is never touched. Timed by CUDA
    events on a card (the host's pace included, as a caller waits for
    it), by the host clock on the CPU. ``after(out)`` runs on each timed
    call's result outside the window; returns (seconds, [its results])."""
    dev = state.pk.device
    fn(state.clone())
    synchronize(dev)
    best, results = math.inf, []
    for _ in range(reps):
        s = state.clone()
        synchronize(dev)
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(s)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            out = fn(s)
            dt = time.perf_counter() - t0
        best = min(best, dt)
        if after is not None:
            results.append(after(out))
        del s, out
    return best, results
