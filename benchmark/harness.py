"""One run of one cell: set-up, the measured window, the traced unit, the
check against the reference, and the result line.

Everything belonging to one cell is found by name: the cell in
``BENCHMARK.json``'s ``workloads``, its configuration's file (``configs``),
its traffic ``traffic/<traffic>.json`` (data: the procedure it runs and
that procedure's parameters), the procedure ``procedures/<procedure>.py``
(its unit of work, what it counts and how its answers are judged; see
``units.py``), its limits ``limits/<workload>.json``, and each metric's
reader ``metrics/<name>.py``, named by the metric's name up to its first
dot (``gbp_ms_per_sweep.slam`` reads with ``gbp_ms_per_sweep.py``): a
function ``read(run)`` returning a number, or None when the run has
nothing to read. A cell, a traffic mix, a procedure, a configuration or a
metric is added by adding files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

import check
import gen
import roofline
import tracing

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "gbp_poplar_tpu")


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    metrics: list          # BENCHMARK.json entries: end_to_end + per_layer
    per_layer: set         # names of the per-layer ones


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` and its files, its
    traffic and limits in ``root``'s copy of this folder."""
    folder = os.path.join(root, os.path.relpath(BENCH, ROOT))
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"error: no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if m["moves"] in moved and _applies(m, name)]
    return Cell(
        workload=wl,
        config=load_json(os.path.join(root, cfg_entry["file"])),
        traffic=load_json(os.path.join(folder, "traffic",
                                        wl["traffic"] + ".json")),
        limits=load_json(os.path.join(folder, "limits", name + ".json")),
        metrics=e2e + layer, per_layer={m["name"] for m in layer})


def _load_module(kind: str, name: str):
    path = os.path.join(BENCH, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """``read`` of ``metrics/<metric up to its first dot>.py``."""
    return _load_module("metrics", metric.split(".")[0]).read


def procedure(name: str):
    """The module ``procedures/<name>.py`` (it imports the program)."""
    return _load_module("procedures", name)


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    setup_s: float
    window_s: float
    spans: dict            # seconds per span name, the window's units
    counts: dict           # the window's counts (solves, sweeps, ...)
    latencies: list        # keyframe latencies (s), the window's
    peak_bytes: int        # torch.cuda.max_memory_allocated in the window
    shape: roofline.Shape
    trace: tracing.Trace | None = None
    # the traced window's program spans as collected ({span: (host s,
    # calls)}, ``units.program_spans``), and the profiled unit's
    # ({span: tracing.Step}); None in an untraced run
    program: dict | None = None
    steps: dict | None = None


def shape_of(problem, pad_multiple: int) -> roofline.Shape:
    """The algorithm's sizes: padded edges, and the two segmented sums
    (edges in landmark order: cameras listed through a permutation,
    landmarks contiguous)."""
    m = max(1, pad_multiple)
    return roofline.Shape(
        n_edges=-(-problem.n_edges // m) * m,
        n_keyframes=problem.n_keyframes, n_points=problem.n_points,
        snavely=problem.intrinsics is not None,
        cam=roofline.Side(problem.n_edges, problem.n_keyframes, True),
        lmk=roofline.Side(problem.n_edges, problem.n_points, False))


def power_line() -> str:
    """The card's name and power limit, by nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def forbidden_modules() -> list[str]:
    """Modules loaded whose top-level name is JAX's or the JAX package's
    (compared whole: ``gbp_poplar_tpu_torch`` is not ``gbp_poplar_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def profile_unit(unit, dev, log=sys.stderr):
    """``unit.profiled`` timed by the host's clock between two
    synchronisations, unprofiled, straight after the window while the card
    is warm (``Trace.plain_s``: the host profiler's own cost stretches the
    traced unit, and not the device's busy time); then the same unit under
    ``torch.profiler`` (host and device), its chrome trace written under
    TMPDIR, read and deleted. Returns the ``tracing.Trace`` and, on a card,
    the program's steps in it (``tracing.program_steps``; None elsewhere,
    where the trace holds no device)."""
    import units
    from torch.profiler import ProfilerActivity, profile, record_function

    units.synchronize(dev)
    t0 = time.perf_counter()
    unit.profiled(units.Recorder(dev))
    units.synchronize(dev)
    plain_s = time.perf_counter() - t0
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    rec = units.Recorder(dev, marks=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=acts) as prof:
            with record_function(tracing.UNIT_MARK):
                unit.profiled(rec)
            units.synchronize(dev)
        prof.export_chrome_trace(path)
        evs = tracing.complete_events(path)
    tr = tracing.load(evs)
    steps = tracing.program_steps(evs) if dev.type == "cuda" else None
    tr.plain_s = plain_s
    print(f"profiled unit: {tr.plain_s!r} s unprofiled, {tr.window_s!r} s "
          "traced", file=log)
    return tr, steps


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             dev: torch.device, t_start: float, log=sys.stderr) -> dict:
    """Set-up, window, (traced unit), check; the result line's object."""
    import units

    if dev.type == "cuda":
        from gbp_poplar_tpu_torch.ops import _cuda

        _cuda.library()           # built by nvcc on a checkout's first run
    proc = procedure(cell.traffic["procedure"])
    problem = gen.make_problem(cell.config, seed)
    unit = proc.Unit(cell.config, cell.traffic, problem, dev, seed)
    unit.warm_up(units.Recorder(dev))
    units.synchronize(dev)
    setup_s = time.perf_counter() - t_start

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rec = units.Recorder(dev, sync=trace)
    with units.program_spans(trace) as totals:
        t0 = time.perf_counter()
        unit.window(rec, t0 + seconds)
        units.synchronize(dev)
        window_s = time.perf_counter() - t0
    program = dict(totals) if totals is not None else None
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    tr, steps = profile_unit(unit, dev, log) if trace else (None, None)
    pad = units.solver_config(cell.config, cell.traffic).edge_pad_multiple

    answers, latencies = unit.answers, unit.latencies
    del unit
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    judge = check.Judge(problem, cell.config, dev,
                        cell.traffic.get("av_depth", 1.0))
    checks, failed = check.judge(proc.rows(judge, answers), cell.limits)
    print(f"reference: {time.perf_counter() - t_ref!r} s over "
          f"{len(answers)} answers", file=log)

    run = Run(setup_s=setup_s, window_s=window_s, spans=rec.spans,
              counts=rec.counts, latencies=latencies, peak_bytes=peak,
              shape=shape_of(problem, pad), trace=tr, program=program,
              steps=steps)
    metrics = {}
    for m in cell.metrics:
        if (m["name"] in cell.per_layer) != trace:
            continue
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": failed == 0, "attempted": int(rec.counts.get(
        proc.KIND, 0)), "failed": int(failed), "metrics": metrics,
        "device": device}
    if tr is not None and dev.type == "cuda":
        device["busy_s"] = tracing.busy_s(tr)
        device["window_s"] = tr.window_s
        out["breakdown"] = tracing.breakdown(tr)
    out["checks"] = checks
    for n, c in checks.items():
        print(f"check {n}: {c['value']!r} (limit {c['limit']!r})", file=log)
    return out


def finite(obj):
    """The result with non-finite numbers as null (JSON has no NaN)."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [finite(v) for v in obj]
    return obj
