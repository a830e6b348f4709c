#!/usr/bin/env python3
"""Per-step readings of one benchmark cell, from the solver's own spans.

    python3 scripts/torch_step_profile.py --workload ladybug-ba \
        --seed 2147483901 --seconds 20

Runs the cell of ``BENCHMARK.json`` as ``benchmark/run.py --trace 1``
does: set-up from the seed and one warm-up unit, then the window of
``--seconds`` with the benchmark's synchronised spans, here inside
``utils/trace.collect()``, which gives each ``gbp.*`` span's host seconds
and calls; then one more bounded unit (a solve, or the cell's traced
keyframes) under ``torch.profiler`` over the host and the card, whose
chrome trace ``tools/profile_sweep`` reads: the device events and device
seconds issued inside each span (``span_table``) and the device's idle
gaps named after the span and host operator at their middle
(``idle_by_span``). Then it times one span with no sink on, with
collection on, and under the profiler.

Prints the card's name and power limit, then as its last line one JSON
object: ``steps``, the per-step readings (host ms per accelerator step,
coarse step and LM iteration, and the share of accelerator steps replayed
from their CUDA graph, in the window; device events per coarse step,
accelerator step and LM iteration, and per sweep, in the profiled unit);
``collected`` {span: [host s, calls]} of the window with the window's
units; ``profiled`` {span: [calls, device events, device s, host
s]}; ``idle_gaps``; ``span_us`` (one span's cost per sink). Needs the
benchmark's files beside the program and a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "benchmark"), ROOT]

import torch  # noqa: E402

import gen  # noqa: E402
import harness  # noqa: E402
import tracing  # noqa: E402
import units  # noqa: E402
from gbp_poplar_tpu_torch.tools import profile_sweep as ps  # noqa: E402
from gbp_poplar_tpu_torch.utils import trace  # noqa: E402

# per-step readings (key, span): host ms a call of the span in the window,
# or device events a call in the profiled unit
HOST_MS = (("accel_ms", "gbp.accel_step"), ("coarse_ms", "gbp.coarse_step"),
           ("lm_iter_ms", "gbp.lm_iter"))
LAUNCHES = (("coarse_launches", "gbp.coarse_step"),
            ("accel_launches", "gbp.accel_step"),
            ("lm_launches", "gbp.lm_iter"))


def span_cost_us(n: int = 20000) -> dict:
    """µs to enter and leave one span: no sink, collection on, under the
    profiler (host activity only)."""
    def per_span():
        t0 = time.perf_counter()
        for _ in range(n):
            with trace.span("gbp.cost"):
                pass
        return 1e6 * (time.perf_counter() - t0) / n

    out = {"off": per_span()}
    with trace.collect():
        out["collect"] = per_span()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        out["profiler"] = per_span()
    return out


def profiled_trace(unit, dev) -> list:
    """The complete events of one ``unit.profiled`` under the profiler,
    inside the benchmark's ``bench.unit`` mark."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(tracing.UNIT_MARK):
                unit.profiled(units.Recorder(dev, marks=True))
            units.synchronize(dev)
        prof.export_chrome_trace(path)
        return ps.complete_events(path)


def measure(workload: str, seed: int, seconds: float,
            dev: torch.device) -> dict:
    from gbp_poplar_tpu_torch.ops import _cuda

    cell = harness.load_cell(workload)
    _cuda.library()
    proc = harness.procedure(cell.traffic["procedure"])
    problem = gen.make_problem(cell.config, seed)
    unit = proc.Unit(cell.config, cell.traffic, problem, dev, seed)
    unit.warm_up(units.Recorder(dev))
    units.synchronize(dev)
    setup_s = time.perf_counter() - T_START

    rec = units.Recorder(dev, sync=True)
    with trace.collect() as totals:
        t0 = time.perf_counter()
        unit.window(rec, t0 + seconds)
        units.synchronize(dev)
        window_s = time.perf_counter() - t0
    evs = profiled_trace(unit, dev)
    table = ps.span_table(evs)
    mark = next(e for e in evs if e.get("name") == tracing.UNIT_MARK)
    gaps = ps.idle_by_span(evs, mark["ts"], mark["ts"] + mark["dur"], 12)
    n_h1 = sum(1 for e in ps.trace_events(evs)
               if "sweep_kernel" in e["name"])

    steps = {}
    for key, name in HOST_MS:
        s, n = totals.get(name, (0.0, 0))
        steps[key] = 1e3 * s / n if n else None
    for key, name in LAUNCHES:
        n, k = table.get(name, (0, 0, 0.0, 0.0))[:2]
        steps[key] = k / n if n else None
    k = table.get("gbp.sweeps", (0, 0))[1]
    steps["sweep_launches"] = k / n_h1 if n_h1 else None
    # the accelerator steps replayed from their CUDA graph in the window:
    # those neither run eagerly nor captured
    n = totals.get("gbp.accel_step", (0.0, 0))[1]
    other = sum(totals.get(name, (0.0, 0))[1]
                for name in ("gbp.accel_eager", "gbp.accel_capture"))
    steps["accel_replay_share"] = (n - other) / n if n else None
    return {"workload": workload, "seed": seed,
            "device": harness.power_line(), "setup_s": setup_s,
            "window_s": window_s, "units": rec.counts.get(proc.KIND, 0),
            "counts": rec.counts, "bench_spans": rec.spans, "steps": steps,
            "collected": {k: list(v) for k, v in sorted(totals.items())},
            "profiled": {k: list(v) for k, v in sorted(table.items())},
            "h1_launches": n_h1, "idle_gaps": gaps,
            "span_us": span_cost_us()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    print(f"card: {harness.power_line()}", file=sys.stderr)
    out = measure(args.workload, args.seed, args.seconds,
                  torch.device("cuda", 0))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
