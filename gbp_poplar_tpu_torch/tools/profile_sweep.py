"""Device time per kernel inside ``run_gbp``, by ``torch.profiler``.

    python -m gbp_poplar_tpu_torch.tools.profile_sweep [ladybug|venice|fr1desk]
        [K] [--production] [--diagnostics]
    GBP_PLATFORM=cpu python -m gbp_poplar_tpu_torch.tools.profile_sweep \
        fr1desk 3

The counterpart of the JAX package's ``scripts/profile_sweep.py``. It
builds ``synthetic_problem_large`` at the named shape (default ladybug;
fr1desk is the TUM sequence's shape, 62 keyframes and 13,300 edges),
initialises it, runs ``run_gbp`` for K sweeps (default 50) once to warm
up, then traces one more call of K sweeps, recording the card only. It
prints each kernel's device µs per sweep with its share of the device
time and its launches per sweep, and the device's busy share between the
start of the first and the end of the last sweep kernel (the union of
kernel, copy and set intervals over that span).

``run_gbp`` runs K anneal-free sweeps of ``GBPConfig(accel_every=0)``;
with ``--production`` those of ``GBPConfig()`` from ``accel_start``
(accelerator chunks live once K >= 100), as the JAX script's production
mode; ``--diagnostics`` adds the per-sweep telemetry (H6).

On the CPU the trace holds the host's operators instead: the top-level
ones are read, and the span is the whole trace.

``busy_share`` and ``kernel_times`` read any chrome trace that
``torch.profiler`` exports (``scripts/torch_kernel_probe.py`` uses them).
``span_table`` reads the solver's own spans
(``utils/trace.span``, ``user_annotation`` events named ``gbp.*``) in such
a trace: calls, host time, and the device events issued inside each;
``idle_by_span`` names the device's idle gaps after the span the host was
in (``scripts/torch_step_profile.py`` uses them).
"""

from __future__ import annotations

import bisect
import json
import os
import sys
import tempfile

import torch

from ..config import GBPConfig
from ..core import build_graph, gbp, init_state
from ..utils import balio
from . import device_label, resolve_device, synchronize

SHAPES = {"ladybug": (1723, 156000, 7), "venice": (1778, 994000, 5),
          "fr1desk": (62, 1900, 7)}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op",)
SWEEP_MARK = "sweep"      # H1 sweep_kernel and H4 sweep_planes_kernel
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
SPAN_CAT = "user_annotation"
SPAN_PREFIX = "gbp."


def trace_events(trace, cats=DEVICE_CATS) -> list:
    """The complete events of ``cats`` in a chrome trace (a file or its
    complete events, ``complete_events``); for host operators
    (``cpu_op``) only the top-level ones of each thread."""
    evs = [e for e in complete_events(trace) if e.get("cat") in cats]
    if "cpu_op" not in cats:
        return evs
    top, end = [], {}
    for e in sorted(evs, key=lambda e: (e.get("tid"), e["ts"], -e["dur"])):
        if e["ts"] >= end.get(e.get("tid"), float("-inf")):
            top.append(e)
            end[e.get("tid")] = e["ts"] + e["dur"]
    return top


def _span(evs: list, marker: str | None) -> tuple[float, float]:
    marks = [e for e in evs if marker is None or marker in e["name"]]
    if not marks:
        raise ValueError(f"the trace holds no {marker} event")
    return (min(e["ts"] for e in marks),
            max(e["ts"] + e["dur"] for e in marks))


def busy_share(trace: str, marker: str | None,
               cats=DEVICE_CATS) -> tuple[float, float, list]:
    """From a chrome trace: the span (ms) from the start of the first to
    the end of the last event whose name holds ``marker`` (the whole
    trace for None), the share of it covered by the union of the events
    of ``cats``, and the five names with the most time in it [(name[:60],
    ms, events)]."""
    evs = trace_events(trace, cats)
    t0, t1 = _span(evs, marker)
    busy, end, per = 0.0, t0, {}
    for e in sorted(evs, key=lambda e: e["ts"]):
        a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
        if b <= a:
            continue
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        ms, n = per.get(e["name"], (0.0, 0))
        per[e["name"]] = (ms + (b - a) / 1e3, n + 1)
    top = sorted(((k[:60], *v) for k, v in per.items()),
                 key=lambda r: -r[1])[:5]
    return (t1 - t0) / 1e3, busy / (t1 - t0), top


def kernel_times(trace: str, cats=DEVICE_CATS) -> dict:
    """{name: (µs, events)} summed over the whole trace."""
    per = {}
    for e in trace_events(trace, cats):
        us, n = per.get(e["name"], (0.0, 0))
        per[e["name"]] = (us + e["dur"], n + 1)
    return per


def complete_events(trace) -> list:
    """The complete (``ph`` X) events of a chrome trace file, or the list
    itself when given one."""
    if not isinstance(trace, str):
        return trace
    with open(trace) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _spans(evs: list) -> list:
    return [e for e in evs if e.get("cat") == SPAN_CAT
            and str(e.get("name", "")).startswith(SPAN_PREFIX)]


def _enclosing(spans: list, calls: list) -> dict:
    """{key: names of the spans enclosing the call, outermost first} for
    ``calls`` [(tid, ts, key)], each against the spans of its own thread
    (properly nested, as ``record_function`` makes them)."""
    by_tid = {}
    for e in spans:
        by_tid.setdefault(e.get("tid"), []).append(e)
    out = {}
    for tid in {c[0] for c in calls}:
        sp = sorted(by_tid.get(tid, []), key=lambda e: (e["ts"], -e["dur"]))
        stack, i = [], 0
        for _, ts, key in sorted(c for c in calls if c[0] == tid):
            while i < len(sp) and sp[i]["ts"] <= ts:
                while stack and (stack[-1]["ts"] + stack[-1]["dur"]
                                 < sp[i]["ts"]):
                    stack.pop()
                stack.append(sp[i])
                i += 1
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < ts:
                stack.pop()
            out[key] = tuple(e["name"] for e in stack)
    return out


def span_table(trace) -> dict:
    """{span name: (calls, device events, device s, host s)} of the
    solver's spans in a chrome trace (a file or its complete events). A
    device event (kernel, copy, set) is issued inside every span that
    encloses, on the launching thread, the runtime call (``cuda_runtime``,
    ``cuda_driver``) carrying its ``correlation`` id, so a nested span's
    events count for its parents too; its device seconds are its own
    duration. Host seconds: the spans' durations (stretched by the
    profiler's own cost)."""
    evs = complete_events(trace)
    spans = _spans(evs)
    calls = [(e.get("tid"), e["ts"], e["args"]["correlation"]) for e in evs
             if e.get("cat") in RUNTIME_CATS
             and "correlation" in e.get("args", {})]
    owner = _enclosing(spans, calls)
    table = {}
    for e in spans:
        n, k, d, h = table.get(e["name"], (0, 0, 0.0, 0.0))
        table[e["name"]] = (n + 1, k, d, h + e["dur"] / 1e6)
    for e in evs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        for name in set(owner.get(e.get("args", {}).get("correlation"), ())):
            n, k, d, h = table[name]
            table[name] = (n, k + 1, d + e["dur"] / 1e6, h)
    return table


def idle_by_span(trace, t0: float | None = None, t1: float | None = None,
                 top: int = 10) -> list:
    """[[name, idle seconds]] of the device's idle time in [t0, t1] (µs;
    the whole trace for None), most first: each gap between device events
    is named ``<innermost gbp.* span> > <top-level host operator>`` at its
    middle (``python`` between operators; the span part left out where no
    span covers it)."""
    evs = complete_events(trace)
    dev = sorted((e for e in evs if e.get("cat") in DEVICE_CATS),
                 key=lambda e: e["ts"])
    host = trace_events(evs, HOST_CATS)
    spans = sorted(_spans(evs), key=lambda e: (e["ts"], -e["dur"]))
    if t0 is None:
        everything = dev + host + spans
        t0 = min(e["ts"] for e in everything)
        t1 = max(e["ts"] + e["dur"] for e in everything)
    busy = []
    for e in dev:
        a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
        if b <= a:
            continue
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])

    host.sort(key=lambda e: e["ts"])
    hs, ss = [e["ts"] for e in host], [e["ts"] for e in spans]

    def covering(evs, starts, t, look):
        # the latest-starting event covering t: the innermost of nested
        # spans; host operators are the top-level ones, so one per thread
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(-1, i - look), -1):
            if evs[j]["ts"] + evs[j]["dur"] >= t:
                return evs[j]
        return None

    per, edge = {}, t0
    for a, b in busy + [[t1, t1]]:
        if a > edge:
            mid = 0.5 * (edge + a)
            s = covering(spans, ss, mid, len(spans))
            h = covering(host, hs, mid, 64)
            name = ((s["name"] + " > ") if s else "") + (
                h["name"] if h else "python")
            per[name] = per.get(name, 0.0) + (a - edge) / 1e6
        edge = max(edge, b)
    return sorted(([k, v] for k, v in per.items()), key=lambda r: -r[1])[:top]


def profile_run(state, graph, cfg: GBPConfig, k: int,
                diagnostics: bool = False,
                iter_offset: int | None = None) -> dict:
    """Trace ``run_gbp(state, graph, cfg, k)`` after one warm-up call of
    the same, which the profiler sees in its warm-up step, so that the
    traced call's first launches are recorded too (the state advances 2 k
    sweeps). Returns the device label, ``span_ms`` and ``busy`` (see
    ``busy_share``) and ``kernels``: [(name, µs per sweep, share of the
    traced device time, events per sweep)], most time first."""
    from torch.profiler import ProfilerActivity, profile, schedule

    dev = state.pk.device
    off = 2 * cfg.steps if iter_offset is None else iter_offset
    cuda = dev.type == "cuda"
    cats = DEVICE_CATS if cuda else HOST_CATS

    def run():
        gbp.run_gbp(state, graph, cfg, k, with_diagnostics=diagnostics,
                    iter_offset=off)
        synchronize(dev)

    acts = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace.json")
        with profile(activities=acts,
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(trace)
                     ) as prof:
            for _ in range(2):
                run()
                prof.step()
        span, busy, _ = busy_share(trace, SWEEP_MARK if cuda else None, cats)
        per = kernel_times(trace, cats)
    total = sum(us for us, _ in per.values()) or 1.0
    rows = sorted(((name, us / k, us / total, n / k)
                   for name, (us, n) in per.items()), key=lambda r: -r[1])
    return {"device": device_label(dev), "sweeps": k, "span_ms": span,
            "busy": busy, "kernels": rows}


def profile(name: str = "ladybug", k: int = 50, production: bool = False,
            diagnostics: bool = False, device=None) -> dict:
    """Build the named shape on the device, initialise, ``profile_run``."""
    dev = resolve_device(device)
    cfg = GBPConfig() if production else GBPConfig(accel_every=0)
    prob = balio.synthetic_problem_large(*SHAPES[name])
    graph = build_graph(prob, cfg, dev)
    state = gbp.initialise(init_state(prob, cfg, dev), graph, cfg)
    out = profile_run(state, graph, cfg, k, diagnostics,
                      cfg.accel_start if production else None)
    out.update(problem=name, edges=prob.n_edges, production=production,
               diagnostics=diagnostics)
    return out


def report(r: dict, top: int = 12) -> list[str]:
    where = "device" if r["device"] != "cpu" else "host (CPU ops)"
    lines = [f"{r.get('problem', 'run_gbp')}: K={r['sweeps']} sweeps"
             + (f", {r['edges']} edges" if "edges" in r else "")
             + f"; {where} time per sweep by name (us, share, launches):"]
    for name, us, share, n in r["kernels"][:top]:
        lines.append(f"  {us:10.1f} us/sweep  {100 * share:5.1f}%  "
                     f"{n:6.2f}/sweep  {name[:90]}")
    lines.append(f"busy {100 * r['busy']:.1f}% of the {r['span_ms']:.3f} ms "
                 f"span; {r['device']}")
    return lines


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = [a for a in argv if not a.startswith("--")]
    name = args[0] if args else "ladybug"
    if name not in SHAPES:
        print(__doc__, file=sys.stderr)
        return 2
    r = profile(name, int(args[1]) if len(args) > 1 else 50,
                production="--production" in argv,
                diagnostics="--diagnostics" in argv)
    for line in report(r):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
