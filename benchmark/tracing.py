"""Reading a ``torch.profiler`` chrome trace: device time by kernel, the
device's busy share, where it idles, and what each of the program's own
steps issued.

The event selection, the interval union and the rule that gives a runtime
call to the spans enclosing it are copied from
``gbp_poplar_tpu_torch/tools/profile_sweep.py`` (``trace_events``,
``busy_share``, ``kernel_times``, ``span_table``), kept here so that a
change to the program cannot move the yardstick. Times in a chrome trace
are in µs; everything returned here is in seconds.
"""

from __future__ import annotations

import bisect
import dataclasses
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op",)
MARK_CAT = "user_annotation"
UNIT_MARK = "bench.unit"
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
STEP_PREFIX = "gbp."      # the program's spans (utils/trace.py)
# The runtime and driver calls that start device work, each one launch: a
# kernel, a whole CUDA graph (one call however many kernels it holds), a
# copy, a set. Inside a stream capture the same calls record into the
# graph and start nothing on the device; they count all the same.
LAUNCH_CALLS = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
    "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch",
    "cudaMemcpy", "cudaMemcpyAsync", "cudaMemcpy2DAsync",
    "cudaMemcpyPeerAsync", "cuMemcpyAsync", "cuMemcpyHtoDAsync_v2",
    "cuMemcpyDtoHAsync_v2", "cuMemcpyDtoDAsync_v2",
    "cudaMemset", "cudaMemsetAsync", "cuMemsetD8Async", "cuMemsetD32Async",
})


@dataclasses.dataclass
class Trace:
    """The device events (sorted by start), the top-level host operators,
    the benchmark's own marks, and the traced window [t0, t1] in µs: the
    span of the ``bench.unit`` mark. ``plain_s``: the same unit's seconds
    unprofiled, by the host's clock, when it was timed."""

    device: list
    host: list
    marks: list
    t0: float
    t1: float
    plain_s: float | None = None

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6


def _top_level(evs: list) -> list:
    """The events no other event of the same thread encloses."""
    top, end = [], {}
    for e in sorted(evs, key=lambda e: (e.get("tid"), e["ts"], -e["dur"])):
        if e["ts"] >= end.get(e.get("tid"), float("-inf")):
            top.append(e)
            end[e.get("tid")] = e["ts"] + e["dur"]
    return top


@dataclasses.dataclass
class Step:
    """One of the program's spans over a trace: its calls, the launches
    (``LAUNCH_CALLS``) made inside them, the device events those calls
    started, their device seconds, and the events by name."""

    calls: int = 0
    launches: int = 0
    events: int = 0
    device_s: float = 0.0
    kernels: dict = dataclasses.field(default_factory=dict)


def complete_events(trace) -> list:
    """The complete (``ph`` X) events of a chrome trace file, or the list
    itself when given one."""
    if not isinstance(trace, str):
        return trace
    with open(trace) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def load(path) -> Trace:
    evs = complete_events(path)
    marks = [e for e in evs if e.get("cat") == MARK_CAT
             and str(e.get("name", "")).startswith("bench.")]
    unit = [e for e in marks if e["name"] == UNIT_MARK]
    if not unit:
        raise ValueError(f"the trace holds no {UNIT_MARK} mark")
    t0 = min(e["ts"] for e in unit)
    t1 = max(e["ts"] + e["dur"] for e in unit)
    device = sorted((e for e in evs if e.get("cat") in DEVICE_CATS),
                    key=lambda e: e["ts"])
    host = _top_level([e for e in evs if e.get("cat") in HOST_CATS])
    return Trace(device=device, host=host, marks=marks, t0=t0, t1=t1)


def _enclosing(spans: list, calls: list) -> dict:
    """{key: names of the spans enclosing the call, outermost first} for
    ``calls`` [(tid, ts, key)], each against the spans of its own thread
    (properly nested, as ``record_function`` makes them)."""
    by_tid = {}
    for e in spans:
        by_tid.setdefault(e.get("tid"), []).append(e)
    per_tid = {}
    for c in calls:
        per_tid.setdefault(c[0], []).append(c)
    out = {}
    for tid, mine in per_tid.items():
        sp = sorted(by_tid.get(tid, []), key=lambda e: (e["ts"], -e["dur"]))
        stack, i = [], 0
        for _, ts, key in sorted(mine, key=lambda c: (c[1], c[2])):
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


def program_steps(trace) -> dict:
    """{span name: Step} of the program's spans (``user_annotation`` events
    named ``gbp.*``) in a chrome trace (a file or its complete events). A
    runtime or driver call counts for every span that encloses it on its
    own thread, so a nested span's calls count for its parents too; the
    device events (kernels, copies, sets) that carry its ``correlation`` id
    count with it (a graph launch's kernels carry the launch's)."""
    evs = complete_events(trace)
    spans = [e for e in evs if e.get("cat") == MARK_CAT
             and str(e.get("name", "")).startswith(STEP_PREFIX)]
    steps = {}
    for e in spans:
        steps.setdefault(e["name"], Step()).calls += 1
    runtime = [e for e in evs if e.get("cat") in RUNTIME_CATS]
    owner = _enclosing(spans, [(e.get("tid"), e["ts"], i)
                               for i, e in enumerate(runtime)])
    issued = {}
    for i, e in enumerate(runtime):
        names = set(owner.get(i, ()))
        if e.get("name") in LAUNCH_CALLS:
            for name in names:
                steps[name].launches += 1
        corr = e.get("args", {}).get("correlation")
        if corr is not None and names:
            issued[corr] = names
    for e in evs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        for name in issued.get(e.get("args", {}).get("correlation"), ()):
            st = steps[name]
            st.events += 1
            st.device_s += e["dur"] / 1e6
            st.kernels[e["name"]] = st.kernels.get(e["name"], 0) + 1
    return steps


def busy_intervals(tr: Trace) -> list:
    """The union of the device events inside the window, as sorted
    disjoint [a, b] (µs)."""
    out = []
    for e in tr.device:
        a, b = max(e["ts"], tr.t0), min(e["ts"] + e["dur"], tr.t1)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_s(tr: Trace) -> float:
    return sum(b - a for a, b in busy_intervals(tr)) / 1e6


def kernel_times(tr: Trace) -> dict:
    """{name: (seconds, events)} of the device events in the window."""
    per = {}
    for e in tr.device:
        if tr.t0 <= e["ts"] < tr.t1:
            s, n = per.get(e["name"], (0.0, 0))
            per[e["name"]] = (s + e["dur"] / 1e6, n + 1)
    return per


def named(tr: Trace, marker: str, exclude: str | None = None) -> list:
    """The device events in the window whose name holds ``marker`` (and
    not ``exclude``)."""
    return [e for e in tr.device if marker in e["name"]
            and (exclude is None or exclude not in e["name"])
            and tr.t0 <= e["ts"] < tr.t1]


def _covering(evs: list, starts: list, t: float):
    """The latest-starting event of ``evs`` (sorted by start) that covers
    time t, looking back over at most 64 events."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - 64), -1):
        if evs[j]["ts"] + evs[j]["dur"] >= t:
            return evs[j]
    return None


def idle_by_host(tr: Trace, top: int = 10) -> list:
    """[[what the host was doing, idle seconds]] for the device's idle time
    in the window, most first: each idle gap is named after the innermost
    benchmark mark and the top-level host operator running at its middle
    ("python" between operators)."""
    host = sorted(tr.host, key=lambda e: e["ts"])
    hs = [e["ts"] for e in host]
    marks = sorted((m for m in tr.marks if m["name"] != UNIT_MARK),
                   key=lambda e: e["ts"])
    ms = [m["ts"] for m in marks]
    per = {}
    edge = tr.t0
    for a, b in busy_intervals(tr) + [[tr.t1, tr.t1]]:
        if a > edge:
            mid = 0.5 * (edge + a)
            m = _covering(marks, ms, mid)
            h = _covering(host, hs, mid)
            name = (m["name"] if m else "bench.unit") + " > " + (
                h["name"] if h else "python")
            per[name] = per.get(name, 0.0) + (a - edge) / 1e6
        edge = max(edge, b)
    return sorted(([k, v] for k, v in per.items()),
                  key=lambda r: -r[1])[:top]


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations with the most
    time and the device's idle time by what the host was doing (the host
    profiler's own cost counts among the gaps)."""
    ops = sorted(([k[:120], v[0]] for k, v in kernel_times(tr).items()),
                 key=lambda r: -r[1])[:top]
    return {"device_ops": ops, "idle_gaps": idle_by_host(tr, top)}
