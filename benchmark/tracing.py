"""Reading a ``torch.profiler`` chrome trace: device time by kernel, the
device's busy share, and where it idles.

The event selection and the interval union are copied from
``gbp_poplar_tpu_torch/tools/profile_sweep.py`` (``trace_events``,
``busy_share``, ``kernel_times``), kept here so that a change to the
program cannot move the yardstick. Times in a chrome trace are in µs;
everything returned here is in seconds.
"""

from __future__ import annotations

import bisect
import dataclasses
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op",)
MARK_CAT = "user_annotation"
UNIT_MARK = "bench.unit"


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


def load(path: str) -> Trace:
    with open(path) as f:
        evs = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
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
