"""Share of the profiled unit (one solve, or the first keyframes of a SLAM
pass) with no kernel, copy or set on the card (%): one minus the device
trace's busy time over the same unit's time unprofiled, by the host's
clock (the traced unit is stretched by the host profiler's own cost; the
device's busy time is not)."""

import tracing


def read(run):
    tr = run.trace
    if tr is None or not tr.device or not tr.plain_s:
        return None
    return 100.0 * (1.0 - tracing.busy_s(tr) / tr.plain_s)
