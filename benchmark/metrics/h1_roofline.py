"""H1 (csrc/sweep.cu sweep_kernel) against its bytes bound (%): the bytes
one fused sweep must move (roofline.sweep_bytes) at the card's published
bandwidth, over H1's mean device time per launch in the traced unit."""

import roofline
import tracing


def read(run):
    if run.trace is None:
        return None
    evs = tracing.named(run.trace, "sweep_kernel")
    if not evs:
        return None
    ms = sum(e["dur"] for e in evs) / len(evs) / 1e3
    return 100.0 * roofline.least_ms(roofline.sweep_bytes(run.shape)) / ms
