"""H3 (csrc/reduce.cu) against its bytes bound (%) per belief update: the
bytes of both kinds' sums (roofline.belief_update_bytes) at the card's
published bandwidth, over the mean device time of the reduce kernels that
follow each H1 launch in the traced unit (a sweep's belief update)."""

import roofline


def read(run):
    tr = run.trace
    if tr is None:
        return None
    evs = [e for e in tr.device if tr.t0 <= e["ts"] < tr.t1]
    per, cur = [], None
    for e in evs:
        if "sweep_kernel" in e["name"]:
            if cur:
                per.append(cur)
            cur = 0.0
        elif cur is not None and "reduce_" in e["name"]:
            cur += e["dur"]
        else:
            if cur:
                per.append(cur)
            cur = None
    if cur:
        per.append(cur)
    if not per:
        return None
    ms = sum(per) / len(per) / 1e3
    return 100.0 * roofline.least_ms(
        roofline.belief_update_bytes(run.shape)) / ms
