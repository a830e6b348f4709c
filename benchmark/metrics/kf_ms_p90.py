"""The 90th percentile of the window's keyframe latencies (ms): from a
keyframe's insertion to the synchronised end of the segment that refines
the map with it."""

import numpy as np


def read(run):
    if not run.latencies:
        return None
    return float(np.percentile(np.asarray(run.latencies) * 1e3, 90))
