"""Launches in the runs of sweeps (``gbp.sweeps``) of the profiled unit
per H1 launch in them (a sweep): the launches one sweep issues."""

import steps


def read(run):
    st = steps.step(run, steps.SWEEPS)
    if st is None:
        return None
    h1 = sum(n for name, n in st.kernels.items() if steps.H1 in name)
    return st.launches / h1 if h1 else None
