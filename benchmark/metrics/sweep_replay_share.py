"""Share of the traced window's runs of sweeps replayed from their CUDA
graph (%): those run neither eagerly (``gbp.sweeps_eager``) nor captured
(``gbp.sweeps_capture``), over all (``gbp.sweeps``). Every solve's
annealed run is eager, so a window with runs of sweeps but none marked
eager comes from a program without these spans: nothing is read."""

import steps

SWEEPS_EAGER = "gbp.sweeps_eager"
SWEEPS_CAPTURE = "gbp.sweeps_capture"


def read(run):
    n = steps.calls(run, steps.SWEEPS)
    eager = steps.calls(run, SWEEPS_EAGER)
    if not n or not eager:
        return None
    return 100.0 * (1.0 - (eager + steps.calls(run, SWEEPS_CAPTURE)) / n)
