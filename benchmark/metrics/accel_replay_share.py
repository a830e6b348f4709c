"""Share of the traced window's accelerator steps replayed from their CUDA
graph (%): those run neither eagerly (``gbp.accel_eager``) nor captured
(``gbp.accel_capture``), over all (``gbp.accel_step``)."""

import steps


def read(run):
    n = steps.calls(run, steps.ACCEL)
    if not n:
        return None
    other = (steps.calls(run, steps.ACCEL_EAGER)
             + steps.calls(run, steps.ACCEL_CAPTURE))
    return 100.0 * (1.0 - other / n)
