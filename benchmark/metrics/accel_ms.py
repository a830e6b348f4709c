"""Host ms an accelerator step (span ``gbp.accel_step``: eager, captured
or replayed) in the traced window."""

import steps


def read(run):
    return steps.host_ms(run, steps.ACCEL)
