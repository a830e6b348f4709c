"""Host ms a coarse step (span ``gbp.coarse_step``) in the traced
window."""

import steps


def read(run):
    return steps.host_ms(run, steps.COARSE)
