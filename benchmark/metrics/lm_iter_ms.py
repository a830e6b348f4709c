"""Host ms an LM iteration of the polish (span ``gbp.lm_iter``) in the
traced window."""

import steps


def read(run):
    return steps.host_ms(run, steps.LM_ITER)
