"""Launches an LM iteration of the polish (``gbp.lm_iter``) in the
profiled unit."""

import steps


def read(run):
    return steps.launches(run, steps.LM_ITER)
