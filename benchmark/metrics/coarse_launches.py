"""Launches a coarse step (``gbp.coarse_step``) in the profiled unit."""

import steps


def read(run):
    return steps.launches(run, steps.COARSE)
