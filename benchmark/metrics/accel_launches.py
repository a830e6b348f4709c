"""Launches an accelerator step (``gbp.accel_step``) in the profiled unit:
a replay's graph launch, input copies and output clones, and the eager
steps' and captures' calls (``tracing.LAUNCH_CALLS``)."""

import steps


def read(run):
    return steps.launches(run, steps.ACCEL)
