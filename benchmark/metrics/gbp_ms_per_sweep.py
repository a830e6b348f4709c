"""Wall ms per sweep of initialise + run_gbp (span ``gbp``): the sweeps,
the accelerator and coarse steps and the telemetry read back."""


def read(run):
    n = run.counts.get("sweeps", 0)
    return 1e3 * run.spans["gbp"] / n if n and "gbp" in run.spans else None
