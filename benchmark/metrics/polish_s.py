"""Seconds per solve in the polish: its exact-edge graph and solve_lm
(span ``polish``)."""


def read(run):
    n = run.counts.get("solves", 0)
    return run.spans["polish"] / n if n and "polish" in run.spans else None
