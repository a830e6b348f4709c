"""The window's time over the solves it completed (s)."""


def read(run):
    n = run.counts.get("solves", 0)
    return run.window_s / n if n else None
