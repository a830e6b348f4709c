"""Host seconds per solve in build_graph + init_state (span ``build``)."""


def read(run):
    n = run.counts.get("solves", 0)
    return run.spans.get("build", 0.0) / n if n else None
