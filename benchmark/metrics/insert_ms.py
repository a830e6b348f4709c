"""Wall ms per insert_keyframe (span ``insert``)."""


def read(run):
    n = run.counts.get("inserts", 0)
    return 1e3 * run.spans["insert"] / n if n else None
