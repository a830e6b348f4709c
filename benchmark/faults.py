"""Faults planted under the timed path, which the comparison that decides
``correct`` has to fail: each patches an attribute the procedures call
through, with ``put(obj, name, value)`` (``monkeypatch.setattr`` in the
tests, ``planted`` in ``control.py --faults``). A cell on one card has no
exchange between cards to leave out.

- ``unchanged``: a step that returns its state unchanged: ``run_gbp``
  sweeps nothing, its telemetry read at the state it was given;
- ``half_batch``: half of the observations left out, the means taken over
  the rest: the program gets every other edge of the problem (its graphs,
  the polish's too, and its telemetry cover those);
- ``altered``: an answer altered where it is produced: the means read back
  from the beliefs, the landmarks shifted by 3 cm.
"""

import contextlib
import dataclasses


def unchanged(put) -> None:
    from gbp_poplar_tpu_torch.core import gbp

    real = gbp.run_gbp

    def run_gbp(state, graph, cfg, n_iters, **kw):
        _, diag = real(state.clone(), graph, cfg, 1, **kw)
        err, cost, rel, rob, _ = diag
        return state, gbp.Diagnostics(*(x.expand(n_iters)
                                        for x in (err, cost, rel, rob)))

    put(gbp, "run_gbp", run_gbp)


def half_batch(put) -> None:
    import units

    real = units.program_problem

    def program_problem(p):
        q = real(p)
        keep = slice(0, None, 2)
        return dataclasses.replace(
            q, n_edges=len(q.cam_idx[keep]), cam_idx=q.cam_idx[keep],
            lmk_idx=q.lmk_idx[keep], measurements=q.measurements[keep])

    put(units, "program_problem", program_problem)


def altered(put) -> None:
    from gbp_poplar_tpu_torch.utils import analysis

    real = analysis.belief_means

    def belief_means(state):
        cam, lmk = real(state)
        return cam, lmk + 0.03

    put(analysis, "belief_means", belief_means)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": altered}


@contextlib.contextmanager
def planted(name: str):
    """The fault ``name`` planted for the ``with`` block."""
    saved = []

    def put(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    FAULTS[name](put)
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)
