"""Entry points: one GBP sweep on a tiny problem, and a dry run of the
sharded solvers over several ranks.

The counterparts of the JAX package's ``__graft_entry__.py``: ``entry()``
returns the flagship compute step (per-factor relinearisation, message
marginalisation, belief reduction) with its inputs; ``dryrun_multichip(n)``
runs the sharded solvers' steps on ``n`` ranks of a ``torch.distributed``
group (``parallel.run``) on tiny shapes. Both run on the drivers' device
(``cuda:0``; the CPU under ``GBP_PLATFORM=cpu``) unless told otherwise.

    python -m gbp_poplar_tpu_torch.entry [n_ranks]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .config import GBPConfig
from .core import build_graph, gbp, init_state


def _tiny_problem():
    from .utils import balio

    return balio.synthetic_problem(n_keyframes=4, n_points=24, seed=0,
                                   pixel_noise=0.5)


def entry(device=None):
    """(fn, (state, graph)): one GBP sweep of ``GBPConfig()`` on the tiny
    synthetic problem after ``initialise``, on ``device`` (default: the
    drivers'). ``fn(state, graph)`` sweeps ``state`` in place and returns
    it, as ``core.gbp.gbp_sweep`` does."""
    from .tools import resolve_device

    dev = resolve_device(device)
    cfg = GBPConfig()
    problem = _tiny_problem()
    graph = build_graph(problem, cfg, dev)
    state = gbp.initialise(init_state(problem, cfg, dev), graph, cfg)

    def fn(state, graph):
        return gbp.gbp_sweep(state, graph, cfg)

    return fn, (state, graph)


def _check_finite(what: str, x: torch.Tensor) -> float:
    v = x.detach().cpu().numpy()
    if not np.isfinite(v).all():
        raise RuntimeError(f"dry run: {what} is not finite: {v}")
    return float(v.ravel()[-1])


def _dryrun_rank(rank) -> dict:
    """One rank's dry run (module level: ``parallel.run`` pickles it)."""
    from . import parallel

    cfg = GBPConfig()
    problem = _tiny_problem()
    dev = rank.device
    out = {}

    # edge axis sharded, beliefs whole on every rank, one all-reduce a sum
    solver = parallel.make_sharded_solver(rank.group, cfg)
    graph, state = solver.prepare(build_graph(problem, cfg, dev),
                                  init_state(problem, cfg, dev))
    _, diag = solver.solve(state, graph, 2)
    out["edge_sharded"] = _check_finite("edge-sharded error",
                                        diag.reproj_err)

    # landmark blocks sharded with their edges, keyframes whole
    msolver = parallel.make_map_sharded_solver(rank.group, cfg)
    graph_m, state_m = msolver.prepare(build_graph(problem, cfg, dev),
                                       init_state(problem, cfg, dev))
    final_m, diag_m = msolver.solve(state_m, graph_m, 2)
    out["map_sharded"] = _check_finite("map-sharded error",
                                       diag_m.reproj_err)

    # a SLAM keyframe insertion on the map-sharded solver, one step after
    ins = msolver.insert_keyframe(final_m, graph_m, 3)
    _, diag_i = msolver.solve(ins, graph_m, 1)
    out["after_insertion"] = _check_finite("post-insertion error",
                                           diag_i.reproj_err)

    # one sweep through the kernels (their plain versions on the CPU)
    graph_k, state_k = solver.prepare(build_graph(problem, cfg, dev),
                                      init_state(problem, cfg, dev))
    state_k = solver.sweep(solver.initialise(state_k, graph_k), graph_k)
    _check_finite("swept camera beliefs", state_k.cam_eta)
    out["device"] = str(dev)
    return out


def dryrun_multichip(n_devices: int, device_type: str | None = None) -> list:
    """Run the sharded solvers on ``n_devices`` ranks (``parallel.run``;
    ``device_type`` "cuda", "cpu", or None for the drivers' device): the
    edge-sharded solve and the map-sharded solve, 2 iterations each; one
    keyframe insertion on the map-sharded solver and one step after it;
    one sweep of the edge-sharded solver through the kernels. Raises if
    an error is not finite; returns each rank's last errors."""
    from . import parallel

    return parallel.run(_dryrun_rank, n_devices, device_type=device_type)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    fn, (state, graph) = entry()
    fn(state, graph)
    err = float(gbp.reprojection_error(state, graph)[0])
    print(f"entry: one sweep on {state.pk.device}, error {err:.4f} px")
    for r, res in enumerate(dryrun_multichip(int(argv[0]) if argv else 2)):
        print(f"dry run rank {r}: {res}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
