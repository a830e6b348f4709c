"""Procedure ``gbp_solve``: the library's ``core.gbp.solve`` on the graph
built in set-up: a fresh ``init_state`` (span ``build``), ``initialise`` +
``run_gbp`` with telemetry and the means on the host (span ``gbp``)."""

import check
import units
from gbp_poplar_tpu_torch.core import build_graph, gbp, init_state
from gbp_poplar_tpu_torch.utils import analysis

KIND = "solves"


class Unit(units.Solves):
    def __init__(self, config, traffic, problem, dev, seed):
        super().__init__(config, traffic, problem, dev, seed)
        self.graph = build_graph(self.prob, self.cfg, dev)

    def unit(self, rec: units.Recorder) -> check.SolveAnswer:
        with rec.span("build"):
            state = init_state(self.prob, self.cfg, self.dev)
        with rec.span("gbp"):
            state, diag = gbp.solve(state, self.graph, self.cfg,
                                    n_iters=self.n_iters)
            err = units.read_back(diag)
            cam_mu, lmk_mu = analysis.belief_means(state)
        rec.count("sweeps", self.n_iters)
        rec.count(KIND)
        return check.SolveAnswer(cam_mu, lmk_mu, err)


rows = units.solve_rows


def control(judge, traffic, problem, seed):
    return check.batch_control(judge, polish=False)
