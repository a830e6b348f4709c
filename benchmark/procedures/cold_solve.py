"""Procedure ``cold_solve``: what ``drivers/ba.py`` does after loading a
problem, without printing, host oracle or checkpoints: ``build_graph`` +
``init_state``, ``initialise``, ``run_gbp`` in spans of
``span_chunks * accel_every`` sweeps with each span's telemetry read back,
the means on the host, then the polish (its exact-edge graph and
``solve_lm``, ``polish_iters`` iterations), the polished means on the
host. Spans: ``build``, ``gbp``, ``polish``."""

import dataclasses

import torch

import check
import units
from gbp_poplar_tpu_torch.core import build_graph, gbp, init_state
from gbp_poplar_tpu_torch.core import gauss_newton as gn
from gbp_poplar_tpu_torch.utils import analysis

KIND = "solves"


class Unit(units.Solves):
    def __init__(self, config, traffic, problem, dev, seed):
        super().__init__(config, traffic, problem, dev, seed)
        self.chunk = max(1, traffic["span_chunks"] * self.cfg.accel_every)
        self.polish_iters = traffic["polish_iters"]

    def unit(self, rec: units.Recorder) -> check.SolveAnswer:
        cfg, dev, prob = self.cfg, self.dev, self.prob
        with rec.span("build"):
            graph = build_graph(prob, cfg, dev)
            state = init_state(prob, cfg, dev)
        with rec.span("gbp"):
            state = gbp.initialise(state, graph, cfg)
            i, err = 0, float("nan")
            while i < self.n_iters:
                n = min(self.chunk, self.n_iters - i)
                state, diag = gbp.run_gbp(state, graph, cfg, n, iter_offset=i)
                err = units.read_back(diag)
                i += n
            cam_mu, lmk_mu = analysis.belief_means(state)
        rec.count("sweeps", self.n_iters)
        del state, graph
        ans = check.SolveAnswer(cam_mu, lmk_mu, err)
        if self.polish_iters:
            with rec.span("polish"):
                graph1 = build_graph(
                    prob, dataclasses.replace(cfg, edge_pad_multiple=1), dev)
                pri = gn.problem_priors(prob, cfg, graph1)
                res = gn.solve_lm(torch.tensor(cam_mu, device=dev),
                                  torch.tensor(lmk_mu, device=dev), graph1,
                                  pri, cfg, n_lm_iters=self.polish_iters)
                ans.final_cam = res.cam.cpu().numpy()
                ans.final_lmk = res.lmk.cpu().numpy()
        rec.count(KIND)
        return ans


rows = units.solve_rows


def control(judge, traffic, problem, seed):
    return check.batch_control(judge, polish=bool(traffic["polish_iters"]))
