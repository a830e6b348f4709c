"""Procedure ``keyframes``: passes over the sequence as ``drivers/slam.py``
runs them through ``core.slam.solve_slam``'s hooks: ``build_graph`` + SLAM
flags (span ``build``), ``initialise``, then per keyframe a segment of the
solver's ``iters_between_kfs`` sweeps with its telemetry read back (span
``gbp``) and the next keyframe's ``insert_keyframe`` (span ``insert``). A
keyframe's latency runs from its insertion (the pass's start for keyframe
1) to the end of the segment that refines the map with it. The means after
``sample_keyframes`` segments drawn from the seed, and after the last, are
kept for the check."""

import time

import numpy as np

import check
import units
from gbp_poplar_tpu_torch.core import build_graph, gbp, init_state, slam
from gbp_poplar_tpu_torch.utils import analysis
from gbp_poplar_tpu_torch.utils import flags as flags_lib

KIND = "keyframes"


def keyframe_sample(seed: int, n_keyframes: int, n: int) -> list[int]:
    """The keyframes whose means a pass keeps for the check: ``n`` drawn
    from the seed, and the last."""
    rng = np.random.default_rng([abs(int(seed)), 17])
    pick = rng.choice(np.arange(1, n_keyframes - 1), min(n, n_keyframes - 2),
                      replace=False)
    return sorted({int(k) for k in pick} | {n_keyframes - 1})


class Stop(Exception):
    """Raised from a pass's hook to end it at the window's close."""


class Unit:
    def __init__(self, config, traffic, problem, dev, seed):
        self.cfg = units.solver_config(config, traffic)
        self.prob = units.program_problem(problem)
        self.dev = dev
        self.av_depth = traffic["av_depth"]
        self.warm_kf = traffic["warmup_keyframes"]
        self.trace_kf = traffic["trace_keyframes"]
        self.sample = set(keyframe_sample(seed, problem.n_keyframes,
                                          traffic["sample_keyframes"]))
        self.answers: list[check.KeyframeAnswer] = []
        self.latencies: list[float] = []

    def run_pass(self, rec: units.Recorder, n_kf: int | None = None,
                 deadline: float | None = None, keep: bool = False) -> None:
        """One pass over keyframes 1 .. n_kf - 1 (all by default). With
        ``deadline`` it ends at the first keyframe completed past it; with
        ``keep`` it records latencies and reads the means back after every
        segment, keeping the sampled keyframes' as answers."""
        cfg, dev, prob = self.cfg, self.dev, self.prob
        ibk = cfg.iters_between_kfs
        n_kf = prob.n_keyframes if n_kf is None else n_kf
        t_ins = {1: time.perf_counter()}
        seg = {"means": None}
        history = {}
        with rec.span("build"):
            graph = build_graph(prob, cfg, dev)
            flags = flags_lib.create_flags(prob, cfg.steps)
            state = init_state(prob, cfg, dev, flags=flags)

        def initialiser(s):
            with rec.span("gbp"):
                return gbp.initialise(s, graph, cfg)

        def runner(s):
            with rec.span("gbp"):
                s, diag = gbp.run_gbp(s, graph, cfg, ibk)
                if keep:
                    seg["means"] = analysis.belief_means(s)
            rec.count("sweeps", ibk)
            return s, diag

        def progress(k, diag):
            now = time.perf_counter()
            rec.count(KIND)
            if keep:
                self.latencies.append(now - t_ins[k])
                history[k] = seg["means"]
                if k in self.sample:
                    self.answers.append(check.KeyframeAnswer(
                        k, *seg["means"], float(diag.reproj_err[-1]),
                        history))
            seg["means"] = None
            if deadline is not None and now >= deadline:
                raise Stop

        def inserter(s, k):
            t_ins[k] = time.perf_counter()
            with rec.span("insert"):
                s = slam.insert_keyframe(s, graph, cfg, k, self.av_depth)
            rec.count("inserts")
            return s

        try:
            slam.solve_slam(state, graph, cfg, n_keyframes=n_kf,
                            av_depth=self.av_depth, progress=progress,
                            runner=runner, inserter=inserter,
                            initialiser=initialiser)
        except Stop:
            pass

    def window(self, rec: units.Recorder, deadline: float) -> None:
        """Passes back to back; the window closes with the first keyframe
        completed past ``deadline``."""
        while rec.counts.get(KIND, 0) == 0 or time.perf_counter() < deadline:
            self.run_pass(rec, deadline=deadline, keep=True)

    def once(self, rec: units.Recorder) -> None:
        self.run_pass(rec, keep=True)

    def warm_up(self, rec: units.Recorder) -> None:
        self.run_pass(rec, n_kf=self.warm_kf + 1)

    def profiled(self, rec: units.Recorder) -> None:
        self.run_pass(rec, n_kf=self.trace_kf + 1)


def rows(judge, answers):
    return [judge.keyframe_row(a) for a in answers]


def control(judge, traffic, problem, seed):
    return check.slam_control(judge, set(keyframe_sample(
        seed, problem.n_keyframes, traffic["sample_keyframes"])))
