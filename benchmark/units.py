"""What the procedures (``procedures/<name>.py``) share: the recorder of
spans and counts, the solver's configuration from a configuration and a
traffic file, the problem as the program takes it, the telemetry's read
back, the batch solves' closed loop, and the collection of the program's
own spans around the traced window. With the procedures, the only
modules of the benchmark that import the program (``gbp_poplar_tpu_torch``).

A traffic file (``traffic/<mix>.json``) names its procedure in
``procedure`` and gives its parameters; ``solver`` holds the
``GBPConfig`` fields that its driver sets. A procedure module defines:

- ``KIND``: the count of what it answers (``solves``, ``keyframes``), the
  result line's ``attempted``;
- ``Unit(config, traffic, problem, dev, seed)``: ``warm_up(rec)``,
  ``window(rec, deadline)`` (one caller, units back to back: a closed
  loop), ``profiled(rec)`` (one bounded unit for the device trace),
  ``once(rec)`` (one unit of the timed path, for ``control.py``), and
  ``answers`` (what the timed path returned, for ``check.py``) and
  ``latencies`` (seconds, the window's, where it has them);
- ``rows(judge, answers)``: the numbers ``check.judge`` holds to limits;
- ``control(judge, traffic, problem, seed)``: the control's answers.

Faults for the checks are planted by patching the attributes these
modules call through (``units.program_problem``, the program's
``gbp.run_gbp`` and ``analysis.belief_means``; ``faults.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from gbp_poplar_tpu_torch.config import GBPConfig
from gbp_poplar_tpu_torch.utils import balio, trace

import check


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Recorder:
    """Spans (seconds per name) and counts of one run's units.

    ``sync``: each span is bounded by a device synchronisation (the traced
    run's window, whose spans the per-layer metrics read); ``marks``: each
    span is also a ``torch.profiler`` mark ``bench.<name>`` (the profiled
    unit, whose idle gaps are named after them). With neither, a span costs
    two reads of the host's clock."""

    def __init__(self, dev: torch.device, sync: bool = False,
                 marks: bool = False):
        self.dev, self.sync, self.marks = dev, sync, marks
        self.spans: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        if self.sync:
            synchronize(self.dev)
        t0 = time.perf_counter()
        ctx = (torch.profiler.record_function("bench." + name) if self.marks
               else contextlib.nullcontext())
        with ctx:
            yield
        if self.sync:
            synchronize(self.dev)
        self.spans[name] = self.spans.get(name, 0.0) + (time.perf_counter()
                                                        - t0)

    def count(self, name: str, n: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + n


def program_spans(on: bool):
    """With ``on``, the program's ``trace.collect()``: it yields the
    totals {span: (host seconds, calls)} of the program's ``gbp.*`` spans
    closed inside the block. Otherwise a null context yielding None, and
    the program's spans stay off."""
    return trace.collect() if on else contextlib.nullcontext()


def solver_config(config: dict, traffic: dict) -> GBPConfig:
    """The configuration's measurement model and priors with the traffic's
    driver settings; coarse groups capped at the keyframes, as the ba
    driver."""
    meas, pri = config["measurement"], config["priors"]
    cfg = GBPConfig(meas_var=meas["meas_var"], huber_nstds=meas["huber_nstds"],
                    prior_std_weaker_factor=pri["weaker_factor"],
                    first_cam_prior_std=pri["first_cam_prior_std"],
                    num_anchor_cams=pri["anchor_cams"],
                    **traffic.get("solver", {}))
    if cfg.coarse_groups > config["n_keyframes"]:
        cfg = dataclasses.replace(cfg, coarse_groups=config["n_keyframes"])
    return cfg


def program_problem(p) -> balio.BAProblem:
    """The generated problem as the program's ``BAProblem``."""
    return balio.BAProblem(
        n_keyframes=p.n_keyframes, n_points=p.n_points, n_edges=p.n_edges,
        k=p.k, cam_idx=p.cam_idx, lmk_idx=p.lmk_idx,
        measurements=p.measurements, cam_means=p.cam_init,
        lmk_means=p.lmk_init, intrinsics=p.intrinsics)


def read_back(diag) -> float:
    """The telemetry rows to the host, as the drivers read them; the last
    row's mean error."""
    errs = diag.reproj_err.cpu().numpy()
    for rows in (diag.cost, diag.n_relins, diag.n_robust):
        rows.cpu().numpy()
    return float(errs[-1])


class Solves:
    """Batch solves back to back; a subclass's ``unit(rec)`` is one solve
    and returns its ``check.SolveAnswer``."""

    def __init__(self, config, traffic, problem, dev, seed):
        self.cfg = solver_config(config, traffic)
        self.prob = program_problem(problem)
        self.dev = dev
        self.n_iters = traffic["n_iters"]
        self.answers: list[check.SolveAnswer] = []
        self.latencies: list[float] = []

    def window(self, rec: Recorder, deadline: float) -> None:
        """Solves back to back until one ends past ``deadline``."""
        while True:
            self.once(rec)
            if time.perf_counter() >= deadline:
                return

    def once(self, rec: Recorder) -> None:
        self.answers.append(self.unit(rec))

    def warm_up(self, rec: Recorder) -> None:
        self.unit(rec)

    def profiled(self, rec: Recorder) -> None:
        self.unit(rec)


def solve_rows(judge: check.Judge, answers) -> list[dict]:
    return [judge.solve_row(a) for a in answers]
