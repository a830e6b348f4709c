"""How ``correct`` is decided: what the timed path returned, held against
the plain reference (``reference.py``), each number beside its limit.

The reference's optimum is ``reference.solve`` in float64 on the MAP
objective the program targets: the measurement term and the priors the
configuration states (``reference.priors``). Numbers, each the worst over
the answers compared:

- ``gbp_gap``: how far the GBP means sit above the optimum, relative to
  it. For a batch solve, in the measurement term alone: (sum of Huber
  losses at the means ``run_gbp`` ended with - the same at the optimum) /
  the latter. (At 1,500 sweeps without a polish GBP still drifts along the
  trajectory's slow mode, which the priors' term reads tenfold.) For a
  keyframe of a SLAM pass, in the whole objective of the segment that
  ended with it: the edges active then and the priors each insertion
  handed on (``reference.slam_priors``, worked out from the pass's
  earlier answers).
- ``chain_gap``: the last keyframe of a SLAM pass in the whole objective
  of the last segment of the reference's own chain
  (``reference.slam_chain``, which takes nothing from the program), over
  that segment's optimum, minus 1.
- ``final_gap``: (MAP objective at the polished means - the optimum's) /
  the optimum's (traffic with a polish).
- ``telemetry_gap``: |last telemetry row's mean error - the reference's
  mean residual norm at the GBP means| / the latter: the per-sweep
  telemetry read back, judged at the state it describes.

The answers a procedure returns are ``SolveAnswer`` and ``KeyframeAnswer``;
``batch_control`` and ``slam_control`` give the control's (the reference
in the program's place, in bfloat16). The cell's ``limits/<workload>.json``
names the numbers compared and their limits.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math

import numpy as np
import torch

import reference

NAMES = ("gbp_gap", "chain_gap", "final_gap", "telemetry_gap")


@dataclasses.dataclass
class SolveAnswer:
    """A solve's means on the host and its last telemetry row's error."""

    gbp_cam: np.ndarray
    gbp_lmk: np.ndarray
    tel_err: float
    final_cam: np.ndarray | None = None
    final_lmk: np.ndarray | None = None


@dataclasses.dataclass
class KeyframeAnswer:
    """The means after keyframe ``k``'s segment, that segment's last
    telemetry row's error (over the active edges), and the pass's means
    after every segment it completed ({j: (cam, lmk)}), from which the
    reference works out the priors each insertion handed on."""

    k: int
    cam: np.ndarray
    lmk: np.ndarray
    tel_err: float
    history: dict


class Judge:
    """The reference's view of one problem under one configuration."""

    def __init__(self, problem, config: dict, dev, av_depth: float = 1.0):
        meas, pri = config["measurement"], config["priors"]
        self.problem, self.dev, self.av_depth = problem, dev, av_depth
        self.meas_var, self.nstds = meas["meas_var"], meas["huber_nstds"]
        self.pri = reference.priors(problem, dev, self.meas_var,
                                    pri["weaker_factor"],
                                    pri["first_cam_prior_std"],
                                    pri["anchor_cams"])
        self._optima = {}

    def cost(self, e, cam, lmk, pri):
        return reference.cost(e, cam, lmk, self.meas_var, self.nstds, pri)

    def batch(self):
        """(edges, objective parts at the optimum) of the whole problem."""
        if None not in self._optima:
            p = self.problem
            e = reference.edges(p, self.dev)
            cam, lmk, _ = reference.solve(e, p.cam_init, p.lmk_init,
                                          self.meas_var, self.nstds, self.pri)
            self._optima[None] = (e, self.cost(e, cam, lmk, self.pri))
        return self._optima[None]

    def _last_segment(self, k: int, history: dict):
        """(edges, priors) of SLAM segment k after the answers
        ``history``."""
        p = self.problem
        return (reference.edges(p, self.dev, p.cam_idx <= k),
                reference.slam_priors(p, self.pri, k, history,
                                      self.av_depth))

    def segment(self, k: int, history: dict):
        """(edges, priors, objective at the optimum) of SLAM segment k."""
        h = hashlib.sha1(str(k).encode())
        for j in range(1, k):
            for x in history[j]:
                h.update(np.ascontiguousarray(x).tobytes())
        key = h.hexdigest()
        if key not in self._optima:
            e, pri = self._last_segment(k, history)
            cam, lmk, _ = reference.solve(e, pri.cam_mu.cpu().numpy(),
                                          pri.lmk_mu.cpu().numpy(),
                                          self.meas_var, self.nstds, pri)
            m, _, pr = self.cost(e, cam, lmk, pri)
            self._optima[key] = (e, pri, m + pr)
        return self._optima[key]

    def chain(self):
        """(edges, priors, objective at the optimum) of the last segment of
        the reference's own SLAM chain, in float64."""
        if "chain" not in self._optima:
            last = self.problem.n_keyframes - 1
            hist = reference.slam_chain(self.problem, self.pri, self.av_depth,
                                        self.meas_var, self.nstds)
            e, pri = self._last_segment(last, hist)
            m, _, pr = self.cost(e, *hist[last], pri)
            self._optima["chain"] = (e, pri, m + pr)
        return self._optima["chain"]

    def solve_row(self, a: SolveAnswer) -> dict:
        e, (m_opt, _, p_opt) = self.batch()
        m, norm, _ = self.cost(e, a.gbp_cam, a.gbp_lmk, self.pri)
        row = {"gbp_gap": (m - m_opt) / m_opt,
               "telemetry_gap": abs(a.tel_err - norm) / norm}
        if a.final_cam is not None:
            m, _, pr = self.cost(e, a.final_cam, a.final_lmk, self.pri)
            row["final_gap"] = (m + pr - m_opt - p_opt) / (m_opt + p_opt)
        return row

    def keyframe_row(self, a: KeyframeAnswer) -> dict:
        e, pri, opt = self.segment(a.k, a.history)
        m, norm, pr = self.cost(e, a.cam, a.lmk, pri)
        row = {"gbp_gap": (m + pr - opt) / opt,
               "telemetry_gap": abs(a.tel_err - norm) / norm}
        if a.k == self.problem.n_keyframes - 1:
            e, pri, opt = self.chain()
            m, _, pr = self.cost(e, a.cam, a.lmk, pri)
            row["chain_gap"] = (m + pr - opt) / opt
        return row


def _bf16_solve(jd: Judge, pri, mask=None):
    """The control's solve: the reference in bfloat16 (per-edge arithmetic;
    sums and solves in float32), its means and its own mean error."""
    p, bf = jd.problem, torch.bfloat16
    e = reference.edges(p, jd.dev, mask)
    cam, lmk, _ = reference.solve(e, pri.cam_mu.cpu().numpy(),
                                  pri.lmk_mu.cpu().numpy(), jd.meas_var,
                                  jd.nstds, pri, edge_dtype=bf)
    _, err, _ = reference.cost(e, cam, lmk, jd.meas_var, jd.nstds, dtype=bf)
    return cam, lmk, err


def batch_control(jd: Judge, polish: bool) -> list[SolveAnswer]:
    """The control's answer to a batch solve: one bfloat16 solve of the
    whole problem (also as the polished means where the traffic
    polishes)."""
    cam, lmk, err = _bf16_solve(jd, jd.pri)
    return [SolveAnswer(cam, lmk, err, cam if polish else None,
                        lmk if polish else None)]


def slam_control(jd: Judge, sample) -> list[KeyframeAnswer]:
    """The control's answers to a SLAM pass: the bfloat16 chain, one solve
    per segment under the priors its own earlier answers hand on, the
    sampled keyframes' means."""
    p, history, answers = jd.problem, {}, []
    for k in range(1, p.n_keyframes):
        pri = reference.slam_priors(p, jd.pri, k, history, jd.av_depth)
        cam, lmk, err = _bf16_solve(jd, pri, p.cam_idx <= k)
        history[k] = (cam, lmk)
        if k in sample:
            answers.append(KeyframeAnswer(k, cam, lmk, err, history))
    return answers


def judge(rows: list[dict], limits: dict) -> tuple[dict, int]:
    """({name: {"value": worst, "limit": limit}} for the numbers
    ``limits`` names (every number when it is empty), answers failing a
    limit). A NaN, a missing limit or no answer at all fails."""
    names = [n for n in NAMES if n in limits] if limits else list(NAMES)

    def bad(v, lim):
        return lim is None or not math.isfinite(v) or v > lim

    failed = sum(1 for r in rows
                 if any(bad(r[n], limits.get(n)) for n in names if n in r))
    checks = {}
    for n in names:
        vals = [r[n] for r in rows if n in r]
        if vals:
            worst = max(vals, key=lambda v: v if math.isfinite(v)
                        else math.inf)
            checks[n] = {"value": worst, "limit": limits.get(n)}
    return checks, failed if rows else 1
