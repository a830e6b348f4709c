"""The two-phase drift-relinearisation experiment.

    python -m gbp_poplar_tpu_torch.tools.exp_drift_phase [SEQ|FILE] [TOTAL] [PHASE1] [k=v ...]
    GBP_PLATFORM=cpu python -m gbp_poplar_tpu_torch.tools.exp_drift_phase f.txt 400 100

The counterpart of the JAX package's ``scripts/exp_drift_phase.py``
(defaults ``fr1desk``, 1,500 sweeps, 300 in phase 1). The drift trigger
(``relin_drift_threshold``) shortens the annealing transient but lets the
solver walk between Huber basins late in a solve; the experiment runs
four schedules on ``GBPConfig(coarse_groups=16)`` plus the overrides:
drift always, drift never, drift for the first PHASE1 sweeps then off,
and off then on. "On" is 0.05 unless the overrides set the threshold;
"off" is 0. Each schedule starts from its own fresh state
(``initialise``, then ``run_gbp``); its second phase continues on the
same state with ``iter_offset`` = the first phase's sweeps. Each reports
its final error, ATE against the GN oracle (60 LM iterations) and the
MAP cost ratio (``seq_common.MapObjective``).
"""

from __future__ import annotations

import dataclasses
import sys

from ..config import GBPConfig
from ..core import build_graph, gbp, init_state
from ..utils import balio, evaluation
from . import device_label, resolve_device, timed
from .seq_common import MapObjective, gn_oracle, parse_overrides

DRIFT_ON = 0.05


def two_phase(prob, n_total: int, n_phase1: int, overrides: dict | None = None,
              device=None) -> dict:
    """The four schedules of ``prob``: the GN oracle's error and cost, and
    per schedule a row ``{"tag", "err", "ate", "ratio", "seconds"}``."""
    dev = resolve_device(device)
    overrides = overrides or {}
    base = dataclasses.replace(GBPConfig(coarse_groups=16), **overrides)
    cfg_on = (base if "relin_drift_threshold" in overrides
              else dataclasses.replace(base, relin_drift_threshold=DRIFT_ON))
    cfg_off = dataclasses.replace(base, relin_drift_threshold=0.0)
    graph = build_graph(prob, cfg_on, dev)
    res_gn = gn_oracle(prob, cfg_on, device=dev)
    gn_cam = res_gn.cam.cpu().numpy()
    obj = MapObjective(prob, cfg_on, dev)
    c_gn = obj(gn_cam, res_gn.lmk.cpu().numpy())

    def run(n1: int, reverse: bool):
        a, b = (cfg_off, cfg_on) if reverse else (cfg_on, cfg_off)
        st = gbp.initialise(init_state(prob, a, dev), graph, a)
        if n1 > 0:
            st, d = gbp.run_gbp(st, graph, a, n1)
        if n_total - n1 > 0:
            st, d = gbp.run_gbp(st, graph, b, n_total - n1, iter_offset=n1)
        return st, float(d.reproj_err[-1])

    out = {"gn_err": float(res_gn.reproj_err[-1]), "gn_cost": c_gn,
           "device": device_label(dev), "rows": []}
    for n1, rev, tag in ((n_total, False, "drift always"),
                         (0, False, "drift never"),
                         (n_phase1, False, f"drift first {n_phase1}"),
                         (n_phase1, True, f"drift AFTER {n_phase1}")):
        (st, err), dt = timed(dev, lambda: run(n1, rev))
        cam_mu, lmk_mu = (m.T.cpu().numpy() for m in gbp._variable_means(st))
        out["rows"].append({"tag": tag, "err": err,
                            "ate": evaluation.ate_rmse(cam_mu, gn_cam),
                            "ratio": obj(cam_mu, lmk_mu) / c_gn,
                            "seconds": dt})
        del st
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    seq = argv[0] if argv else "fr1desk"
    n_total = int(argv[1]) if len(argv) > 1 else 1500
    n_phase1 = int(argv[2]) if len(argv) > 2 else 300
    overrides = parse_overrides(argv[3:])
    prob = balio.load_bal(seq)
    print(f"{seq}: {prob.n_keyframes} kf / {prob.n_points} lmk / "
          f"{prob.n_edges} edges; total {n_total}, phase1 {n_phase1}; "
          f"overrides {overrides}", flush=True)
    r = two_phase(prob, n_total, n_phase1, overrides)
    print(f"GN: {r['gn_err']:.4f} px, cost {r['gn_cost']:.1f}")
    for w in r["rows"]:
        print(f"  {w['tag']:28s} err {w['err']:6.3f} px  ATE(GBP,GN) "
              f"{w['ate']:8.5f} m  cost ratio {w['ratio']:.4f}  "
              f"{w['seconds']:.1f}s ({r['device']})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
