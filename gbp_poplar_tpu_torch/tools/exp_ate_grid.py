"""Batch GBP against the GN MAP oracle across config variants.

    python -m gbp_poplar_tpu_torch.tools.exp_ate_grid SEQ|FILE N ["k=v,k=v" ...]
    GBP_PLATFORM=cpu python -m gbp_poplar_tpu_torch.tools.exp_ate_grid f.txt 300 base fused=0

The counterpart of the JAX package's ``scripts/exp_ate_grid.py``. Each
spec after N is one variant: comma-separated ``k=v`` overrides
(``tools/seq_common.parse_overrides``) on the ba driver's defaults,
``GBPConfig(coarse_groups=min(16, keyframes))``; ``base`` runs them
unchanged. The GN oracle (60 LM iterations) is solved once; each variant
starts from a fresh graph and state and reports its final error, ATE
against GN and the MAP cost ratio at its final means (the same annealed
robust objective, ``seq_common.MapObjective``). On a card the kernels are
built and the first variant run once before any clock starts
(``seq_common.warm_up``; its time is printed apart), and the card is
synchronised before each clock read.
"""

from __future__ import annotations

import dataclasses
import sys

from ..config import GBPConfig
from ..core import build_graph, gbp, init_state
from ..utils import balio, evaluation
from . import device_label, resolve_device, timed
from .seq_common import MapObjective, gn_oracle, parse_overrides, warm_up

def grid(prob, n_iters: int, specs, device=None) -> dict:
    """The variants ``specs`` of ``prob``: the GN oracle's error and cost,
    and per variant a row ``{"spec", "err", "ate", "ratio",
    "seconds"}``."""
    dev = resolve_device(device)
    base = GBPConfig(coarse_groups=min(16, prob.n_keyframes))
    res_gn = gn_oracle(prob, base, device=dev)
    gn_cam = res_gn.cam.cpu().numpy()
    obj = MapObjective(prob, base, dev)
    c_gn = obj(gn_cam, res_gn.lmk.cpu().numpy())
    cfgs = [dataclasses.replace(base, **parse_overrides(s)) for s in specs]
    out = {"gn_err": float(res_gn.reproj_err[-1]), "gn_cost": c_gn,
           "warm_up_seconds": warm_up(prob, cfgs[0], dev),
           "device": device_label(dev), "rows": []}
    for spec, cfg in zip(specs, cfgs):
        graph = build_graph(prob, cfg, dev)
        state = init_state(prob, cfg, dev)
        (state, diag), dt = timed(dev, lambda: gbp.solve(
            state, graph, cfg, n_iters=n_iters))
        cam_mu, lmk_mu = (m.T.cpu().numpy()
                          for m in gbp._variable_means(state))
        out["rows"].append({
            "spec": spec, "err": float(diag.reproj_err[-1]),
            "ate": evaluation.ate_rmse(cam_mu, gn_cam),
            "ratio": obj(cam_mu, lmk_mu) / c_gn, "seconds": dt})
        del state, graph, diag
    return out


def report(name: str, prob, n_iters: int, r: dict) -> list[str]:
    """The JAX script's lines, and the warm-up time and device."""
    lines = [f"{name}: {prob.n_keyframes} kf / {prob.n_edges} edges, "
             f"{n_iters} iters; GN reproj {r['gn_err']:.3f} px, cost "
             f"{r['gn_cost']:.1f}",
             f"{'variant':48s} {'err px':>7s} {'ATE m':>9s} {'ratio':>7s} "
             f"{'time s':>7s}"]
    lines += [f"{w['spec']:48s} {w['err']:7.3f} {w['ate']:9.5f} "
              f"{w['ratio']:7.4f} {w['seconds']:7.1f}" for w in r["rows"]]
    lines.append(f"kernel build and warm-up {r['warm_up_seconds']:.1f}s, "
                 f"not in the times ({r['device']})")
    return lines


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        raise SystemExit("usage: exp_ate_grid SEQ|FILE N [spec ...]")
    seq, n_iters = argv[0], int(argv[1])
    specs = argv[2:] or ["base"]
    for spec in specs:
        parse_overrides(spec)            # refuse a bad spec before solving
    prob = balio.load_bal(seq)
    for line in report(seq, prob, n_iters, grid(prob, n_iters, specs)):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
