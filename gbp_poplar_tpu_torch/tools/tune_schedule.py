"""Solver-schedule variants on sequences, and how each converges.

    python -m gbp_poplar_tpu_torch.tools.tune_schedule --seq fr1desk --n_iters 1000 \\
        --set reference \\
        --set gn:relin_every_iter=1,lambda_damping=1,eta_damping=0.7 \\
        --set drift:relin_drift_threshold=0.05
    GBP_PLATFORM=cpu python -m gbp_poplar_tpu_torch.tools.tune_schedule --seq f.txt --n_iters 300

The counterpart of the JAX package's ``scripts/tune_schedule.py``. Each
``--seq`` (repeatable; default the three TUM sequences) is a sequence name
or a BAL file; each ``--set NAME[:k=v,...]`` (repeatable; default
``reference``) is a variant of ``GBPConfig`` overrides
(``tools/seq_common.parse_overrides``). Per variant: a fresh graph and
state, ``gbp.solve`` for ``--n_iters`` sweeps, the error at sweeps 9, 50,
100, 200, 500 and the last, the smallest error, and the wall time. On a
card the kernels are built and the first variant run once before any
clock starts (``seq_common.warm_up``; its time is printed apart), and the
card is synchronised before each clock read.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..config import GBPConfig
from ..core import build_graph, gbp, init_state
from ..utils import balio
from . import device_label, resolve_device, timed
from .seq_common import SEQUENCES, parse_overrides, warm_up

MARKS = (9, 50, 100, 200, 500)


def parse_variant(spec: str) -> tuple[str, dict]:
    """``NAME[:k=v,...]`` -> (name, overrides)."""
    name, _, kvs = spec.partition(":")
    return name, parse_overrides(kvs)


def tune(prob, n_iters: int, variants, device=None) -> dict:
    """The ``variants`` (``NAME[:k=v,...]`` specs) of ``prob``: per variant a
    row ``{"name", "errs": {sweep: error}, "min", "seconds"}``."""
    dev = resolve_device(device)
    parsed = [parse_variant(v) for v in variants]
    out = {"warm_up_seconds": warm_up(prob, GBPConfig(**parsed[0][1]), dev),
           "device": device_label(dev), "rows": []}
    idx = [i for i in (*MARKS, n_iters - 1) if i < n_iters]
    for name, overrides in parsed:
        cfg = GBPConfig(**overrides)
        graph = build_graph(prob, cfg, dev)
        state = init_state(prob, cfg, dev)
        (state, diag), dt = timed(dev, lambda: gbp.solve(
            state, graph, cfg, n_iters=n_iters))
        errs = diag.reproj_err.cpu().numpy()
        out["rows"].append({"name": name,
                            "errs": {i: float(errs[i]) for i in idx},
                            "min": float(np.nanmin(errs)), "seconds": dt})
        del state, graph, diag
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tune_schedule")
    p.add_argument("--seq", action="append", default=None)
    p.add_argument("--n_iters", type=int, default=1000)
    p.add_argument("--set", dest="variants", action="append", default=None,
                   metavar="NAME[:k=v,...]")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    variants = args.variants or ["reference"]
    for v in variants:
        parse_variant(v)                 # refuse a bad spec before solving
    dev = resolve_device()
    for seq in args.seq or SEQUENCES:
        prob = balio.load_bal(seq)
        print(f"{seq}: {prob.n_keyframes} kf / {prob.n_points} lmk / "
              f"{prob.n_edges} edges", flush=True)
        r = tune(prob, args.n_iters, variants, dev)
        for w in r["rows"]:
            print(f"  {w['name']:28s} t={w['seconds']:6.1f}s  "
                  + "  ".join(f"e[{i}]={e:.3f}" for i, e in w["errs"].items())
                  + f"  min={w['min']:.3f}", flush=True)
        print(f"  kernel build and warm-up {r['warm_up_seconds']:.1f}s, not "
              f"in the times ({r['device']})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
