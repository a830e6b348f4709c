"""Sweep time at a named problem: the raw sweep chain or ``run_gbp``.

    python -m gbp_poplar_tpu_torch.tools.bench_sweep [fr1xyz|fr2robot2|
        fr1desk|ladybug|ladybug_snavely|venice|scale|FILE] ... [--production]
    GBP_PLATFORM=cpu python -m gbp_poplar_tpu_torch.tools.bench_sweep FILE

The counterpart of the JAX package's ``scripts/bench_sweep.py``. For each
name: build the graph, ``initialise``, then time K sweeps (the fastest of
three timed runs after a warm-up, each from a clone of the same state,
``tools.time_reps``) and print ms/sweep and sweeps/s on stdout, as the JAX
script does. K is 2000 for a TUM sequence or a file, 100 at the Ladybug
shape, 50 at the Venice shape.

The raw chain is K ``gbp_sweep`` calls (each builds its own belief tables);
``--production`` times ``run_gbp(K, with_diagnostics=False, iter_offset=
2 * steps)`` instead, the solve's hot loop (anneal-free, accelerator
chunks at their place in the schedule, the post-sweep tables reused).

``scale`` is the problem-size ladder: the three TUM sequences (skipped by
name when absent), then the synthetic 140k, 420k and Ladybug-shape 1.1M
edges, each with a sanity solve (60 iterations with diagnostics from a
fresh state: the first and last error).
"""

from __future__ import annotations

import sys

from ..config import GBPConfig
from ..core import gbp, init_state
from ..utils import balio
from . import device_label, resolve_device, time_reps
from .bench import LADYBUG_SHAPE, VENICE_SHAPE, initialised, sweep_chain

SEQUENCES = ("fr2robot2", "fr1xyz", "fr1desk")
LADDER = ((200, 20_000, 7, "synthetic-140k"),
          (800, 60_000, 7, "synthetic-420k"),
          (1723, 156_000, 7, "ladybug-scale-1.1M"))
SEQ_K = 2000
SANITY_ITERS = 60


def bench(prob, name: str, cfg: GBPConfig, K: int, sanity: bool = False,
          production: bool = False, device=None) -> dict:
    """Time K sweeps of ``prob`` (see the module docstring), print the
    line, return its numbers."""
    dev = resolve_device(device)
    graph, s = initialised(prob, cfg, dev)

    if production:
        def run(x):
            return gbp.run_gbp(x, graph, cfg, K, with_diagnostics=False,
                               iter_offset=2 * cfg.steps)[0]
    else:
        run = sweep_chain(graph, cfg, K)

    dt, _ = time_reps(run, s)
    del s
    out = {"name": name, "edges": graph.n_edges, "sweeps": K,
           "production": production, "ms_per_sweep": dt / K * 1e3,
           "sweeps_per_sec": K / dt, "device": device_label(dev)}
    line = (f"{name:20s} E={graph.n_edges:8d} "
            f"{out['ms_per_sweep']:8.3f} ms/sweep "
            f"({out['sweeps_per_sec']:9.1f} sweeps/s)")
    if sanity:
        _, diag = gbp.solve(init_state(prob, cfg, dev), graph, cfg,
                            n_iters=SANITY_ITERS)
        errs = diag.reproj_err.cpu().numpy()
        out.update(err_first=float(errs[0]), err_last=float(errs[-1]))
        line += f"  err {errs[0]:8.2f} -> {errs[-1]:6.2f}"
    print(f"{line}  ({out['device']})", flush=True)
    return out


def bench_names(names, production: bool = False, device=None) -> list:
    """``bench`` for each name of the module docstring; [their dicts]."""
    dev = resolve_device(device)
    cfg = GBPConfig()
    rows = []
    for n in names:
        if n == "ladybug":
            rows.append(bench(balio.synthetic_problem_large(*LADYBUG_SHAPE),
                              n, cfg, 100, production=production,
                              device=dev))
        elif n == "ladybug_snavely":
            rows.append(bench(balio.synthetic_problem_large(
                *LADYBUG_SHAPE, snavely=True), n, cfg, 100, device=dev))
        elif n == "venice":
            rows.append(bench(balio.synthetic_problem_large(*VENICE_SHAPE),
                              n, cfg, 50, production=production, device=dev))
        elif n == "scale":
            for seq in SEQUENCES:
                try:
                    prob = balio.load_bal(seq)
                except FileNotFoundError:
                    print(f"{seq}: not found, skipping", flush=True)
                    continue
                rows.append(bench(prob, seq, cfg, SEQ_K, sanity=True,
                                  device=dev))
            for (c, l, o, name) in LADDER:
                rows.append(bench(balio.synthetic_problem_large(c, l, o),
                                  name, cfg, 100, sanity=True, device=dev))
        else:
            rows.append(bench(balio.load_bal(n), n, cfg, SEQ_K,
                              production=production, device=dev))
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    production = "--production" in argv
    names = [a for a in argv if a != "--production"] or ["fr1xyz"]
    bench_names(names, production)
    return 0


if __name__ == "__main__":
    sys.exit(main())
