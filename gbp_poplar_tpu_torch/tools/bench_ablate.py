"""Sweep-cost ablation at one problem size: where do the milliseconds go?

    python -m gbp_poplar_tpu_torch.tools.bench_ablate [ladybug|NAME|FILE] [K]
    GBP_PLATFORM=cpu python -m gbp_poplar_tpu_torch.tools.bench_ablate FILE 3

The counterpart of the JAX package's ``scripts/bench_ablate.py``. Times K
repetitions (default 50; the fastest of three timed runs after a warm-up,
each from a clone of the state after ``initialise``, ``tools.time_reps``)
of six programs on the same state, and prints ms per repetition:

  - ``full``: the real ``gbp_sweep`` with ``GBPConfig()``, the fused
    pipeline: belief tables (H2), the fused sweep (H1), the belief update
    (H3);
  - ``kernel``: the unfused pipeline's per-edge sweep alone (H4,
    ``ops/sweep_kernel.sweep_planes``) on belief planes gathered once;
  - ``gather``: the unfused pipeline's two belief gathers (H5);
  - ``reduce``: ``update_beliefs`` alone (H3), messages held;
  - ``gath+kern``: the gathers, then the per-edge sweep;
  - ``kern+red``: the per-edge sweep on the planes gathered once, then
    the belief update.

As in the JAX script, ``full`` is the fused pipeline while ``kernel`` and
its pairs are the unfused one, so the rows do not sum to ``full``. PyTorch
runs eagerly, so no program needs the JAX script's feedback of outputs
into inputs to keep its work from being elided.
"""

from __future__ import annotations

import sys

from ..config import GBPConfig
from ..core import gbp
from ..ops import reduce_kernel, sweep_kernel
from ..utils import balio
from . import device_label, resolve_device, time_reps
from .bench import LADYBUG_SHAPE, initialised, sweep_chain

PROGRAMS = ("full", "kernel", "gather", "reduce", "gath+kern", "kern+red")


def programs(state, graph, cfg: GBPConfig, k: int) -> dict:
    """{name: fn(state) -> state}, each running its program ``k`` times
    in place on the state it is given (see the module docstring). The
    ``kernel`` programs read the beliefs of ``state`` gathered now."""
    bc0 = reduce_kernel.gather(state.cam_bel, graph.cam_idx)
    bl0 = reduce_kernel.gather(state.lmk_bel, graph.lmk_idx)

    def gathered(s):
        return (reduce_kernel.gather(s.cam_bel, graph.cam_idx),
                reduce_kernel.gather(s.lmk_bel, graph.lmk_idx))

    def kernel(s):
        for _ in range(k):
            sweep_kernel.sweep_planes(s, graph, bc0, bl0, cfg)
        return s

    def gather(s):
        for _ in range(k):
            gathered(s)
        return s

    def reduce(s):
        for _ in range(k):
            s = gbp.update_beliefs(s, graph, cfg)
        return s

    def gath_kern(s):
        for _ in range(k):
            sweep_kernel.sweep_planes(s, graph, *gathered(s), cfg)
        return s

    def kern_red(s):
        for _ in range(k):
            sweep_kernel.sweep_planes(s, graph, bc0, bl0, cfg)
            s = gbp.update_beliefs(s, graph, cfg)
        return s

    return dict(zip(PROGRAMS, (sweep_chain(graph, cfg, k), kernel, gather,
                               reduce, gath_kern, kern_red)))


def ablate(prob, name: str, k: int = 50, device=None) -> dict:
    """ms per repetition of each program on ``prob`` after initialise;
    prints a line each."""
    dev = resolve_device(device)
    cfg = GBPConfig()
    graph, state = initialised(prob, cfg, dev)
    label = device_label(dev)
    print(f"{name}: E={graph.n_edges} C={graph.n_keyframes} "
          f"L={graph.n_points} device={label}", flush=True)
    ms = {}
    for nm, fn in programs(state, graph, cfg, k).items():
        dt, _ = time_reps(fn, state)
        ms[nm] = dt / k * 1e3
        print(f"  {nm:9s} {ms[nm]:8.3f} ms/sweep", flush=True)
    return {"name": name, "edges": graph.n_edges, "k": k, "ms": ms,
            "device": label}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    name = argv[0] if argv else "ladybug"
    k = int(argv[1]) if len(argv) > 1 else 50
    prob = (balio.synthetic_problem_large(*LADYBUG_SHAPE) if name == "ladybug"
            else balio.load_bal(name))
    ablate(prob, name, k)
    return 0


if __name__ == "__main__":
    sys.exit(main())
