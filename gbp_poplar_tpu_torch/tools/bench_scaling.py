"""Sweeps/s of the sharded solvers at 1, 2, 4, ... cards, and the scaling
efficiency against one.

    python -m gbp_poplar_tpu_torch.tools.bench_scaling [ladybug|NAME|FILE]
        [n_sweeps]                         # GBP_SHARD_MODE=edges|map
    GBP_PLATFORM=cpu python -m gbp_poplar_tpu_torch.tools.bench_scaling FILE

The counterpart of the JAX package's ``scripts/bench_scaling.py``. For
N = 1, 2, 4, ... up to the cards present, ``parallel.run`` starts N ranks
(NCCL, one card each), each prepares its block of the graph and state
(``make_sharded_solver``: edge blocks; ``make_map_sharded_solver`` with
``GBP_SHARD_MODE=map``: landmark blocks), initialises, and times
``solver.run(state, graph, n_sweeps, 0)`` (the fastest of three timed runs
after a warm-up, each from a clone of its block, ``tools.time_reps``; the
slowest rank counts). The efficiency at N is sweeps/s(N) / (N sweeps/s(1)).
Each rank also times the all-reduces the timed program issues (their
bytes read from one more run by ``count_all_reduce``, each size timed by
``all_reduce_ms``): the collectives' cost a sweep at N, diagnostics and
accelerator steps included, which ``scaling_model`` predicts from one
card for the sweep alone.

With one card it reports N = 1 only, and says so: ranks sharing a card
time-slice it, so their rate is not a scaling number. On the CPU
(``GBP_PLATFORM=cpu``) the ranks are gloo processes, up to ``max_n`` (one
by default): they exercise the collectives' structure, not a card's
speed.
"""

from __future__ import annotations

import contextlib
import os
import sys

import torch
import torch.distributed as dist

from ..config import GBPConfig
from ..core import build_graph, comm, init_state
from ..utils import balio
from . import device_label, paced_ms, resolve_device, time_reps
from .bench import LADYBUG_SHAPE

MODES = ("edges", "map")
ALL_REDUCE_REPS = 20


@contextlib.contextmanager
def count_all_reduce():
    """Record the bytes of every ``torch.distributed.all_reduce`` in this
    process while the block runs (the list it yields, one entry a call);
    the real function is back when the block ends."""
    calls, real = [], dist.all_reduce

    def counted(tensor, *args, **kwargs):
        calls.append(tensor.numel() * tensor.element_size())
        return real(tensor, *args, **kwargs)

    dist.all_reduce = counted
    try:
        yield calls
    finally:
        dist.all_reduce = real


def all_reduce_ms(group, tensors, dev, reps: int = ALL_REDUCE_REPS
                  ) -> tuple[float, float]:
    """(host, device) ms a call of core/comm.py's ``all_sum`` of
    ``tensors`` over ``group``, ``reps`` calls back to back after a
    warm-up (``tools.paced_ms``)."""
    return paced_ms(lambda: comm.all_sum(group, tensors), reps, dev)


def make_solver(group, cfg: GBPConfig, mode: str):
    from ..parallel import make_map_sharded_solver, make_sharded_solver

    if mode not in MODES:
        raise ValueError(f"GBP_SHARD_MODE must be one of {MODES}, not "
                         f"{mode!r}")
    return (make_map_sharded_solver(group, cfg) if mode == "map"
            else make_sharded_solver(group, cfg))


def _rank_seconds(rank, problem, mode: str, n_sweeps: int) -> tuple:
    """One rank of ``bench_n``: the fastest timed run of its block (s),
    the ms a sweep of the all-reduces that run issues (counted in one
    more run, each size timed once: the larger of host and device time a
    call), and their number a sweep."""
    cfg = GBPConfig()
    solver = make_solver(rank.group, cfg, mode)
    graph, state = solver.prepare(build_graph(problem, cfg, rank.device),
                                  init_state(problem, cfg, rank.device))
    state = solver.initialise(state, graph)
    dt, _ = time_reps(lambda s: solver.run(s, graph, n_sweeps, 0)[0], state)
    with count_all_reduce() as calls:
        solver.run(state.clone(), graph, n_sweeps, 0)
    ms = {b: max(all_reduce_ms(rank.group,
                               [torch.ones(b // 4, device=rank.device)],
                               rank.device))
          for b in sorted(set(calls))}
    return dt, sum(ms[b] for b in calls) / n_sweeps, len(calls) / n_sweeps


def bench_n(problem, n: int, n_sweeps: int, mode: str,
            device_type: str) -> tuple[float, float, float]:
    """Sweeps/s of ``n`` ranks on ``device_type``, the ms a sweep of
    their all-reduces (each the slowest rank's), and the all-reduces a
    sweep."""
    from ..parallel import run

    out = run(_rank_seconds, n, (problem, mode, n_sweeps), device_type)
    return (n_sweeps / max(o[0] for o in out), max(o[1] for o in out),
            out[0][2])


def scaling(problem, name: str, n_sweeps: int = 100, mode: str = "edges",
            device=None, max_n: int | None = None) -> dict:
    """Sweeps/s and efficiency at N = 1, 2, 4, ... ranks (see the module
    docstring); prints a line per N."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        n_avail = torch.cuda.device_count()
        n_avail = min(n_avail, max_n) if max_n else n_avail
    else:
        n_avail = max_n or 1
    label = device_label(dev)
    print(f"{name}: E={problem.n_edges}, devices available: {n_avail} "
          f"({label}), mode={mode}", flush=True)
    if dev.type == "cuda" and n_avail == 1:
        print("  one card: N=1 only (ranks sharing a card time-slice it, so "
              "their rate is not a scaling number)", flush=True)
    elif dev.type != "cuda":
        print("  CPU ranks (gloo): the collectives' structure, not a card's "
              "speed", flush=True)
    rows, base, n = {}, None, 1
    while n <= n_avail:
        sps, comm_ms, calls = bench_n(problem, n, n_sweeps, mode, dev.type)
        base = sps if base is None else base
        eff = sps / (base * n)
        rows[n] = {"sweeps_per_sec": sps, "efficiency": eff,
                   "all_reduce_ms_per_sweep": comm_ms,
                   "all_reduces_per_sweep": calls}
        print(f"  {n:2d} device(s): {sps:10.1f} sweeps/s  "
              f"(scaling efficiency {eff:5.2f}); {calls:.2f} all-reduces "
              f"a sweep, {comm_ms:.4f} ms", flush=True)
        n *= 2
    return {"name": name, "edges": problem.n_edges, "mode": mode,
            "sweeps": n_sweeps, "devices": n_avail, "rows": rows,
            "device": label}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    name = argv[0] if argv else "fr1xyz"
    n_sweeps = int(argv[1]) if len(argv) > 1 else 100
    problem = (balio.synthetic_problem_large(*LADYBUG_SHAPE)
               if name == "ladybug" else balio.load_bal(name))
    scaling(problem, name, n_sweeps, os.environ.get("GBP_SHARD_MODE",
                                                    "edges"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
