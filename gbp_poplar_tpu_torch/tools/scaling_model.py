"""Predicted scaling efficiency of the sharded solvers at N cards, from
measured inputs.

    python -m gbp_poplar_tpu_torch.tools.scaling_model [--problems ladybug,
        FILE] [--sweep_ms name=ms,...] [--json OUT]

The counterpart of the JAX package's ``scripts/scaling_model.py``, for
H100 cards of one host joined by NVLink. Every input is measured or a
named data-sheet constant:

  1. **the payload per sweep, measured**: one sharded ``gbp_sweep`` on 2
     gloo ranks on the CPU (``parallel.run``), both modes, with every
     ``torch.distributed.all_reduce`` that core/comm.py issues counted by
     its buffer's bytes (``count_all_reduce``): what the collectives move,
     read from the run as the JAX script reads it from the compiled HLO;
  2. **T1, the sweep time on one card, measured** by ``tools/bench.py``'s
     rows (the Ladybug shape's raw chain, or a sequence's headline), or
     passed in with ``--sweep_ms``;
  3. **the per-call latency, measured** on the card: NCCL all-reduces of
     the payload at world size 1 (``parallel.run``) back to back, the
     larger of the host's time to issue one and the events' time per call
     (``bench_scaling.all_reduce_ms``, the timer of chip_smoke.py phase
     14 (a) and of ``bench_scaling`` at N cards). At world size 1 NCCL
     does no work on the device, so this is the host's cost of a call,
     which moves from run to run; the NCCL kernel's own latency across
     NVLink is not in it. ``bench_scaling`` measures the efficiency and
     the all-reduces at N cards where they are present;
  4. **the link, a data-sheet constant**: NVLink 4 gives one H100 SXM 900
     GB/s, 450 GB/s each way (NVIDIA's H100 data sheet); a ring all-reduce
     of B bytes over N cards sends 2 (N-1)/N B from each card.

  t_comm(N) = calls (latency + 2 (N-1)/N B / NVLINK_BYTES_PER_S)
  efficiency(N) = T1 / (N (T1/N + t_comm(N))) = 1 / (1 + N t_comm / T1)

The compute splits evenly over the edge axis (sharding pads every rank's
block to one size; map mode pads landmark blocks), so the collective is
the serial part. The model leaves out start-up (the same at any N).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..config import GBPConfig
from ..core import build_graph, init_state
from ..utils import balio
from . import device_label, resolve_device
from .bench import LADYBUG_SHAPE
from .bench_scaling import MODES, all_reduce_ms, count_all_reduce
from .bench_scaling import make_solver

# NVLink 4 on an H100 SXM: 900 GB/s per card in both directions together
# (NVIDIA's H100 data sheet), so 450 GB/s each way
NVLINK_BYTES_PER_S = 450e9
PAYLOAD_RANKS = 2
NS = (1, 2, 4, 8)


def _rank_payload(rank, problem, mode: str) -> list:
    """One rank of ``measure_payload``: the bytes of each all-reduce of
    one sweep after initialise."""
    cfg = GBPConfig()
    solver = make_solver(rank.group, cfg, mode)
    graph, state = solver.prepare(build_graph(problem, cfg, rank.device),
                                  init_state(problem, cfg, rank.device))
    state = solver.initialise(state, graph)
    with count_all_reduce() as calls:
        solver.sweep(state, graph)
    return calls


def measure_payload(problem, mode: str) -> list:
    """The bytes of each all-reduce one sharded ``gbp_sweep`` issues, on
    PAYLOAD_RANKS gloo ranks on the CPU (every rank issues the same)."""
    from ..parallel import run

    out = run(_rank_payload, PAYLOAD_RANKS, (problem, mode), "cpu")
    if any(o != out[0] for o in out):
        raise RuntimeError(f"ranks issued different all-reduces: {out}")
    return out[0]


def _rank_latency(rank, n_bytes: int) -> float:
    """One rank of ``measure_latency_us``: ms a call."""
    buf = [torch.ones(n_bytes // 4, device=rank.device)]
    return max(all_reduce_ms(rank.group, buf, rank.device))


def measure_latency_us(n_bytes: int, device=None) -> float:
    """µs a call of an all-reduce of ``n_bytes`` at world size 1 on the
    device (NCCL on a card): the larger of ``all_reduce_ms``'s host and
    device times, the pace one all-reduce a sweep sets in a solve the
    host issues ahead."""
    from ..parallel import run

    dev = resolve_device(device)
    return run(_rank_latency, 1, (n_bytes,), dev.type)[0] * 1e3


def measure_t1_ms(name: str, device=None) -> float:
    """One card's ms/sweep from tools/bench.py's rows: the Ladybug shape's
    raw chain, or a sequence's headline (initialise + run_gbp)."""
    from . import bench

    if name == "ladybug":
        return bench.bench_ladybug(device=device)["ms_per_sweep"]
    r = bench.bench_tum(name, device=device)
    return 1e3 / r["sweeps_per_sec"]


def predict(t1_ms: float, payload: int, calls: int, latency_us: float,
            n: int) -> tuple[float, float]:
    """(efficiency, t_comm µs) at ``n`` cards (module docstring)."""
    if n == 1:
        return 1.0, 0.0
    ring = 2.0 * (n - 1) / n * payload / NVLINK_BYTES_PER_S
    t_comm = calls * latency_us * 1e-6 + ring
    return 1.0 / (1.0 + n * t_comm / (t1_ms * 1e-3)), t_comm * 1e6


def model(name: str, problem=None, t1_ms: float | None = None,
          device=None) -> dict:
    """The model's inputs and predictions for one problem, both modes
    (see the module docstring); prints a block of lines."""
    dev = resolve_device(device)
    problem = problem if problem is not None else (
        balio.synthetic_problem_large(*LADYBUG_SHAPE) if name == "ladybug"
        else balio.load_bal(name))
    if t1_ms is None:
        t1_ms = measure_t1_ms(name, dev)
    rows = {}
    for mode in MODES:
        calls = measure_payload(problem, mode)
        payload = sum(calls)
        lat = measure_latency_us(payload, dev)
        effs = {n: predict(t1_ms, payload, len(calls), lat, n) for n in NS}
        rows[mode] = {
            "all_reduce_bytes_per_sweep": payload,
            "all_reduce_calls_per_sweep": len(calls),
            "latency_us": lat, "sweep_ms_single_card": t1_ms,
            "efficiency": {str(n): e for n, (e, _) in effs.items()},
            "comm_us": {str(n): c for n, (_, c) in effs.items()}}
        print(f"{name} [{mode}]: payload {payload / 1024:.1f} KiB/sweep in "
              f"{len(calls)} all-reduce(s) (measured on {PAYLOAD_RANKS} gloo "
              f"CPU ranks), T1 {t1_ms:.4f} ms, latency {lat:.1f} us a call "
              f"({device_label(dev)})", flush=True)
        for n in NS[1:]:
            e, c = effs[n]
            print(f"   N={n:2d}: comm {c:8.1f} us  eff {e:.3f}", flush=True)
    return {"name": name, "n_keyframes": problem.n_keyframes,
            "n_points": problem.n_points, "n_edges": problem.n_edges,
            "nvlink_bytes_per_s": NVLINK_BYTES_PER_S,
            "device": device_label(dev), **rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None, help="write the model's numbers")
    ap.add_argument("--problems", default="ladybug")
    ap.add_argument("--sweep_ms", default=None,
                    help="one card's ms/sweep as name=ms,... (else measured)")
    args = ap.parse_args(argv)
    sweep_ms = {}
    if args.sweep_ms:
        for kv in args.sweep_ms.split(","):
            k, v = kv.split("=")
            sweep_ms[k] = float(v)
    out = {"model": "eff = 1/(1 + N t_comm/T1); t_comm = calls (latency + "
                    "2(N-1)/N B / NVLink)", "problems": {}}
    for name in args.problems.split(","):
        out["problems"][name] = model(name, t1_ms=sweep_ms.get(name))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
