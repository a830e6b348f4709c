"""Device memory of a solve, tensor by tensor and stage by stage: where
one card's memory runs out.

    python -m gbp_poplar_tpu_torch.tools.memory_ledger [edges_in_millions]
        [--obs K] [--shape C,L,K] [--production] [--sweeps N]
    GBP_PLATFORM=cpu python -m gbp_poplar_tpu_torch.tools.memory_ledger 0.01

The counterpart of the JAX package's ``scripts/memory_ledger.py``. The
problem is ``synthetic_problem_large`` at ``edges_in_millions`` (default
4.97) with ``--obs`` observations a landmark (default 5) and Venice's
ratio of 560 landmarks a keyframe, or the shape ``--shape keyframes,
landmarks,obs`` (BAL Final-13682's observation count: ``--shape
13682,4141092,7``, 28,987,644 edges). It reports:

  1. every tensor of ``GBPGraph`` (the segments, their H3 chunk plans and
     the ``derived`` segments the coarse step adds) and of ``GBPState``,
     by field, in GiB and B/edge (each storage counted once);
  2. per stage, the peak of ``torch.cuda.max_memory_allocated`` after
     ``reset_peak_memory_stats`` (XLA's ``memory_analysis`` has no
     counterpart here), the memory live after it and the host seconds:
     build (graph and state), ``initialise``, ``run_gbp``, one coarse
     step, the LM polish. ``run_gbp`` runs 8 sweeps of ``GBPConfig()``
     without diagnostics; with ``--production`` the ba driver's
     configuration (accelerator chunks, coarse corrector over 16 groups)
     for 100 sweeps from ``accel_start`` with per-sweep diagnostics, so
     two accelerator chunks are live.

A stage that runs out of device memory ends the ledger there; the result
names it. On the CPU the tallies are exact and the peaks not measured.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from ..config import GBPConfig
from ..core import build_graph, gauss_newton as gn, gbp, init_state
from ..core.factor_graph import GBPState
from ..ops import sweep_kernel, table_kernel
from ..utils import analysis, balio, evaluation
from . import device_label, resolve_device, synchronize

GIB = 2 ** 30
LMK_PER_KF = 560          # Venice-1778: 994,000 landmarks, 1,778 keyframes
SWEEP_RTOL = 1e-4         # the first sweep's slice, relative to 1 + max |x|
SWEEP_FLIP_FRAC = 1e-3    # ... and lanes whose discrete outputs may differ


def venice_like_shape(edges_m: float, obs: int = 5) -> tuple[int, int, int]:
    """(keyframes, landmarks, obs) of about ``edges_m`` million edges: at
    least ``obs`` keyframes, each landmark's observers."""
    n_l = int(edges_m * 1e6 / obs)
    return max(n_l // LMK_PER_KF, obs), n_l, obs


def driver_config() -> GBPConfig:
    """The ba driver's configuration with its defaults."""
    from ..drivers import ba, common

    args = ba.build_parser().parse_args(["--bal_file", "-"])
    return common.config_from_args(args, default_coarse_groups=16)[0]


def tally(obj, prefix: str = "", seen: set | None = None) -> list:
    """[(field, description, bytes)] of every tensor reachable from a
    graph or state (dataclasses, named tuples, dicts), each storage once;
    host arrays are listed with 0 device bytes."""
    seen = set() if seen is None else seen
    rows = []
    if isinstance(obj, torch.Tensor):
        st = obj.untyped_storage()
        key = (obj.device, st.data_ptr())
        n = 0 if key in seen else st.nbytes()
        seen.add(key)
        rows.append((prefix, f"{str(obj.dtype)[6:]}{list(obj.shape)}", n))
    elif isinstance(obj, np.ndarray):
        rows.append((prefix, f"host {obj.dtype}{list(obj.shape)}", 0))
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            rows += tally(getattr(obj, f.name), _join(prefix, f.name), seen)
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        for f in obj._fields:
            rows += tally(getattr(obj, f), _join(prefix, f), seen)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            rows += tally(v, f"{prefix}[{k!r}]", seen)
    return rows


def _join(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def exact_edge_graph(graph, n_edges: int):
    """The graph of the real edges alone, as ``drivers.ba._polish_problem``
    builds it (``edge_pad_multiple=1``), cut from the padded graph: the
    segments already cover the real edges only."""
    def cut(x):
        return None if x is None else x[..., :n_edges].contiguous()

    return dataclasses.replace(
        graph, cam_idx=cut(graph.cam_idx), lmk_idx=cut(graph.lmk_idx),
        meas=cut(graph.meas), meas_var=cut(graph.meas_var),
        intr=cut(graph.intr), derived={})


class _Stages:
    """Runs named stages, recording each one's host seconds and, on a
    card, its peak and live device memory; stops at the first stage that
    runs out of memory."""

    def __init__(self, dev: torch.device, n_edges: int):
        self.dev, self.n_edges = dev, n_edges
        self.rows, self.oom = [], None

    def __call__(self, name: str, fn):
        if self.oom is not None:
            return None
        cuda = self.dev.type == "cuda"
        synchronize(self.dev)
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.dev)
        t0 = time.perf_counter()
        try:
            out = fn()
            synchronize(self.dev)
        except torch.cuda.OutOfMemoryError as e:
            self.oom = {"stage": name, "error": str(e).splitlines()[0]}
            out = None
        row = {"stage": name, "seconds": time.perf_counter() - t0,
               "peak_gib": None, "live_gib": None}
        if cuda:
            row["peak_gib"] = torch.cuda.max_memory_allocated(self.dev) / GIB
            row["live_gib"] = torch.cuda.memory_allocated(self.dev) / GIB
            row["peak_b_per_edge"] = row["peak_gib"] * GIB / self.n_edges
        self.rows.append(row)
        return out


def _slice_check(state: GBPState, graph, sl: slice):
    """The inputs of the first sweep on the edges ``sl``, and a function
    that holds the swept state's slice against the plain sweep of them on
    the same tables (H2's, bit-identical to its plain version)."""
    tables = table_kernel.build_tables(state.cam_bel, state.lmk_bel)
    pre = dataclasses.replace(
        state, pk=state.pk[:, sl].clone(),
        damping_count=state.damping_count[sl].clone(),
        robust=state.robust[sl].clone(), active=state.active[sl].clone())
    g_sl = dataclasses.replace(
        graph, cam_idx=graph.cam_idx[sl].clone(),
        lmk_idx=graph.lmk_idx[sl].clone(),
        meas=graph.meas[:, sl].contiguous(),
        meas_var=graph.meas_var[sl].clone(),
        intr=None if graph.intr is None else graph.intr[:, sl].contiguous(),
        derived={})

    def check(cfg) -> dict:
        sweep_kernel.sweep(pre, g_sl, *tables, cfg, reference=True)
        k_pk = state.pk[:, sl]
        flip = ((state.damping_count[sl] != pre.damping_count)
                | (state.robust[sl] != pre.robust))
        keep = ~flip
        a, b = k_pk[:, keep], pre.pk[:, keep]
        same_nan = bool((torch.isnan(a) == torch.isnan(b)).all())
        diff = torch.nan_to_num((a - b).abs(), nan=0.0)
        scale = 1.0 + torch.nan_to_num(b.abs(), nan=0.0).amax(1)
        rel = float((diff.amax(1) / scale).max()) if diff.numel() else 0.0
        return {"edges": sl.stop - sl.start,
                "first_element": sl.start,
                "bit_identical": bool(torch.equal(k_pk.nan_to_num(0.123),
                                                  pre.pk.nan_to_num(0.123))
                                      and not bool(flip.any())),
                "max_abs_err": float(diff.max()) if diff.numel() else 0.0,
                "max_rel_err": rel, "flips": int(flip.sum()),
                "ok": (same_nan and rel <= SWEEP_RTOL
                       and int(flip.sum()) <= SWEEP_FLIP_FRAC * len(flip) + 1)}

    return check


def ledger(shape: tuple[int, int, int], production: bool = False,
           n_sweeps: int | None = None, iter_offset: int | None = None,
           polish_iters: int = 1, slice_edges: int = 0,
           device=None, problem=None, oracle: bool = False) -> dict:
    """The ledger of ``synthetic_problem_large(*shape)`` (see the module
    docstring). ``n_sweeps`` and ``iter_offset`` override ``run_gbp``'s
    (8 and 2 steps; with ``production`` 100 and ``accel_start``). With
    ``slice_edges`` > 0 the first sweep runs alone and its last
    ``slice_edges`` edges are held against the plain sweep on that slice
    (``slice``). ``problem``: that shape's problem, if the caller has
    generated it. With ``oracle``, the host's float64 error at the belief
    means after initialise (``oracle_initialise``), beside the device's
    (``err_initialise``). Returns the tallies, the stages, the errors
    and, if a stage ran out of memory, ``oom``."""
    dev = resolve_device(device)
    cfg = driver_config() if production else GBPConfig()
    if n_sweeps is None:
        n_sweeps = 2 * cfg.accel_every if production else 8
    if iter_offset is None:
        iter_offset = cfg.accel_start if production else 2 * cfg.steps
    out = {"device": device_label(dev), "shape": tuple(shape),
           "production": production, "sweeps": n_sweeps,
           "iter_offset": iter_offset}
    if problem is None:
        t0 = time.perf_counter()
        problem = balio.synthetic_problem_large(*shape)
        out["problem_seconds"] = time.perf_counter() - t0
    n_real = out["edges"] = problem.n_edges
    run = _Stages(dev, n_real)
    built = run("build", lambda: (build_graph(problem, cfg, dev),
                                  init_state(problem, cfg, dev)))
    if built is None:
        return dict(out, stages=run.rows, oom=run.oom)
    graph, state = built
    del built
    out["padded"] = graph.n_edges
    out["pk_elements"] = state.pk.numel()

    def initialise():
        s = gbp.initialise(state, graph, cfg)
        return s, float(gbp.reprojection_error(s, graph, cfg=cfg)[0])

    state, out["err_initialise"] = run("initialise", initialise) or (None,
                                                                    None)
    if oracle and state is not None:
        out["oracle_initialise"] = evaluation.numpy_reprojection_error(
            *analysis.belief_means(state), problem)[0]
    diags = production

    def solve():
        s, n, errs = state, n_sweeps, []
        if slice_edges:
            m = min(slice_edges, graph.n_edges)
            check = _slice_check(s, graph, slice(graph.n_edges - m,
                                                 graph.n_edges))
            s, d = gbp.run_gbp(s, graph, cfg, 1, with_diagnostics=diags,
                               iter_offset=iter_offset)
            out["slice"] = check(cfg)
            del check
            n -= 1
            errs.append(d)
        s, d = gbp.run_gbp(s, graph, cfg, n, with_diagnostics=diags,
                           iter_offset=iter_offset + n_sweeps - n)
        errs.append(d)
        if diags:
            out["errs"] = torch.cat([x.reproj_err for x in errs]).tolist()
        return s

    if state is not None:
        state = run("run_gbp", solve)
    if state is not None:
        cfg_c = (cfg if cfg.coarse_groups > 0 else dataclasses.replace(
            cfg, coarse_groups=min(16, graph.n_keyframes)))

        def coarse():
            degs = gbp._active_degrees(state, graph, cfg_c)
            s, info = gbp._coarse_step(state, graph, cfg_c, degs)
            out["coarse_gain"] = float(info.gain)
            return s

        state = run("coarse step", coarse)
    if state is not None and polish_iters > 0:
        def polish():
            cam_mu, lmk_mu = analysis.belief_means(state)
            g1 = exact_edge_graph(graph, n_real)
            pri = gn.problem_priors(problem, cfg, g1)
            res = gn.solve_lm(torch.tensor(cam_mu, device=dev),
                              torch.tensor(lmk_mu, device=dev), g1, pri,
                              cfg, n_lm_iters=polish_iters)
            out["polish_err"] = float(res.reproj_err[-1])
            out["polish_cost"] = res.cost.tolist()
            return True

        run(f"LM polish ({polish_iters} iterations)", polish)
    out["stages"], out["oom"] = run.rows, run.oom
    if state is not None:
        out["graph"] = tally(graph)
        out["state"] = tally(state)
    return out


def report(r: dict) -> list[str]:
    e = r["edges"]
    lines = [f"shape: {r['shape'][0]} kf / {r['shape'][1]} lmk / "
             f"{r['shape'][2]} obs = {e} edges ({r.get('padded', '-')} "
             f"padded; pk {r.get('pk_elements', '-')} elements); "
             + (f"problem generated in {r['problem_seconds']:.1f} s; "
                if "problem_seconds" in r else "")
             + f"{'production' if r['production'] else 'sweep chain'}, "
             f"{r['sweeps']} sweeps from iteration {r['iter_offset']}"]
    for title, key in (("GBPGraph", "graph"), ("GBPState", "state")):
        rows = r.get(key)
        if rows is None:
            continue
        total = sum(n for _, _, n in rows)
        lines.append(f"== {title}: {total / GIB:.3f} GiB, "
                     f"{total / e:.1f} B/edge ==")
        for f, desc, n in sorted(rows, key=lambda x: -x[2]):
            if n >= 2 ** 20:
                lines.append(f"  {n / 2**20:10.1f} MiB  {n / e:7.1f} B/edge"
                             f"  {f:28s} {desc}")
        small = sum(n for _, _, n in rows if n < 2 ** 20)
        lines.append(f"  {small / 2**20:10.1f} MiB  (everything under 1 MiB)")
    for s in r["stages"]:
        mem = ("peak not measured (no card)" if s["peak_gib"] is None else
               f"peak {s['peak_gib']:.3f} GiB ({s['peak_b_per_edge']:.1f} "
               f"B/edge), live after {s['live_gib']:.3f} GiB")
        lines.append(f"stage {s['stage']}: {s['seconds']:.2f} s, {mem}")
    if "oracle_initialise" in r:
        lines.append(f"error after initialise {r['err_initialise']:.4f} px "
                     f"on the device, {r['oracle_initialise']:.4f} px by the "
                     "host oracle at the same means")
    if r.get("errs"):
        lines.append(f"error {r['err_initialise']:.4f} px after initialise "
                     f"-> {r['errs'][-1]:.4f} px after {len(r['errs'])} "
                     "sweeps")
    if "slice" in r:
        s = r["slice"]
        lines.append(f"first sweep, last {s['edges']} edges against the "
                     f"plain sweep: bit-identical {s['bit_identical']}, max "
                     f"|kernel - plain| {s['max_abs_err']:.3e} (relative "
                     f"{s['max_rel_err']:.3e}), decision flips {s['flips']}")
    if "coarse_gain" in r:
        lines.append(f"coarse step: gain {r['coarse_gain']:g}")
    if "polish_err" in r:
        lines.append(f"polish: {r['polish_err']:.4f} px, MAP cost by "
                     "iteration " + ", ".join(f"{c:.6e}"
                                              for c in r["polish_cost"]))
    if r["oom"]:
        lines.append(f"OUT OF MEMORY at stage {r['oom']['stage']}: "
                     f"{r['oom']['error']}")
    lines.append(f"device: {r['device']}")
    return lines


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts, pos = {}, []
    it = iter(argv)
    for a in it:
        if a in ("--obs", "--shape", "--sweeps"):
            opts[a] = next(it)
        elif a == "--production":
            opts[a] = True
        else:
            pos.append(a)
    if "--shape" in opts:
        shape = tuple(int(x) for x in opts["--shape"].split(","))
    else:
        shape = venice_like_shape(float(pos[0]) if pos else 4.97,
                                  int(opts.get("--obs", 5)))
    r = ledger(shape, production="--production" in opts,
               n_sweeps=int(opts["--sweeps"]) if "--sweeps" in opts else None)
    for line in report(r):
        print(line, flush=True)
    return 1 if r["oom"] else 0


if __name__ == "__main__":
    sys.exit(main())
