#!/usr/bin/env python3
"""Drive the PyTorch port (gbp_poplar_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
the final ``ok`` line:
  1. environment: torch/CUDA versions, the card's name and power limit;
     a CUDA device is required;
  2. build the hand-written kernels (csrc/*.cu) with nvcc;
  3. each kernel against its plain PyTorch version on the card: the table
     build (H2) and the segmented sum (H3) on random inputs and at the
     Ladybug shape; one sweep (H1) on the small pinhole problem, the
     Snavely problem and the Ladybug-shape state after initialise + 20
     sweeps; then each kernel's time beside its plain version's;
  4. the main path at the Ladybug shape (synthetic_problem_large(1723,
     156000, 7): 1,092,000 edges, 1,092,608 padded): build_graph /
     init_state on the card, initialise, run_gbp(200) with diagnostics,
     the launch counts of every kernel, the same 200 sweeps with
     kernels="reference", ms/sweep of both, and peak device memory.

The last lines are one JSON object of per-kernel results, the card's
``name, power.limit`` as nvidia-smi prints it, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

LADYBUG_SHAPE = (1723, 156000, 7)      # keyframes, landmarks, obs/landmark
# Initial landmark perturbation (the ba driver's --ltn, metres): the
# generator's means are the ground truth, and a solve from the truth has
# nothing to fall from; 5 cm at 4-8 m depth starts at about 5.6 px.
LADYBUG_LMK_NOISE = 0.05
MAIN_SWEEPS = 200
TIMED_SWEEPS = 20

# Tolerances, kernel against plain version on the same card. The library
# is built with -fmad=false and IEEE divide/sqrt, the same rounding as
# PyTorch's separate elementwise kernels, so the outputs are expected to
# agree to the last bit except where the two take a borderline decision
# differently; the bounds leave room for that and nothing else.
TABLE_RTOL = 1e-5          # table means, relative to 1 + |mean|
REDUCE_RTOL = 1e-5         # sums, relative to the sum of |terms| (the plain
                           # version adds with atomics in run-dependent order)
SWEEP_RTOL = 1e-4          # edge fields, relative to 1 + max |field|
SWEEP_FLIP_FRAC = 1e-3     # lanes whose discrete outputs may differ
MAIN_AGREE_PX = 0.05       # final error: kernels vs reference, px ...
MAIN_AGREE_REL = 0.02      # ... or this fraction, whichever is larger


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events,
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def same(a, b) -> bool:
    """Bitwise-equal values, NaN matching NaN."""
    import torch

    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    import gbp_poplar_tpu_torch  # noqa: F401  (sets TF32 off)
    from gbp_poplar_tpu_torch.config import GBPConfig, InitConfig
    from gbp_poplar_tpu_torch.core import build_graph, factor_graph as fg
    from gbp_poplar_tpu_torch.core import gbp, init_state
    from gbp_poplar_tpu_torch.ops import _cuda, reduce_kernel, sweep_kernel
    from gbp_poplar_tpu_torch.ops import table_kernel
    from gbp_poplar_tpu_torch.utils import balio, priors

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = smi_line()

    # ---- 1. environment ----
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__},"
          f" CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    print(f"[env] card: {card}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    _cuda.library()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {' '.join(_cuda.NVCC_FLAGS)})")
    with open(_cuda.ptxas_log) as f:
        for line in f:
            if "Compiling entry" in line or "spill" in line or "Used" in line:
                print("[build] " + line.strip())

    # ---- 3. kernels against their plain versions ----
    cfg = GBPConfig(accel_every=0, coarse_groups=0)
    rng = np.random.default_rng(0)

    def table_case(label, bel, d):
        k = table_kernel.build_table(bel, d)
        r = table_kernel.build_table(bel, d, reference=True)
        comp = bel.shape[0]
        check(same(k[:, :comp], r[:, :comp]),
              f"table {label}: belief columns differ")
        check(same(k[:, comp + d:], r[:, comp + d:]),
              f"table {label}: valid flag or padding differ")
        diff = (k[:, comp:comp + d] - r[:, comp:comp + d]).abs()
        rel = (diff / (1.0 + r[:, comp:comp + d].abs())).max().item()
        print(f"[H2] {label}: max |kernel - plain| mean "
              f"{diff.max().item():.3e} (relative {rel:.3e}, bound "
              f"{TABLE_RTOL}), invalid rows {int((r[:, comp + d] == 0).sum())}")
        check(rel <= TABLE_RTOL, f"table {label}: means differ")
        return diff.max().item()

    def random_beliefs(d, n):
        comp = d + d * (d + 1) // 2
        eta = rng.normal(0, 1, (d, n))
        a = rng.normal(0, 1, (n, d, d))
        lam = a @ a.transpose(0, 2, 1) + 0.5 * np.eye(d)
        packed = np.stack([lam[:, i, j] for i in range(d) for j in range(i + 1)])
        bel = np.concatenate([eta, packed]).astype(np.float32)
        bel[d:, 7] = 0.0                     # singular -> invalid
        bel[0, 11] = np.nan                  # poisoned -> invalid
        check(bel.shape[0] == comp, "belief layout")
        return torch.tensor(bel, device=dev)

    h2_err = 0.0
    for d, n in ((6, LADYBUG_SHAPE[0]), (3, LADYBUG_SHAPE[1])):
        h2_err = max(h2_err, table_case(f"random d={d} n={n}",
                                        random_beliefs(d, n), d))

    def reduce_case(label, planes, seg, prior):
        k = reduce_kernel.segment_sum(planes, seg, prior)
        r = reduce_kernel.segment_sum(planes, seg, prior, reference=True)
        scale = reduce_kernel.segment_sum(planes.abs(), seg, prior.abs(),
                                          reference=True)
        diff = (k - r).abs()
        rel = (diff / (scale + 1e-30)).max().item()
        again = reduce_kernel.segment_sum(planes, seg, prior)
        check(torch.equal(k, again), f"reduce {label}: not deterministic")
        print(f"[H3] {label}: max |kernel - plain| {diff.max().item():.3e} "
              f"(relative to sum |terms| {rel:.3e}, bound {REDUCE_RTOL}); "
              f"bit-identical on rerun")
        check(rel <= REDUCE_RTOL, f"reduce {label}: sums differ")
        return diff.max().item()

    prob_l = priors.apply_init_noise(
        balio.synthetic_problem_large(*LADYBUG_SHAPE),
        InitConfig(lmk_noise=LADYBUG_LMK_NOISE, seed=0))
    graph_l = build_graph(prob_l, cfg, dev)
    e_l = graph_l.n_edges
    print(f"[main] Ladybug shape: {prob_l.n_keyframes} keyframes, "
          f"{prob_l.n_points} landmarks, {prob_l.n_edges} edges "
          f"({e_l} padded), landmarks perturbed by N(0, "
          f"{LADYBUG_LMK_NOISE} m)")
    h3_err = 0.0
    pk_rand = torch.tensor(rng.normal(0, 1, (36, e_l)).astype(np.float32),
                           device=dev)
    for label, rows, seg, n_var in (
            ("random cam", pk_rand[:27], graph_l.cam_seg, graph_l.n_keyframes),
            ("random lmk", pk_rand[27:], graph_l.lmk_seg, graph_l.n_points)):
        prior = torch.tensor(rng.normal(0, 1, (rows.shape[0], n_var))
                             .astype(np.float32), device=dev)
        h3_err = max(h3_err, reduce_case(label, rows, seg, prior))

    def sweep_case(label, state, graph):
        ct = table_kernel.build_table(state.cam_bel, 6, reference=True)
        lt = table_kernel.build_table(state.lmk_bel, 3, reference=True)
        sk, sr = state.clone(), state.clone()
        sweep_kernel.sweep(sk, graph, ct, lt, cfg)
        sweep_kernel.sweep(sr, graph, ct, lt, cfg, reference=True)
        torch.cuda.synchronize()
        flip = ((sk.damping_count != sr.damping_count)
                | (sk.robust != sr.robust))
        n_flip = int(flip.sum())
        keep = ~flip
        worst, worst_rel, worst_field = 0.0, 0.0, ""
        for fname, (a, b) in fg.EDGE_PACK_OFFSETS.items():
            kf, rf = sk.pk[a:b][:, keep], sr.pk[a:b][:, keep]
            same_nan = torch.isnan(kf) == torch.isnan(rf)
            check(bool(same_nan.all()), f"sweep {label}: NaN pattern {fname}")
            diff = torch.nan_to_num((kf - rf).abs(), nan=0.0)
            err = diff.max().item() if diff.numel() else 0.0
            scale = 1.0 + torch.nan_to_num(rf.abs(), nan=0.0).max().item()
            if err / scale > worst_rel:
                worst, worst_rel, worst_field = err, err / scale, fname
        relins = int((sr.damping_count == -cfg.num_undamped_iters).sum())
        print(f"[H1] {label}: {graph.n_edges} edges, {relins} relinearised, "
              f"{int(sr.robust.sum())} robust; lanes with differing "
              f"decisions {n_flip} (bound {SWEEP_FLIP_FRAC:g} of edges); "
              f"worst field {worst_field or '-'}: max |kernel - plain| "
              f"{worst:.3e} (relative {worst_rel:.3e}, bound {SWEEP_RTOL})")
        check(n_flip <= SWEEP_FLIP_FRAC * graph.n_edges + 1,
              f"sweep {label}: too many decision flips")
        check(worst_rel <= SWEEP_RTOL, f"sweep {label}: fields differ")
        return worst

    h1_err = 0.0
    for label, prob in (
            ("pinhole synthetic_problem", balio.synthetic_problem(
                n_keyframes=6, n_points=60, seed=0, pixel_noise=0.5)),
            ("Snavely synthetic_problem_snavely",
             balio.synthetic_problem_snavely(pixel_noise=0.5))):
        g = build_graph(prob, cfg, dev)
        s = gbp.initialise(init_state(prob, cfg, dev), g, cfg)
        s, _ = gbp.run_gbp(s, g, cfg, 6, with_diagnostics=False)
        h1_err = max(h1_err, sweep_case(label, s, g))

    state_l = gbp.initialise(init_state(prob_l, cfg, dev), graph_l, cfg)
    state_l, _ = gbp.run_gbp(state_l, graph_l, cfg, 20,
                             with_diagnostics=False)
    h1_err = max(h1_err, sweep_case("Ladybug after initialise + 20 sweeps",
                                    state_l, graph_l))
    for d, bel in ((6, state_l.cam_bel), (3, state_l.lmk_bel)):
        h2_err = max(h2_err, table_case(f"Ladybug state d={d}", bel, d))
    h3_err = max(h3_err, reduce_case(
        "Ladybug state cam", state_l.pk[54:81], graph_l.cam_seg,
        state_l.cam_prior))
    h3_err = max(h3_err, reduce_case(
        "Ladybug state lmk", state_l.pk[81:90], graph_l.lmk_seg,
        state_l.lmk_prior))

    # each kernel's time beside its plain version's, at the Ladybug shape
    st_k, st_r = state_l.clone(), state_l.clone()
    ct = table_kernel.build_table(state_l.cam_bel, 6)
    lt = table_kernel.build_table(state_l.lmk_bel, 3)
    times = {
        "sweep": (
            cuda_ms(lambda: sweep_kernel.sweep(st_k, graph_l, ct, lt, cfg),
                    TIMED_SWEEPS),
            cuda_ms(lambda: sweep_kernel.sweep(st_r, graph_l, ct, lt, cfg,
                                               reference=True), 3)),
        "table": (
            cuda_ms(lambda: (table_kernel.build_table(state_l.cam_bel, 6),
                             table_kernel.build_table(state_l.lmk_bel, 3)),
                    TIMED_SWEEPS),
            cuda_ms(lambda: (
                table_kernel.build_table(state_l.cam_bel, 6, reference=True),
                table_kernel.build_table(state_l.lmk_bel, 3,
                                         reference=True)), 5)),
        "reduce": (
            cuda_ms(lambda: gbp.update_beliefs(st_k, graph_l, cfg),
                    TIMED_SWEEPS),
            cuda_ms(lambda: gbp.update_beliefs(
                st_r, graph_l, dataclasses.replace(cfg, kernels="reference")),
                5)),
    }
    for k, (ms, plain) in times.items():
        print(f"[time] {k}: kernel {ms:.4f} ms, plain PyTorch {plain:.4f} ms "
              f"per sweep at {e_l} padded edges ({card})")
    del st_k, st_r, ct, lt

    # ---- 4. the main path at the Ladybug shape ----
    ref_cfg = dataclasses.replace(cfg, kernels="reference")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in (sweep_kernel.sweep, table_kernel.build_table,
               reduce_kernel.segment_sum):
        fn.launches = 0
    s0 = init_state(prob_l, cfg, dev)
    s = gbp.initialise(s0, graph_l, cfg)
    err0 = gbp.reprojection_error(s, graph_l)[0].item()
    s, diag = gbp.run_gbp(s, graph_l, cfg, MAIN_SWEEPS)
    torch.cuda.synchronize()
    launches = {"sweep": sweep_kernel.sweep.launches,
                "table": table_kernel.build_table.launches,
                "reduce": reduce_kernel.segment_sum.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    err = diag.reproj_err.cpu().numpy()
    marks = [i for i in (0, 9, 19, 49, 99, 149) if i < MAIN_SWEEPS]
    print("[main] kernels: error by sweep "
          + ", ".join(f"{i + 1}: {err[i]:.4f}" for i in marks) + " px")
    print(f"[main] kernels: error {err0:.4f} px after initialise -> "
          f"{err[-1]:.4f} px after {MAIN_SWEEPS} sweeps (min {err.min():.4f},"
          f" relinearised at the end {int(diag.n_relins[-1])}, robust "
          f"{int(diag.n_robust[-1])}); peak device memory {peak_gib:.2f} GiB")
    print(f"[main] launches in the main path: {launches}")
    check(bool(np.isfinite(err).all()), "main path: non-finite error")
    check(err[-1] < err0, "main path: error did not fall")
    check(launches == {"sweep": MAIN_SWEEPS, "table": 2 * MAIN_SWEEPS,
                       "reduce": 2 * MAIN_SWEEPS + 2},
          "main path did not go through every kernel once per sweep")

    s_r = gbp.initialise(init_state(prob_l, ref_cfg, dev), graph_l, ref_cfg)
    s_r, diag_r = gbp.run_gbp(s_r, graph_l, ref_cfg, MAIN_SWEEPS)
    err_r = diag_r.reproj_err.cpu().numpy()
    gap = abs(float(err[-1]) - float(err_r[-1]))
    bound = max(MAIN_AGREE_PX, MAIN_AGREE_REL * float(err_r[-1]))
    print(f"[main] reference: error {err_r[-1]:.4f} px after {MAIN_SWEEPS} "
          f"sweeps; |kernels - reference| {gap:.4f} px (bound {bound:.4f})")
    check(bool(np.isfinite(err_r).all()) and gap <= bound,
          "main path: kernels and reference disagree")

    # ms/sweep, anneal-free sweeps without diagnostics, after warm-up
    sweep_ms = {}
    for label, c, st in (("kernels", cfg, s), ("reference", ref_cfg, s_r)):
        gbp.run_gbp(st, graph_l, c, 2, with_diagnostics=False,
                    iter_offset=2 * c.steps)
        n = TIMED_SWEEPS if label == "kernels" else 5
        sweep_ms[label] = cuda_ms(
            lambda: gbp.run_gbp(st, graph_l, c, n, with_diagnostics=False,
                                iter_offset=2 * c.steps), 1) / n
        print(f"[main] {label}: {sweep_ms[label]:.4f} ms/sweep at {e_l} "
              f"padded edges ({card})")

    # the main path as run above: with per-sweep diagnostics (plain
    # PyTorch: per-variable means, projection, reductions)
    diag_ms = cuda_ms(lambda: gbp.run_gbp(s, graph_l, cfg, TIMED_SWEEPS,
                                          iter_offset=2 * cfg.steps),
                      1) / TIMED_SWEEPS
    print(f"[main] kernels with diagnostics: {diag_ms:.4f} ms/sweep "
          f"({card})")

    replaces = {
        "sweep": ("gbp_poplar_tpu_torch/csrc/sweep.cu",
                  "gbp_poplar_tpu/ops/sweep_kernel.py:274", h1_err),
        "table": ("gbp_poplar_tpu_torch/csrc/table.cu",
                  "gbp_poplar_tpu/ops/table_kernel.py:41", h2_err),
        "reduce": ("gbp_poplar_tpu_torch/csrc/reduce.cu",
                   "gbp_poplar_tpu/ops/reduce_kernel.py:171", h3_err),
    }
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": err_k,
         "ms": times[k][0], "plain_ms": times[k][1]}
        for k, (src, rep, err_k) in replaces.items()]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
