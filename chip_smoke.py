#!/usr/bin/env python3
"""Drive the PyTorch port (gbp_poplar_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
the final ``ok`` line:
  1. environment: torch/CUDA versions, the card's name and power limit;
     a CUDA device is required;
  2. build the hand-written kernels (csrc/*.cu) with nvcc, one process per
     source, and print each kernel's registers and spills;
  3. the fused path's kernels against their plain PyTorch versions on the
     card: the table build (H2) and the segmented sum (H3) on random inputs
     and at the Ladybug shape; one fused sweep (H1) on the small pinhole
     problem, the Snavely problem and the Ladybug-shape state after
     initialise + 20 sweeps; then each kernel's time beside its plain
     version's;
  4. the fused main path at the Ladybug shape (synthetic_problem_large(
     1723, 156000, 7): 1,092,000 edges, 1,092,608 padded), reference
     schedule (accel_every=0): build_graph / init_state on the card,
     initialise, run_gbp(200) with diagnostics, the launch counts of every
     kernel, the same 200 sweeps with kernels="reference", ms/sweep of
     both, and peak device memory; then ``solve_ba`` on the small pinhole
     problem with the library defaults (``GBPConfig()``);
  5. the Venice shape (synthetic_problem_large(1778, 994000, 5): 4,970,000
     edges, the shape of BAL Venice-1778) with its cameras relabelled by a
     random permutation, as in an unordered photo collection, and its
     landmarks perturbed by N(0, 5 cm): the gather (H5) against
     index_select on its camera and landmark indices (bit-identical); one
     unfused sweep (H4) against its plain version on the pinhole and
     Snavely problems and on the Venice state after initialise + 20
     sweeps, and against the fused sweep (H1) on that state;
  6. the unfused main path at the Venice shape: GBPConfig(fused=False),
     every other default (accelerator every 50 sweeps from sweep 150),
     300 sweeps with diagnostics: the error at marks, the accelerator's
     steps, the launch counts, peak device memory;
  7. the same solve with kernels="reference" and with fused=True: the
     final errors must agree;
  8. times at the Venice shape: H4 and H5 beside their plain versions,
     ms/sweep of both pipelines with and without the accelerator, and the
     accelerator's cost per chunk.

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
# BAL Venice-1778 (1,778 cameras, 993,923 points, 5,001,946 observations)
# as the JAX package's bench.py sizes it
VENICE_SHAPE = (1778, 994000, 5)
# Initial landmark perturbation (the ba driver's --ltn, metres): the
# generator's means are the ground truth, and a solve from the truth has
# nothing to fall from; 5 cm at 4-8 m depth starts at about 5.6 px.
LMK_NOISE = 0.05
LADYBUG_SWEEPS = 200
VENICE_SWEEPS = 300
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


def shuffle_cameras(prob, seed: int = 0):
    """The problem with its cameras relabelled by a random permutation (new
    id of camera c: perm[c]): the ids of an unordered photo collection
    follow no sequence."""
    import numpy as np

    perm = np.random.default_rng(seed).permutation(prob.n_keyframes)

    def moved(x):
        if x is None:
            return None
        out = np.empty_like(x)
        out[perm] = x
        return out

    return dataclasses.replace(
        prob, cam_idx=perm[prob.cam_idx].astype(prob.cam_idx.dtype),
        cam_means=moved(prob.cam_means), intrinsics=moved(prob.intrinsics))


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
    wrappers = {"sweep": sweep_kernel.sweep, "table": table_kernel.build_table,
                "reduce": reduce_kernel.segment_sum,
                "sweep_planes": sweep_kernel.sweep_planes,
                "gather": reduce_kernel.gather}

    def reset_counts():
        torch.cuda.synchronize()
        for fn in wrappers.values():
            fn.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        return {k: fn.launches for k, fn in wrappers.items()}

    # ---- 1. environment ----
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__},"
          f" CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    print(f"[env] card: {card}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    _cuda.library()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {' '.join(_cuda.NVCC_FLAGS)}, one process per source)")
    with open(_cuda.ptxas_log) as f:
        for line in f:
            if "Compiling entry" in line or "spill" in line or "Used" in line:
                print("[build] " + line.strip())

    # ---- 3. the fused path's kernels against their plain versions ----
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
        InitConfig(lmk_noise=LMK_NOISE, seed=0))
    graph_l = build_graph(prob_l, cfg, dev)
    e_l = graph_l.n_edges
    print(f"[main] Ladybug shape: {prob_l.n_keyframes} keyframes, "
          f"{prob_l.n_points} landmarks, {prob_l.n_edges} edges "
          f"({e_l} padded), landmarks perturbed by N(0, {LMK_NOISE} m)")
    h3_err = 0.0
    pk_rand = torch.tensor(rng.normal(0, 1, (36, e_l)).astype(np.float32),
                           device=dev)
    for label, rows, seg, n_var in (
            ("random cam", pk_rand[:27], graph_l.cam_seg, graph_l.n_keyframes),
            ("random lmk", pk_rand[27:], graph_l.lmk_seg, graph_l.n_points)):
        prior = torch.tensor(rng.normal(0, 1, (rows.shape[0], n_var))
                             .astype(np.float32), device=dev)
        h3_err = max(h3_err, reduce_case(label, rows, seg, prior))

    def compare_sweeps(tag, label, graph, sk, sr, against):
        """Field-by-field comparison of two swept states; returns the
        largest absolute difference of the worst field."""
        flip = ((sk.damping_count != sr.damping_count)
                | (sk.robust != sr.robust))
        n_flip = int(flip.sum())
        keep = ~flip
        worst, worst_rel, worst_field = 0.0, 0.0, ""
        for fname, (a, b) in fg.EDGE_PACK_OFFSETS.items():
            kf, rf = sk.pk[a:b][:, keep], sr.pk[a:b][:, keep]
            same_nan = torch.isnan(kf) == torch.isnan(rf)
            check(bool(same_nan.all()), f"{tag} {label}: NaN pattern {fname}")
            diff = torch.nan_to_num((kf - rf).abs(), nan=0.0)
            err = diff.max().item() if diff.numel() else 0.0
            scale = 1.0 + torch.nan_to_num(rf.abs(), nan=0.0).max().item()
            if err / scale > worst_rel:
                worst, worst_rel, worst_field = err, err / scale, fname
        relins = int((sr.damping_count == -cfg.num_undamped_iters).sum())
        print(f"[{tag}] {label}: {graph.n_edges} edges, {relins} "
              f"relinearised, {int(sr.robust.sum())} robust; lanes with "
              f"differing decisions {n_flip} (bound {SWEEP_FLIP_FRAC:g} of "
              f"edges); worst field {worst_field or '-'}: max |kernel - "
              f"{against}| {worst:.3e} (relative {worst_rel:.3e}, bound "
              f"{SWEEP_RTOL})")
        check(n_flip <= SWEEP_FLIP_FRAC * graph.n_edges + 1,
              f"{tag} {label}: too many decision flips")
        check(worst_rel <= SWEEP_RTOL, f"{tag} {label}: fields differ")
        return worst

    def sweep_case(label, state, graph):
        ct = table_kernel.build_table(state.cam_bel, 6, reference=True)
        lt = table_kernel.build_table(state.lmk_bel, 3, reference=True)
        sk, sr = state.clone(), state.clone()
        sweep_kernel.sweep(sk, graph, ct, lt, cfg)
        sweep_kernel.sweep(sr, graph, ct, lt, cfg, reference=True)
        return compare_sweeps("H1", label, graph, sk, sr, "plain")

    small = (("pinhole synthetic_problem", balio.synthetic_problem(
                 n_keyframes=6, n_points=60, seed=0, pixel_noise=0.5)),
             ("Snavely synthetic_problem_snavely",
              balio.synthetic_problem_snavely(pixel_noise=0.5)))
    h1_err = 0.0
    for label, prob in small:
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
    del st_k, st_r, ct, lt, state_l

    # ---- 4. the fused main path at the Ladybug shape ----
    ref_cfg = dataclasses.replace(cfg, kernels="reference")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    s0 = init_state(prob_l, cfg, dev)
    s = gbp.initialise(s0, graph_l, cfg)
    err0 = gbp.reprojection_error(s, graph_l)[0].item()
    s, diag = gbp.run_gbp(s, graph_l, cfg, LADYBUG_SWEEPS)
    launches_l = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    err = diag.reproj_err.cpu().numpy()
    marks = [i for i in (0, 9, 19, 49, 99, 149) if i < LADYBUG_SWEEPS]
    print("[main] kernels: error by sweep "
          + ", ".join(f"{i + 1}: {err[i]:.4f}" for i in marks) + " px")
    print(f"[main] kernels: error {err0:.4f} px after initialise -> "
          f"{err[-1]:.4f} px after {LADYBUG_SWEEPS} sweeps (min "
          f"{err.min():.4f}, relinearised at the end {int(diag.n_relins[-1])},"
          f" robust {int(diag.n_robust[-1])}); peak device memory "
          f"{peak_gib:.2f} GiB")
    print(f"[main] launches in the Ladybug main path: {launches_l}")
    check(bool(np.isfinite(err).all()), "main path: non-finite error")
    check(err[-1] < err0, "main path: error did not fall")
    check(launches_l == {"sweep": LADYBUG_SWEEPS, "table": 2 * LADYBUG_SWEEPS,
                         "reduce": 2 * LADYBUG_SWEEPS + 2, "sweep_planes": 0,
                         "gather": 0},
          "main path did not go through every kernel once per sweep")

    s_r = gbp.initialise(init_state(prob_l, ref_cfg, dev), graph_l, ref_cfg)
    s_r, diag_r = gbp.run_gbp(s_r, graph_l, ref_cfg, LADYBUG_SWEEPS)
    err_r = diag_r.reproj_err.cpu().numpy()
    gap = abs(float(err[-1]) - float(err_r[-1]))
    bound = max(MAIN_AGREE_PX, MAIN_AGREE_REL * float(err_r[-1]))
    print(f"[main] reference: error {err_r[-1]:.4f} px after "
          f"{LADYBUG_SWEEPS} sweeps; |kernels - reference| {gap:.4f} px "
          f"(bound {bound:.4f})")
    check(bool(np.isfinite(err_r).all()) and gap <= bound,
          "main path: kernels and reference disagree")

    # ms/sweep, anneal-free sweeps without diagnostics, after warm-up
    for label, c, st in (("kernels", cfg, s), ("reference", ref_cfg, s_r)):
        gbp.run_gbp(st, graph_l, c, 2, with_diagnostics=False,
                    iter_offset=2 * c.steps)
        n = TIMED_SWEEPS if label == "kernels" else 5
        ms = cuda_ms(lambda: gbp.run_gbp(st, graph_l, c, n,
                                         with_diagnostics=False,
                                         iter_offset=2 * c.steps), 1) / n
        print(f"[main] {label}: {ms:.4f} ms/sweep at {e_l} padded edges "
              f"({card})")

    # the main path as run above: with per-sweep diagnostics (plain
    # PyTorch: per-variable means, projection, reductions)
    diag_ms = cuda_ms(lambda: gbp.run_gbp(s, graph_l, cfg, TIMED_SWEEPS,
                                          iter_offset=2 * cfg.steps),
                      1) / TIMED_SWEEPS
    print(f"[main] kernels with diagnostics: {diag_ms:.4f} ms/sweep "
          f"({card})")
    del s, s_r, s0, graph_l, prob_l, diag, diag_r
    torch.cuda.empty_cache()

    # the one-call entry point with the library defaults (GBPConfig():
    # fused sweep, accelerator every 50 sweeps from sweep 150)
    _, _, e_s = gbp_poplar_tpu_torch.solve_ba(small[0][1], n_iters=200,
                                              device=dev)
    print(f"[main] solve_ba(pinhole problem) with GBPConfig(): error "
          f"{e_s[0]:.4f} -> {e_s[-1]:.4f} px in {len(e_s)} sweeps")
    check(bool(np.isfinite(e_s).all()) and e_s[-1] < e_s[0],
          "solve_ba with the default config failed")

    # ---- 5. the Venice shape: H5 and H4 against their plain versions ----
    cfg_u = GBPConfig(fused=False)
    t0 = time.perf_counter()
    prob_v = priors.apply_init_noise(
        shuffle_cameras(balio.synthetic_problem_large(*VENICE_SHAPE)),
        InitConfig(lmk_noise=LMK_NOISE, seed=0))
    graph_v = build_graph(prob_v, cfg_u, dev)
    e_v = graph_v.n_edges
    print(f"[venice] Venice shape: {prob_v.n_keyframes} cameras (ids "
          f"shuffled), {prob_v.n_points} landmarks, {prob_v.n_edges} edges "
          f"({e_v} padded), landmarks perturbed by N(0, {LMK_NOISE} m); "
          f"problem and graph built in {time.perf_counter() - t0:.1f} s")

    state_v = gbp.initialise(init_state(prob_v, cfg_u, dev), graph_v, cfg_u)
    h5_err = 0.0
    for label, src, idx in (("cameras", state_v.cam_bel, graph_v.cam_idx),
                            ("landmarks", state_v.lmk_bel, graph_v.lmk_idx)):
        k = reduce_kernel.gather(src, idx)
        r = reduce_kernel.gather(src, idx, reference=True)
        h5_err = max(h5_err, (k - r).abs().max().item())
        print(f"[H5] Venice {label}: [{src.shape[0]}, {src.shape[1]}] -> "
              f"[{k.shape[0]}, {k.shape[1]}], bit-identical to index_select:"
              f" {same(k, r)}")
        check(same(k, r), f"gather {label}: differs from index_select")

    def sweep_planes_case(label, state, graph, c):
        bc = reduce_kernel.gather(state.cam_bel, graph.cam_idx,
                                  reference=True)
        bl = reduce_kernel.gather(state.lmk_bel, graph.lmk_idx,
                                  reference=True)
        sk, sr = state.clone(), state.clone()
        sweep_kernel.sweep_planes(sk, graph, bc, bl, c)
        sweep_kernel.sweep_planes(sr, graph, bc, bl, c, reference=True)
        return compare_sweeps("H4", label, graph, sk, sr, "plain")

    h4_err = 0.0
    for label, prob in small:
        g = build_graph(prob, cfg_u, dev)
        s = gbp.initialise(init_state(prob, cfg_u, dev), g, cfg_u)
        s, _ = gbp.run_gbp(s, g, cfg_u, 6, with_diagnostics=False)
        h4_err = max(h4_err, sweep_planes_case(label, s, g, cfg_u))
    state_v, _ = gbp.run_gbp(state_v, graph_v, cfg_u, 20,
                             with_diagnostics=False)
    h4_err = max(h4_err, sweep_planes_case(
        "Venice after initialise + 20 sweeps", state_v, graph_v, cfg_u))
    # H4 (gathered planes, per-edge means) against H1 (tables) on the same
    # state, each with its own kernels: no difference expected
    s4, s1 = state_v.clone(), state_v.clone()
    sweep_kernel.sweep_planes(
        s4, graph_v, reduce_kernel.gather(state_v.cam_bel, graph_v.cam_idx),
        reduce_kernel.gather(state_v.lmk_bel, graph_v.lmk_idx), cfg_u)
    sweep_kernel.sweep(s1, graph_v, table_kernel.build_table(state_v.cam_bel,
                                                             6),
                       table_kernel.build_table(state_v.lmk_bel, 3), cfg_u)
    compare_sweeps("H4", "Venice, H4 on gathered planes vs H1 on tables",
                   graph_v, s4, s1, "H1")
    h4_vs_h1 = all(torch.equal(getattr(s4, f), getattr(s1, f))
                   for f in ("pk", "damping_count", "robust"))
    print(f"[H4] Venice: H4 and H1 bit-identical on the same state: "
          f"{h4_vs_h1}")
    del s4, s1

    # ---- 6. the unfused main path at the Venice shape ----
    del state_v
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    s = gbp.initialise(init_state(prob_v, cfg_u, dev), graph_v, cfg_u)
    err0 = gbp.reprojection_error(s, graph_v)[0].item()
    accel_log = []
    t0 = time.perf_counter()
    s, diag = gbp.run_gbp(s, graph_v, cfg_u, VENICE_SWEEPS,
                          accel_log=accel_log)
    launches_v = read_counts()
    wall = time.perf_counter() - t0
    peak_v = torch.cuda.max_memory_allocated() / 2**30
    err = diag.reproj_err.cpu().numpy()
    marks = [i for i in (0, 9, 49, 99, 149, 159, 199, 209, 249, 259, 299)
             if i < VENICE_SWEEPS]
    print("[venice] unfused kernels: error by sweep "
          + ", ".join(f"{i + 1}: {err[i]:.4f}" for i in marks) + " px")
    for n_at, st in accel_log:
        print(f"[venice] accelerator after sweep {n_at}: gain "
              f"{st.gain.item():.4f}, "
              f"{'accepted' if bool(st.accepted) else 'rejected'} (MAP cost "
              f"{st.cost_cur.item():.6e} -> candidate "
              f"{st.cost_cand.item():.6e})")
    n_jumps = sum(bool(st.accepted) and st.gain.item() > 0
                  for _, st in accel_log)
    print(f"[venice] unfused kernels: error {err0:.4f} px after initialise "
          f"-> {err[-1]:.4f} px after {VENICE_SWEEPS} sweeps (min "
          f"{err.min():.4f}); {n_jumps} accelerator jumps accepted of "
          f"{len(accel_log)} steps; {wall:.1f} s wall with diagnostics; "
          f"peak device memory {peak_v:.2f} GiB")
    print(f"[venice] launches in the Venice main path: {launches_v}")
    check(bool(np.isfinite(err).all()), "Venice main path: non-finite error")
    check(err[-1] < err0, "Venice main path: error did not fall")
    check([n for n, _ in accel_log] == [160, 210, 260],
          "Venice main path: the accelerator did not step at 160, 210, 260")
    # 10 annealed sweeps, then chunks of 50: chunk 1 plain, chunk 2 dead
    # but averaging its means, chunks 3-5 live, 40 plain sweeps; tables
    # (H2) only for the 200 averaged sweeps' means; reductions (H3) also
    # at initialise and for the accelerator's active degrees
    check(launches_v == {"sweep": 0, "table": 400,
                         "reduce": 2 * VENICE_SWEEPS + 4,
                         "sweep_planes": VENICE_SWEEPS,
                         "gather": 2 * VENICE_SWEEPS},
          "Venice main path did not go through H5, H4 and H3 every sweep")

    # ---- 7. agreement at the Venice shape ----
    ends = {}
    for label, c in (("reference", dataclasses.replace(cfg_u,
                                                       kernels="reference")),
                     ("fused", dataclasses.replace(cfg_u, fused=True))):
        s_x = gbp.initialise(init_state(prob_v, c, dev), graph_v, c)
        s_x, d_x = gbp.run_gbp(s_x, graph_v, c, VENICE_SWEEPS)
        e_x = d_x.reproj_err.cpu().numpy()
        ends[label] = e_x
        gap = abs(float(err[-1]) - float(e_x[-1]))
        bound = max(MAIN_AGREE_PX, MAIN_AGREE_REL * float(e_x[-1]))
        print(f"[venice] {label}: error {e_x[-1]:.4f} px after "
              f"{VENICE_SWEEPS} sweeps; |unfused kernels - {label}| "
              f"{gap:.6f} px (bound {bound:.4f}), largest per-sweep "
              f"difference {np.abs(e_x - err).max():.6f} px")
        check(bool(np.isfinite(e_x).all()) and gap <= bound,
              f"Venice main path: kernels and {label} disagree")
        del s_x, d_x

    # ---- 8. times at the Venice shape ----
    bc = reduce_kernel.gather(s.cam_bel, graph_v.cam_idx)
    bl = reduce_kernel.gather(s.lmk_bel, graph_v.lmk_idx)
    st_k, st_r = s.clone(), s.clone()
    times["sweep_planes"] = (
        cuda_ms(lambda: sweep_kernel.sweep_planes(st_k, graph_v, bc, bl,
                                                  cfg_u), TIMED_SWEEPS),
        cuda_ms(lambda: sweep_kernel.sweep_planes(st_r, graph_v, bc, bl,
                                                  cfg_u, reference=True), 3))
    times["gather"] = (
        cuda_ms(lambda: (reduce_kernel.gather(s.cam_bel, graph_v.cam_idx),
                         reduce_kernel.gather(s.lmk_bel, graph_v.lmk_idx)),
                TIMED_SWEEPS),
        cuda_ms(lambda: (
            reduce_kernel.gather(s.cam_bel, graph_v.cam_idx, reference=True),
            reduce_kernel.gather(s.lmk_bel, graph_v.lmk_idx, reference=True)),
                TIMED_SWEEPS))
    for k in ("sweep_planes", "gather"):
        print(f"[time] {k}: kernel {times[k][0]:.4f} ms, plain PyTorch "
              f"{times[k][1]:.4f} ms per sweep at {e_v} padded edges "
              f"({card})")
    del st_k, st_r, bc, bl

    n_acc = 2 * cfg_u.accel_every
    for label, fused in (("unfused", False), ("fused", True)):
        c = dataclasses.replace(cfg_u, fused=fused)
        c0 = dataclasses.replace(c, accel_every=0)
        st = s.clone()
        gbp.run_gbp(st, graph_v, c0, 2, with_diagnostics=False,
                    iter_offset=2 * c.steps)
        plain_ms = cuda_ms(lambda: gbp.run_gbp(
            st, graph_v, c0, TIMED_SWEEPS, with_diagnostics=False,
            iter_offset=2 * c.steps), 1) / TIMED_SWEEPS
        # two live chunks: every sweep averages its means, two steps
        acc_ms = cuda_ms(lambda: gbp.run_gbp(
            st, graph_v, c, n_acc, with_diagnostics=False,
            iter_offset=10 * c.accel_start), 1) / n_acc
        print(f"[venice] {label}: {plain_ms:.4f} ms/sweep without the "
              f"accelerator, {acc_ms:.4f} ms/sweep with it live (chunk cost "
              f"{(acc_ms - plain_ms) * c.accel_every:.3f} ms per "
              f"{c.accel_every} sweeps) at {e_v} padded edges ({card})")
        del st
    degs = gbp._active_degrees(s, graph_v, cfg_u)
    cam_mu, lmk_mu = gbp._variable_means(s)
    snap = (cam_mu, lmk_mu, torch.full_like(cam_mu, 1e-4))
    avg = (cam_mu + 1e-4, lmk_mu)
    st = s.clone()
    step_ms = cuda_ms(lambda: gbp._accel_step(st, snap, avg, graph_v, cfg_u,
                                              degs), 5)
    means_ms = cuda_ms(lambda: gbp._sanitized_means(st, cfg_u), TIMED_SWEEPS)
    print(f"[venice] accelerator: one step {step_ms:.4f} ms, the means a "
          f"chunk averages {means_ms:.4f} ms per sweep ({card})")
    del st

    replaces = {
        "sweep": ("gbp_poplar_tpu_torch/csrc/sweep.cu",
                  "gbp_poplar_tpu/ops/sweep_kernel.py:274", h1_err),
        "table": ("gbp_poplar_tpu_torch/csrc/table.cu",
                  "gbp_poplar_tpu/ops/table_kernel.py:41", h2_err),
        "reduce": ("gbp_poplar_tpu_torch/csrc/reduce.cu",
                   "gbp_poplar_tpu/ops/reduce_kernel.py:171", h3_err),
        "sweep_planes": ("gbp_poplar_tpu_torch/csrc/sweep.cu",
                         "gbp_poplar_tpu/ops/sweep_kernel.py:43", h4_err),
        "gather": ("gbp_poplar_tpu_torch/csrc/gather.cu",
                   "gbp_poplar_tpu/ops/reduce_kernel.py:439", h5_err),
    }
    launches = {k: launches_l[k] + launches_v[k] for k in replaces}
    check(all(n > 0 for n in launches.values()),
          "a kernel was never launched by the main paths")
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
