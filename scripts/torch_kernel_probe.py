#!/usr/bin/env python3
"""Profile the port's kernels on one CUDA card, by torch.profiler.

    python3 scripts/torch_kernel_probe.py [--tree DIR] [h4] [h2] [h3] [driver]
                                          [slam]

With no mode, h4, h2 and h3:
  h4  the unfused sweep (H4) at chip_smoke.py's Venice shape (shuffled
      cameras, after initialise + 20 sweeps) beside the fused one (H1) on
      the same state, in turns (H4, H1, H1, H4), each by the profiler's
      device time per launch and by CUDA events, beside its bound; the two
      sweeps' outputs must be bit-identical;
  h2  the table build (H2) at the Ladybug and Venice shapes: the cameras
      alone, the landmarks alone and both kinds, each by the profiler's
      device time per call (all its table_kernel launches) and per launch,
      and by CUDA events per call, beside its bound; a tree whose
      table_kernel has no ``build_tables`` (the two-launch build, one per
      kind) is timed through its ``build_table(bel, d)``;
  h3  the two passes of H3's permuted-segment sum, camera side, at both
      shapes: the chunk plan (chunks, runs), the device time of each pass
      (pass 1 ``reduce_chunks``, pass 2 ``reduce_combine``), the whole sum
      by CUDA events beside its bound and ``torch.index_add``;
  driver  the ``ba`` driver in process at chip_smoke.py's Ladybug shape
      written as a BAL file, as chip_smoke.py's uninterrupted run (defaults,
      ``--ltn 0.05``, 1,000 sweeps): its steady-state sweeps/s; then the same
      run with torch.profiler tracing the card only: its sweeps/s and the
      device's busy share between the first and the last sweep kernel (the
      union of kernel, copy and set intervals over that span), with the
      kernels that take the most device time there;
  slam  incremental SLAM at chip_smoke.py's TUM fr1desk shape with the
      slam driver's config, from the state after three segments and
      insertions: one segment of 700 sweeps with the accelerator on and
      off, each with and without per-sweep diagnostics (ms per segment and
      per sweep, host clock after a synchronise), one keyframe insertion;
      then one segment with and one without diagnostics traced by
      torch.profiler (the card only): the device's busy share between the
      first and the last sweep kernel and the kernels with the most device
      time.

The traces of ``driver`` and ``slam`` are read by
``gbp_poplar_tpu_torch.tools.profile_sweep.busy_share`` (of the tree
imported: with ``--tree``, a checkout that has that module).

``--tree DIR`` imports ``gbp_poplar_tpu_torch`` from another checkout
(a parent commit unpacked with ``git archive``), so that one call can run
parent and change in turns. Prints the card's name and power limit first;
needs a CUDA card.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import chip_smoke as cs  # noqa: E402


def _problem(shape, shuffle):
    from gbp_poplar_tpu_torch.config import InitConfig
    from gbp_poplar_tpu_torch.utils import balio, priors

    raw = balio.synthetic_problem_large(*shape)
    if shuffle:
        raw = cs.shuffle_cameras(raw)
    return priors.apply_init_noise(raw, InitConfig(lmk_noise=cs.LMK_NOISE,
                                                   seed=0))


def _graph(shape, shuffle, dev):
    from gbp_poplar_tpu_torch.config import GBPConfig
    from gbp_poplar_tpu_torch.core import build_graph

    return build_graph(_problem(shape, shuffle), GBPConfig(), dev)


def _warm_state(shape, shuffle, cfg, dev):
    """chip_smoke.py's state: initialise + 20 sweeps."""
    from gbp_poplar_tpu_torch.core import build_graph, gbp, init_state

    prob = _problem(shape, shuffle)
    g = build_graph(prob, cfg, dev)
    s = gbp.initialise(init_state(prob, cfg, dev), g, cfg)
    s, _ = gbp.run_gbp(s, g, cfg, 20, with_diagnostics=False)
    return g, s


def probe_h4(dev) -> None:
    import torch

    from gbp_poplar_tpu_torch.config import GBPConfig
    from gbp_poplar_tpu_torch.ops import reduce_kernel, sweep_kernel
    from gbp_poplar_tpu_torch.ops import table_kernel

    cfg = GBPConfig(fused=False)
    g, s = _warm_state(cs.VENICE_SHAPE, True, cfg, dev)
    bc = reduce_kernel.gather(s.cam_bel, g.cam_idx)
    bl = reduce_kernel.gather(s.lmk_bel, g.lmk_idx)
    ct, lt = table_kernel.build_tables(s.cam_bel, s.lmk_bel)
    sweeps = {
        "H4": (lambda st: sweep_kernel.sweep_planes(st, g, bc, bl, cfg),
               "sweep_planes_kernel", cs.sweep_bytes(g, True)),
        "H1": (lambda st: sweep_kernel.sweep(st, g, ct, lt, cfg),
               "sweep_kernel", cs.sweep_bytes(g, False)),
    }
    outs = []
    for run, _, _ in sweeps.values():
        st = s.clone()
        run(st)
        outs.append(st)
    same = all(torch.equal(getattr(outs[0], f), getattr(outs[1], f))
               for f in ("pk", "damping_count", "robust"))
    print(f"[h4] Venice, {g.n_edges} padded edges: H4 and H1 bit-identical "
          f"on one sweep: {same}")
    for label in ("H4", "H1", "H1", "H4"):
        run, kernel, n_bytes = sweeps[label]
        st = s.clone()
        dev_ms = cs.device_ms(lambda: run(st), cs.TIMED_SWEEPS, kernel)
        ev_ms = cs.cuda_ms(lambda: run(st), cs.TIMED_SWEEPS)
        bound, by = cs.least_ms(n_bytes, 0)
        print(f"[h4] {label}: device {dev_ms:.4f} ms per launch (profiler), "
              f"events {ev_ms:.4f} ms; bound {bound:.4f} ms by {by} "
              f"({bound / dev_ms:.0%} of it reached)")
        del st
    del g, s, bc, bl, ct, lt, outs
    torch.cuda.empty_cache()


def _table_calls(cam_bel, lmk_bel) -> dict:
    """The tree's table build per kind and for both: {label: (call,
    launches per call)}."""
    from gbp_poplar_tpu_torch.ops import table_kernel as tk

    if not hasattr(tk, "build_tables"):
        return {"cameras": (lambda: tk.build_table(cam_bel, 6), 1),
                "landmarks": (lambda: tk.build_table(lmk_bel, 3), 1),
                "both kinds": (lambda: (tk.build_table(cam_bel, 6),
                                        tk.build_table(lmk_bel, 3)), 2)}
    no_c, no_l = cam_bel[:, :0], lmk_bel[:, :0]
    return {"cameras": (lambda: tk.build_tables(cam_bel, no_l), 1),
            "landmarks": (lambda: tk.build_tables(no_c, lmk_bel), 1),
            "both kinds": (lambda: tk.build_tables(cam_bel, lmk_bel), 1)}


def probe_h2(dev) -> None:
    import torch

    from gbp_poplar_tpu_torch.config import GBPConfig

    cfg = GBPConfig(accel_every=0)
    for label, shape, shuffle in (("Ladybug", cs.LADYBUG_SHAPE, False),
                                  ("Venice", cs.VENICE_SHAPE, True)):
        g, s = _warm_state(shape, shuffle, cfg, dev)
        n_c, n_l = s.cam_bel.shape[1], s.lmk_bel.shape[1]
        for name, (fn, n) in _table_calls(s.cam_bel, s.lmk_bel).items():
            n_bytes = (4 * 63 * n_c * (name != "landmarks")
                       + 4 * 25 * n_l * (name != "cameras"))
            launch_ms = cs.device_ms(fn, cs.TIMED_SWEEPS, "table_kernel")
            call_ms = n * launch_ms
            ev = cs.cuda_ms(fn, cs.TIMED_SWEEPS)
            b, _ = cs.least_ms(n_bytes, 0)
            print(f"[h2] {label} ({n_c} cameras, {n_l} landmarks), {name}: "
                  f"device {call_ms:.4f} ms per call ({n} launch(es), "
                  f"{launch_ms:.4f} ms each), events {ev:.4f} ms per call; "
                  f"bound {b:.4f} ms by bytes ({b / call_ms:.0%} of it "
                  f"reached)")
        del g, s
        torch.cuda.empty_cache()


def probe_h3(dev) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gbp_poplar_tpu_torch.ops import reduce_kernel

    for label, shape, shuffle in (("Ladybug", cs.LADYBUG_SHAPE, False),
                                  ("Venice", cs.VENICE_SHAPE, True)):
        g = _graph(shape, shuffle, dev)
        seg, plan = g.cam_seg, g.cam_seg.plan
        n_real = seg.var.shape[0]
        gen = torch.Generator(device=dev).manual_seed(0)
        rows = torch.randn((36, g.n_edges), device=dev, generator=gen)[:27]
        prior = torch.randn((27, seg.n_var), device=dev, generator=gen)
        for _ in range(3):
            reduce_kernel.segment_sum(rows, seg, prior)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                reduce_kernel.segment_sum(rows, seg, prior)
            torch.cuda.synchronize()
        passes = {ev.key.split("(")[0]: ev.device_time_total / ev.count / 1e3
                  for ev in prof.key_averages() if ev.device_time_total > 0}
        ms = cs.cuda_ms(lambda: reduce_kernel.segment_sum(rows, seg, prior),
                        cs.TIMED_SWEEPS)
        lib = cs.cuda_ms(lambda: torch.index_add(
            prior, 1, g.cam_idx[:n_real], rows[:, :n_real]), cs.TIMED_SWEEPS)
        b, _ = cs.least_ms(*cs.reduce_work(seg, 27))
        print(f"[h3] {label} cameras: {plan.n_chunks} chunks of "
              f"{plan.chunk} edges, {plan.n_runs} runs "
              f"({plan.n_runs / plan.n_chunks:.1f} per chunk); "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in passes.items())
              + f"; whole {ms:.4f} ms ({b / ms:.0%} of the {b:.4f} ms "
              f"bound), index_add {lib:.4f} ms")
        del g, rows, prior
        torch.cuda.empty_cache()


def probe_driver(dev) -> None:
    import contextlib
    import io
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from gbp_poplar_tpu_torch.drivers import ba
    from gbp_poplar_tpu_torch.tools.profile_sweep import busy_share
    from gbp_poplar_tpu_torch.utils import balio

    n_iters = cs.DRIVER_SWEEPS[1]
    with tempfile.TemporaryDirectory() as tmp:
        bal = os.path.join(tmp, "ladybug.txt")
        balio.save_bal(bal, balio.synthetic_problem_large(*cs.LADYBUG_SHAPE))
        argv = ["--bal_file", bal, "--ltn", str(cs.LMK_NOISE), "--n_iters",
                str(n_iters)]

        def drive():
            out, err = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                cs.check(ba.main(argv) == 0, "ba driver failed")
            return err.getvalue().split("steady-state")[1].split()[0]

        rate = drive()
        trace = os.path.join(tmp, "trace.json")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            rate_prof = drive()
        prof.export_chrome_trace(trace)
        span, share, top = busy_share(trace, "sweep_kernel")
    print(f"[driver] Ladybug shape, {n_iters} sweeps, defaults: steady state "
          f"{rate} sweeps/s; traced run {rate_prof} sweeps/s, device busy "
          f"{share:.1%} of the {span:.1f} ms from the first to the last "
          f"sweep kernel; most device time: "
          + "; ".join(f"{k} {ms:.1f} ms ({n})" for k, ms, n in top))


def probe_slam(dev) -> None:
    import dataclasses
    import tempfile
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from gbp_poplar_tpu_torch.core import build_graph, gbp, init_state, slam
    from gbp_poplar_tpu_torch.drivers import slam as slam_driver
    from gbp_poplar_tpu_torch.tools.profile_sweep import busy_share
    from gbp_poplar_tpu_torch.utils import flags

    cfg, _ = slam_driver.config_from_args(
        slam_driver.build_parser().parse_args(["--bal_file", "-"]))
    ibk = cs.SLAM_IBK
    prob = _problem(cs.SLAM_SHAPE, False)
    graph = build_graph(prob, cfg, dev)
    state = gbp.initialise(init_state(
        prob, cfg, dev, flags=flags.create_flags(prob, cfg.steps)),
        graph, cfg)
    for k in range(1, 4):
        state, _ = gbp.run_gbp(state, graph, cfg, ibk,
                               with_diagnostics=False)
        state = slam.insert_keyframe(state, graph, cfg, k + 1)

    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    off = dataclasses.replace(cfg, accel_every=0)
    for label, c in (("on", cfg), ("off", off)):
        for diags in (True, False):
            st = state.clone()
            ms = wall_ms(lambda: gbp.run_gbp(st, graph, c, ibk,
                                             with_diagnostics=diags))
            print(f"[slam] one segment of {ibk} sweeps (keyframes 0-4), "
                  f"accelerator {label}, {'with' if diags else 'without'} "
                  f"diagnostics: {ms:.1f} ms, {ms / ibk:.4f} ms/sweep")
    st = state.clone()
    print(f"[slam] one keyframe insertion: "
          f"{wall_ms(lambda: slam.insert_keyframe(st, graph, cfg, 5)):.2f} "
          "ms")
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace.json")
        for diags in (True, False):
            st = state.clone()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                gbp.run_gbp(st, graph, cfg, ibk, with_diagnostics=diags)
                torch.cuda.synchronize()
            prof.export_chrome_trace(trace)
            span, share, top = busy_share(trace, "sweep_kernel")
            print(f"[slam] traced segment {'with' if diags else 'without'} "
                  f"diagnostics: device busy {share:.1%} of the {span:.1f} ms "
                  "from the first to the last sweep kernel; most device "
                  "time: " + "; ".join(f"{k} {ms:.1f} ms ({n})"
                                       for k, ms, n in top))


PROBES = {"h4": probe_h4, "h2": probe_h2, "h3": probe_h3,
          "driver": probe_driver, "slam": probe_slam}


def main(argv) -> int:
    import torch

    tree = None
    if argv[:1] == ["--tree"] and len(argv) > 1:
        tree, argv = os.path.abspath(argv[1]), argv[2:]
    if not torch.cuda.is_available() or any(a not in PROBES for a in argv):
        print(__doc__, file=sys.stderr)
        return 1
    if tree:
        sys.path.insert(0, tree)
    import gbp_poplar_tpu_torch  # noqa: F401  (sets TF32 off)

    where = os.path.dirname(os.path.dirname(gbp_poplar_tpu_torch.__file__))
    print(f"[probe] {cs.smi_line()}; gbp_poplar_tpu_torch from {where}")
    dev = torch.device("cuda", 0)
    for name in argv or ["h4", "h2", "h3"]:
        PROBES[name](dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
