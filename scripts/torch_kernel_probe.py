#!/usr/bin/env python3
"""Profile the two passes of H3's permuted-segment sum on one CUDA card.

    python3 scripts/torch_kernel_probe.py

For the camera side at chip_smoke.py's Ladybug and Venice shapes (Venice
with shuffled camera ids): the chunk plan (chunks, runs), the device time
of each pass (pass 1 ``reduce_chunks``, pass 2 ``reduce_combine``) by
torch.profiler, the whole sum by CUDA events beside its bound and
``torch.index_add``.

Prints the card's name and power limit first; needs a CUDA card.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import chip_smoke as cs  # noqa: E402


def _graph(shape, shuffle, dev):
    from gbp_poplar_tpu_torch.config import GBPConfig, InitConfig
    from gbp_poplar_tpu_torch.core import build_graph
    from gbp_poplar_tpu_torch.utils import balio, priors

    raw = balio.synthetic_problem_large(*shape)
    if shuffle:
        raw = cs.shuffle_cameras(raw)
    prob = priors.apply_init_noise(raw, InitConfig(lmk_noise=cs.LMK_NOISE,
                                                   seed=0))
    return build_graph(prob, GBPConfig(), dev)


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


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available() or argv:
        print(__doc__, file=sys.stderr)
        return 1
    import gbp_poplar_tpu_torch  # noqa: F401  (sets TF32 off)

    print(f"[probe] {cs.smi_line()}")
    dev = torch.device("cuda", 0)
    probe_h3(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
