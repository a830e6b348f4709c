"""Each hand-written CUDA kernel of the port against its plain PyTorch
version, on a CUDA card.

The kernels have no CPU mode: without a card these tests skip with a
reason. On the card: ``python -m pytest -m cuda tests/test_torch_cuda.py``.
This file imports no JAX, so it runs where only the port is installed.
"""

import numpy as np
import pytest
import torch

from gbp_poplar_tpu_torch import solve_ba
from gbp_poplar_tpu_torch.config import GBPConfig
from gbp_poplar_tpu_torch.core import factor_graph as fg
from gbp_poplar_tpu_torch.core import gbp
from gbp_poplar_tpu_torch.ops import reduce_kernel, sweep_kernel, table_kernel
from gbp_poplar_tpu_torch.utils import balio


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pinhole", "snavely"])
def test_kernels_match_plain_on_card(cuda_device, name):
    prob = (balio.synthetic_problem(n_keyframes=6, n_points=60, seed=0,
                                    pixel_noise=0.5) if name == "pinhole"
            else balio.synthetic_problem_snavely(pixel_noise=0.5))
    cfg = GBPConfig(accel_every=0)
    g = fg.build_graph(prob, cfg, cuda_device)
    s = gbp.initialise(fg.init_state(prob, cfg, cuda_device), g, cfg)
    s, _ = gbp.run_gbp(s, g, cfg, 20, with_diagnostics=False)
    for d, bel in ((6, s.cam_bel), (3, s.lmk_bel)):
        k = table_kernel.build_table(bel, d)
        r = table_kernel.build_table(bel, d, reference=True)
        torch.testing.assert_close(k, r, rtol=1e-5, atol=0)
    sk, sr = s.clone(), s.clone()
    ct = table_kernel.build_table(s.cam_bel, 6, reference=True)
    lt = table_kernel.build_table(s.lmk_bel, 3, reference=True)
    sweep_kernel.sweep(sk, g, ct, lt, cfg)
    sweep_kernel.sweep(sr, g, ct, lt, cfg, reference=True)
    assert torch.equal(sk.damping_count, sr.damping_count)
    assert torch.equal(sk.robust, sr.robust)
    torch.testing.assert_close(sk.pk, sr.pk, rtol=1e-4, atol=1e-4)
    for rows, seg, prior in ((sk.pk[54:81], g.cam_seg, sk.cam_prior),
                             (sk.pk[81:90], g.lmk_seg, sk.lmk_prior)):
        k = reduce_kernel.segment_sum(rows, seg, prior)
        r = reduce_kernel.segment_sum(rows, seg, prior, reference=True)
        # the plain version adds with atomics in a run-dependent order:
        # bound the difference by 1e-5 of the sum of |terms|
        scale = reduce_kernel.segment_sum(rows.abs(), seg, prior.abs(),
                                          reference=True)
        assert bool(((k - r).abs() <= 1e-5 * scale).all())
        assert torch.equal(k, reduce_kernel.segment_sum(rows, seg, prior))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pinhole", "snavely"])
def test_unfused_kernels_match_plain_on_card(cuda_device, name):
    """H5 (gather) bit-identical to index_select, on shuffled camera ids
    too; H4 (unfused sweep) against its plain version, and against H1 on
    the same state: no difference."""
    prob = (balio.synthetic_problem(n_keyframes=6, n_points=60, seed=0,
                                    pixel_noise=0.5) if name == "pinhole"
            else balio.synthetic_problem_snavely(pixel_noise=0.5))
    cfg = GBPConfig(accel_every=0, fused=False)
    g = fg.build_graph(prob, cfg, cuda_device)
    s = gbp.initialise(fg.init_state(prob, cfg, cuda_device), g, cfg)
    s, _ = gbp.run_gbp(s, g, cfg, 17, with_diagnostics=False)
    perm = torch.randperm(prob.n_keyframes, device=cuda_device).to(
        torch.int32)
    for src, idx in ((s.cam_bel, g.cam_idx), (s.lmk_bel, g.lmk_idx),
                     (s.cam_bel, perm[g.cam_idx.long()].contiguous())):
        assert torch.equal(reduce_kernel.gather(src, idx),
                           reduce_kernel.gather(src, idx, reference=True))
    bc = reduce_kernel.gather(s.cam_bel, g.cam_idx)
    bl = reduce_kernel.gather(s.lmk_bel, g.lmk_idx)
    sk, sr, s1 = s.clone(), s.clone(), s.clone()
    sweep_kernel.sweep_planes(sk, g, bc, bl, cfg)
    sweep_kernel.sweep_planes(sr, g, bc, bl, cfg, reference=True)
    assert torch.equal(sk.damping_count, sr.damping_count)
    assert torch.equal(sk.robust, sr.robust)
    torch.testing.assert_close(sk.pk, sr.pk, rtol=1e-4, atol=1e-4)
    ct = table_kernel.build_table(s.cam_bel, 6)
    lt = table_kernel.build_table(s.lmk_bel, 3)
    sweep_kernel.sweep(s1, g, ct, lt, cfg)
    for f in ("pk", "damping_count", "robust"):
        assert torch.equal(getattr(sk, f), getattr(s1, f)), f


@pytest.mark.cuda
def test_accelerated_solve_same_on_both_pipelines_on_card(cuda_device):
    """run_gbp with the accelerator, fused and unfused pipelines: the
    same trajectory to the bit (H4's per-edge means are H2's)."""
    prob = balio.synthetic_problem_large(n_keyframes=20, n_points=600,
                                         obs_per_lmk=5, seed=0)
    out = []
    for fused in (True, False):
        cfg = GBPConfig(accel_every=8, accel_start=10, fused=fused)
        g = fg.build_graph(prob, cfg, cuda_device)
        s = gbp.initialise(fg.init_state(prob, cfg, cuda_device), g, cfg)
        out.append(gbp.run_gbp(s, g, cfg, 40))
    (sa, da), (sb, db) = out
    assert torch.equal(da.reproj_err, db.reproj_err)
    assert torch.equal(sa.pk, sb.pk) and torch.equal(sa.lmk_bel, sb.lmk_bel)


@pytest.mark.cuda
def test_solve_ba_default_config_on_card(cuda_device):
    """``solve_ba`` with the default GBPConfig() on the card lands where
    the CPU run (plain versions) does."""
    prob = balio.synthetic_problem(n_keyframes=6, n_points=60, seed=0,
                                   pixel_noise=0.5)
    _, _, e_gpu = solve_ba(prob, n_iters=200, device=cuda_device)
    _, _, e_cpu = solve_ba(prob, n_iters=200, device="cpu")
    assert np.isfinite(e_gpu).all() and e_gpu[-1] < e_gpu[0]
    np.testing.assert_allclose(e_gpu[-1], e_cpu[-1], rtol=0.01, atol=0.01)
