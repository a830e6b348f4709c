"""Each hand-written CUDA kernel of the port against its plain PyTorch
version, on a CUDA card.

The kernels have no CPU mode: without a card these tests skip with a
reason. On the card: ``python -m pytest -m cuda tests/test_torch_cuda.py``.
This file imports no JAX, so it runs where only the port is installed.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gbp_poplar_tpu_torch import solve_ba
from gbp_poplar_tpu_torch.config import GBPConfig
from gbp_poplar_tpu_torch.core import factor_graph as fg
from gbp_poplar_tpu_torch.core import coarse, gbp
from gbp_poplar_tpu_torch.core.intrinsics import refit_intrinsics
from gbp_poplar_tpu_torch.ops import (coarse_kernel, cost_kernel, diag_kernel,
                                      reduce_kernel, sweep_kernel,
                                      table_kernel)
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
    for k, r in zip(table_kernel.build_tables(s.cam_bel, s.lmk_bel),
                    table_kernel.build_tables(s.cam_bel, s.lmk_bel,
                                              reference=True)):
        torch.testing.assert_close(k, r, rtol=1e-5, atol=0)
    sk, sr = s.clone(), s.clone()
    ct, lt = table_kernel.build_tables(s.cam_bel, s.lmk_bel, reference=True)
    sweep_kernel.sweep(sk, g, ct, lt, cfg)
    sweep_kernel.sweep(sr, g, ct, lt, cfg, reference=True)
    assert torch.equal(sk.damping_count, sr.damping_count)
    assert torch.equal(sk.robust, sr.robust)
    torch.testing.assert_close(sk.pk, sr.pk, rtol=1e-4, atol=1e-4)
    for rows, seg, prior in ((sk.pk[54:81], g.cam_seg, sk.cam_prior),
                             (sk.pk[81:90], g.lmk_seg, sk.lmk_prior)):
        k = reduce_kernel.segment_sum(rows, seg, prior)
        r = reduce_kernel.segment_sum(rows, seg, prior, reference=True)
        # the plain version adds in another (sorted, fixed) order: bound
        # the difference by 1e-5 of the sum of |terms|
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
    ct, lt = table_kernel.build_tables(s.cam_bel, s.lmk_bel)
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


@pytest.mark.cuda
def test_sweep_odd_edge_count_on_card(cuda_device):
    """H1 and H4 with ``edge_pad_multiple=1`` and an odd edge count (rows
    not 16-byte aligned, so each lane copies its own column into the
    stage; the last tile partial): each bit-identical to its plain
    version, and to each other on the same state."""
    prob = balio.synthetic_problem_large(n_keyframes=20, n_points=601,
                                         obs_per_lmk=5, seed=0)
    cfg = GBPConfig(accel_every=0, edge_pad_multiple=1)
    g = fg.build_graph(prob, cfg, cuda_device)
    assert g.n_edges % 2 == 1 and g.n_edges % 32 != 0
    s = gbp.initialise(fg.init_state(prob, cfg, cuda_device), g, cfg)
    s, _ = gbp.run_gbp(s, g, cfg, 17, with_diagnostics=False)
    ct, lt = table_kernel.build_tables(s.cam_bel, s.lmk_bel)
    bc = reduce_kernel.gather(s.cam_bel, g.cam_idx)
    bl = reduce_kernel.gather(s.lmk_bel, g.lmk_idx)
    sk, sr, s4, s4r = s.clone(), s.clone(), s.clone(), s.clone()
    sweep_kernel.sweep(sk, g, ct, lt, cfg)
    sweep_kernel.sweep(sr, g, ct, lt, cfg, reference=True)
    sweep_kernel.sweep_planes(s4, g, bc, bl, cfg)
    sweep_kernel.sweep_planes(s4r, g, bc, bl, cfg, reference=True)
    for a_state, b_state in ((sk, sr), (sk, s4), (s4, s4r)):
        for f in ("pk", "damping_count", "robust"):
            a, b = getattr(a_state, f), getattr(b_state, f)
            assert bool(((a == b) | (a != a) & (b != b)).all()), f


@pytest.mark.cuda
def test_build_tables_match_plain_on_card(cuda_device):
    """H2's one launch for both kinds, at the Ladybug shape's variable
    counts (1,723 cameras, 156,000 landmarks) on random beliefs with a
    singular and a NaN column: the belief, flag and pad columns equal to
    the plain version's, the means within 1e-5 of 1 + |mean|; and equal to
    the same kernel's launch for one kind, the other given no variables."""
    rng = np.random.default_rng(0)
    bels = []
    for d, n in ((6, 1723), (3, 156000)):
        a = rng.normal(0, 1, (n, d, d))
        lam = a @ a.transpose(0, 2, 1) + 0.5 * np.eye(d)
        packed = np.stack([lam[:, i, j] for i in range(d)
                           for j in range(i + 1)])
        bel = np.concatenate([rng.normal(0, 1, (d, n)), packed]).astype(
            np.float32)
        bel[d:, 7] = 0.0
        bel[0, 11] = np.nan
        bels.append(torch.tensor(bel, device=cuda_device))
    table_kernel.build_tables.launches = 0
    tables = table_kernel.build_tables(*bels)
    assert table_kernel.build_tables.launches == 1
    plain = table_kernel.build_tables(*bels, reference=True)
    alone = (table_kernel.build_tables(bels[0], bels[1][:, :0])[0],
             table_kernel.build_tables(bels[0][:, :0], bels[1])[1])
    for (bel, d), k, r, a in zip(((bels[0], 6), (bels[1], 3)), tables, plain,
                                 alone):
        comp = bel.shape[0]
        same = (k == r) | (k.isnan() & r.isnan())
        assert bool(same[:, :comp].all()) and bool(same[:, comp + d:].all())
        rel = (k[:, comp:comp + d] - r[:, comp:comp + d]).abs() / (
            1 + r[:, comp:comp + d].abs())
        assert rel.max().item() <= 1e-5
        assert torch.equal(k.nan_to_num(), a.nan_to_num())


@pytest.mark.cuda
def test_chunked_reduce_on_shuffled_cameras_on_card(cuda_device):
    """H3's two-pass sum over the chunk plan of camera-shuffled segments
    (several chunks, a ragged last one) and of the coarse group segments:
    within 1e-5 of the sum of |terms| of the plain version, and
    bit-identical on rerun."""
    from gbp_poplar_tpu_torch.core import coarse

    prob = balio.synthetic_problem_large(n_keyframes=300, n_points=20001,
                                         obs_per_lmk=5, seed=1)
    perm = np.random.default_rng(1).permutation(prob.n_keyframes)
    prob.cam_idx = perm[prob.cam_idx].astype(prob.cam_idx.dtype)
    g = fg.build_graph(prob, GBPConfig(), cuda_device)
    assert g.cam_seg.plan is not None and g.cam_seg.plan.n_chunks > 1
    rng = np.random.default_rng(2)
    rows = torch.tensor(rng.normal(0, 1, (27, g.n_edges)).astype(np.float32),
                        device=cuda_device)
    groups = coarse.group_segments(g, 16)
    for seg in (g.cam_seg, groups.edge_cam, groups.edge_pair, groups.lmk):
        assert seg.plan is not None
        n = seg.var.shape[0]
        planes = rows[:, :n]
        prior = torch.tensor(rng.normal(0, 1, (27, seg.n_var))
                             .astype(np.float32), device=cuda_device)
        k = reduce_kernel.segment_sum(planes, seg, prior)
        r = reduce_kernel.segment_sum(planes, seg, prior, reference=True)
        scale = reduce_kernel.segment_sum(planes.abs(), seg, prior.abs(),
                                          reference=True)
        assert bool(((k - r).abs() <= 1e-5 * scale).all())
        assert torch.equal(k, reduce_kernel.segment_sum(planes, seg, prior))


@pytest.mark.cuda
def test_sweeps_under_slam_config_on_card(cuda_device):
    """H1 and H4 under the SLAM driver's schedule flags (relinearise every
    sweep, the one-sided depth guard, the rescue after 300 sweeps), right
    after a keyframe insertion, with some landmarks behind the cameras and
    the damping counters spread across the rescue threshold: each
    bit-identical to its plain version and to each other; then a whole
    SLAM solve lands where the CPU run does."""
    from gbp_poplar_tpu_torch import solve_slam
    from gbp_poplar_tpu_torch.core import slam
    from gbp_poplar_tpu_torch.utils import flags

    prob = balio.synthetic_problem(n_keyframes=6, n_points=60, seed=2,
                                   pixel_noise=0.5)
    cfg = GBPConfig(relin_every_iter=True, eta_damping=0.7,
                    iters_before_damping=0, relin_behind_camera=False,
                    behind_camera_rescue_iters=300)
    g = fg.build_graph(prob, cfg, cuda_device)
    s = gbp.initialise(fg.init_state(
        prob, cfg, cuda_device, flags=flags.create_flags(prob, cfg.steps)),
        g, cfg)
    s, _ = gbp.run_gbp(s, g, cfg, 30, with_diagnostics=False)
    s = slam.insert_keyframe(s, g, cfg, 2, 6.0)
    lmk = g.lmk_idx[s.active > 0].unique()
    s.lmk_bel[:3, lmk[:16:2]] *= -1.0
    s.damping_count.copy_(torch.randint(
        -2, 700, (g.n_edges,), device=cuda_device,
        generator=torch.Generator(device=cuda_device).manual_seed(1)).to(
            torch.int32))
    ct, lt = table_kernel.build_tables(s.cam_bel, s.lmk_bel)
    bc = reduce_kernel.gather(s.cam_bel, g.cam_idx)
    bl = reduce_kernel.gather(s.lmk_bel, g.lmk_idx)
    sk, sr, s4, s4r = s.clone(), s.clone(), s.clone(), s.clone()
    sweep_kernel.sweep(sk, g, ct, lt, cfg)
    sweep_kernel.sweep(sr, g, ct, lt, cfg, reference=True)
    sweep_kernel.sweep_planes(s4, g, bc, bl, cfg)
    sweep_kernel.sweep_planes(s4r, g, bc, bl, cfg, reference=True)
    for a_state, b_state in ((sk, sr), (sk, s4), (s4, s4r)):
        for f in ("pk", "damping_count", "robust"):
            a, b = getattr(a_state, f), getattr(b_state, f)
            assert bool(((a == b) | (a != a) & (b != b)).all()), f
    _, _, e_gpu = solve_slam(prob, cfg, 60, 6.0, device=cuda_device)
    _, _, e_cpu = solve_slam(prob, cfg, 60, 6.0, device="cpu")
    assert np.isfinite(e_gpu).all()
    np.testing.assert_allclose(e_gpu[:, -1], e_cpu[:, -1], rtol=0.01,
                               atol=0.01)


@pytest.mark.cuda
def test_weaken_priors_and_bad_mask_on_card(cuda_device):
    """weaken_priors through H3 (cameras shuffled: the two-pass sum)
    against kernels="reference": priors and flags equal, beliefs within
    1e-5 of the sum of |terms|; then reprojection_error and map_cost with
    a bad-association mask against the same calls on a CPU copy of the
    state, and the error against the host oracle."""
    from gbp_poplar_tpu_torch.utils import analysis, evaluation

    prob = balio.synthetic_problem_large(n_keyframes=300, n_points=20001,
                                         obs_per_lmk=5, seed=1)
    perm = np.random.default_rng(1).permutation(prob.n_keyframes)
    prob.cam_idx = perm[prob.cam_idx].astype(prob.cam_idx.dtype)
    cfg = GBPConfig()
    g = fg.build_graph(prob, cfg, cuda_device)
    assert g.cam_seg.plan is not None
    s = gbp.initialise(fg.init_state(prob, cfg, cuda_device), g, cfg)
    reduce_kernel.segment_sum.launches = 0
    sk = gbp.weaken_priors(s.clone(), g, cfg)
    assert reduce_kernel.segment_sum.launches == 2
    sr = gbp.weaken_priors(s.clone(), g, GBPConfig(kernels="reference"))
    for f in ("cam_prior", "lmk_prior", "cam_weaken", "lmk_weaken"):
        assert torch.equal(getattr(sk, f), getattr(sr, f)), f
    assert not torch.equal(sk.cam_prior, s.cam_prior)
    for bel, rows, seg, prior in ((sk.cam_bel, sk.pk[54:81], g.cam_seg,
                                   sk.cam_prior),
                                  (sk.lmk_bel, sk.pk[81:90], g.lmk_seg,
                                   sk.lmk_prior)):
        ref = reduce_kernel.segment_sum(rows, seg, prior, reference=True)
        scale = reduce_kernel.segment_sum(rows.abs(), seg, prior.abs(),
                                          reference=True)
        assert bool(((bel - ref).abs() <= 1e-5 * scale).all())

    ids = np.random.default_rng(2).choice(prob.n_edges, 500, replace=False)
    bad_np = fg.bad_edge_mask(prob, ids, cfg)
    bad = torch.as_tensor(bad_np, device=cuda_device)
    cpu = fg.state_from_numpy(fg.state_to_numpy(sk), "cpu")
    g_cpu = fg.build_graph(prob, cfg, "cpu")
    for fn in (lambda st, gr, b: gbp.reprojection_error(st, gr, b),
               lambda st, gr, b: (gbp.map_cost(st, gr, cfg, b),)):
        on_card = [x.item() for x in fn(sk, g, bad)]
        on_cpu = [x.item() for x in fn(cpu, g_cpu, torch.as_tensor(bad_np))]
        np.testing.assert_allclose(on_card, on_cpu, rtol=1e-5)
    err, _ = gbp.reprojection_error(sk, g, bad)
    err_all, _ = gbp.reprojection_error(sk, g)
    cam_mu, lmk_mu = analysis.belief_means(sk)
    o_err, _ = evaluation.numpy_reprojection_error(cam_mu, lmk_mu, prob,
                                                   bad_associations=ids)
    assert err.item() != err_all.item() and abs(o_err - err.item()) < 1e-3


@pytest.mark.cuda
def test_plain_segment_sum_repeats_on_card(cuda_device):
    """The plain segmented sum on the card (``index_add_`` under PyTorch's
    deterministic algorithms) gives the same bits run after run, on
    camera-shuffled segments of thousands of edges per camera, within
    1e-5 of the sum of |terms| of the CPU's sequential sum; the
    deterministic mode is off again after each call."""
    prob = balio.synthetic_problem_large(n_keyframes=30, n_points=20001,
                                         obs_per_lmk=5, seed=1)
    perm = np.random.default_rng(1).permutation(prob.n_keyframes)
    prob.cam_idx = perm[prob.cam_idx].astype(prob.cam_idx.dtype)
    g = fg.build_graph(prob, GBPConfig(), cuda_device)
    g_cpu = fg.build_graph(prob, GBPConfig(), "cpu")
    rng = np.random.default_rng(3)
    rows = rng.normal(0, 1, (27, g.n_edges)).astype(np.float32)
    prior = rng.normal(0, 1, (27, g.n_keyframes)).astype(np.float32)
    on_card = [reduce_kernel.segment_sum(
        torch.tensor(rows, device=cuda_device), g.cam_seg,
        torch.tensor(prior, device=cuda_device), reference=True)
        for _ in range(3)]
    assert not torch.are_deterministic_algorithms_enabled()
    for again in on_card[1:]:
        assert torch.equal(again, on_card[0])
    cpu = reduce_kernel.segment_sum(torch.tensor(rows), g_cpu.cam_seg,
                                    torch.tensor(prior))
    scale = reduce_kernel.segment_sum(torch.tensor(np.abs(rows)),
                                      g_cpu.cam_seg, torch.tensor(
                                          np.abs(prior)))
    assert bool(((on_card[0].cpu() - cpu).abs() <= 1e-5 * scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pinhole", "snavely"])
def test_diag_kernel_matches_plain_on_card(cuda_device, name):
    """H6 against its plain version on the card, on a state with singular
    beliefs (two landmarks' Lambda zeroed, a camera's eta NaN), with and
    without a bad mask: counts equal, float sums within 1e-5 of the sum of
    |terms| (the value: the terms are >= 0), the same bits on a rerun;
    then run_gbp's per-sweep diagnostics through H6 (one launch a sweep;
    one table build a sweep, after it, which the next sweep reads, and one
    before the first) against kernels="reference"."""
    prob = (balio.synthetic_problem(n_keyframes=6, n_points=60, seed=0,
                                    pixel_noise=0.5) if name == "pinhole"
            else balio.synthetic_problem_snavely(pixel_noise=0.5))
    cfg = GBPConfig(accel_every=0)
    g = fg.build_graph(prob, cfg, cuda_device)
    s = gbp.initialise(fg.init_state(prob, cfg, cuda_device), g, cfg)
    s, _ = gbp.run_gbp(s, g, cfg, 18, with_diagnostics=False)
    sing = s.clone()
    seen = g.lmk_idx[s.active > 0].unique()
    sing.lmk_bel[3:, seen[:2]] = 0.0
    sing.cam_bel[0, 1] = float("nan")
    bad = torch.rand(g.n_edges, device=cuda_device,
                     generator=torch.Generator(device=cuda_device)
                     .manual_seed(0)) < 0.1
    n = cfg.num_undamped_iters
    for st in (s, sing):
        for mask in (None, bad):
            k = diag_kernel.edge_sums(st, g, n, mask)
            r = diag_kernel.edge_sums(st, g, n, mask, reference=True)
            assert torch.equal(k[[0, 3, 4]], r[[0, 3, 4]])
            assert bool(((k[1:3] - r[1:3]).abs() <= 1e-5 * r[1:3]).all())
            assert torch.equal(k, diag_kernel.edge_sums(st, g, n, mask))
    assert (diag_kernel.edge_sums(sing, g, n)[0]
            < diag_kernel.edge_sums(s, g, n)[0])

    diag_kernel.edge_sums.launches = 0
    table_kernel.build_tables.launches = 0
    _, dk = gbp.run_gbp(s.clone(), g, cfg, 10)
    assert diag_kernel.edge_sums.launches == 10
    assert table_kernel.build_tables.launches == 11
    _, dr = gbp.run_gbp(s.clone(), g, GBPConfig(accel_every=0,
                                                kernels="reference"), 10)
    # the two runs' beliefs part by H3's other summation order
    np.testing.assert_allclose(dk.reproj_err.cpu(), dr.reproj_err.cpu(),
                               rtol=1e-3)
    assert dk.n_relins.dtype == torch.int64


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pinhole", "snavely"])
def test_chunk_kernels_match_plain_on_card(cuda_device, name):
    """H7 (the coarse step's per-edge blocks) per plane within 1e-3 of the
    plane's largest magnitude of its plain version, the same edges
    dropped; H8 (the cost's data term) at K = 1, 2, 3 sets, with and
    without a bad mask, within 1e-6 of the sum of |loss| of its plain
    version; both the same bits on a second call."""
    prob = (balio.synthetic_problem(n_keyframes=6, n_points=60, seed=0,
                                    pixel_noise=0.5) if name == "pinhole"
            else balio.synthetic_problem_snavely(pixel_noise=0.5))
    cfg = GBPConfig(accel_every=0, coarse_groups=3)
    g = fg.build_graph(prob, cfg, cuda_device)
    s = gbp.initialise(fg.init_state(prob, cfg, cuda_device), g, cfg)
    s, _ = gbp.run_gbp(s, g, cfg, 20, with_diagnostics=False)
    cam_mu, lmk_mu = gbp._variable_means(s)
    s_cam = coarse._fin(coarse._cam_rigid_basis(coarse._fin(cam_mu.T)))
    k = coarse_kernel.coarse_edge_blocks(cam_mu, lmk_mu, s_cam, s, g, cfg)
    r = coarse_kernel.coarse_edge_blocks(cam_mu, lmk_mu, s_cam, s, g, cfg,
                                         reference=True)
    assert torch.equal((k == 0).all(dim=0), (r == 0).all(dim=0))
    scale = r.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    assert bool(((k - r).abs() <= 1e-3 * scale).all())
    assert torch.equal(k, coarse_kernel.coarse_edge_blocks(
        cam_mu, lmk_mu, s_cam, s, g, cfg))
    rng = np.random.default_rng(0)
    sets = [(cam_mu, lmk_mu)] + [
        (cam_mu + torch.tensor(rng.normal(0, 1e-3, cam_mu.shape),
                               dtype=cam_mu.dtype, device=cuda_device),
         lmk_mu + torch.tensor(rng.normal(0, 1e-2, lmk_mu.shape),
                               dtype=lmk_mu.dtype, device=cuda_device))
        for _ in range(2)]
    bad = torch.zeros(g.n_edges, dtype=torch.bool, device=cuda_device)
    bad[::7] = True
    for n_sets in (1, 2, 3):
        for mask in (None, bad):
            got = cost_kernel.cost_sums(s, g, sets[:n_sets], cfg.huber_nstds,
                                        mask)
            want = cost_kernel.cost_sums(s, g, sets[:n_sets],
                                         cfg.huber_nstds, mask,
                                         reference=True)
            assert bool(((got - want).abs() <= 1e-6 * want.abs()).all())
            assert torch.equal(got, cost_kernel.cost_sums(
                s, g, sets[:n_sets], cfg.huber_nstds, mask))
    # strided operands (a transposed basis, a column slice of the means)
    # are the same tensors to the kernels
    s_cam_t = s_cam.transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(k, coarse_kernel.coarse_edge_blocks(
        cam_mu.T.contiguous().T, lmk_mu, s_cam_t, s, g, cfg))
    assert torch.equal(
        cost_kernel.cost_sums(s, g, sets[:2], cfg.huber_nstds),
        cost_kernel.cost_sums(s, g, [(cam_mu.T.contiguous().T, lmk_mu),
                                     sets[1]], cfg.huber_nstds))


@pytest.mark.cuda
def test_refit_intrinsics_through_h8_on_card(cuda_device):
    """One intrinsics refit on a Snavely problem with its focal lengths off
    by up to 7 % (the ba driver's --refine_intrinsics step), its three MAP
    costs priced by H8, against the same refit with kernels="reference":
    the same decision and the same new (f, k1, k2) within 1e-4; a graph
    whose intrinsics are a strided view prices to the same bits."""
    prob = balio.synthetic_problem_snavely(8, 80, pixel_noise=0.3, seed=3)
    rng = np.random.default_rng(1)
    prob.intrinsics[:, 0] *= rng.uniform(0.93, 1.07, prob.n_keyframes)
    prob.intrinsics[:, 1] += rng.normal(0, 0.05, prob.n_keyframes)
    cfg = GBPConfig(accel_every=0)
    ref = dataclasses.replace(cfg, kernels="reference")
    g = fg.build_graph(prob, cfg, cuda_device)
    s = gbp.initialise(fg.init_state(prob, cfg, cuda_device), g, cfg)
    s, _ = gbp.run_gbp(s, g, cfg, 40, with_diagnostics=False)
    before = cost_kernel.cost_sums.launches
    new_intr, acc = refit_intrinsics(s, g, cfg)
    assert cost_kernel.cost_sums.launches - before == 3
    want_intr, want_acc = refit_intrinsics(s, g, ref)
    assert bool(acc) and bool(want_acc)
    torch.testing.assert_close(new_intr, want_intr, rtol=1e-4, atol=1e-5)
    strided = dataclasses.replace(g, intr=new_intr.T.contiguous().T)
    assert not strided.intr.is_contiguous()
    assert torch.equal(
        gbp.map_cost(s, strided, cfg),
        gbp.map_cost(s, dataclasses.replace(g, intr=new_intr), cfg))


def hand_loop(state, graph, cfg, n):
    """``run_gbp(state, graph, cfg, n)``'s sweep sequence as a plain loop
    of ``iteration``/``gbp_sweep``, ``_diag_sums`` and ``_accel_step``,
    every sweep building its own tables and every post-sweep read building
    its own (``_diag_sums``, ``_sanitized_means``): the run without the
    table carry or the prepared H6 launch. The schedule is run_gbp's at
    iteration offset 0 (anneal, dead and live accelerator chunks,
    leftover), without the coarse step. Returns (state, Diagnostics)."""
    rows = []

    def sweep(s, i=None, sums=None):
        s = (gbp.gbp_sweep(s, graph, cfg) if i is None
             else gbp.iteration(s, graph, cfg, i))
        rows.append(gbp._diag_sums(s, graph, cfg))
        if sums is not None:
            mc, ml = gbp._sanitized_means(s, cfg)
            sums = (sums[0] + mc, sums[1] + ml)
        return s, sums

    def chunk(s):
        zeros = (torch.zeros_like(s.cam_bel[:6]),
                 torch.zeros_like(s.lmk_bel[:3]))
        for _ in range(ce):
            s, zeros = sweep(s, sums=zeros)
        return s, (zeros[0] / ce, zeros[1] / ce)

    warm = min(n, 2 * cfg.steps)
    for i in range(warm):
        state, _ = sweep(state, i)
    left, ce = n - warm, cfg.accel_every
    if ce > 0 and left >= 2 * ce:
        n_chunks = left // ce
        degs = gbp._active_degrees(state, graph, cfg)
        n_dead = min(n_chunks,
                     max(0, -(-(cfg.accel_start - ce - warm) // ce)))
        if n_dead:
            for _ in range((n_dead - 1) * ce):
                state, _ = sweep(state)
            state, avg = chunk(state)
            snap = (*avg, torch.zeros_like(avg[0]))
        else:
            cam_mu, lmk_mu = gbp._variable_means(state)
            snap = (cam_mu, lmk_mu, torch.zeros_like(cam_mu))
        for _ in range(n_dead, n_chunks):
            state, avg = chunk(state)
            state, snap, _ = gbp._accel_step(state, snap, avg, graph, cfg,
                                             degs)
        left -= n_chunks * ce
    for _ in range(left):
        state, _ = sweep(state)
    return state, gbp._diagnostics_from_sums(torch.stack(rows),
                                             state.cam_bel.dtype)


def assert_same_run(a, b):
    """Two runs' (state, Diagnostics) equal to the bit, NaN matching."""
    for (k, x), y in zip(fg.state_to_numpy(a[0]).items(),
                         fg.state_to_numpy(b[0]).values()):
        assert np.array_equal(x, y, equal_nan=True), k
    for x, y in zip(a[1][:4], b[1][:4]):
        assert np.array_equal(x.cpu().numpy(), y.cpu().numpy(),
                              equal_nan=True)


# run_gbp's schedules for the hand loop: the Ladybug main path's (no
# accelerator) and one with annealing, a dead chunk, live chunks and
# leftover sweeps (22 sweeps: 4 annealed, chunks of 4 ending at 8 (dead,
# averaging), 12, 16, 20, then 2)
CHUNKED = dict(steps=2, accel_every=4, accel_start=12)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ladybug", "chunks"])
def test_run_gbp_equals_hand_loop_on_card(cuda_device, case):
    """run_gbp with diagnostics (the post-sweep tables carried into the
    next fused sweep, H6 set up once) against the hand loop (every sweep
    and every read building its own tables, H6 set up per call), to the
    bit in state and diagnostics: at the Ladybug shape on its main path's
    config (12 sweeps), and with annealing and accelerator chunks on a
    7,000-edge problem."""
    if case == "ladybug":
        prob = balio.synthetic_problem_large(1723, 156000, 7)
        cfg, n = GBPConfig(accel_every=0), 12
    else:
        prob = balio.synthetic_problem_large(n_keyframes=20, n_points=1000,
                                             obs_per_lmk=7, seed=2)
        cfg, n = GBPConfig(**CHUNKED), 22
    g = fg.build_graph(prob, cfg, cuda_device)
    s = gbp.initialise(fg.init_state(prob, cfg, cuda_device), g, cfg)
    table_kernel.build_tables.launches = 0
    diag_kernel.edge_sums.launches = 0
    run = gbp.run_gbp(s.clone(), g, cfg, n)
    # one build a sweep (its tables serve the next sweep of its run), and
    # one for the first sweep of each run of sweeps: the annealed 10 and
    # the 2 after them at the Ladybug config; the annealed 4, the dead
    # chunk, 3 live chunks and the 2 leftover sweeps in the chunked one
    runs = 2 if case == "ladybug" else 6
    assert table_kernel.build_tables.launches == n + runs
    assert diag_kernel.edge_sums.launches == n
    assert_same_run(run, hand_loop(s.clone(), g, cfg, n))


@pytest.mark.cuda
def test_diag_is_one_kernel_per_call_on_card(cuda_device):
    """One edge_sums call on given tables is one device kernel, H6's, by
    the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prob = balio.synthetic_problem_large(n_keyframes=20, n_points=1000,
                                         obs_per_lmk=7, seed=2)
    cfg = GBPConfig(accel_every=0)
    g = fg.build_graph(prob, cfg, cuda_device)
    s = gbp.initialise(fg.init_state(prob, cfg, cuda_device), g, cfg)
    tables = table_kernel.build_tables(s.cam_bel, s.lmk_bel)
    n = cfg.num_undamped_iters
    diag_kernel.edge_sums(s, g, n, tables=tables)          # scratch, build
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            diag_kernel.edge_sums(s, g, n, tables=tables)
        torch.cuda.synchronize()
    on_card = [ev.name for ev in prof.events()
               if ev.device_type == DeviceType.CUDA]
    assert len(on_card) == 3 and all("diag_sums" in k for k in on_card)


@pytest.mark.cuda
def test_diag_ticket_resets_on_card(cuda_device):
    """H6's sums repeat to the bit over three reruns and across calls that
    alternate between a 7-block and a 1-block grid on the same scratch:
    every launch leaves its ticket at 0 for the next."""
    cfg = GBPConfig(accel_every=0)
    cases = []
    for prob in (balio.synthetic_problem_large(n_keyframes=20,
                                               n_points=1000, obs_per_lmk=7,
                                               seed=2),
                 balio.synthetic_problem(n_keyframes=6, n_points=60, seed=0,
                                         pixel_noise=0.5)):
        g = fg.build_graph(prob, cfg, cuda_device)
        s = gbp.initialise(fg.init_state(prob, cfg, cuda_device), g, cfg)
        s, _ = gbp.run_gbp(s, g, cfg, 18, with_diagnostics=False)
        cases.append((s, g))
    assert cases[0][1].n_edges > 6 * 1024 and cases[1][1].n_edges <= 1024
    n = cfg.num_undamped_iters
    first = [diag_kernel.edge_sums(s, g, n) for s, g in cases]
    for _ in range(3):
        for (s, g), want in zip(cases, first):
            assert torch.equal(diag_kernel.edge_sums(s, g, n), want)
    for (s, g), want in zip(cases, first):
        r = diag_kernel.edge_sums(s, g, n, reference=True)
        assert torch.equal(want[[0, 3, 4]], r[[0, 3, 4]])
        assert bool(((want[1:3] - r[1:3]).abs() <= 1e-5 * r[1:3]).all())


@pytest.mark.cuda
def test_prepared_diag_follows_replaced_tensors_on_card(cuda_device):
    """The prepared launch (DiagLaunch, as run_gbp sets it up) against the
    plain version after ``state.robust`` and ``state.damping_count`` are
    replaced by changed clones between calls: it reads the new tensors,
    not the old ones it was set up on."""
    prob = balio.synthetic_problem_large(n_keyframes=20, n_points=1000,
                                         obs_per_lmk=7, seed=2)
    cfg = GBPConfig(accel_every=0)
    g = fg.build_graph(prob, cfg, cuda_device)
    s = gbp.initialise(fg.init_state(prob, cfg, cuda_device), g, cfg)
    s, _ = gbp.run_gbp(s, g, cfg, 18, with_diagnostics=False)
    n = cfg.num_undamped_iters
    rows = torch.empty((3, 5), dtype=torch.float64, device=cuda_device)
    launch = diag_kernel.DiagLaunch(s, g, n, rows)
    tables = table_kernel.build_tables(s.cam_bel, s.lmk_bel)
    launch(s, tables, 0)
    old_robust, old_count = s.robust, s.damping_count
    s.robust = ~old_robust                      # every Huber flag flipped
    launch(s, tables, 1)
    s.damping_count = torch.full_like(old_count, -n)   # all relinearised
    launch(s, tables, 2)
    want = [None, None, diag_kernel.edge_sums(s, g, n, reference=True)]
    s.damping_count = old_count
    want[1] = diag_kernel.edge_sums(s, g, n, reference=True)
    s.robust = old_robust
    want[0] = diag_kernel.edge_sums(s, g, n, reference=True)
    for got, r in zip(rows, want):
        assert torch.equal(got[[0, 3, 4]], r[[0, 3, 4]])
        assert bool(((got[1:3] - r[1:3]).abs() <= 1e-5 * r[1:3]).all())
    act = int((s.active > 0).sum())
    assert rows[1, 4] == act - rows[0, 4] and rows[2, 3] == act


def _nccl_solve(rank):
    """One NCCL rank: the edge-sharded solve of the coarse test problem
    (parallel/sharding.py), its gathered state and errors on the host."""
    from gbp_poplar_tpu_torch import parallel

    prob = balio.synthetic_problem(n_keyframes=6, n_points=60, seed=0,
                                   pixel_noise=0.5)
    cfg = GBPConfig(coarse_groups=3)
    graph = fg.build_graph(prob, cfg, rank.device)
    solver = parallel.make_sharded_solver(rank.group, cfg)
    g, s = solver.prepare(graph, fg.init_state(prob, cfg, rank.device))
    s, diag = solver.solve(s, g, 200)
    full = solver.gather(s, graph.n_edges)
    return fg.state_to_numpy(full), diag.reproj_err.cpu()


@pytest.mark.cuda
def test_nccl_one_rank_equals_single_device_on_card(cuda_device):
    """The edge-sharded solve at world size 1 over NCCL (one all_reduce
    per reduction, the prior added after it) is the single-device solve
    to the bit: 200 sweeps with the accelerator and the coarse
    corrector."""
    from gbp_poplar_tpu_torch import parallel

    (fields, err), = parallel.run(_nccl_solve, 1, device_type="cuda")
    prob = balio.synthetic_problem(n_keyframes=6, n_points=60, seed=0,
                                   pixel_noise=0.5)
    cfg = GBPConfig(coarse_groups=3)
    s, diag = gbp.solve(fg.init_state(prob, cfg, cuda_device),
                        fg.build_graph(prob, cfg, cuda_device), cfg, 200)
    assert torch.equal(err, diag.reproj_err.cpu())
    for k, v in fg.state_to_numpy(s).items():
        assert np.array_equal(v, fields[k], equal_nan=True), k


def _starved_problem():
    """synthetic_problem(12 keyframes, 120 points) with every other
    keyframe's observations cut to its first 2: the data of those cameras'
    S blocks has rank 4 at most, and weak priors leave the blocks near
    singular."""
    p = balio.synthetic_problem(n_keyframes=12, n_points=120, seed=1,
                                pixel_noise=0.5)
    cam = np.asarray(p.cam_idx)
    keep = np.ones(len(cam), bool)
    for c in range(1, p.n_keyframes, 2):
        keep[np.flatnonzero(cam == c)[2:]] = False
    return dataclasses.replace(
        p, n_edges=int(keep.sum()), cam_idx=p.cam_idx[keep],
        lmk_idx=p.lmk_idx[keep], measurements=p.measurements[keep])


@pytest.mark.cuda
@pytest.mark.parametrize("lm_lambda", [1e-6, 1e-9])
def test_lm_preconditioner_blocks_same_on_card_and_host(cuda_device,
                                                        lm_lambda):
    """ROADMAP C3: the LM's block-Jacobi preconditioner inverts S's
    diagonal blocks with cholesky_ex; on near-singular blocks (a starved
    problem, priors weakened 1e4 times, little damping) the card and the
    host find the same non-finite inverses, by cholesky_ex and by the
    unrolled inv6x6 (the JAX package's algorithm), and the two algorithms
    the same count."""
    from gbp_poplar_tpu_torch.core import gauss_newton as gn
    from gbp_poplar_tpu_torch.ops import linalg

    prob = _starved_problem()
    cfg = GBPConfig(edge_pad_multiple=1, prior_std_weaker_factor=1e4)
    graph = fg.build_graph(prob, cfg, cuda_device)
    pri = gn.problem_priors(prob, cfg, graph)
    s = gn.schur_block_diagonal(pri.cam_mu, pri.lmk_mu, graph, pri, cfg,
                                lm_lambda)
    counts = []
    for inv in (linalg.inv6x6_cholesky_ex, linalg.inv6x6):
        card = ~torch.isfinite(inv(s)).flatten(-2).all(-1)
        host = ~torch.isfinite(inv(s.cpu())).flatten(-2).all(-1)
        assert torch.equal(card.cpu(), host), inv.__name__
        counts.append(int(host.sum()))
    assert counts[0] == counts[1] > 0, counts


# ---------------------------------------------------------------------------
# the accelerator step as one CUDA graph (core/gbp.py, _AccelGraph)
# ---------------------------------------------------------------------------

# the slam driver's schedule flags (benchmark/traffic/keyframes.json)
SLAM_CFG = dict(relin_behind_camera=False, behind_camera_rescue_iters=300,
                iters_before_damping=0, relin_every_iter=True,
                eta_damping=0.7, lambda_damping=True,
                relin_drift_threshold=0.05, iters_between_kfs=700)


def _accel_run(case, device):
    """The case's solve on the card: (state, telemetry rows, accel_log,
    span calls). ``slam``: solve_slam over 5 keyframes, 700 sweeps a
    segment (11 live steps each, the priors replaced by every segment's
    annealing); ``ladybug``: a Ladybug-like problem with the coarse step,
    three run_gbp calls of 40 sweeps as the ba driver's spans."""
    from gbp_poplar_tpu_torch.core import slam
    from gbp_poplar_tpu_torch.utils import flags, trace

    log = []
    with trace.collect() as totals:
        if case == "slam":
            prob = balio.synthetic_problem(n_keyframes=5, n_points=60,
                                           seed=2, pixel_noise=0.5)
            cfg = GBPConfig(**SLAM_CFG)
            g = fg.build_graph(prob, cfg, device)
            s = fg.init_state(prob, cfg, device,
                              flags=flags.create_flags(prob, cfg.steps))
            res = slam.solve_slam(s, g, cfg, av_depth=6.0, runner=(
                lambda st: gbp.run_gbp(st, g, cfg, cfg.iters_between_kfs,
                                       accel_log=log)))
            s, rows = res.state, res[1:]
        else:
            prob = balio.synthetic_problem_large(n_keyframes=20,
                                                 n_points=1000,
                                                 obs_per_lmk=7, seed=2)
            cfg = GBPConfig(accel_every=8, accel_start=10, coarse_groups=4)
            g = fg.build_graph(prob, cfg, device)
            s = gbp.initialise(fg.init_state(prob, cfg, device), g, cfg)
            rows = []
            for i in range(0, 120, 40):
                s, d = gbp.run_gbp(s, g, cfg, 40, iter_offset=i,
                                   accel_log=log)
                rows += [x.cpu().numpy() for x in d[:4]]
    return s, rows, log, {k: n for k, (_, n) in totals.items()}


def _step_numbers(info):
    """An AccelStep's tensors (and its coarse record's), in order."""
    out = [info.gain, info.accepted, info.cost_cur, info.cost_cand]
    if info.coarse is not None:
        out += list(info.coarse)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["slam", "ladybug"])
def test_captured_accel_step_equals_eager_on_card(cuda_device, monkeypatch,
                                                  case):
    """run_gbp with the accelerator step replayed from its CUDA graph
    against the same solve with every step run eagerly (``_accel_math``
    called directly): the state, the telemetry and every accel_log entry
    to the bit. Of the steps one ran eagerly and one was captured, the
    rest were replays; the logged scalars are each step's own tensors,
    not views of the graph's outputs."""
    got = _accel_run(case, cuda_device)
    monkeypatch.setattr(gbp, "_accel_step", gbp._accel_math)
    want = _accel_run(case, cuda_device)
    (s, rows, log, calls), (s0, rows0, log0, _) = got, want
    for (k, x), y in zip(fg.state_to_numpy(s).items(),
                         fg.state_to_numpy(s0).values()):
        assert np.array_equal(x, y, equal_nan=True), k
    for x, y in zip(rows, rows0, strict=True):
        assert np.array_equal(x, y, equal_nan=True)
    n_steps = len(log)
    assert n_steps == calls["gbp.accel_step"] == len(log0) >= (
        44 if case == "slam" else 12)
    assert calls["gbp.accel_eager"] == calls["gbp.accel_capture"] == 1
    for (n, info), (n0, info0) in zip(log, log0):
        assert n == n0
        for x, y in zip(_step_numbers(info), _step_numbers(info0),
                        strict=True):
            assert np.array_equal(x.cpu().numpy(), y.cpu().numpy(),
                                  equal_nan=True), n
    for field in ("gain", "accepted", "cost_cur", "cost_cand"):
        ptrs = {getattr(i, field).data_ptr() for _, i in log}
        assert len(ptrs) == n_steps, field
    assert len({float(i.cost_cur) for _, i in log}) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["slam", "ladybug"])
def test_replayed_launches_count_on_card(cuda_device, monkeypatch, case):
    """Each kernel wrapper's ``launches`` counts the launches that ran, the
    replayed ones too and the capture's not: a solve whose steps were run
    eagerly, captured and replayed counts what the same solve with every
    step eager counts, and H8 one launch an accelerator step and one a
    coarse step."""
    def counts(run_case):
        for fn in gbp._COUNTED:
            monkeypatch.setattr(fn, "launches", 0)
        _, _, log, calls = run_case(case, cuda_device)
        torch.cuda.synchronize(cuda_device)
        return [fn.launches for fn in gbp._COUNTED], log, calls

    got, log, calls = counts(_accel_run)
    assert calls["gbp.accel_eager"] == calls["gbp.accel_capture"] == 1
    assert calls["gbp.accel_step"] == len(log) > 2
    n_coarse = sum(info.coarse is not None for _, info in log)
    assert n_coarse == (0 if case == "slam" else len(log))
    assert got[gbp._COUNTED.index(cost_kernel.cost_sums)] == (
        len(log) + n_coarse)
    monkeypatch.setattr(gbp, "_accel_step", gbp._accel_math)
    want, _, _ = counts(_accel_run)
    assert got == want


@pytest.mark.cuda
def test_accel_graph_lives_with_its_state_on_card(cuda_device, monkeypatch):
    """The captured step is its state's: a fresh state captures its own,
    ``clone()`` carries none, and the first state's is freed with it (no
    cycle holds it); its memory serves the next capture, so fresh states
    one after another hold the device's reserved memory level. H8's
    ticket is 0 after the replays. When a tensor the graph reads in place
    is replaced, the next step runs eagerly, the one after recaptures,
    and the solve equals an eager one to the bit."""
    import weakref

    from gbp_poplar_tpu_torch.utils import trace

    prob = balio.synthetic_problem_large(n_keyframes=20, n_points=1000,
                                         obs_per_lmk=7, seed=2)
    cfg = GBPConfig(accel_every=8, accel_start=10)
    g = fg.build_graph(prob, cfg, cuda_device)

    def run(s, n, offset=0):
        with trace.collect() as totals:
            s, d = gbp.run_gbp(s, g, cfg, n, iter_offset=offset)
        return s, d, {k: c for k, (_, c) in totals.items()}

    def fresh():
        return gbp.initialise(fg.init_state(prob, cfg, cuda_device), g, cfg)

    a, _, calls_a = run(fresh(), 50)
    b, _, calls_b = run(fresh(), 50)
    for calls in (calls_a, calls_b):
        assert calls["gbp.accel_step"] == 5
        assert calls["gbp.accel_eager"] == calls["gbp.accel_capture"] == 1
    held = a.accel_graph
    assert isinstance(held, gbp._AccelGraph) and held.graph is not None
    assert b.accel_graph is not held and b.accel_graph.graph is not None
    assert a.clone().accel_graph is None
    assert int(held.scratch.ticket.item()) == 0
    refs = weakref.ref(held), weakref.ref(held.graph)
    del a, held
    assert all(r() is None for r in refs)
    reserved = []
    for _ in range(4):
        s, _, _ = run(fresh(), 50)
        assert gbp._POOLS[cuda_device][2]() is s.accel_graph.pool
        del s
        torch.cuda.synchronize(cuda_device)
        reserved.append(torch.cuda.memory_reserved(cuda_device))
    assert reserved[3] == reserved[1], reserved

    b.pk = b.pk.clone()
    c = b.clone()
    b, d, calls = run(b, 40, 50)
    assert calls["gbp.accel_step"] == 5
    assert calls["gbp.accel_eager"] == calls["gbp.accel_capture"] == 1
    monkeypatch.setattr(gbp, "_accel_step", gbp._accel_math)
    c, d0, _ = run(c, 40, 50)
    assert_same_run((b, d), (c, d0))


def _nccl_accel_calls(rank):
    """One NCCL rank's span calls over an edge-sharded solve with the
    accelerator, and whether its state holds a captured step."""
    from gbp_poplar_tpu_torch import parallel
    from gbp_poplar_tpu_torch.utils import trace

    prob = balio.synthetic_problem_large(n_keyframes=20, n_points=1000,
                                         obs_per_lmk=7, seed=2)
    cfg = GBPConfig(accel_every=8, accel_start=10)
    solver = parallel.make_sharded_solver(rank.group, cfg)
    g, s = solver.prepare(fg.build_graph(prob, cfg, rank.device),
                          fg.init_state(prob, cfg, rank.device))
    with trace.collect() as totals:
        s, _ = solver.solve(s, g, 50)
    return {k: n for k, (_, n) in totals.items()}, s.accel_graph is None


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["reference", "nccl"])
def test_accel_steps_stay_eager_on_card(cuda_device, case):
    """With ``kernels="reference"`` or a process group (the sharded
    solvers) every accelerator step on the card runs eagerly and no state
    holds a captured step."""
    from gbp_poplar_tpu_torch import parallel
    from gbp_poplar_tpu_torch.utils import trace

    if case == "nccl":
        ((calls, none),) = parallel.run(_nccl_accel_calls, 1,
                                        device_type="cuda")
    else:
        prob = balio.synthetic_problem_large(n_keyframes=20, n_points=1000,
                                             obs_per_lmk=7, seed=2)
        cfg = GBPConfig(accel_every=8, accel_start=10, kernels="reference")
        g = fg.build_graph(prob, cfg, cuda_device)
        s = gbp.initialise(fg.init_state(prob, cfg, cuda_device), g, cfg)
        with trace.collect() as totals:
            s, _ = gbp.run_gbp(s, g, cfg, 50)
        calls = {k: n for k, (_, n) in totals.items()}
        none = s.accel_graph is None
    assert calls["gbp.accel_step"] == calls["gbp.accel_eager"] == 5
    assert "gbp.accel_capture" not in calls and none


# ---------------------------------------------------------------------------
# the runs of sweeps as CUDA graphs (core/gbp.py, _SweepGraph)
# ---------------------------------------------------------------------------

# _accel_run's runs of sweeps: (all, eager, captured). slam: 4 segments of
# 15 runs; each segment's annealed run is eager, the three anneal-free
# shapes ((50, collect), 50, 40) are first seen in segment 1, (50,
# collect) is captured there and the other two in segment 2. ladybug:
# three run_gbp calls, 19 runs: the annealed one, (8, collect) 13 times
# (first seen, captured, replayed), the leftover 6 and four empty runs.
SWEEP_RUNS = {"slam": (60, 7, 3), "ladybug": (19, 7, 1)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["slam", "ladybug"])
def test_replayed_sweeps_equal_eager_on_card(cuda_device, monkeypatch,
                                             case):
    """run_gbp with its runs of sweeps and accelerator steps replayed from
    their CUDA graphs against the same solve with every step run eagerly
    (``_capturable`` false): the state (beliefs, ``pk`` and every other
    field), every telemetry row and every accel_log entry to the bit, and
    each kernel wrapper the same launch count. The spans count the eager,
    captured and replayed runs."""
    def run(capturable):
        for fn in gbp._COUNTED:
            monkeypatch.setattr(fn, "launches", 0)
        if not capturable:
            monkeypatch.setattr(gbp, "_capturable", lambda *args: False)
        out = _accel_run(case, cuda_device)
        torch.cuda.synchronize(cuda_device)
        return out, [fn.launches for fn in gbp._COUNTED]

    (s, rows, log, calls), got = run(True)
    (s0, rows0, log0, calls0), want = run(False)
    for (k, x), y in zip(fg.state_to_numpy(s).items(),
                         fg.state_to_numpy(s0).values()):
        assert np.array_equal(x, y, equal_nan=True), k
    for x, y in zip(rows, rows0, strict=True):
        assert np.array_equal(x, y, equal_nan=True)
    assert len(log) == len(log0) > 0
    for (n, info), (n0, info0) in zip(log, log0):
        assert n == n0
        for x, y in zip(_step_numbers(info), _step_numbers(info0),
                        strict=True):
            assert np.array_equal(x.cpu().numpy(), y.cpu().numpy(),
                                  equal_nan=True), n
    assert got == want
    n_runs, eager, captured = SWEEP_RUNS[case]
    assert calls["gbp.sweeps"] == calls0["gbp.sweeps"] == n_runs
    assert calls["gbp.sweeps_eager"] == eager
    assert calls["gbp.sweeps_capture"] == captured
    assert calls0["gbp.sweeps_eager"] == n_runs
    assert "gbp.sweeps_capture" not in calls0
    assert calls0["gbp.accel_eager"] == calls0["gbp.accel_step"]


@pytest.mark.cuda
def test_sweep_graphs_live_with_their_state_on_card(cuda_device,
                                                    monkeypatch):
    """A state's captured runs of sweeps are its own: a fresh state
    captures its own, ``clone()`` carries none, they share the state's
    pool with its accelerator step (another live state's are in another
    pool), and they are freed with the state (no cycle holds them). Their
    H6 ticket is 0 after the replays. When a tensor the graphs read in
    place is replaced, the next run of that shape runs eagerly, the one
    after recaptures, and the solve equals an eager one to the bit."""
    import weakref

    from gbp_poplar_tpu_torch.utils import trace

    prob = balio.synthetic_problem_large(n_keyframes=20, n_points=1000,
                                         obs_per_lmk=7, seed=2)
    cfg = GBPConfig(accel_every=8, accel_start=10)
    g = fg.build_graph(prob, cfg, cuda_device)

    def run(s, n, offset=0):
        with trace.collect() as totals:
            s, d = gbp.run_gbp(s, g, cfg, n, iter_offset=offset)
        return s, d, {k: c for k, (_, c) in totals.items()}

    def fresh():
        return gbp.initialise(fg.init_state(prob, cfg, cuda_device), g, cfg)

    # 7 runs: the annealed one, five (8, collect) chunks and the empty
    # leftover; the annealed, the first chunk and the empty run eager, the
    # second chunk captured, three replays
    a, _, calls_a = run(fresh(), 50)
    b, _, calls_b = run(fresh(), 50)
    for calls in (calls_a, calls_b):
        assert calls["gbp.sweeps"] == 7
        assert calls["gbp.sweeps_eager"] == 3
        assert calls["gbp.sweeps_capture"] == 1
    (held,) = a.sweep_graphs.values()
    assert isinstance(held, gbp._SweepGraph) and held.graph is not None
    assert held.pool is a.accel_graph.pool
    (other,) = b.sweep_graphs.values()
    assert other is not held and other.pool is b.accel_graph.pool
    assert other.pool is not held.pool
    assert a.clone().sweep_graphs is None
    # the state reads the graph's own buffers: no second copy of its priors
    assert a.cam_prior is held.ins[2] and a.lmk_prior is held.ins[3]
    assert int(held.launch.scratch.ticket.item()) == 0
    refs = weakref.ref(held), weakref.ref(held.graph), weakref.ref(held.pool)
    del a, held
    assert all(r() is None for r in refs)

    b.active = b.active.clone()
    c = b.clone()
    b, d, calls = run(b, 40, 50)
    # the empty annealed run, the first chunk (its graph dropped) and the
    # empty leftover eager, the second chunk recaptured, three replays
    assert calls["gbp.sweeps"] == 7
    assert calls["gbp.sweeps_eager"] == 3
    assert calls["gbp.sweeps_capture"] == 1
    monkeypatch.setattr(gbp, "_capturable", lambda *args: False)
    c, d0, _ = run(c, 40, 50)
    assert_same_run((b, d), (c, d0))
