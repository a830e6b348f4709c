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
