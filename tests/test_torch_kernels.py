"""The port's kernel modules: plain versions against the JAX package's
Pallas kernels (run in interpret mode, as the JAX tests run them on the
CPU), and the wrappers' device dispatch. The CUDA kernels themselves are
held against these plain versions on the card by tests/test_torch_cuda.py
and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbp_poplar_tpu.ops import planes as jpl
from gbp_poplar_tpu.ops.reduce_kernel import blocked_reduce, build_blocked_index
from gbp_poplar_tpu.ops.table_kernel import build_lmk_table
from gbp_poplar_tpu_torch.config import GBPConfig
from gbp_poplar_tpu_torch.core import factor_graph as fg
from gbp_poplar_tpu_torch.core import gbp
from gbp_poplar_tpu_torch.ops import reduce_kernel, sweep_kernel, table_kernel
from gbp_poplar_tpu_torch.utils import balio

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def large():
    """Ladybug-like visibility at 40 keyframes: 21,000 edges."""
    prob = balio.synthetic_problem_large(n_keyframes=40, n_points=3000,
                                         obs_per_lmk=7, seed=1)
    return prob, fg.build_graph(prob, GBPConfig(), "cpu")


@pytest.mark.parametrize("kind", ["cam", "lmk"])
def test_segment_sum_matches_blocked_reduce(large, kind):
    """H3's plain version against the JAX blocked one-hot reduce (the
    Pallas kernel in interpret mode) on random message planes. The two sum
    in different orders: the bound is 1e-6 of the sum of |terms|."""
    prob, g = large
    rng = np.random.default_rng(0)
    comp, n_var, seg, idx, be = (
        (27, prob.n_keyframes, g.cam_seg, g.cam_idx, 8192) if kind == "cam"
        else (9, prob.n_points, g.lmk_seg, g.lmk_idx, 1024))
    planes = rng.normal(0, 1, (comp, g.n_edges)).astype(np.float32)
    planes[:, prob.n_edges:] = 0.0          # padding edges carry nothing
    bidx = build_blocked_index(idx.numpy()[:prob.n_edges], n_var, be,
                               n_edges_padded=g.n_edges)
    assert bidx is not None
    want = np.asarray(blocked_reduce(jnp.asarray(planes),
                                     jnp.asarray(idx.numpy()), bidx, n_var,
                                     interpret=True))
    prior = rng.normal(0, 1, (comp, n_var)).astype(np.float32)
    got = reduce_kernel.segment_sum(torch.tensor(planes), seg,
                                    torch.tensor(prior)).numpy()
    scale = np.zeros((comp, n_var))
    np.add.at(scale.T, idx.numpy()[:prob.n_edges],
              np.abs(planes[:, :prob.n_edges]).T)
    np.testing.assert_allclose(got - prior, want, rtol=0,
                               atol=1e-6 * scale.max())
    assert reduce_kernel.segment_sum.launches == 0     # CPU: plain version


def test_lmk_table_matches_build_lmk_table():
    """H2's plain version (landmarks) against the JAX fused table builder
    in interpret mode, including singular and NaN-poisoned beliefs: the
    belief columns and validity flags are copies and must be equal; the
    means are the same adjugate expression, bounded per row by the 3x3
    condition number times 32 ulps (as the JAX package's own test)."""
    rng = np.random.default_rng(11)
    l, rows = 1000, 1024
    lam = rng.normal(0, 1, (6, l)).astype(np.float32)
    lam[:3] += 3.0
    eta = rng.normal(0, 1, (3, l)).astype(np.float32)
    lam[:, 17] = 0.0                          # singular -> invalid
    eta[0, 42] = np.nan                       # poisoned -> invalid
    tbl_j, _ = build_lmk_table(jnp.asarray(eta), jnp.asarray(lam), rows,
                               interpret=True)
    tbl_j = np.asarray(tbl_j)[:l, :table_kernel.LMK_WIDTH]
    tbl_t = table_kernel.build_table_reference(
        torch.tensor(np.concatenate([eta, lam])), 3).numpy()
    assert tbl_t.shape == (l, table_kernel.LMK_WIDTH)
    np.testing.assert_array_equal(tbl_t[:, :9], tbl_j[:, :9])
    np.testing.assert_array_equal(tbl_t[:, 12:], tbl_j[:, 12:])
    assert not tbl_t[17, 12] and not tbl_t[42, 12] and tbl_t[:, 12].sum() > 990
    conds = np.array([
        np.linalg.cond(np.asarray([[lam[jpl.sym_slot(a, b), i]
                                    for b in range(3)] for a in range(3)],
                                  np.float64))
        if lam[:, i].any() else np.inf for i in range(l)])
    tol = np.maximum(conds, 1e2) * 32 * np.finfo(np.float32).eps
    dmu = (np.abs(tbl_t[:, 9:12] - tbl_j[:, 9:12])
           / (1.0 + np.abs(tbl_j[:, 9:12]))).max(axis=1)
    assert not (np.nan_to_num(dmu) > tol).any()


def test_cam_table_matches_jax_means():
    """H2's plain version (cameras) against the JAX package's camera-side
    table glue: solve_sym means, zeroed whole where not finite."""
    rng = np.random.default_rng(12)
    c = 300
    a = rng.normal(0, 1, (c, 6, 6))
    m = a @ a.transpose(0, 2, 1) + 0.5 * np.eye(6)
    lam = np.stack([m[:, i, j] for (i, j) in jpl.SYM6_IDX]).astype(np.float32)
    eta = rng.normal(0, 1, (6, c)).astype(np.float32)
    lam[0, 5] = np.nan
    eta[2, 9] = np.inf
    mu = jnp.concatenate(jpl.solve_sym(jpl.unpack_sym(jnp.asarray(lam), 6),
                                       jpl.unpack_vec(jnp.asarray(eta), 6)))
    ok = np.asarray(jnp.all(jnp.isfinite(mu), axis=0))
    mu = np.where(ok, np.asarray(mu), 0.0)
    tbl = table_kernel.build_table_reference(
        torch.tensor(np.concatenate([eta, lam])), 6).numpy()
    np.testing.assert_array_equal(tbl[:, :27], np.concatenate([eta, lam]).T)
    np.testing.assert_array_equal(tbl[:, 33], ok.astype(np.float32))
    assert not ok[5] and not ok[9] and ok.sum() == c - 2
    assert not tbl[:, 34:].any()
    np.testing.assert_allclose(tbl[:, 27:33], mu.T, rtol=1e-4,
                               atol=1e-4 * np.abs(mu).max())


def test_build_tables_is_the_table_build_per_kind(large):
    """``build_tables`` (one launch for both kinds on a card) gives on the
    CPU exactly ``build_table_reference`` of each kind, as it does for one
    kind with the other given no variables; ``_sanitized_means`` reads the
    means and the zeroing from it."""
    prob, g = large
    cfg = GBPConfig(accel_every=0)
    s = gbp.initialise(fg.init_state(prob, cfg, "cpu"), g, cfg)
    s.lmk_bel[:, 3] = float("nan")
    ct, lt = table_kernel.build_tables(s.cam_bel, s.lmk_bel)
    assert torch.equal(ct, table_kernel.build_table_reference(s.cam_bel, 6))
    assert torch.equal(lt.nan_to_num(), table_kernel.build_table_reference(
        s.lmk_bel, 3).nan_to_num())
    ct_alone, lt_none = table_kernel.build_tables(s.cam_bel, s.lmk_bel[:, :0])
    assert torch.equal(ct, ct_alone) and lt_none.shape == (0, 16)
    assert lt[3, 12] == 0 and not lt[3, 9:12].any()
    cam_mu, lmk_mu = gbp._sanitized_means(s, cfg)
    assert torch.equal(cam_mu, ct[:, 27:33].T)
    assert torch.equal(lmk_mu, lt[:, 9:12].T)
    assert table_kernel.build_tables.launches == 0      # CPU: plain version


def test_wrappers_dispatch_by_device(large):
    """CPU tensors take the plain versions (the launch counters stay at 0);
    a tensor on neither the CPU nor a CUDA device is refused, never
    silently computed some other way."""
    prob, g = large
    cfg = GBPConfig(accel_every=0)
    s = gbp.initialise(fg.init_state(prob, cfg, "cpu"), g, cfg)
    ref = s.clone()
    for fn in (sweep_kernel.sweep, table_kernel.build_tables,
               reduce_kernel.segment_sum):
        fn.launches = 0
    gbp.gbp_sweep(s, g, cfg)
    gbp.gbp_sweep(ref, g, GBPConfig(accel_every=0, kernels="reference"))
    assert torch.equal(s.pk, ref.pk) and torch.equal(s.cam_bel, ref.cam_bel)
    assert (sweep_kernel.sweep.launches, table_kernel.build_tables.launches,
            reduce_kernel.segment_sum.launches) == (0, 0, 0)
    meta = torch.empty((9, 5), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        table_kernel.build_tables(torch.empty((27, 0), device="meta"), meta)
    with pytest.raises(ValueError, match="unsupported device"):
        table_kernel.build_tables(torch.empty((27, 4), device="meta"), meta)
    with pytest.raises(ValueError, match="beliefs on"):
        table_kernel.build_tables(s.cam_bel, meta)
    with pytest.raises(ValueError, match="kernels"):
        GBPConfig(kernels="triton")
