"""The port's Levenberg-Marquardt / iterative-Schur solver (core/
gauss_newton.py) against a dense solve and against the JAX package.

One Schur step (PCG on the reduced camera system, landmark
back-substitution) is held against the dense solve of the full damped
normal equations in float64. Warm-started LM runs are compared per
iteration with both JAX paths (the batched one and the chunked plane-major
one, forced by a small ``_GN_CHUNK_EDGES``); cold starts, which the JAX
package documents as float32-sensitive, by outcome.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbp_poplar_tpu.config import GBPConfig as JaxConfig
from gbp_poplar_tpu.config import InitConfig as JaxInitConfig
from gbp_poplar_tpu.core import build_graph as jax_build_graph
from gbp_poplar_tpu.core import gauss_newton as jax_gn
from gbp_poplar_tpu.utils import balio as jax_balio
from gbp_poplar_tpu.utils import priors as jax_priors
from gbp_poplar_tpu_torch import GBPConfig, InitConfig
from gbp_poplar_tpu_torch.core import factor_graph as fg
from gbp_poplar_tpu_torch.core import gauss_newton as gn
from gbp_poplar_tpu_torch.ops import planes as pl
from gbp_poplar_tpu_torch.utils import balio, priors

torch.set_num_threads(1)

# per-iteration MAP cost of warm starts, relative: float32 sums in other
# orders (measured up to 5e-6)
COST_RTOL = 1e-4
# an accepted step that lowers the cost by less than this fraction is a
# float32 tie the packages may decide either way (~10 ulps at the optimum)
TIE_REL = 1e-6
# final reprojection error of cold starts, compared by outcome
COLD_ATOL_PX = 0.02
N_LM = 12

KW = dict(n_keyframes=6, n_points=60, seed=3, pixel_noise=0.5)
NOISE = dict(trans_noise=0.03, rot_noise=1.0, lmk_noise=0.1, seed=3)


def _problems(noise_free=False):
    """(port problem, JAX problem): the synthetic problem with its means
    perturbed (the priors' centres and the cold start)."""
    kw = dict(KW, pixel_noise=0.0) if noise_free else KW
    return (priors.apply_init_noise(balio.synthetic_problem(**kw),
                                    InitConfig(**NOISE)),
            jax_priors.apply_init_noise(jax_balio.synthetic_problem(**kw),
                                        JaxInitConfig(**NOISE)))


def _port_setup(problem, dtype=torch.float32):
    cfg = GBPConfig(edge_pad_multiple=1)
    graph = fg.build_graph(problem, cfg, "cpu")
    pri = gn.problem_priors(problem, cfg, graph)
    if dtype != torch.float32:
        graph = dataclasses.replace(graph, meas=graph.meas.to(dtype),
                                    meas_var=graph.meas_var.to(dtype))
        pri = gn.GNPriors(*(x.to(dtype) for x in pri))
    return cfg, graph, pri


def test_schur_step_matches_dense_solve():
    """dx from the Schur complement, PCG and back-substitution equals the
    dense solve of the full damped normal equations, float64."""
    problem = balio.synthetic_problem(n_keyframes=4, n_points=20, seed=1,
                                      pixel_noise=1.0)
    cfg, graph, pri = _port_setup(problem, torch.float64)
    camT, lmkT = pri.cam_mu.T, pri.lmk_mu.T
    lam = torch.tensor(1e-3, dtype=torch.float64)
    ne = gn._build_planes(camT, lmkT, graph, pri, cfg.huber_nstds, lam,
                          ref=True)
    rhs = ne.b_c - gn._w_z_c6(ne, graph, gn._minv_apply(ne, ne.b_l3), True)
    dx_c = gn._pcg(ne, rhs, 200, 1e-12,
                   lambda p: gn._schur_matvec_p(ne, graph, p, True))
    dx_l = gn._minv_apply(ne, ne.b_l3 - gn._wt_v_l3(ne, graph, dx_c, True))

    c, l = problem.n_keyframes, problem.n_points
    n = 6 * c + 3 * l
    h = np.zeros((n, n))
    for i in range(c):
        h[6 * i:6 * i + 6, 6 * i:6 * i + 6] = ne.a_c[i].numpy()
    m_inv = pl.unpack_sym(ne.m_inv6, 3)
    m_inv = np.stack([np.stack([m_inv[i][j].numpy() for j in range(3)], -1)
                      for i in range(3)], -2)                   # [L, 3, 3]
    m = np.linalg.inv(m_inv)
    for j in range(l):
        o = 6 * c + 3 * j
        h[o:o + 3, o:o + 3] = m[j]
    w = ne.w18.numpy().T.reshape(-1, 6, 3)
    for k, (ci, li) in enumerate(zip(graph.cam_idx.tolist(),
                                     graph.lmk_idx.tolist())):
        o_c, o_l = 6 * ci, 6 * c + 3 * li
        h[o_c:o_c + 6, o_l:o_l + 3] += w[k]
        h[o_l:o_l + 3, o_c:o_c + 6] += w[k].T
    b = np.concatenate([ne.b_c.numpy().ravel(), ne.b_l3.numpy().T.ravel()])
    dx = np.linalg.solve(h, b)
    np.testing.assert_allclose(dx_c.numpy().ravel(), dx[:6 * c], rtol=1e-6,
                               atol=1e-8)
    np.testing.assert_allclose(dx_l.numpy().T.ravel(), dx[6 * c:],
                               rtol=1e-6, atol=1e-8)


def test_cold_start_converges_and_matches_jax_by_outcome():
    """From the perturbed means of a noise-free problem LM converges to a
    sub-0.2 px fit (the priors keep it from 0), as the JAX solver does;
    the two land within COLD_ATOL_PX."""
    tp, jp = _problems(noise_free=True)
    res = gn.solve_problem(tp, GBPConfig(), "cpu", n_lm_iters=40,
                           cg_iters=60)
    err = float(res.reproj_err[-1])
    want = float(jax_gn.solve_problem(jp, JaxConfig(), n_lm_iters=40,
                                      cg_iters=60).reproj_err[-1])
    assert err < 0.2, err
    assert abs(err - want) < COLD_ATOL_PX, (err, want)
    assert torch.isfinite(res.cam).all() and torch.isfinite(res.lmk).all()


@pytest.mark.parametrize("jax_path", ["batched", "chunked"])
def test_warm_lm_matches_jax(jax_path, monkeypatch):
    """A warm start (the generator's means moved by N(0, 2 cm) / N(0, 5
    cm), the priors at the perturbed means): per-iteration MAP costs agree
    to COST_RTOL, and the accept decisions are equal up to the first
    float32 tie (the first three iterations here)."""
    tp, jp = _problems()
    truth = balio.synthetic_problem(**KW)
    rng = np.random.default_rng(0)
    cam = (truth.cam_means + rng.normal(0, 2e-2, truth.cam_means.shape)
           ).astype(np.float32)
    lmk = (truth.lmk_means + rng.normal(0, 5e-2, truth.lmk_means.shape)
           ).astype(np.float32)

    jc = JaxConfig(edge_pad_multiple=1)
    jg = jax_build_graph(jp, jc)
    cam_lam0, lmk_lam0 = jax_priors.prior_lambdas(jp, jc.meas_var)
    jpri = jax_gn.annealed_priors(jg, jnp.asarray(jp.cam_means),
                                  jnp.asarray(jp.lmk_means), cam_lam0,
                                  lmk_lam0, jc)
    if jax_path == "chunked":
        monkeypatch.setattr(jax_gn, "_GN_CHUNK_EDGES", 64)
    want = jax_gn.solve_lm(jnp.asarray(cam), jnp.asarray(lmk), jg, jpri, jc,
                           n_lm_iters=N_LM)

    cfg, graph, pri = _port_setup(tp)
    np.testing.assert_allclose(
        float(gn.map_cost(torch.tensor(cam), torch.tensor(lmk), graph, pri,
                          cfg)),
        float(jax_gn.map_cost(jnp.asarray(cam), jnp.asarray(lmk), jg, jpri,
                              jc)), rtol=COST_RTOL)
    got = gn.solve_lm(torch.tensor(cam), torch.tensor(lmk), graph, pri, cfg,
                      n_lm_iters=N_LM)
    cost = got.cost.numpy()
    assert cost.shape == (N_LM,) and np.all(np.diff(cost) <= 0)
    np.testing.assert_allclose(cost, np.asarray(want.cost), rtol=COST_RTOL)
    np.testing.assert_allclose(got.reproj_err.numpy(),
                               np.asarray(want.reproj_err), rtol=1e-4)
    np.testing.assert_allclose(got.cam.numpy(), np.asarray(want.cam),
                               rtol=0, atol=1e-3)
    before = np.concatenate([[float(gn.map_cost(
        torch.tensor(cam), torch.tensor(lmk), graph, pri, cfg))], cost[:-1]])
    clear = 0
    while (clear < N_LM and got.accepted[clear]
           and before[clear] - cost[clear] > TIE_REL * abs(cost[clear])):
        clear += 1
    assert clear >= 3
    np.testing.assert_array_equal(got.accepted.numpy()[:clear],
                                  np.asarray(want.accepted)[:clear])


def test_zero_lm_iterations_return_empty_traces():
    """n_lm_iters=0 returns the start and empty traces (the JAX batched
    path's behaviour; its chunked path raises there)."""
    tp, _ = _problems()
    cfg, graph, pri = _port_setup(tp)
    res = gn.solve_lm(pri.cam_mu, pri.lmk_mu, graph, pri, cfg, n_lm_iters=0)
    assert res.cost.shape == (0,) and res.reproj_err.shape == (0,)
    assert res.accepted.shape == (0,) and res.accepted.dtype == torch.bool
    assert torch.equal(res.cam, pri.cam_mu) and torch.equal(res.lmk,
                                                            pri.lmk_mu)
    assert float(res.lm_lambda) == pytest.approx(1e-4)


def test_annealed_priors_match_jax():
    tp, jp = _problems()
    cfg, graph, pri = _port_setup(tp)
    jc = JaxConfig(edge_pad_multiple=1)
    cam_lam0, lmk_lam0 = jax_priors.prior_lambdas(jp, jc.meas_var)
    want = jax_gn.annealed_priors(
        jax_build_graph(jp, jc), jnp.asarray(jp.cam_means),
        jnp.asarray(jp.lmk_means), cam_lam0, lmk_lam0, jc)
    for f, a, b in zip(gn.GNPriors._fields, pri, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   err_msg=f)
