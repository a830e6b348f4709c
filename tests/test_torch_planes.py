"""Plane algebra of the PyTorch port against the JAX package's ops/planes.

Same inputs, made with numpy from a seed, through both. The two run the
same formulas in the same order; they differ by the rounding of their
transcendental and square-root implementations (PyTorch's CPU sqrt is not
correctly rounded), so every comparison allows a few float32 ulps, scaled
by the output's magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbp_poplar_tpu.ops import planes as jpl
from gbp_poplar_tpu_torch.ops import planes as tpl

torch.set_num_threads(1)

N = 512
RTOL = 2e-5       # a few f32 ulps, amplified by the small solves


def _close(t, j, rtol=RTOL, scale=None, what=""):
    b = t.numpy().astype(np.float64)
    # the JAX package keeps plane rows 2-D, (1, N)
    a = np.asarray(j, np.float64).reshape(b.shape)
    s = np.abs(a).max() if scale is None else scale
    np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * s, err_msg=what)


def _spd(d, n, rng, indefinite=0):
    a = rng.normal(0, 1, (n, d, d))
    m = a @ a.transpose(0, 2, 1) + 0.1 * np.eye(d)
    m[:indefinite] -= 50.0 * np.eye(d)            # some indefinite matrices
    idx = tpl.SYM6_IDX if d == 6 else tpl.SYM3_IDX
    return np.stack([m[:, i, j] for (i, j) in idx]).astype(np.float32)


def _both(x):
    return torch.tensor(x), jnp.asarray(x)


@pytest.mark.parametrize("d", [3, 6])
def test_cholesky_with_pivot(d):
    rng = np.random.default_rng(d)
    t, j = _both(_spd(d, N, rng, indefinite=16))
    lt, pt = tpl.cholesky_with_pivot(tpl.unpack_sym(t, d))
    lj, pj, _ = jpl.cholesky_with_pivot(jpl.unpack_sym(j, d))
    for i in range(d):
        for k in range(i + 1):
            _close(lt[i][k], lj[i][k], what=f"L[{i}][{k}]")
    _close(pt, pj, what="min_pivot")
    # the sign of the minimum pivot is the positive-definite decision
    np.testing.assert_array_equal(pt.numpy() > 0, np.asarray(pj)[0] > 0)
    assert (pt.numpy() <= 0).sum() >= 16


@pytest.mark.parametrize("d", [3, 6])
def test_chol_solve_and_solve_sym(d):
    rng = np.random.default_rng(10 + d)
    t, j = _both(_spd(d, N, rng))
    b = rng.normal(0, 1, (d, N)).astype(np.float32)
    bt, bj = _both(b)
    xt = tpl.solve_sym(tpl.unpack_sym(t, d), tpl.unpack_vec(bt, d))
    xj = jpl.solve_sym(jpl.unpack_sym(j, d), jpl.unpack_vec(bj, d))
    for i in range(d):
        _close(xt[i], xj[i], rtol=1e-4, what=f"x[{i}]")
    lt, _ = tpl.cholesky_with_pivot(tpl.unpack_sym(t, d))
    xt2 = tpl.chol_solve(lt, tpl.unpack_vec(bt, d))
    for i in range(d):
        np.testing.assert_array_equal(xt2[i].numpy(), xt[i].numpy())


def test_inv_sym3_posdef():
    rng = np.random.default_rng(3)
    t, j = _both(_spd(3, N, rng, indefinite=32))
    it, okt = tpl.inv_sym3_posdef(tpl.unpack_sym(t, 3))
    ij, okj = jpl.inv_sym3_posdef(jpl.unpack_sym(j, 3))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj)[0])
    for a in range(3):
        for b in range(3):
            _close(it[a][b], ij[a][b], rtol=1e-6, what=f"inv[{a}][{b}]")


def test_so3_exp_small_and_large_angles():
    rng = np.random.default_rng(4)
    w = rng.normal(0, 1, (3, N)).astype(np.float32)
    w[:, :64] *= 1e-7                       # the small-angle branch
    w[:, 64:128] *= 3.0                     # beyond pi
    wt, wj = _both(w)
    rt = tpl.so3_exp(tpl.unpack_vec(wt, 3))
    rj = jpl.so3_exp(jpl.unpack_vec(wj, 3))
    for a in range(3):
        for b in range(3):
            _close(rt[a][b], rj[a][b], rtol=1e-6, scale=1.0,
                   what=f"R[{a}][{b}]")


def _edge_inputs(snavely, rng):
    cam = np.concatenate([rng.normal(0, 0.3, (3, N)),
                          rng.normal(0, 0.1, (3, N))]).astype(np.float32)
    lmk = rng.normal(0, 1, (3, N)).astype(np.float32)
    lmk[2] = (-1 if snavely else 1) * rng.uniform(3, 8, N)
    var = np.full((N,), 4.0, np.float32)
    k = np.array([[500, 0, 320], [0, 480, 240], [0, 0, 1]], np.float32)
    intr = None
    if snavely:
        intr = np.stack([rng.uniform(450, 550, N), np.full(N, -0.3),
                         np.full(N, 0.1)]).astype(np.float32)
    # measurements near the projections: some residuals beyond the Huber
    # threshold (2.5 sigma = 5 px), most inside
    (u, v), _, _ = jpl.project(
        jpl.unpack_vec(jnp.asarray(cam), 6), jpl.unpack_vec(jnp.asarray(lmk), 3),
        jnp.asarray(k),
        None if intr is None else jpl.unpack_vec(jnp.asarray(intr), 3))
    meas = (np.concatenate([np.asarray(u), np.asarray(v)])
            + rng.normal(0, 3.0, (2, N))).astype(np.float32)
    return cam, lmk, meas, var, k, intr


@pytest.mark.parametrize("snavely", [False, True], ids=["pinhole", "snavely"])
def test_project(snavely):
    cam, lmk, meas, var, k, intr = _edge_inputs(snavely,
                                                np.random.default_rng(5))
    args_t = (tpl.unpack_vec(torch.tensor(cam), 6),
              tpl.unpack_vec(torch.tensor(lmk), 3), k,
              None if intr is None else tpl.unpack_vec(torch.tensor(intr), 3))
    args_j = (jpl.unpack_vec(jnp.asarray(cam), 6),
              jpl.unpack_vec(jnp.asarray(lmk), 3), jnp.asarray(k),
              None if intr is None else jpl.unpack_vec(jnp.asarray(intr), 3))
    (ut, vt), yt, _ = tpl.project(*args_t)
    (uj, vj), yj, _ = jpl.project(*args_j)
    _close(ut, uj, what="u")
    _close(vt, vj, what="v")
    for i in range(3):
        _close(yt[i], yj[i], what=f"y_cf[{i}]")


@pytest.mark.parametrize("snavely", [False, True], ids=["pinhole", "snavely"])
def test_linearise(snavely):
    cam, lmk, meas, var, k, intr = _edge_inputs(snavely,
                                                np.random.default_rng(6))
    out_t = tpl.linearise(
        tpl.unpack_vec(torch.tensor(cam), 6),
        tpl.unpack_vec(torch.tensor(lmk), 3), k, torch.tensor(meas[0]),
        torch.tensor(meas[1]), torch.tensor(var), 2.5,
        None if intr is None else tpl.unpack_vec(torch.tensor(intr), 3))
    out_j = jpl.linearise(
        jpl.unpack_vec(jnp.asarray(cam), 6),
        jpl.unpack_vec(jnp.asarray(lmk), 3), jnp.asarray(k),
        jnp.asarray(meas[0]), jnp.asarray(meas[1]), jnp.asarray(var), 2.5,
        None if intr is None else jpl.unpack_vec(jnp.asarray(intr), 3))
    eta_c, eta_l, lam_cc, lam_cl, lam_ll, rob_t, _ = out_t
    eta_cj, eta_lj, lam_ccj, lam_clj, lam_llj, rob_j, _ = out_j
    # the Huber switch is a threshold on the residual: equal decisions
    np.testing.assert_array_equal(rob_t.numpy(), np.asarray(rob_j).reshape(-1))
    assert 0 < rob_t.numpy().sum() < N
    tol = 1e-4      # Jacobian products through sin/cos/sqrt of both stacks
    for i in range(6):
        _close(eta_c[i], eta_cj[i], rtol=tol, what=f"eta_c[{i}]")
        for j in range(3):
            _close(lam_cl[i][j], lam_clj[i][j], rtol=tol,
                   what=f"lam_cl[{i}][{j}]")
        for j in range(i + 1):
            _close(lam_cc[i][j], lam_ccj[i][j], rtol=tol,
                   what=f"lam_cc[{i}][{j}]")
    for i in range(3):
        _close(eta_l[i], eta_lj[i], rtol=tol, what=f"eta_l[{i}]")
        for j in range(i + 1):
            _close(lam_ll[i][j], lam_llj[i][j], rtol=tol,
                   what=f"lam_ll[{i}][{j}]")
