"""The port's library utilities against the JAX package on the same inputs:
dense linear algebra and transforms, the dense factor linearisation, prior
re-centring and weakening, known-bad association masks, KL divergences and
message traces, and the edge dump.

JAX runs on its XLA path; states come across by ``state_from_numpy``.
Tolerances, each against the JAX function:
  - to the bit: ``bad_edge_mask``, ``recenter_priors`` (the products are
    separate elementwise operations in both packages), ``dump_edge`` and
    ``save_beliefs`` (copies), the masked error's exclusion;
  - INV_RTOL_PER_COND times the condition number (of the largest entry):
    ``inv6x6`` / ``inf_to_mean`` on SPD blocks with condition numbers 10,
    1e3 and 1e5; ``inv6x6`` unrolls the same equilibrated Cholesky, but
    the equilibration's reciprocal square root and the closing matrix
    product round differently, which the condition number amplifies
    (measured: 1.6e-8 x cond); ``inv6x6_cholesky_ex`` (the library
    factorisation) within the same bound (measured 2.4e-8 x cond);
  - SWEEP_RTOL (of a field's largest magnitude): ``weaken_priors``, whose
    belief sums add in other orders;
  - ERR_RTOL: masked reprojection error and MAP cost;
  - LIN_RTOL: the linearisation and the transforms (sin/cos, matrix
    products in other orders);
  - KL_RTOL: KL divergences of well-conditioned Gaussians.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbp_poplar_tpu.config import GBPConfig as JaxConfig
from gbp_poplar_tpu.core import build_graph as jax_build_graph
from gbp_poplar_tpu.core import gbp as jax_gbp
from gbp_poplar_tpu.core import init_state as jax_init_state
from gbp_poplar_tpu.core.factor_graph import bad_edge_mask as jax_bad_mask
from gbp_poplar_tpu.ops import lie as jax_lie
from gbp_poplar_tpu.ops import linalg as jax_linalg
from gbp_poplar_tpu.ops import projection as jax_projection
from gbp_poplar_tpu.utils import analysis as jax_analysis
from gbp_poplar_tpu.utils import balio as jax_balio
from gbp_poplar_tpu.utils import debug as jax_debug
from gbp_poplar_tpu_torch import GBPConfig
from gbp_poplar_tpu_torch.core import factor_graph as fg
from gbp_poplar_tpu_torch.core import gbp
from gbp_poplar_tpu_torch.ops import lie, linalg, projection
from gbp_poplar_tpu_torch.ops import planes as pl
from gbp_poplar_tpu_torch.utils import analysis, balio, debug, evaluation

torch.set_num_threads(1)

INV_RTOL_PER_COND = 1e-7
SWEEP_RTOL = 1e-5
ERR_RTOL = 1e-5
LIN_RTOL = 1e-4
KL_RTOL = 1e-4

K = np.array([[517.3, 0.0, 318.6], [0.0, 516.5, 255.3], [0.0, 0.0, 1.0]],
             np.float32)


def _fields(s):
    return {f: np.asarray(getattr(s, f)) for f in fg.STATE_FIELDS}


@pytest.fixture(scope="module")
def swept():
    """The pinhole synthetic problem in both packages and the JAX state
    after initialise (``init``) and after one more sweep (``swept``), each
    with its port copy."""
    kw = dict(n_keyframes=6, n_points=60, seed=0, pixel_noise=0.5)
    tp, jp = balio.synthetic_problem(**kw), jax_balio.synthetic_problem(**kw)
    jc = JaxConfig(use_pallas=False)
    jg = jax_build_graph(jp, jc)
    ji = jax.jit(lambda s: jax_gbp.initialise(s, jg, jc))(
        jax_init_state(jp, jc))
    js = jax.jit(lambda s: jax_gbp.gbp_sweep(s, jg, jc))(ji)
    cfg = GBPConfig()
    graph = fg.build_graph(tp, cfg, "cpu")
    return dict(tp=tp, jp=jp, jc=jc, jg=jg, ji=ji, js=js, cfg=cfg,
                graph=graph)


def _port(s):
    return fg.state_from_numpy(_fields(s), "cpu")


def _random_spd(rng, n, d, cond):
    """SPD [n, d, d] with eigenvalues spread log-uniformly over ``cond``,
    in random bases, scaled by up to 1e4."""
    q, _ = np.linalg.qr(rng.normal(size=(n, d, d)))
    ev = np.exp(rng.uniform(0, np.log(cond), (n, d)))
    scale = np.exp(rng.uniform(0, np.log(1e4), (n, 1, 1)))
    return (q * ev[:, None, :]) @ np.swapaxes(q, 1, 2) * scale


# ---------------------------------------------------------------------------
# ops: linalg, lie, projection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cond", [10.0, 1e3, 1e5])
def test_port_inv6x6_and_inf_to_mean_match_jax(cond):
    rng = np.random.default_rng(int(cond))
    lam = _random_spd(rng, 64, 6, cond).astype(np.float32)
    eta = rng.normal(size=(64, 6)).astype(np.float32)
    mu, sig = linalg.inf_to_mean(torch.tensor(eta), torch.tensor(lam))
    jmu, jsig = jax_linalg.inf_to_mean(jnp.asarray(eta), jnp.asarray(lam))
    jsig, jmu = np.asarray(jsig), np.asarray(jmu)
    rtol = INV_RTOL_PER_COND * cond
    scale = np.abs(jsig).max(axis=(1, 2), keepdims=True)
    assert (np.abs(sig.numpy() - jsig) <= rtol * scale).all()
    assert (np.abs(mu.numpy() - jmu)
            <= rtol * np.abs(jmu).max(axis=1, keepdims=True)).all()
    np.testing.assert_array_equal(
        linalg.inf_to_mu(torch.tensor(eta), torch.tensor(lam)).numpy(),
        mu.numpy())
    lib = linalg.inv6x6_cholesky_ex(torch.tensor(lam)).numpy()
    assert (np.abs(lib - jsig) <= rtol * scale).all()
    # not positive definite: NaN, as the JAX function's negative pivot
    bad = lam.copy()
    bad[0, 2, 2] = -1.0
    jbad = np.asarray(jax_linalg.inv6x6(jnp.asarray(bad)))
    assert np.isnan(jbad[0]).any() and np.isfinite(jbad[1:]).all()
    for inv in (linalg.inv6x6, linalg.inv6x6_cholesky_ex):
        out = inv(torch.tensor(bad)).numpy()
        assert np.isnan(out[0]).any() and np.isfinite(out[1:]).all()
        np.testing.assert_array_equal(np.isnan(out), np.isnan(jbad))


def test_port_inv3x3_bmm_bmv_match_jax():
    rng = np.random.default_rng(7)
    a = (rng.normal(size=(16, 3, 3)) + 3 * np.eye(3)).astype(np.float32)
    np.testing.assert_allclose(linalg.inv3x3(torch.tensor(a)).numpy(),
                               np.asarray(jax_linalg.inv3x3(jnp.asarray(a))),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(linalg.inv_dxd(torch.tensor(a)).numpy(),
                               np.linalg.inv(a), rtol=2e-3, atol=1e-4)
    b = rng.normal(size=(16, 3, 5)).astype(np.float32)
    v = rng.normal(size=(16, 3)).astype(np.float32)
    np.testing.assert_allclose(
        linalg.bmm(torch.tensor(a), torch.tensor(b)).numpy(),
        np.asarray(jax_linalg.bmm(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        linalg.bmv(torch.tensor(a), torch.tensor(v)).numpy(),
        np.asarray(jax_linalg.bmv(jnp.asarray(a), jnp.asarray(v))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(linalg.transpose(torch.tensor(b)).numpy(),
                                  np.swapaxes(b, -1, -2))


def test_port_lie_transforms_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 0.7, (10, 6)).astype(np.float32)
    x[0, 3:] = 0.0                                  # the identity rotation
    xt, xj = torch.tensor(x), jnp.asarray(x)
    for ours, theirs in ((lie.tranf_w2c(xt), jax_lie.tranf_w2c(xj)),
                         (lie.tranf_c2w(xt), jax_lie.tranf_c2w(xj)),
                         (lie.optic_axis_point_world(xt, 2.5),
                          jax_lie.optic_axis_point_world(xj, 2.5)),
                         (lie.optic_axis_point_world(xt),
                          jax_lie.optic_axis_point_world(xj))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=LIN_RTOL, atol=LIN_RTOL)
    # T_c2w inverts T_w2c; the optic-axis point sits at the depth asked
    eye = lie.tranf_c2w(xt) @ lie.tranf_w2c(xt)
    np.testing.assert_allclose(eye.numpy(), np.broadcast_to(np.eye(4),
                                                            eye.shape),
                               atol=1e-5)
    p = lie.optic_axis_point_world(xt, 2.5)
    np.testing.assert_allclose(lie.w2c_apply(xt, p).numpy()[:, 2], 2.5,
                               rtol=1e-5)


def _edges(rng, n):
    cam = rng.normal(size=(n, 6)).astype(np.float32)
    cam[:, 3:] *= 0.5
    cam[:, :3] *= 0.2
    lmk = rng.normal(size=(n, 3)).astype(np.float32)
    lmk[:, 2] += 4.0
    return cam, lmk


def test_port_linearise_factor_consistency():
    """tests/test_projection.py's consistency test on the port: at zero
    residual eta = Lambda x0; the Lambda blocks are symmetric and PSD."""
    cam, lmk = _edges(np.random.default_rng(42), 6)
    cam, lmk = torch.tensor(cam), torch.tensor(lmk)
    meas = projection.project(cam, lmk, K)
    var = torch.full((6,), 4.0)
    pot, robust = projection.linearise_factor(cam, lmk, K, meas, var, 2.5)
    assert not robust.any()
    want = linalg.bmv(pot.lam_cc, cam) + linalg.bmv(pot.lam_cl, lmk)
    np.testing.assert_allclose(pot.eta_c.numpy(), want.numpy(), rtol=1e-3,
                               atol=1e-2)
    np.testing.assert_allclose(pot.lam_cc.numpy(),
                               pot.lam_cc.transpose(-1, -2).numpy(),
                               rtol=1e-5, atol=1e-5)
    eigs = np.linalg.eigvalsh(pot.lam_cc.numpy())
    assert (eigs > -1e-5 * eigs.max(axis=-1, keepdims=True)).all()


@pytest.mark.parametrize("model", ["pinhole", "snavely"])
def test_port_linearise_factor_matches_jax(model):
    rng = np.random.default_rng(11)
    cam = np.concatenate([rng.normal(0, 0.2, (32, 3)),
                          rng.normal(0, 0.1, (32, 3))], 1).astype(np.float32)
    lmk = np.concatenate([rng.uniform(-1, 1, (32, 2)),
                          rng.uniform(4, 8, (32, 1))], 1).astype(np.float32)
    intr = None
    if model == "snavely":
        lmk[:, 2] *= -1.0                           # in front: z < 0
        intr = np.stack([rng.uniform(450, 550, 32), np.full(32, -0.3),
                         np.full(32, 0.1)], 1).astype(np.float32)
    # measurements off by N(0, 4 px): about half the edges are robust
    # (beyond 2.5 sigma = 5 px)
    base = np.asarray(jax_projection.project(
        jnp.asarray(cam), jnp.asarray(lmk), jnp.asarray(K),
        None if intr is None else jnp.asarray(intr)))
    meas = (base + rng.normal(0, 4, base.shape)).astype(np.float32)
    var = np.full(32, 4.0, np.float32)
    pot, robust = projection.linearise_factor(
        torch.tensor(cam), torch.tensor(lmk), K, torch.tensor(meas),
        torch.tensor(var), 2.5, None if intr is None else torch.tensor(intr))
    jpot, jrobust = jax_projection.linearise_factor(
        jnp.asarray(cam), jnp.asarray(lmk), jnp.asarray(K), jnp.asarray(meas),
        jnp.asarray(var), 2.5, None if intr is None else jnp.asarray(intr))
    np.testing.assert_array_equal(robust.numpy(), np.asarray(jrobust))
    assert 0 < int(robust.sum()) < 32
    for f in projection.FactorPotential._fields:
        a, b = getattr(pot, f).numpy(), np.asarray(getattr(jpot, f))
        assert a.shape == b.shape, f
        scale = np.abs(b).reshape(32, -1).max(axis=1)
        scale = scale.reshape((32,) + (1,) * (b.ndim - 1))
        assert (np.abs(a - b) <= LIN_RTOL * scale).all(), f


# ---------------------------------------------------------------------------
# core: priors, bad associations
# ---------------------------------------------------------------------------

def test_port_recenter_priors_matches_jax(swept):
    """recenter_priors from a float64 input: the prior etas equal the JAX
    package's to the bit (both cast to float32 before the product); the
    Lambdas and the omitted kind untouched; the means solve back."""
    ji, tp = swept["ji"], swept["tp"]
    rng = np.random.default_rng(3)
    cam_mu = rng.normal(0, 1, (tp.n_keyframes, 6))
    lmk_mu = rng.normal(0, 3, (tp.n_points, 3))
    before = _port(ji)
    for kw in (dict(cam_mu=cam_mu), dict(lmk_mu=lmk_mu),
               dict(cam_mu=cam_mu, lmk_mu=lmk_mu)):
        got = fg.state_to_numpy(gbp.recenter_priors(_port(ji), **kw))
        want = _fields(jax_gbp.recenter_priors(ji, **kw))
        for f in ("cam_prior_eta", "cam_prior_lam", "lmk_prior_eta",
                  "lmk_prior_lam"):
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    s = gbp.recenter_priors(_port(ji), cam_mu=cam_mu)
    back = pl.pack_vec(pl.solve_sym(pl.unpack_sym(s.cam_prior_lam, 6),
                                    pl.unpack_vec(s.cam_prior_eta, 6))).T
    np.testing.assert_allclose(back.numpy(), cam_mu, rtol=1e-4, atol=1e-5)
    assert torch.equal(s.cam_prior_lam, before.cam_prior_lam)
    assert torch.equal(s.lmk_prior, before.lmk_prior)
    s2 = gbp.recenter_priors(_port(ji))
    assert torch.equal(s2.cam_prior, before.cam_prior)


def test_port_weaken_priors_matches_jax(swept):
    """weaken_priors on the initialised state, twice: every field within
    SWEEP_RTOL of the JAX package's (its XLA belief update: the graph has
    far fewer than 131,072 edges), the flags equal."""
    ji, jg, graph, cfg = swept["ji"], swept["jg"], swept["graph"], swept["cfg"]
    assert graph.n_edges < 1 << 17
    s = _port(ji)
    jw = ji
    for _ in range(2):
        s = gbp.weaken_priors(s, graph, cfg)
        jw = jax_gbp.weaken_priors(jw, jg)
        got, want = fg.state_to_numpy(s), _fields(jw)
        for f in fg.STATE_FIELDS:
            a, b = got[f], want[f]
            if b.dtype.kind in "biu":
                np.testing.assert_array_equal(a, b, err_msg=f)
            else:
                np.testing.assert_allclose(
                    a, b, rtol=SWEEP_RTOL,
                    atol=SWEEP_RTOL * max(np.abs(b).max(), 1e-30), err_msg=f)
    assert (got["cam_weaken"] < _fields(ji)["cam_weaken"]).any()


def test_port_bad_associations_match_jax(swept):
    """tests/test_utils_aux.py's bad-association test on the port, plus the
    mask, the masked error and the masked MAP cost against the JAX
    package's."""
    tp, jp, js, jg = swept["tp"], swept["jp"], swept["js"], swept["jg"]
    graph, cfg, jc = swept["graph"], swept["cfg"], swept["jc"]
    state = _port(js)
    bad_ids = [0, 7, tp.n_edges - 1]
    mask = fg.bad_edge_mask(tp, bad_ids, cfg)
    jmask = jax_bad_mask(jp, bad_ids, jc)
    assert mask.dtype == jmask.dtype == bool
    np.testing.assert_array_equal(mask, jmask)
    assert mask.shape[0] == graph.n_edges and mask.sum() == len(bad_ids)
    bad = torch.as_tensor(mask)

    err_all, cost_all = map(float, gbp.reprojection_error(state, graph))
    err_ex, cost_ex = map(float, gbp.reprojection_error(state, graph,
                                                        bad=bad))
    assert cost_ex < cost_all and err_ex != err_all
    jerr, jcost = map(float, jax_gbp.reprojection_error(
        js, jg, bad=jnp.asarray(mask)))
    np.testing.assert_allclose([err_ex, cost_ex], [jerr, jcost],
                               rtol=ERR_RTOL)
    # an empty list changes nothing
    none = torch.as_tensor(fg.bad_edge_mask(tp, [], cfg))
    assert [float(x) for x in gbp.reprojection_error(state, graph, none)] \
        == [err_all, cost_all]
    assert gbp.map_cost(state, graph, cfg, none).item() == \
        gbp.map_cost(state, graph, cfg).item()

    cam_mu, lmk_mu = analysis.belief_means(state)
    o_err, _ = evaluation.numpy_reprojection_error(
        cam_mu, lmk_mu, tp, bad_associations=bad_ids)
    assert abs(o_err - err_ex) < 1e-3

    # the data term drops the excluded edges (priors zeroed, so the
    # quadratic cannot swamp the Huber sum in float32)
    s0 = _port(js)
    s0.cam_prior.zero_()
    s0.lmk_prior.zero_()
    c_all = gbp.map_cost(s0, graph, cfg).item()
    c_ex = gbp.map_cost(s0, graph, cfg, bad=bad).item()
    assert c_ex < c_all
    j0 = js._replace(**{f: jnp.zeros_like(getattr(js, f)) for f in (
        "cam_prior_eta", "cam_prior_lam", "lmk_prior_eta", "lmk_prior_lam")})
    np.testing.assert_allclose(
        c_ex, float(jax_gbp.map_cost(j0, jg, jc, bad=jnp.asarray(mask))),
        rtol=ERR_RTOL)
    np.testing.assert_allclose(
        gbp.map_cost(state, graph, cfg, bad).item(),
        float(jax_gbp.map_cost(js, jg, jc, bad=jnp.asarray(mask))),
        rtol=ERR_RTOL)
    for ids in ([tp.n_edges], [-1]):
        with pytest.raises(ValueError):
            fg.bad_edge_mask(tp, ids, cfg)


# ---------------------------------------------------------------------------
# utils: analysis, debug
# ---------------------------------------------------------------------------

def test_port_kl_divergence_properties_and_jax():
    """tests/test_utils_aux.py's KL test on the port, and both divergences
    against the JAX package's on the same inputs."""
    rng = np.random.default_rng(1)
    a = rng.normal(0, 1, (5, 3, 3))
    lam0 = a @ np.transpose(a, (0, 2, 1)) + 3 * np.eye(3)
    eta0 = rng.normal(0, 1, (5, 3))
    lam1, eta1 = lam0 * 1.5, eta0 + 0.3
    t = [torch.tensor(x, dtype=torch.float32) for x in (eta0, lam0, eta1,
                                                        lam1)]
    j = [jnp.asarray(x, jnp.float32) for x in (eta0, lam0, eta1, lam1)]
    np.testing.assert_allclose(
        analysis.kl_divergence(t[0], t[1], t[0], t[1]).numpy(), 0.0,
        atol=1e-4)
    kl01 = analysis.kl_divergence(*t).numpy()
    assert (kl01 > 0).all()
    s01 = analysis.symmetric_kl(*t).numpy()
    s10 = analysis.symmetric_kl(t[2], t[3], t[0], t[1]).numpy()
    np.testing.assert_allclose(s01, s10, rtol=1e-5)
    np.testing.assert_allclose(kl01, np.asarray(jax_analysis.kl_divergence(
        *j)), rtol=KL_RTOL)
    np.testing.assert_allclose(s01, np.asarray(jax_analysis.symmetric_kl(
        *j)), rtol=KL_RTOL)

    l0, l1 = lam0[0], lam1[0]
    s0, s1 = np.linalg.inv(l0), np.linalg.inv(l1)
    d = s1 @ eta1[0] - s0 @ eta0[0]
    kl_np = 0.5 * (np.trace(l1 @ s0) + d @ l1 @ d - 3
                   + np.log(np.linalg.det(s1) / np.linalg.det(s0)))
    np.testing.assert_allclose(kl01[0], kl_np, rtol=1e-3)

    # 6x6 (the Cholesky inverse) against JAX on well-conditioned blocks
    c0, c1 = (_random_spd(rng, 8, 6, 100.0) for _ in range(2))
    e0, e1 = rng.normal(0, 30, (8, 6)), rng.normal(0, 30, (8, 6))
    ours = analysis.symmetric_kl(*(torch.tensor(x, dtype=torch.float32)
                                   for x in (e0, c0, e1, c1))).numpy()
    theirs = np.asarray(jax_analysis.symmetric_kl(
        *(jnp.asarray(x, jnp.float32) for x in (e0, c0, e1, c1))))
    np.testing.assert_allclose(ours, theirs, rtol=KL_RTOL)


def _with_messages(state, rng, port):
    """``state`` with well-conditioned random message precisions (SPD,
    condition number 100) and etas, the same for the JAX state and its
    port copy given the same generator state."""
    e = state.pk.shape[1] if port else state.msg_c_lam.shape[1]
    c6 = _random_spd(rng, e, 6, 100.0)
    c3 = _random_spd(rng, e, 3, 100.0)
    e6, e3 = rng.normal(0, 30, (6, e)), rng.normal(0, 30, (3, e))
    p6 = np.stack([c6[:, i, j] for (i, j) in pl.SYM6_IDX]).astype(np.float32)
    p3 = np.stack([c3[:, i, j] for (i, j) in pl.SYM3_IDX]).astype(np.float32)
    if port:
        for name, x in (("msg_c_lam", p6), ("msg_l_lam", p3),
                        ("msg_c_eta", e6), ("msg_l_eta", e3)):
            getattr(state, name).copy_(torch.tensor(x, dtype=torch.float32))
        return state
    return state._replace(msg_c_lam=jnp.asarray(p6), msg_l_lam=jnp.asarray(p3),
                          msg_c_eta=jnp.asarray(e6, jnp.float32),
                          msg_l_eta=jnp.asarray(e3, jnp.float32))


def test_port_message_traces_match_jax(swept, tmp_path):
    """message_kl_trace on well-conditioned messages within KL_RTOL of the
    JAX package's; on the solver's own messages (rank 2, see
    utils/analysis.py) the camera side is NaN exactly where the JAX
    package's is. message_norms and save_beliefs against JAX's."""
    ji, js = swept["ji"], swept["js"]
    jprev = _with_messages(ji, np.random.default_rng(5), port=False)
    jcur = _with_messages(js, np.random.default_rng(6), port=False)
    prev = _with_messages(_port(ji), np.random.default_rng(5), port=True)
    cur = _with_messages(_port(js), np.random.default_rng(6), port=True)
    ours = analysis.message_kl_trace(prev, cur)
    theirs = jax_analysis.message_kl_trace(jprev, jcur)
    for k in ("to_cam", "to_lmk"):
        assert ours[k].shape == (swept["graph"].n_edges,)
        assert np.isfinite(ours[k]).all() and (ours[k] > 0).all()
        np.testing.assert_allclose(ours[k], theirs[k], rtol=KL_RTOL)

    real_prev = _port(js)
    real = gbp.gbp_sweep(_port(js), swept["graph"], swept["cfg"])
    jnext = jax.jit(lambda s: jax_gbp.gbp_sweep(s, swept["jg"],
                                                swept["jc"]))(js)
    ours = analysis.message_kl_trace(real_prev, real)
    theirs = jax_analysis.message_kl_trace(js, jnext)
    np.testing.assert_array_equal(np.isnan(ours["to_cam"]),
                                  np.isnan(theirs["to_cam"]))
    assert np.isnan(ours["to_cam"]).any()

    norms, jnorms = analysis.message_norms(real), jax_analysis.message_norms(
        jnext)
    for k in ("to_cam", "to_lmk"):
        np.testing.assert_allclose(norms[k], jnorms[k], rtol=SWEEP_RTOL,
                                   atol=SWEEP_RTOL * jnorms[k].max())
    analysis.save_beliefs(str(tmp_path / "a.npz"), _port(js))
    jax_analysis.save_beliefs(str(tmp_path / "b.npz"), js)
    a, b = np.load(tmp_path / "a.npz"), np.load(tmp_path / "b.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        assert a[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_port_dump_edge_matches_jax(swept, capsys):
    """dump_edge equals the JAX package's on the same state, key by key,
    in value and type; print_edge prints it."""
    js, jg, graph = swept["js"], swept["jg"], swept["graph"]
    state = _port(js)
    for e in (0, 3, 101, swept["tp"].n_edges - 1, graph.n_edges - 1):
        ours = debug.dump_edge(state, graph, e)
        theirs = jax_debug.dump_edge(js, jg, e)
        assert list(ours) == list(theirs)
        for k, v in theirs.items():
            assert type(ours[k]) is type(v), k
            if isinstance(v, np.ndarray):
                assert ours[k].dtype == v.dtype and ours[k].shape == v.shape
                np.testing.assert_array_equal(ours[k], v, err_msg=k)
            else:
                assert ours[k] == v, k
    info = debug.dump_edge(state, graph, 3)
    assert info["f_lam_cc"].shape == (6, 6) and info["f_lam_cl"].shape == (6,
                                                                           3)
    np.testing.assert_array_equal(info["f_lam_cc"], info["f_lam_cc"].T)
    assert np.isfinite(info["msg_to_cam_eta"]).all()
    debug.print_edge(state, graph, 3)
    out = capsys.readouterr().out
    assert out.startswith(f"edge 3: cam {info['cam']} <-> lmk {info['lmk']}")
