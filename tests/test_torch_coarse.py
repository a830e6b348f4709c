"""The port's coarse-space corrector (core/coarse.py, gbp._coarse_step and
its place in run_gbp) against the JAX package.

The increment is compared from the same state and means; the rigid bases
also against finite differences. ``_coarse_step`` and whole solves with
the accelerator and the corrector on are compared by their decisions and
errors. The decisions rest on float32 MAP-cost comparisons that the two
stacks add in other orders, so the solves here are chosen where the
margins are well above that agreement (noted per test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbp_poplar_tpu.config import GBPConfig as JaxConfig
from gbp_poplar_tpu.config import InitConfig as JaxInitConfig
from gbp_poplar_tpu.core import build_graph as jax_build_graph
from gbp_poplar_tpu.core import coarse as jax_coarse
from gbp_poplar_tpu.core import factor_graph as jax_fg
from gbp_poplar_tpu.core import gbp as jax_gbp
from gbp_poplar_tpu.core import init_state as jax_init_state
from gbp_poplar_tpu.ops import lie as jax_lie
from gbp_poplar_tpu.ops import projection as jax_projection
from gbp_poplar_tpu.utils import balio as jax_balio
from gbp_poplar_tpu.utils import priors as jax_priors
from gbp_poplar_tpu_torch import GBPConfig, InitConfig
from gbp_poplar_tpu_torch.core import coarse, gauss_newton
from gbp_poplar_tpu_torch.core import factor_graph as fg
from gbp_poplar_tpu_torch.core import gbp
from gbp_poplar_tpu_torch.utils import balio, priors

torch.set_num_threads(1)

# the increment, relative to its largest component: float32 assembly of a
# 18x18 system from per-edge products in another order (measured 3.2e-5)
INCREMENT_RTOL = 1e-3
# rigid bases: forward-mode derivatives of the same formulas (measured
# 2.4e-7)
BASIS_ATOL = 1e-5
# per-sweep reprojection error of whole solves with the corrector on
# (measured up to 1.1e-4 px on the conftest problem, 2.2e-5 px below)
SOLVE_ATOL_PX = 1e-3
# a decision whose cost margin is below this many float32 ulps is a tie
# that the two packages' summation orders may break either way
TIE_ULPS = 4
PAD = 256
G = 4
SCHEDULE = dict(accel_every=8, accel_start=10, coarse_groups=G)


def _jax_state(fields):
    return jax_fg.GBPState(**{f: jnp.asarray(fields[f])
                              for f in fg.STATE_FIELDS})


def _problem(name):
    """(port problem, JAX problem): ``small`` is synthetic_problem(6, 60);
    ``drift`` is 20 keyframes at Ladybug-like visibility (3,000 edges)
    with the cameras perturbed by 10 cm / 1 degree and the landmarks by
    5 cm, so the first coarse steps have a large group-level error to
    remove."""
    if name == "small":
        kw = dict(n_keyframes=6, n_points=60, seed=0, pixel_noise=0.5)
        return (balio.synthetic_problem(**kw),
                jax_balio.synthetic_problem(**kw))
    kw = dict(n_keyframes=20, n_points=600, obs_per_lmk=5, seed=0)
    noise = dict(trans_noise=0.1, rot_noise=1.0, lmk_noise=0.05, seed=0)
    return (priors.apply_init_noise(balio.synthetic_problem_large(**kw),
                                    InitConfig(**noise)),
            jax_priors.apply_init_noise(
                jax_balio.synthetic_problem_large(**kw),
                JaxInitConfig(**noise)))


@pytest.fixture(scope="module")
def swept():
    """The small problem after initialise + 30 JAX sweeps (the reference
    schedule, coarse_groups=3): (port problem, JAX graph, state fields)."""
    tp, jp = _problem("small")
    jc = JaxConfig(coarse_groups=3, edge_pad_multiple=64, accel_every=0)
    jg = jax_build_graph(jp, jc)
    js = jax.jit(lambda s: jax_gbp.initialise(s, jg, jc))(
        jax_init_state(jp, jc))
    js, _ = jax.jit(lambda s: jax_gbp.run_gbp(s, jg, jc, 30))(js)
    return tp, jg, {f: np.asarray(getattr(js, f)) for f in fg.STATE_FIELDS}


def _port(tp, fields, **kw):
    cfg = GBPConfig(coarse_groups=3, edge_pad_multiple=64, accel_every=0,
                    **kw)
    return (cfg, fg.build_graph(tp, cfg, "cpu"),
            fg.state_from_numpy(fields, "cpu"))


def test_rigid_bases_match_jax_and_finite_differences():
    rng = np.random.default_rng(0)
    cam = rng.normal(0, 0.3, (5, 6)).astype(np.float32)
    cam[0] = 0.0                 # the identity pose: so3_log's 0/0 guard
    s = coarse._cam_rigid_basis(torch.tensor(cam))
    assert s.shape == (5, 6, 6) and s.dtype == torch.float32
    np.testing.assert_allclose(
        s.numpy(), np.asarray(jax_coarse._cam_rigid_basis(jnp.asarray(cam))),
        rtol=0, atol=BASIS_ATOL)
    # moving the world content by G and the cameras by S xi leaves the
    # reprojection of co-moving points unchanged to first order
    xi = np.array([0.01, -0.02, 0.015, 0.01, -0.005, 0.02], np.float32)
    y = rng.normal(0, 1, (5, 3)).astype(np.float32) + 3.0
    k = np.array([[500., 0, 320], [0, 500, 240], [0, 0, 1]], np.float32)
    rg = np.asarray(jax_lie.so3_exp(jnp.asarray(xi[3:])))
    y_new = (rg @ y.T).T + xi[:3]
    cam_new = cam + np.einsum("cij,j->ci", s.numpy(), xi)
    uv0 = np.asarray(jax_projection.project(jnp.asarray(cam), jnp.asarray(y),
                                            jnp.asarray(k)))
    uv1 = coarse.projection.project(torch.tensor(cam_new), torch.tensor(y_new),
                                    k).numpy()
    np.testing.assert_allclose(uv1, uv0, rtol=0, atol=0.2)

    y = np.array([[1., 2., 3.], [0., -1., 2.]], np.float32)
    sl = coarse._lmk_rigid_basis(torch.tensor(y)).numpy()
    np.testing.assert_allclose(
        sl, np.asarray(jax_coarse._lmk_rigid_basis(jnp.asarray(y))),
        rtol=0, atol=0)
    xi = np.array([0.1, 0.2, -0.1, 0.05, -0.02, 0.03], np.float32)
    np.testing.assert_allclose(np.einsum("lij,j->li", sl, xi),
                               xi[:3] + np.cross(xi[3:], y),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("offset", [0.0, 0.05], ids=["at_means", "off"])
def test_coarse_increment_matches_jax(swept, offset):
    tp, jg, fields = swept
    js = _jax_state(fields)
    cam_mu, lmk_mu = jax_gbp._variable_means(js)
    cam_mu, lmk_mu = cam_mu + offset, lmk_mu + offset
    jc = JaxConfig(coarse_groups=3, edge_pad_multiple=64)
    want = jax_coarse.coarse_increment(js, jg, jc, cam_mu, lmk_mu)
    cfg, graph, state = _port(tp, fields)
    got = coarse.coarse_increment(state, graph, cfg,
                                  torch.tensor(np.asarray(cam_mu)),
                                  torch.tensor(np.asarray(lmk_mu)))
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert np.abs(w).max() > 1e-4          # a real increment
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=INCREMENT_RTOL * np.abs(w).max())


def test_increment_vanishes_at_the_lm_optimum(swept):
    """At the port's own LM solution of the same objective the coarse
    gradient is (numerically) zero, so the increment is small; away from
    it, it is decisively not (the JAX package's bounds)."""
    tp, _, fields = swept
    cfg, graph, state = _port(tp, fields)
    res = gauss_newton.solve_problem(tp, cfg, "cpu", n_lm_iters=40)
    d_cam, d_lmk = coarse.coarse_increment(state, graph, cfg, res.cam.T,
                                           res.lmk.T)
    assert d_cam.abs().max().item() < 0.05
    assert d_lmk.abs().max().item() < 0.05
    d_cam2, _ = coarse.coarse_increment(state, graph, cfg, res.cam.T + 0.3,
                                        res.lmk.T + 0.3)
    assert d_cam2.abs().max().item() > 0.1


def test_coarse_step_is_monotone_and_matches_jax():
    """From the drift problem's state after 18 JAX sweeps (the reference
    schedule) the port's step and the JAX step both apply the increment at
    scale 1 (the MAP cost falls by about 1.5 of 9.6e4, ~190 float32 ulps,
    and scale 1 beats 0.3 by ~90 ulps), the cost does not rise, and the
    shifted fields agree."""
    tp, jp = _problem("drift")
    jc = JaxConfig(edge_pad_multiple=PAD, **dict(SCHEDULE, accel_every=0))
    jg = jax_build_graph(jp, jc)
    js = jax.jit(lambda s: jax_gbp.initialise(s, jg, jc))(
        jax_init_state(jp, jc))
    js, _ = jax.jit(lambda s: jax_gbp.run_gbp(s, jg, jc, 18))(js)
    fields = {f: np.asarray(getattr(js, f)) for f in fg.STATE_FIELDS}

    cfg = GBPConfig(edge_pad_multiple=PAD, **dict(SCHEDULE, accel_every=0))
    graph = fg.build_graph(tp, cfg, "cpu")
    state = fg.state_from_numpy(fields, "cpu")
    degs = gbp._active_degrees(state, graph, cfg)
    c0 = gbp.map_cost(state, graph, cfg).item()
    state, info = gbp._coarse_step(state, graph, cfg, degs)
    c1 = gbp.map_cost(state, graph, cfg).item()
    assert np.isfinite(c1) and c1 <= c0
    assert float(info.gain) == 1.0
    margins = (info.cost_cur - info.cost_cand[0],
               info.cost_cand[1] - info.cost_cand[0])
    assert all(m.item() > 0.5 for m in margins), margins

    j_out = jax_gbp._coarse_step(
        js, jg, jc, jax_gbp._active_degrees(js, jg, None, False), None, False)
    out = fg.state_to_numpy(state)
    for f in ("cam_eta", "lmk_eta", "msg_c_eta", "msg_l_eta"):
        want = np.asarray(getattr(j_out, f))
        assert not np.array_equal(want, fields[f]), f
        np.testing.assert_allclose(out[f], want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=f)


def test_degenerate_edge_drops_only_itself(swept):
    """An edge whose landmark sits on its camera's plane (|z| ~ 1e-30, the
    Jacobian overflows) drops out of the reduced system alone: the
    increment stays finite and of the same size, not zeroed."""
    tp, _, fields = swept
    cfg, graph, state = _port(tp, fields)
    cam_mu, lmk_mu = gbp._variable_means(state)
    cam_mu, lmk_mu = cam_mu + 0.3, lmk_mu + 0.3
    d0, _ = coarse.coarse_increment(state, graph, cfg, cam_mu, lmk_mu)
    ref = d0.abs().max().item()
    assert ref > 0.05
    ci, li = int(graph.cam_idx[0]), int(graph.lmk_idx[0])
    x = cam_mu[:, ci].numpy()
    r = coarse.lie.so3_exp(torch.tensor(x[3:])).numpy()
    lmk_np = lmk_mu.numpy().copy()
    lmk_np[:, li] = r.T @ (np.array([0.1, 0.1, 1e-30], np.float32) - x[:3])
    d1, dl1 = coarse.coarse_increment(state, graph, cfg, cam_mu,
                                      torch.tensor(lmk_np))
    assert torch.isfinite(d1).all() and torch.isfinite(dl1).all()
    assert d1.abs().max().item() > 0.2 * ref


def test_group_sums_match_index_add(swept):
    """The coarse sums through the graph's group segments (the H3 path)
    equal ``index_add_`` keyed by the groups directly, over the real
    edges, to the last bit on the CPU, and repeat exactly."""
    tp, _, _ = swept
    cfg = GBPConfig(coarse_groups=3)
    graph = fg.build_graph(tp, cfg, "cpu")
    segs = coarse.group_segments(graph, 3)
    assert coarse.group_segments(graph, 3) is segs        # built once
    n = tp.n_edges
    x = torch.tensor(np.random.default_rng(1).normal(
        0, 1, (graph.n_edges, 6, 6)).astype(np.float32))
    ga = segs.g_cam[graph.cam_idx.long()][:n]
    gb = segs.g_lmk[graph.lmk_idx.long()][:n]
    for seg, key, nv in ((segs.edge_cam, ga, 3), (segs.edge_lmk, gb, 3),
                         (segs.edge_pair, ga * 3 + gb, 9)):
        want = torch.zeros((nv, 6, 6)).index_add_(0, key, x[:n])
        got = coarse._group_sum(x, seg, ref=False)
        assert torch.equal(got, want)
        assert torch.equal(coarse._group_sum(x, seg, ref=False), got)
    lmk_x = x[:graph.n_points]
    want = torch.zeros((3, 6, 6)).index_add_(0, segs.g_lmk, lmk_x)
    assert torch.equal(coarse._group_sum(lmk_x, segs.lmk, ref=False), want)


def _jax_run_with_decisions(jp, jc, n_iters, chunk=None):
    """JAX run_gbp on ``jp``: (per-sweep errors, [(kind, moved)] per
    accelerator and coarse step). With ``chunk``, run as the JAX ba driver
    does: jitted spans of ``chunk`` sweeps with a traced offset and a
    static warm-up length."""
    rec = []
    real_c, real_a = jax_gbp._coarse_step, jax_gbp._accel_step

    def record(kind, old, new):
        jax.debug.callback(lambda m: rec.append((kind, bool(m))),
                           jnp.any(new.cam_eta != old.cam_eta))

    def c_spy(state, *a, **k):
        out = real_c(state, *a, **k)
        record("coarse", state, out)
        return out

    def a_spy(state, *a, **k):
        out = real_a(state, *a, **k)
        record("accel", state, out[0])
        return out

    jg = jax_build_graph(jp, jc)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_gbp, "_coarse_step", c_spy)
        mp.setattr(jax_gbp, "_accel_step", a_spy)
        s = jax.jit(lambda s: jax_gbp.initialise(s, jg, jc))(
            jax_init_state(jp, jc))
        if chunk is None:
            _, d = jax.jit(lambda s: jax_gbp.run_gbp(s, jg, jc, n_iters))(s)
            errs = [np.asarray(d.reproj_err)]
        else:
            run = jax.jit(lambda s, off, n, warm: jax_gbp.run_gbp(
                s, jg, jc, n, iter_offset=off, warm=warm),
                static_argnums=(2, 3))
            errs = []
            for i in range(0, n_iters, chunk):
                n = min(chunk, n_iters - i)
                s, d = run(s, jnp.asarray(i, jnp.int32), n,
                           min(n, max(0, 2 * jc.steps - i)))
                errs.append(np.asarray(d.reproj_err))
            jax.effects_barrier()
    return np.concatenate(errs), rec


def _port_run(tp, n_iters, chunk=None, **schedule):
    cfg = GBPConfig(edge_pad_multiple=PAD, **dict(SCHEDULE, **schedule))
    graph = fg.build_graph(tp, cfg, "cpu")
    s = gbp.initialise(fg.init_state(tp, cfg, "cpu"), graph, cfg)
    chunk = chunk or n_iters
    errs, log = [], []
    for i in range(0, n_iters, chunk):
        s, d = gbp.run_gbp(s, graph, cfg, min(chunk, n_iters - i),
                           iter_offset=i, accel_log=log)
        errs.append(d.reproj_err.numpy())
    decisions = []
    for _, info in log:
        decisions.append(("accel", bool(info.accepted)
                          and float(info.gain) > 0))
        decisions.append(("coarse", float(info.coarse.gain) > 0))
    return np.concatenate(errs), log, decisions


def test_run_gbp_with_coarse_matches_jax():
    """32 sweeps of the drift problem with the accelerator and the coarse
    corrector (4 groups) every 8 sweeps from sweep 10: the same decisions
    as the JAX package (no aligned displacement at sweeps 18 and 26; the
    coarse step accepted at scale 1 both times, lowering the MAP cost by
    1.46 and 0.13 of 9.6e4, 190 and 17 float32 ulps) and the same
    per-sweep error."""
    tp, jp = _problem("drift")
    want, j_dec = _jax_run_with_decisions(
        jp, JaxConfig(edge_pad_multiple=PAD, **SCHEDULE), 32)
    err, log, dec = _port_run(tp, 32)
    assert [n for n, _ in log] == [18, 26]
    assert dec == j_dec
    assert [float(i.coarse.gain) for _, i in log] == [1.0, 1.0]
    assert err.shape == (32,) and err[-1] < err[0]
    np.testing.assert_allclose(err, want, rtol=0, atol=SOLVE_ATOL_PX)


def _ulps(a, b) -> float:
    """|a - b| in float32 ulps of ``a``."""
    return abs(float(a) - float(b)) / float(np.spacing(np.float32(abs(
        float(a)))))


def _clear_decisions(log):
    """The port's decisions up to the first one taken by fewer than
    TIE_ULPS float32 ulps of the MAP cost (an accelerator candidate with
    gain > 0 against the current cost; the coarse step's best candidate
    against the cost it had to beat). Past such a tie the two packages
    may decide either way and then sit on states ulps apart."""
    out = []
    for _, info in log:
        if float(info.gain) > 0 and _ulps(info.cost_cur,
                                          info.cost_cand) < TIE_ULPS:
            break
        out.append(("accel", bool(info.accepted) and float(info.gain) > 0))
        c = info.coarse
        if _ulps(c.cost_cur, c.cost_cand.min()) < TIE_ULPS:
            break
        out.append(("coarse", float(c.gain) > 0))
    return out


def test_driver_schedule_matches_jax_traced_offset():
    """The ba driver's schedule: spans of 4 * accel_every sweeps, one
    run_gbp call each. The JAX driver jits a span with a traced offset: no
    static dead-chunk elision, so a chunk that ends before accel_start
    runs both steps gated (gain 0, its displacement kept); the port passes
    the offset as an int and elides that chunk. With accel_start 20, two
    spans of 32 sweeps: JAX gates the steps after sweep 18 (no move); the
    port steps after 26, 40, 48, 56 and 64, with the JAX package's
    decisions up to the first float32 tie (the coarse step after sweep 48
    lowers the cost by 2 ulps), and every per-sweep error agrees."""
    tp, jp = _problem("drift")
    sched = dict(SCHEDULE, accel_start=20)
    want, j_dec = _jax_run_with_decisions(
        jp, JaxConfig(edge_pad_multiple=PAD, **sched), 64, chunk=32)
    err, log, _ = _port_run(tp, 64, chunk=32, accel_start=20)
    assert [n for n, _ in log] == [26, 40, 48, 56, 64]
    assert j_dec[:2] == [("accel", False), ("coarse", False)]
    clear = _clear_decisions(log)
    assert len(clear) >= 4                     # the steps after 26 and 40
    assert j_dec[2:2 + len(clear)] == clear
    np.testing.assert_allclose(err, want, rtol=0, atol=SOLVE_ATOL_PX)
