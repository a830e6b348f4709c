"""The port's incremental SLAM (core/slam.py) and the gn schedule's edge
branches against the JAX package.

States are carried across with ``state_from_numpy``; the JAX package runs
on its XLA path (the CPU default). One keyframe insertion and one masked
relinearisation are compared field by field: float fields within
SWEEP_RTOL of the field's largest magnitude (the stacks round sin/cos/sqrt
and sum the belief reductions differently), discrete fields equal.
``edge_math`` is compared under the SLAM driver's config (relinearise every
sweep, one-sided depth guard, settled-edge rescue) on a state built so that
every branch of that config is taken. Whole SLAM solves are compared by
outcome, the error at the end of every segment. The four fast tests of
tests/test_slam.py are mirrored on the port (three as ``test_port_*``: the
conftest tiers the JAX ones slow by name, and the port's take seconds).
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
from gbp_poplar_tpu.core import slam as jax_slam
from gbp_poplar_tpu.utils import balio as jax_balio
from gbp_poplar_tpu.utils import flags as jax_flags
from gbp_poplar_tpu_torch import GBPConfig, solve_slam
from gbp_poplar_tpu_torch.core import factor_graph as fg
from gbp_poplar_tpu_torch.core import gbp, slam
from gbp_poplar_tpu_torch.ops import planes as pl
from gbp_poplar_tpu_torch.utils import balio, flags

torch.set_num_threads(1)

SWEEP_RTOL = 1e-5
# final error of every segment of a whole SLAM solve: both packages follow
# the same trajectory to float32 noise (measured: 6e-5 px at most)
SOLVE_ATOL_PX = 0.01
SOLVE_RTOL = 0.01
AV_DEPTH = 6.0           # the synthetic cloud sits at z in [4, 8]
WARM_SWEEPS = 40

# the slam driver's default schedule (drivers/slam.py of both packages)
SLAM_KW = dict(relin_every_iter=True, eta_damping=0.7, lambda_damping=True,
               iters_before_damping=0, relin_behind_camera=False,
               behind_camera_rescue_iters=300)
SCHEDULES = {"gn": SLAM_KW, "reference": {}}


def _problems():
    kw = dict(n_keyframes=6, n_points=60, seed=2, pixel_noise=0.5)
    return balio.synthetic_problem(**kw), jax_balio.synthetic_problem(**kw)


def _fields(js):
    return {f: np.array(getattr(js, f)) for f in fg.STATE_FIELDS}


def _assert_state_close(out, want, rtol=SWEEP_RTOL):
    for f in fg.STATE_FIELDS:
        a, b = want[f], out[f]
        assert a.shape == b.shape, f
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            np.testing.assert_allclose(
                b, a, rtol=rtol, atol=rtol * max(np.abs(a).max(), 1e-30),
                err_msg=f)


@pytest.fixture(scope="module")
def warmed():
    """Per schedule: (port problem, port graph, JAX graph, JAX config, JAX
    SLAM state after initialise + WARM_SWEEPS sweeps on keyframes 0, 1)."""
    tp, jp = _problems()
    out = {}
    for name, kw in SCHEDULES.items():
        jc = JaxConfig(**kw)
        jg = jax_build_graph(jp, jc)
        js = jax_init_state(jp, jc, flags=jax_flags.create_flags(jp, jc.steps))
        js = jax.jit(lambda s, jg=jg, jc=jc: jax_gbp.run_gbp(
            jax_gbp.initialise(s, jg, jc), jg, jc, WARM_SWEEPS,
            with_diagnostics=False)[0])(js)
        out[name] = (tp, fg.build_graph(tp, GBPConfig(**kw), "cpu"), jg, jc,
                     js)
    return out


def _poison(fields, how):
    """Beliefs that take insert_keyframe's fallbacks: the previous
    keyframe's belief without a finite mean (the prior's mean is handed
    off instead), or no landmark with a valid depth (av_depth is used)."""
    fields = {k: v.copy() for k, v in fields.items()}
    if how == "prev_kf_nan":
        fields["cam_eta"][0, 1] = np.nan
    elif how == "no_valid_depth":
        fields["lmk_lam"][:] = 0.0
    return fields


@pytest.mark.parametrize("schedule,how", [
    ("gn", "none"), ("reference", "none"), ("gn", "prev_kf_nan"),
    ("gn", "no_valid_depth")])
def test_insert_keyframe_matches_jax(warmed, schedule, how):
    tp, graph, jg, jc, js = warmed[schedule]
    before = _poison(_fields(js), how)
    js0 = type(js)(**{f: jnp.asarray(before[f]) for f in type(js)._fields})
    want = _fields(jax.jit(lambda s: jax_slam.insert_keyframe(
        s, jg, jc, 2, AV_DEPTH))(js0))
    state = fg.state_from_numpy(before, "cpu")
    out = fg.state_to_numpy(slam.insert_keyframe(
        state, graph, GBPConfig(**SCHEDULES[schedule]), 2, AV_DEPTH))
    _assert_state_close(out, want)
    # the new keyframe's edges took part in the relinearisation
    new = np.asarray(graph.cam_idx) == 2
    assert (out["active"][new] == 1).all()
    assert not np.array_equal(out["lin_mu"][:, new], before["lin_mu"][:, new])


@pytest.mark.parametrize("n_valid", [0, 1, 6, 7])
def test_depth_median_is_jax_nanmedian(n_valid):
    """The depth median of an even count is the mean of the two middle
    values (jnp.nanmedian), not the lower one (torch.nanmedian); NaN when
    no value is valid."""
    rng = np.random.default_rng(n_valid)
    z = rng.uniform(1.0, 9.0, 40).astype(np.float32)
    valid = np.zeros(40, bool)
    valid[rng.choice(40, n_valid, replace=False)] = True
    want = np.asarray(jnp.nanmedian(jnp.where(valid, z, jnp.nan)))
    got = slam._depth_median(torch.tensor(z), torch.tensor(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    if n_valid % 2 == 0 and n_valid:
        lower = torch.nanmedian(torch.tensor(np.where(valid, z, np.nan)))
        assert lower.item() != got.item()


def _seen_by(graph, fields, cams):
    """Landmarks with an active edge to one of ``cams``, ascending."""
    cam, lmk = graph.cam_idx.numpy(), graph.lmk_idx.numpy()
    return np.unique(lmk[np.isin(cam, cams) & (fields["active"] > 0)])


def _behind_camera(fields, lmks):
    """Put the listed landmarks' belief means behind the cameras (the
    synthetic cloud sits in front, at z in [4, 8]: negating eta negates
    the mean)."""
    fields = {k: v.copy() for k, v in fields.items()}
    fields["lmk_eta"][:, lmks] *= -1.0
    return fields


@pytest.mark.parametrize("behind", [True, False])
def test_relinearise_masked_matches_jax(warmed, behind):
    """The masked relinearisation on a state with behind-camera and
    non-finite means, under both sidedness of the depth guard."""
    tp, graph, jg, _, js = warmed["gn"]
    kw = dict(SLAM_KW, relin_behind_camera=behind)
    seen = _seen_by(graph, _fields(js), [0, 1])
    flipped, poisoned = seen[:8:2], seen[9]
    fields = _behind_camera(_fields(js), flipped)
    fields["lmk_eta"][0, poisoned] = np.nan
    js0 = type(js)(**{f: jnp.asarray(fields[f]) for f in type(js)._fields})
    mask = np.random.default_rng(0).random(graph.n_edges) < 0.7
    want = _fields(jax_gbp.relinearise_masked(js0, jg, JaxConfig(**kw),
                                              jnp.asarray(mask)))
    state = fg.state_from_numpy(fields, "cpu")
    out = fg.state_to_numpy(gbp.relinearise_masked(
        state, graph, GBPConfig(**kw), torch.tensor(mask)))
    _assert_state_close(out, want)
    changed = (out["lin_mu"] != fields["lin_mu"]).any(axis=0)
    lmk = np.asarray(graph.lmk_idx)
    assert changed.any() and not changed[~mask].any()
    assert not changed[lmk == poisoned].any()
    # behind-camera edges relinearise only under the two-sided guard
    assert changed[np.isin(lmk, flipped) & mask].any() == behind


def _slam_edge_inputs(js, graph, jg, fused):
    """edge_math's inputs on the warmed SLAM state with eight of the
    active landmarks moved behind the cameras and one onto camera 0's
    plane, the damping counters spread over [-2, 700) (across the rescue
    threshold of 300, with zeros where damping switches on): numpy arrays
    of the JAX argument list, and premu (None unfused)."""
    fields = _fields(js)
    seen = _seen_by(graph, fields, [0, 1])
    fields = _behind_camera(fields, seen[:16:2])
    plane = _seen_by(graph, fields, [0])[1]
    cam_mu = np.asarray(jax_gbp._variable_means(js)[0])
    r0 = balio._so3exp_np(cam_mu[3:, 0])
    y = r0.T @ (np.array([0.3, 0.2, 0.01]) - cam_mu[:3, 0])
    lam = fields["lmk_lam"][:, plane]
    lam_m = np.array([[lam[pl.sym_slot(i, j)] for j in range(3)]
                      for i in range(3)])
    fields["lmk_eta"][:, plane] = lam_m @ y
    rng = np.random.default_rng(1)
    dc = rng.integers(-2, 700, graph.n_edges).astype(np.int32)
    dc[::17] = 0
    fields["damping_count"] = dc
    js = type(js)(**{f: jnp.asarray(fields[f]) for f in type(js)._fields})
    cidx, lidx = jnp.asarray(graph.cam_idx), jnp.asarray(graph.lmk_idx)
    premu = None
    if fused:
        cam_mu, lmk_mu, cam_ok, lmk_ok = jax_gbp._sanitize_means(
            *jax_gbp._variable_means(js))
        premu = jnp.concatenate([
            jnp.take(cam_mu, cidx, 1), jnp.take(lmk_mu, lidx, 1),
            (jnp.take(cam_ok, cidx, 1).astype(jnp.float32)
             * jnp.take(lmk_ok, lidx, 1).astype(jnp.float32))])
    bc = jnp.take(jnp.concatenate([js.cam_eta, js.cam_lam]), cidx, 1)
    bl = jnp.take(jnp.concatenate([js.lmk_eta, js.lmk_lam]), lidx, 1)
    edge = ("f_eta_c", "f_eta_l", "f_lam_cc", "f_lam_cl", "f_lam_ll",
            "msg_c_eta", "msg_c_lam", "msg_l_eta", "msg_l_lam", "damping",
            "damping_count", "mu", "lin_mu", "robust", "active")
    return ([bc, bl, jg.meas, jg.meas_var] + [getattr(js, n) for n in edge],
            premu)


@pytest.mark.parametrize("fused", [True, False], ids=["premu", "per-edge"])
def test_edge_math_matches_jax_under_slam_config(warmed, fused):
    """edge_math under the SLAM driver's config against the JAX function,
    with the pre-solved means (fused pipeline) and without (unfused). The
    state takes every branch: relinearise every sweep; in front of the
    camera; behind it, refused while unsettled and rescued once the
    counter passes 300; on the camera plane, refused; inactive edges;
    damping switched on at counter 0."""
    tp, graph, jg, jc, js = warmed["gn"]
    args_j, premu = _slam_edge_inputs(js, graph, jg, fused)
    out_j = jax_gbp.edge_math(*args_j, jg.k, jc, premu=premu)
    args_t = [torch.tensor(np.array(a)) for a in args_j]
    out_t = gbp.edge_math(*args_t, np.asarray(jg.k), GBPConfig(**SLAM_KW),
                          None if premu is None
                          else torch.tensor(np.array(premu)))
    for i, (a, b) in enumerate(zip(out_j, out_t)):
        a = np.asarray(a).reshape(b.shape)
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b.numpy(), a, err_msg=str(i))
        else:
            np.testing.assert_allclose(
                b.numpy(), a, rtol=SWEEP_RTOL,
                atol=SWEEP_RTOL * np.nanmax(np.abs(a)), err_msg=str(i))
    # every branch was taken: depth of each edge at its belief means
    mu = out_t[11]
    y_cf, _ = pl.w2c_apply(pl.unpack_vec(mu[:6], 6), pl.unpack_vec(mu[6:], 3))
    z = y_cf[2].numpy()
    active = args_t[18].numpy() > 0
    count = args_t[14].numpy() + active
    relin = (out_t[12] != args_t[16]).any(dim=0).numpy()
    settled = count > SLAM_KW["behind_camera_rescue_iters"]
    front, behind = z > 0.05, z < -0.05
    assert relin[active & front].all() and not relin[~active].any()
    assert (active & behind & settled).any() and (active & behind
                                                  & ~settled).any()
    assert relin[active & behind & settled].all()
    assert not relin[active & behind & ~settled].any()
    plane = active & (np.abs(z) <= 0.05)
    assert plane.any() and not relin[plane].any()
    damping = out_t[9].numpy()
    switched = active & (args_t[14].numpy() == 0)
    assert switched.any() and (damping[switched] == np.float32(0.7)).all()


def _slam_state(problem, cfg):
    graph = fg.build_graph(problem, cfg, "cpu")
    state = fg.init_state(problem, cfg, "cpu",
                          flags=flags.create_flags(problem, cfg.steps))
    return graph, state


def test_port_insert_keyframe_semantics():
    """tests/test_slam.py's insertion test, on the port."""
    problem, _ = _problems()
    cfg = GBPConfig()
    graph, state = _slam_state(problem, cfg)
    state = gbp.initialise(state, graph, cfg)
    state, _ = gbp.run_gbp(state, graph, cfg, 40)

    new_kf = 2
    prev_mu = pl.solve_sym(
        pl.unpack_sym(state.cam_lam[:, new_kf - 1], 6),
        pl.unpack_vec(state.cam_eta[:, new_kf - 1], 6))
    state2 = slam.insert_keyframe(state.clone(), graph, cfg, new_kf)

    active = state2.active.numpy()
    cam_idx = graph.cam_idx.numpy()
    assert (active[cam_idx == new_kf] == 1).all()
    assert (active[cam_idx > new_kf] == 0).all()
    # padding edges carry keyframe id 0 and stay inactive
    assert (cam_idx[problem.n_edges:] == 0).all()
    assert (active[problem.n_edges:] == 0).all()

    prior_mu = pl.solve_sym(
        pl.unpack_sym(state2.cam_prior_lam[:, new_kf], 6),
        pl.unpack_vec(state2.cam_prior_eta[:, new_kf], 6))
    np.testing.assert_allclose(torch.stack(prior_mu).numpy(),
                               torch.stack(prev_mu).numpy(), rtol=1e-4,
                               atol=1e-5)

    cam_weaken = state2.cam_weaken.numpy()
    assert cam_weaken[new_kf] == cfg.steps
    assert (cam_weaken[:new_kf] == 0).all()
    assert (state2.damping_count.numpy() == -cfg.iters_before_damping).all()
    assert (state2.damping.numpy() == 0).all()
    first_kf = graph.first_kf.numpy()
    lmk_weaken = state2.lmk_weaken.numpy()
    assert (lmk_weaken[first_kf == new_kf] == cfg.steps).all()
    assert (lmk_weaken[first_kf < new_kf] == 0).all()


def test_port_slam_end_to_end():
    problem, _ = _problems()
    cfg = GBPConfig()
    graph, state = _slam_state(problem, cfg)
    result = slam.solve_slam(state, graph, cfg, iters_between_kfs=60,
                             av_depth=AV_DEPTH)
    assert result.reproj_err.shape == (problem.n_keyframes - 1, 60)
    assert np.isfinite(result.reproj_err).all()
    final_err = result.reproj_err[-1, -10:].mean()
    active = result.state.active.numpy()
    assert (active[:problem.n_edges] == 1).all()
    assert (active[problem.n_edges:] == 0).all()
    assert final_err < 1.0, f"SLAM failed to converge: {final_err}px"


def test_port_slam_matches_batch_quality():
    problem, _ = _problems()
    cfg = GBPConfig()
    graph = fg.build_graph(problem, cfg, "cpu")
    state_b = gbp.initialise(fg.init_state(problem, cfg, "cpu"), graph, cfg)
    _, diag_b = gbp.run_gbp(state_b, graph, cfg, 150)
    err_batch = float(diag_b.reproj_err[-10:].mean())
    _, state_i = _slam_state(problem, cfg)
    result = slam.solve_slam(state_i, graph, cfg, iters_between_kfs=60,
                             av_depth=AV_DEPTH)
    err_slam = float(result.reproj_err[-1, -10:].mean())
    assert abs(err_slam - err_batch) < 0.6, (err_slam, err_batch)


def test_first_uv_matches_first_observation():
    problem, _ = _problems()
    graph = fg.build_graph(problem, GBPConfig(), "cpu")
    ci, li = np.asarray(problem.cam_idx), np.asarray(problem.lmk_idx)
    meas = np.asarray(problem.measurements)
    uv = graph.first_uv.numpy()
    for l in range(problem.n_points):
        m = li == l
        if not m.any():
            np.testing.assert_array_equal(uv[:, l], 0.0)
            continue
        first = np.flatnonzero(m)[np.argmin(ci[m])]
        np.testing.assert_allclose(uv[:, l], meas[first], rtol=0, atol=1e-4)


def test_solve_slam_matches_jax_by_outcome():
    """The whole incremental solve under the SLAM driver's schedule, 60
    sweeps per keyframe, through the one-call entry point: the error at
    the end of every segment as the JAX package's."""
    tp, jp = _problems()
    jc = JaxConfig(**SLAM_KW)
    jg = jax_build_graph(jp, jc)
    want = jax_slam.solve_slam(
        jax_init_state(jp, jc, flags=jax_flags.create_flags(jp, jc.steps)),
        jg, jc, iters_between_kfs=60, av_depth=AV_DEPTH).reproj_err
    cam, lmk, got = solve_slam(tp, GBPConfig(**SLAM_KW), 60, AV_DEPTH,
                               device="cpu")
    assert got.shape == want.shape == (tp.n_keyframes - 1, 60)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:, -1], want[:, -1], rtol=SOLVE_RTOL,
                               atol=SOLVE_ATOL_PX)
    assert cam.shape == (tp.n_keyframes, 6) and lmk.shape == (tp.n_points, 3)


def test_resume_by_keyframe_is_bit_exact():
    """solve_slam from a state saved after keyframe 4's insertion (as
    numpy) continues exactly as the uninterrupted run."""
    problem, _ = _problems()
    cfg = GBPConfig(**SLAM_KW)
    graph, state = _slam_state(problem, cfg)
    saved = {}

    def keep(k, st):
        if k == 3:
            # a copy: on the CPU the arrays are views of the live state
            saved["state"] = {f: a.copy()
                              for f, a in fg.state_to_numpy(st).items()}

    whole = slam.solve_slam(state, graph, cfg, iters_between_kfs=30,
                            av_depth=AV_DEPTH, segment_callback=keep)
    resumed = slam.solve_slam(fg.state_from_numpy(saved["state"], "cpu"),
                              graph, cfg, iters_between_kfs=30,
                              av_depth=AV_DEPTH, start_kf=4)
    assert resumed.reproj_err.shape == (2, 30)
    for f in ("reproj_err", "cost", "n_relins", "n_robust"):
        np.testing.assert_array_equal(getattr(resumed, f),
                                      getattr(whole, f)[3:], err_msg=f)
    assert torch.equal(resumed.state.pk, whole.state.pk)
