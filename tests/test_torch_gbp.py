"""The port's batch GBP solve against the JAX package.

One sweep from the same JAX-initialised state, carried across with
``state_from_numpy``, is compared field by field against JAX ``gbp_sweep``
on its XLA path (``use_pallas=False``) and on its fused Pallas path (the
sweep, table and reduction kernels in interpret mode). The two stacks
round sin/cos/sqrt differently and sum the belief reductions in other
orders, so float fields agree to a few float32 ulps of the field's
magnitude and every discrete output (relinearise, Huber, counters) is
equal. Whole solves are compared by outcome: the final error.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from gbp_poplar_tpu.config import GBPConfig as JaxConfig
from gbp_poplar_tpu.core import build_graph as jax_build_graph
from gbp_poplar_tpu.core import gbp as jax_gbp
from gbp_poplar_tpu.core import init_state as jax_init_state
from gbp_poplar_tpu.utils import balio as jax_balio
from gbp_poplar_tpu_torch import GBPConfig, solve_ba
from gbp_poplar_tpu_torch.core import factor_graph as fg
from gbp_poplar_tpu_torch.core import gbp
from gbp_poplar_tpu_torch.utils import balio

torch.set_num_threads(1)

# float fields, relative to the field's largest magnitude: one sweep's
# float32 rounding differences (measured up to 4e-7) with margin
SWEEP_RTOL = 1e-5
# final reprojection error of a whole solve: kernels of both packages
# follow the same trajectory to fp32 noise (measured equal to 4 digits)
SOLVE_ATOL_PX = 0.01
SOLVE_RTOL = 0.01


PAD = 256       # the JAX fused path needs windows keyed to its block


def _jax_cfg(fused: bool):
    return JaxConfig(use_pallas="interpret" if fused else False,
                     accel_every=0, edge_pad_multiple=PAD,
                     pallas_block_edges=PAD)


def _problem(name):
    if name == "pinhole":
        return (balio.synthetic_problem(n_keyframes=5, n_points=40, seed=4,
                                        pixel_noise=0.5),
                jax_balio.synthetic_problem(n_keyframes=5, n_points=40,
                                            seed=4, pixel_noise=0.5))
    return (balio.synthetic_problem_snavely(pixel_noise=0.5),
            jax_balio.synthetic_problem_snavely(pixel_noise=0.5))


def _jax_fields(s):
    return {f: np.asarray(getattr(s, f)) for f in fg.STATE_FIELDS}


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
    """Per problem: (port problem, JAX graph, jitted JAX XLA sweep, JAX
    state after initialise + 17 XLA sweeps). After 17 sweeps the next one
    is the first whose damping counter passes the relinearisation
    threshold, with damping already on."""
    out = {}
    oracle = _jax_cfg(False)
    for name in ("pinhole", "snavely"):
        tp, jp = _problem(name)
        jg = jax_build_graph(jp, oracle)
        js = jax.jit(lambda s: jax_gbp.initialise(s, jg, oracle))(
            jax_init_state(jp, oracle))
        step = jax.jit(lambda s, jg=jg: jax_gbp.gbp_sweep(s, jg, oracle))
        for _ in range(17):
            js = step(js)
        out[name] = (tp, jg, step, js)
    return out


@pytest.mark.parametrize("fused", [False, True], ids=["xla", "fused"])
@pytest.mark.parametrize("name", ["pinhole", "snavely"])
def test_one_sweep_matches_jax(warmed, name, fused):
    tp, jg, step, js = warmed[name]
    jc = _jax_cfg(fused)
    if fused:
        assert jg.cam_win is not None          # JAX takes the fused kernel
        want = jax.jit(lambda s: jax_gbp.gbp_sweep(s, jg, jc))(js)
    else:
        want = step(js)
    want = _jax_fields(want)
    before = _jax_fields(js)
    tc = GBPConfig(accel_every=0, edge_pad_multiple=PAD)
    state = fg.state_from_numpy(before, "cpu")
    graph = fg.build_graph(tp, tc, "cpu")
    out = fg.state_to_numpy(gbp.gbp_sweep(state, graph, tc))
    _assert_state_close(out, want)
    relins = (want["damping_count"] == -jc.num_undamped_iters).sum()
    assert relins > 0 and (before["damping"] > 0).any()


def test_initialise_and_diagnostics_match_jax(synthetic):
    jc = _jax_cfg(False)
    tc = GBPConfig(accel_every=0, edge_pad_multiple=PAD)
    jg = jax_build_graph(synthetic, jc)
    js = jax.jit(lambda s: jax_gbp.initialise(s, jg, jc))(
        jax_init_state(synthetic, jc))
    graph = fg.build_graph(synthetic, tc, "cpu")
    state = gbp.initialise(fg.init_state(synthetic, tc, "cpu"), graph, tc)
    _assert_state_close(fg.state_to_numpy(state), _jax_fields(js))
    step = jax.jit(lambda s: jax_gbp.gbp_sweep(s, jg, jc))
    for _ in range(3):
        js = step(js)
        state = gbp.gbp_sweep(state, graph, tc)
    dj = jax_gbp.diagnostics(js, jg, jc)
    dt = gbp.diagnostics(state, graph, tc)
    np.testing.assert_allclose(dt.reproj_err.item(), float(dj.reproj_err),
                               rtol=1e-5)
    np.testing.assert_allclose(dt.cost.item(), float(dj.cost), rtol=1e-4)
    assert dt.n_relins.item() == int(dj.n_relins)
    assert dt.n_robust.item() == int(dj.n_robust)


def test_edge_math_matches_jax(warmed):
    """edge_math on the same gathered inputs as the JAX function, with the
    pre-solved means (sanitised per variable, as the JAX tables hold
    them) given to both."""
    import jax.numpy as jnp

    _, jg, _, js = warmed["snavely"]
    cam_mu, lmk_mu, cam_ok, lmk_ok = jax_gbp._sanitize_means(
        *jax_gbp._variable_means(js))
    premu = jnp.concatenate([
        jnp.take(cam_mu, jg.cam_idx, 1), jnp.take(lmk_mu, jg.lmk_idx, 1),
        (jnp.take(cam_ok, jg.cam_idx, 1).astype(jnp.float32)
         * jnp.take(lmk_ok, jg.lmk_idx, 1).astype(jnp.float32))])
    bc = jnp.take(jnp.concatenate([js.cam_eta, js.cam_lam]), jg.cam_idx, 1)
    bl = jnp.take(jnp.concatenate([js.lmk_eta, js.lmk_lam]), jg.lmk_idx, 1)
    edge = ("f_eta_c", "f_eta_l", "f_lam_cc", "f_lam_cl", "f_lam_ll",
            "msg_c_eta", "msg_c_lam", "msg_l_eta", "msg_l_lam", "damping",
            "damping_count", "mu", "lin_mu", "robust", "active")
    args_j = ([bc, bl, jg.meas, jg.meas_var]
              + [getattr(js, n) for n in edge])
    out_j = jax_gbp.edge_math(*args_j, jg.k, _jax_cfg(False), intr=jg.intr,
                              premu=premu)
    args_t = [torch.tensor(np.array(a)) for a in args_j]
    out_t = gbp.edge_math(*args_t, np.asarray(jg.k), GBPConfig(accel_every=0),
                          torch.tensor(np.array(premu)),
                          intr=torch.tensor(np.array(jg.intr)))
    for i, (a, b) in enumerate(zip(out_j, out_t)):
        a = np.asarray(a).reshape(b.shape)
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b.numpy(), a, err_msg=str(i))
        else:
            np.testing.assert_allclose(
                b.numpy(), a, rtol=SWEEP_RTOL,
                atol=SWEEP_RTOL * np.abs(a).max(), err_msg=str(i))


def test_solve_matches_jax_by_outcome(synthetic):
    """200 iterations of the reference schedule (accel_every=0) on the
    conftest problem: the port and the JAX package land on the same final
    error."""
    jc = _jax_cfg(False)
    jg = jax_build_graph(synthetic, jc)
    _, dj = jax.jit(lambda s: jax_gbp.solve(s, jg, jc, n_iters=200))(
        jax_init_state(synthetic, jc))
    ej = np.asarray(dj.reproj_err)
    cam, lmk, et = solve_ba(synthetic, GBPConfig(accel_every=0), 200,
                            device="cpu")
    assert et.shape == (200,) and np.isfinite(et).all()
    assert et[-1] < et[0]
    np.testing.assert_allclose(et[-1], ej[-1], rtol=SOLVE_RTOL,
                               atol=SOLVE_ATOL_PX)
    # the host oracle agrees with the on-device telemetry at the solution
    from gbp_poplar_tpu_torch.utils.evaluation import numpy_reprojection_error
    err, _ = numpy_reprojection_error(cam, lmk, synthetic)
    np.testing.assert_allclose(err, et[-1], rtol=1e-3)


@pytest.mark.parametrize("kw", [dict(accel_every=50), dict(accel_every=0)],
                         ids=["accel", "coarse"])
def test_run_gbp_refuses_unported_schedules(synthetic, kw):
    """The coarse corrector is not ported: run_gbp refuses coarse_groups
    > 0, with the (ported) accelerator on ("accel") or off ("coarse")."""
    cfg = GBPConfig(coarse_groups=4, **kw)
    graph = fg.build_graph(synthetic, cfg, "cpu")
    state = fg.init_state(synthetic, cfg, "cpu")
    with pytest.raises(NotImplementedError, match="A6"):
        gbp.run_gbp(state, graph, cfg, 10)


def test_reprojection_error_is_nan_without_valid_edges(synthetic):
    cfg = GBPConfig(accel_every=0)
    graph = fg.build_graph(synthetic, cfg, "cpu")
    state = gbp.initialise(fg.init_state(synthetic, cfg, "cpu"), graph, cfg)
    assert np.isfinite(gbp.reprojection_error(state, graph)[0].item())
    state.active.zero_()
    err, cost = gbp.reprojection_error(state, graph)
    assert np.isnan(err.item()) and cost.item() == 0.0


def test_port_imports_no_jax():
    """Every module of the port imports without pulling in JAX or the JAX
    package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import gbp_poplar_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'gbp_poplar_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'gbp_poplar_tpu' or m.startswith('gbp_poplar_tpu.')]\n"
        "assert len(mods) >= 15, mods\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=root, timeout=120)
    assert out.returncode == 0, out.stderr
