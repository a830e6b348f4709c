"""The port's sequence-level tools (``gbp_poplar_tpu_torch/tools/``
``seq_common``, ``validate_sequences``, ``diagnose_accuracy``,
``exp_ate_grid``, ``exp_drift_phase``, ``tune_schedule``) on the CPU,
against the JAX package's TUM scripts.

The problem is a BAL file written with ``save_bal``:
``synthetic_problem_large(12, 300, 5)``, landmarks perturbed by N(0, 5 cm)
(seed 0). One JAX solve with ``GBPConfig()`` is shared by the module.
Where a JAX script is module-level code (diagnose_accuracy,
exp_drift_phase) or fixes a budget the test must cut (validate_sequences'
SLAM cadence), its steps are rebuilt here from the JAX library. Per-edge
statistics are compared on the same state, carried across; whole solves
by outcome, since their float32 relinearisation decisions may part after
many sweeps: px relative 1e-3, MAP costs relative 1e-4, ATE 1e-4 m
absolute (tests/test_torch_tools.py's bounds).
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gbp_poplar_tpu.config import GBPConfig as JaxConfig
from gbp_poplar_tpu.core import build_graph as jax_build_graph
from gbp_poplar_tpu.core import gauss_newton as jax_gn
from gbp_poplar_tpu.core import gbp as jax_gbp
from gbp_poplar_tpu.core import init_state as jax_init_state
from gbp_poplar_tpu.core import slam as jax_slam
from gbp_poplar_tpu.ops import planes as jax_pl
from gbp_poplar_tpu.ops import projection as jax_proj
from gbp_poplar_tpu.utils import analysis as jax_analysis
from gbp_poplar_tpu.utils import balio as jax_balio
from gbp_poplar_tpu.utils import evaluation as jax_evaluation
from gbp_poplar_tpu.utils import flags as jax_flags
from gbp_poplar_tpu.utils import priors as jax_priors
from gbp_poplar_tpu_torch import GBPConfig, InitConfig
from gbp_poplar_tpu_torch.core import factor_graph as fg
from gbp_poplar_tpu_torch.core import gauss_newton as gn
from gbp_poplar_tpu_torch.tools import diagnose_accuracy as da
from gbp_poplar_tpu_torch.tools import tune_schedule as ts
from gbp_poplar_tpu_torch.tools import validate_sequences as vs
from gbp_poplar_tpu_torch.tools.seq_common import (MapObjective,
                                                   parse_overrides)
from gbp_poplar_tpu_torch.utils import balio, priors

torch.set_num_threads(1)

SHAPE = (12, 300, 5)
N_ITERS = 200
SLAM_IBK = 20
# the same statistic of the same state: relative, against the field's
# largest magnitude
STATS_RTOL = 1e-5
# whole protocols by outcome
PX_RTOL = 1e-3
COST_RTOL = 1e-4
ATE_ATOL_M = 1e-4
SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts")


def _script(name: str):
    """A JAX script as a module (its ``main`` is not run)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bal_path(tmp_path_factory):
    prob = priors.apply_init_noise(balio.synthetic_problem_large(*SHAPE),
                                   InitConfig(lmk_noise=0.05, seed=0))
    path = str(tmp_path_factory.mktemp("seq") / "synthetic_12kf.txt")
    balio.save_bal(path, prob)
    return path


@pytest.fixture(scope="module")
def jax_solve(bal_path):
    """The JAX package's ``GBPConfig()`` solve of the file, N_ITERS sweeps."""
    prob = jax_balio.load_bal(bal_path)
    cfg = JaxConfig()
    graph = jax_build_graph(prob, cfg)
    final, diag = jax.jit(lambda s: jax_gbp.solve(s, graph, cfg,
                                                  n_iters=N_ITERS))(
        jax_init_state(prob, cfg))
    return prob, cfg, graph, final, np.asarray(diag.reproj_err)


def _close(got, want, what, scale):
    """Within STATS_RTOL of ``want`` and of ``scale``, the magnitude of the
    terms ``want`` is computed from (a pixel residual is a difference of
    pixel coordinates of hundreds of px)."""
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=STATS_RTOL, atol=STATS_RTOL * scale,
                               err_msg=what)


def jax_map_cost(jprob, jcfg):
    """The JAX scripts' MAP cost split, ``(robust, prior)`` at (cam [C, 6],
    lmk [L, 3]): ``_robust_cost`` and ``_prior_cost`` on the exact-edge
    graph with the annealed priors of the problem's means."""
    g1 = jax_build_graph(jprob, dataclasses.replace(jcfg,
                                                    edge_pad_multiple=1))
    cam_lam0, lmk_lam0 = jax_priors.prior_lambdas(jprob, jcfg.meas_var)
    pri = jax_gn.annealed_priors(
        g1, jnp.asarray(jprob.cam_means), jnp.asarray(jprob.lmk_means),
        cam_lam0, lmk_lam0, jcfg)

    def split(cam, lmk):
        r = g1.meas.T - jax_proj.project(jnp.asarray(cam)[g1.cam_idx],
                                         jnp.asarray(lmk)[g1.lmk_idx], g1.k)
        return (float(jax_gn._robust_cost(r, g1.meas_var, jcfg.huber_nstds)),
                float(jax_gn._prior_cost(jnp.asarray(cam), jnp.asarray(lmk),
                                         pri)))

    return split


# --------------------------------------------------------------------------
# parse_overrides
# --------------------------------------------------------------------------

SHARED_SPECS = (
    "base",
    "eta_damping=0.7",
    "relin_every_iter=1,lambda_damping=1,eta_damping=0.7",
    "relin_drift_threshold=0.05",
    "relin_drift_threshold=0,accel_every=0",
    "lambda_damping=0",
    "lambda_damping=false,reset_damping_on_relin=0",
    "coarse_groups=16,accel_start=200,n_iters=1500",
    "min_depth=0.1,huber_nstds=3,steps=4",
)


@pytest.mark.parametrize("spec", SHARED_SPECS)
def test_parse_overrides_as_the_jax_parsers(spec):
    """The JAX scripts' two parsers, on fields both packages have:
    exp_ate_grid's ``parse_spec`` (diagnose_accuracy's and
    exp_drift_phase's module-level loops are the same code) and
    tune_schedule's ``parse_variant``."""
    got = parse_overrides(spec)
    want = _script("exp_ate_grid").parse_spec(spec)
    assert got == want
    assert [type(v) for v in got.values()] == [type(v) for v in want.values()]
    if spec != "base":
        _, cfg = _script("tune_schedule").parse_variant(f"v:{spec}")
        assert got == {k: getattr(cfg, k) for k in got}
    # a list of k=v items, as diagnose_accuracy and exp_drift_phase take
    items = [] if spec == "base" else spec.split(",")
    assert parse_overrides(items) == got
    assert ts.parse_variant(f"v:{spec}") == ("v", got)


def test_parse_overrides_port_fields_and_refusals():
    """An int given as a float (the float parsers' reading), the port's
    string field, and the refusals: the JAX package's TPU knobs by name,
    pointing to kernels/fused, and unknown fields."""
    assert parse_overrides("coarse_groups=16.0") == {"coarse_groups": 16}
    assert parse_overrides("kernels=reference,fused=0") == {
        "kernels": "reference", "fused": False}
    assert parse_overrides("fused=False") == {"fused": False}
    for k in ("use_pallas", "pallas_fused", "pallas_block_edges",
              "table_carry"):
        with pytest.raises(ValueError, match=k) as exc:
            parse_overrides(f"{k}=0")
        assert "kernels" in str(exc.value) and "fused" in str(exc.value)
    with pytest.raises(ValueError, match="unknown GBPConfig field: bogus"):
        parse_overrides("bogus=1")


# --------------------------------------------------------------------------
# MapObjective
# --------------------------------------------------------------------------

def test_map_objective_split_matches_jax(bal_path):
    """The robust and prior parts at means off the optimum, against the
    JAX scripts' ``_robust_cost`` and ``_prior_cost``; their sum against
    ``gauss_newton.map_cost``."""
    prob = balio.load_bal(bal_path)
    cfg = GBPConfig()
    rng = np.random.default_rng(0)
    cam = (prob.cam_means + rng.normal(0, 1e-3, prob.cam_means.shape)
           ).astype(np.float32)
    lmk = (prob.lmk_means + rng.normal(0, 0.02, prob.lmk_means.shape)
           ).astype(np.float32)
    obj = MapObjective(prob, cfg, "cpu")
    robust, prior = obj.split(cam, lmk)

    want_r, want_p = jax_map_cost(jax_balio.load_bal(bal_path),
                                  JaxConfig())(cam, lmk)
    assert want_r > 10 * want_p > 0
    np.testing.assert_allclose(robust, want_r, rtol=1e-5)
    np.testing.assert_allclose(prior, want_p, rtol=1e-5)
    total = float(gn.map_cost(torch.tensor(cam), torch.tensor(lmk),
                              obj.graph, obj.priors, cfg))
    np.testing.assert_allclose(obj(cam, lmk), total, rtol=1e-6)


# --------------------------------------------------------------------------
# edge_stats on the JAX final state
# --------------------------------------------------------------------------

def _jax_edge_stats(final, graph, e: int, cfg) -> dict:
    """scripts/diagnose_accuracy.py:61-121 on a JAX state."""
    st = jax.tree.map(np.asarray, final)
    cam_mu, lmk_mu = map(np.asarray, jax_gbp._variable_means(final))
    mu_c = cam_mu[:, np.asarray(graph.cam_idx)[:e]]
    mu_l = lmk_mu[:, np.asarray(graph.lmk_idx)[:e]]
    mu = np.concatenate([mu_c, mu_l])
    dmu = np.linalg.norm(mu - st.mu[:, :e], axis=0)
    drift = np.linalg.norm(mu - st.lin_mu[:, :e], axis=0)
    (u, v), y_cf, _ = jax_pl.project(jax_pl.unpack_vec(jnp.asarray(mu_c), 6),
                                     jax_pl.unpack_vec(jnp.asarray(mu_l), 3),
                                     graph.k)
    meas = np.asarray(graph.meas)[:, :e]
    res = np.hypot(meas[0] - np.squeeze(np.asarray(u)),
                   meas[1] - np.squeeze(np.asarray(v)))
    depth = np.squeeze(np.asarray(y_cf[2]))
    hi = res > np.percentile(res, 95)
    lo = ~hi
    thr = cfg.dmu_threshold
    robust = st.robust[:e]
    return {
        "res": res, "dmu": dmu, "drift": drift, "depth": depth,
        "cam_mu": cam_mu.T, "lmk_mu": lmk_mu.T,
        "res_mean": res.mean(), "res_median": np.median(res),
        "res_p90": np.percentile(res, 90), "res_p99": np.percentile(res, 99),
        "res_max": res.max(), "robust_frac": robust.mean(),
        "dmu_median": np.median(dmu), "dmu_p90": np.percentile(dmu, 90),
        "dmu_above": (dmu > thr).mean(),
        "drift_median": np.median(drift),
        "drift_p90": np.percentile(drift, 90), "drift_max": drift.max(),
        "hi_dmu_median": np.median(dmu[hi]),
        "hi_dmu_above": (dmu[hi] > thr).mean(),
        "hi_drift_median": np.median(drift[hi]),
        "hi_robust_frac": robust[hi].mean(),
        "lo_dmu_median": np.median(dmu[lo]),
        "lo_dmu_above": (dmu[lo] > thr).mean(),
        "lo_drift_median": np.median(drift[lo]),
        "depth_neg": np.mean(depth < 0),
        "depth_below_min": np.mean(depth < cfg.min_depth),
        "worst": np.argsort(res)[-25:][::-1],
        "catastrophic": {t: ((res > t).sum(), res[res > t].sum() / e)
                         for t in (10.0, 50.0)},
    }


def _behind_camera(final, n: int):
    """The JAX state with the first ``n`` landmarks' belief eta negated:
    their means mirror through the origin, behind the cameras."""
    eta = np.array(final.lmk_eta)
    eta[:, :n] *= -1
    return final._replace(lmk_eta=jnp.asarray(eta))


@pytest.mark.parametrize("behind", [0, 12])
def test_edge_stats_match_the_jax_formulas(jax_solve, behind):
    """Field by field on the same state, carried across: the final state
    and, with ``behind``, a copy with landmarks behind the cameras (the
    depth and residual at negative z through ``ops/planes.project``)."""
    prob, jcfg, jgraph, final, _ = jax_solve
    if behind:
        final = _behind_camera(final, behind)
    e = prob.n_edges
    want = _jax_edge_stats(final, jgraph, e, jcfg)
    state = fg.state_from_numpy(
        {f: np.asarray(getattr(final, f)) for f in fg.STATE_FIELDS}, "cpu")
    graph = fg.graph_from_numpy(
        {f: (None if getattr(jgraph, f) is None
             else np.asarray(getattr(jgraph, f))) for f in fg.GRAPH_FIELDS},
        "cpu")
    before = fg.state_to_numpy(state)
    before = {k: v.copy() for k, v in before.items()}
    got = da.edge_stats(state, graph, GBPConfig(), e)
    for k, v in fg.state_to_numpy(state).items():      # reads only
        np.testing.assert_array_equal(v, before[k], err_msg=k)
    if behind:
        assert got["depth_neg"] > 0
    # each field against the magnitude of its terms: pixel coordinates for
    # the residuals, the means for dmu and drift
    px = float(np.abs(np.asarray(jgraph.meas)[:, :e]).max())
    mu = float(np.abs(np.asarray(final.mu)[:, :e]).max())
    fields = {"depth": float(np.abs(want["depth"]).max()),
              "cam_mu": float(np.abs(want["cam_mu"]).max()),
              "lmk_mu": float(np.abs(want["lmk_mu"]).max())}

    def scale(k):
        if k.endswith(("_frac", "_above", "_neg", "_below_min")):
            return 1.0                                   # shares of edges
        if k.startswith("res"):
            return px
        if "dmu" in k or "drift" in k:
            return mu
        return fields[k]

    for k, v in want.items():
        if k not in ("worst", "catastrophic"):
            _close(got[k], v, k, scale(k))
    assert got["catastrophic"].keys() == want["catastrophic"].keys()
    for t, (n, share) in want["catastrophic"].items():
        assert got["catastrophic"][t][0] == n
        _close(got["catastrophic"][t][1], share, f"share {t}", px / e)
    # the worst edges by rank, except where a residual ties a neighbour's
    # within the tolerance
    r = np.sort(want["res"])[::-1][:da.N_WORST + 1]
    gap = np.abs(np.diff(r)) > STATS_RTOL * px
    for i in range(da.N_WORST):
        if gap[i] and (i == 0 or gap[i - 1]):
            assert got["worst"][i] == want["worst"][i], i
    lines = da.stats_lines(got, GBPConfig())
    assert sum(ln.startswith("    e") for ln in lines) == da.N_WORST


# --------------------------------------------------------------------------
# the protocols by outcome
# --------------------------------------------------------------------------

def _jax_run_sequence(jax_solve, ibk: int) -> dict:
    """scripts/validate_sequences.py's run_sequence, its SLAM cadence cut
    to ``ibk``; the GBP solve is the module's."""
    prob, cfg, _, final, errs = jax_solve
    cam_mu, _ = jax_analysis.belief_means(final)
    res = jax_gn.solve_problem(prob, cfg, n_lm_iters=vs.GN_LM_ITERS,
                               cg_iters=vs.GN_CG_ITERS)
    flags = jax_flags.create_flags(prob, cfg.steps)
    state_i = jax_init_state(prob, cfg, flags=flags)
    slam_cfg = dataclasses.replace(cfg, relin_drift_threshold=0.05,
                                   lambda_damping=True)
    result = jax_slam.solve_slam(state_i, jax_build_graph(prob, slam_cfg),
                                 slam_cfg, iters_between_kfs=ibk,
                                 av_depth=1.0)
    cam_slam, _ = jax_analysis.belief_means(result.state)
    gn_cam = np.asarray(res.cam)
    return {"gbp_err": float(errs[-10:].mean()),
            "gn_err": float(np.asarray(res.reproj_err)[-1]),
            "gn_cost": float(np.asarray(res.cost)[-1]),
            "ate": jax_evaluation.ate_rmse(cam_mu, gn_cam),
            "slam_err": float(result.reproj_err[-1, -10:].mean()),
            "ate_slam": jax_evaluation.ate_rmse(cam_slam, gn_cam)}


def test_validate_sequences_matches_jax(jax_solve, bal_path, capsys):
    got = vs.run_sequence(bal_path, N_ITERS, device="cpu",
                          iters_between_kfs=SLAM_IBK)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"{bal_path:10s} | GBP ") and line.endswith("cpu")
    want = _jax_run_sequence(jax_solve, SLAM_IBK)
    for k in ("gbp_err", "gn_err", "slam_err"):
        np.testing.assert_allclose(got[k], want[k], rtol=PX_RTOL, err_msg=k)
    np.testing.assert_allclose(got["gn_cost"], want["gn_cost"],
                               rtol=COST_RTOL)
    for k in ("ate", "ate_slam"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATE_ATOL_M,
                                   err_msg=k)


def test_tune_schedule_reference_matches_jax(jax_solve, bal_path):
    """tune's ``reference`` variant is the JAX module solve's config."""
    prob = balio.load_bal(bal_path)
    r = ts.tune(prob, N_ITERS, ["reference"], device="cpu")
    (row,) = r["rows"]
    errs = jax_solve[4]
    assert list(row["errs"]) == [9, 50, 100, N_ITERS - 1]
    np.testing.assert_allclose(row["errs"][N_ITERS - 1], errs[-1],
                               rtol=PX_RTOL)
    np.testing.assert_allclose(row["min"], np.nanmin(errs), rtol=PX_RTOL)
    assert r["warm_up_seconds"] == 0.0 and r["device"] == "cpu"
