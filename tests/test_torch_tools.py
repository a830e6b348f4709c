"""The port's entry points and tools (``gbp_poplar_tpu_torch.entry``,
``tools/validate_scale``, ``tools/memory_ledger``, ``tools/profile_sweep``)
on the CPU.

``entry()``'s sweep is held against the JAX package's
``__graft_entry__.entry()`` sweep field by field; ``validate_scale``'s
protocol against the same protocol run through the JAX library, by
outcome (both solves are float32 runs whose relinearisation decisions may
part after many sweeps); the ledger's tallies against the tensors they
name; the profiler trace parser against a hand-made trace and a recorded
CPU trace.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from gbp_poplar_tpu.config import GBPConfig as JaxConfig
from gbp_poplar_tpu.core import build_graph as jax_build_graph
from gbp_poplar_tpu.core import gauss_newton as jax_gn
from gbp_poplar_tpu.core import gbp as jax_gbp
from gbp_poplar_tpu.core import init_state as jax_init_state
from gbp_poplar_tpu.drivers.ba import _polish_problem as jax_polish_problem
from gbp_poplar_tpu.utils import analysis as jax_analysis
from gbp_poplar_tpu.utils import balio as jax_balio
from gbp_poplar_tpu.utils import evaluation as jax_evaluation
from gbp_poplar_tpu_torch import GBPConfig, entry
from gbp_poplar_tpu_torch.core import factor_graph as fg
from gbp_poplar_tpu_torch.core import gbp
from gbp_poplar_tpu_torch.drivers import ba
from gbp_poplar_tpu_torch.tools import memory_ledger as ml
from gbp_poplar_tpu_torch.tools import profile_sweep as ps
from gbp_poplar_tpu_torch.tools import resolve_device
from gbp_poplar_tpu_torch.tools import validate_scale as vs
from gbp_poplar_tpu_torch.utils import balio

torch.set_num_threads(1)

# one sweep's float fields, relative to the field's largest magnitude
# (tests/test_torch_gbp.py's bound)
SWEEP_RTOL = 1e-5
# validate_scale by outcome: final errors relative, MAP costs as the LM
# tests' COST_RTOL, ATE absolute (m)
PX_RTOL = 1e-3
COST_RTOL = 1e-4
ATE_ATOL_M = 1e-4
SMALL_SHAPE = (12, 300, 5)
SMALL_ITERS = 100


def _assert_state_close(out, want):
    for f in fg.STATE_FIELDS:
        a, b = want[f], out[f]
        assert a.shape == b.shape, f
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            np.testing.assert_allclose(
                b, a, rtol=SWEEP_RTOL,
                atol=SWEEP_RTOL * max(np.abs(a).max(), 1e-30), err_msg=f)


def test_entry_sweep_matches_jax_entry():
    """entry(device="cpu") builds the JAX entry's problem and state; one
    sweep of each agrees field by field."""
    jfn, (js, jg) = jax_entry.entry()
    fn, (state, graph) = entry.entry(device="cpu")
    assert state.pk.device.type == "cpu"
    _assert_state_close(fg.state_to_numpy(state),
                        {f: np.asarray(getattr(js, f))
                         for f in fg.STATE_FIELDS})
    assert fn(state, graph) is state
    want = jax.jit(jfn)(js, jg)
    _assert_state_close(fg.state_to_numpy(state),
                        {f: np.asarray(getattr(want, f))
                         for f in fg.STATE_FIELDS})


def test_dryrun_multichip_on_gloo_ranks():
    """Both sharding modes, the insertion and the kernel sweep on two CPU
    ranks: finite errors, the same on both ranks."""
    out = entry.dryrun_multichip(2, device_type="cpu")
    assert len(out) == 2
    for r in out:
        assert r["device"] == "cpu"
        for k in ("edge_sharded", "map_sharded", "after_insertion"):
            assert np.isfinite(r[k]), k
    assert out[0] == out[1]


def test_tools_need_a_card_unless_told(monkeypatch):
    """Without GBP_PLATFORM=cpu the tools take cuda:0 and stop without
    one; an explicit device or GBP_PLATFORM=cpu runs on the CPU."""
    monkeypatch.delenv("GBP_PLATFORM", raising=False)
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(SystemExit):
            resolve_device()
        with pytest.raises(SystemExit):
            entry.entry()
    assert resolve_device("cpu").type == "cpu"
    monkeypatch.setenv("GBP_PLATFORM", "cpu")
    assert resolve_device().type == "cpu"


def _jax_protocol(n_iters: int) -> dict:
    """scripts/validate_scale.py's steps through the JAX library."""
    prob = jax_balio.synthetic_problem_large(*SMALL_SHAPE)
    cfg = JaxConfig()
    graph = jax_build_graph(prob, cfg)
    final, diag = jax.jit(lambda s: jax_gbp.solve(s, graph, cfg,
                                                  n_iters=n_iters))(
        jax_init_state(prob, cfg))
    cam_mu, lmk_mu = jax_analysis.belief_means(final)
    graph1, pri = jax_polish_problem(prob, cfg)
    gbp_cost = float(jax_gn.map_cost(jnp.asarray(cam_mu),
                                     jnp.asarray(lmk_mu), graph1, pri, cfg))
    res_p = jax_gn.solve_lm(jnp.asarray(cam_mu), jnp.asarray(lmk_mu),
                            graph1, pri, cfg, n_lm_iters=vs.POLISH_ITERS)
    cam_g, lmk_g = jnp.asarray(prob.cam_means), jnp.asarray(prob.lmk_means)
    lam = 1e-4
    for _ in range(vs.COLD_ROUNDS):
        res_g = jax_gn.solve_lm(cam_g, lmk_g, graph1, pri, cfg,
                                n_lm_iters=vs.COLD_ITERS, lambda0=lam)
        cam_g, lmk_g, lam = res_g.cam, res_g.lmk, float(res_g.lm_lambda)
    gn_cam = np.asarray(res_g.cam)
    return {
        "gbp_err": float(np.asarray(diag.reproj_err)[-1]),
        "gbp_cost": gbp_cost,
        "polish_err": float(res_p.reproj_err[-1]),
        "polish_cost": float(np.asarray(res_p.cost)[-1]),
        "gn_err": float(res_g.reproj_err[-1]),
        "gn_cost": float(np.asarray(res_g.cost)[-1]),
        "ate_gbp": jax_evaluation.ate_rmse(cam_mu, gn_cam),
        "ate_polish": jax_evaluation.ate_rmse(np.asarray(res_p.cam), gn_cam),
    }


def test_validate_scale_matches_jax_protocol():
    got = vs.validate(balio.synthetic_problem_large(*SMALL_SHAPE),
                      SMALL_ITERS, device="cpu")
    want = _jax_protocol(SMALL_ITERS)
    for k in ("gbp_err", "polish_err", "gn_err"):
        np.testing.assert_allclose(got[k], want[k], rtol=PX_RTOL, err_msg=k)
    for k in ("gbp_cost", "polish_cost", "gn_cost"):
        np.testing.assert_allclose(got[k], want[k], rtol=COST_RTOL,
                                   err_msg=k)
    for k in ("ate_gbp", "ate_polish"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATE_ATOL_M,
                                   err_msg=k)
    np.testing.assert_allclose(got["ratio_polish"], 1.0, rtol=0, atol=1e-4)
    # the census follows the polish: same decisions, every block finite
    cen = got["census"]
    assert cen["same_decisions_as_polish"]
    assert cen["blocks"] == SMALL_SHAPE[0]
    for k in ("cholesky_ex_device", "cholesky_ex_cpu", "unrolled_device",
              "unrolled_cpu"):
        assert cen[k] == [0] * vs.POLISH_ITERS, k
    assert any(line.startswith("cost ratio GBP/GN")
               for line in vs.report(got))


def _live_tensors(obj, seen: dict) -> dict:
    """{storage pointer: bytes} of every tensor reachable through the
    object's attributes and containers, walked independently of
    ``ml.tally``."""
    if isinstance(obj, torch.Tensor):
        seen[obj.untyped_storage().data_ptr()] = obj.nbytes
    elif isinstance(obj, dict):
        for v in obj.values():
            _live_tensors(v, seen)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _live_tensors(v, seen)
    elif hasattr(obj, "__dict__"):
        for v in vars(obj).values():
            _live_tensors(v, seen)
    return seen


def test_memory_ledger_tallies_the_live_tensors():
    """After a production ledger run's stages (the coarse step adds its
    derived segments) the tallies equal the bytes of the tensors the
    graph and state hold; pk alone is 436 B a padded edge."""
    shape = SMALL_SHAPE
    cfg = GBPConfig()
    prob = balio.synthetic_problem_large(*shape)
    graph = fg.build_graph(prob, cfg, "cpu")
    state = fg.init_state(prob, cfg, "cpu")
    from gbp_poplar_tpu_torch.core import coarse
    coarse.group_segments(graph, 4)
    assert graph.derived
    for obj in (graph, state):
        want = sum(_live_tensors(obj, {}).values())
        assert sum(n for _, _, n in ml.tally(obj)) == want
    names = [f for f, _, _ in ml.tally(graph)]
    assert "cam_seg.plan.order" in names
    assert any(f.startswith("derived[") for f in names)
    e = graph.n_edges
    pk = dict((f, n) for f, _, n in ml.tally(state))["pk"]
    assert pk / e == 436
    assert sum(n for _, _, n in ml.tally(state)) / e >= 436

    r = ml.ledger(shape, production=True, n_sweeps=12, iter_offset=0,
                  polish_iters=2, slice_edges=300, device="cpu", oracle=True)
    assert r["oom"] is None
    # the solver's error after initialise is the float64 host oracle's at
    # the same means, to float32 rounding
    np.testing.assert_allclose(r["err_initialise"], r["oracle_initialise"],
                               rtol=1e-5)
    assert [s["stage"] for s in r["stages"]] == [
        "build", "initialise", "run_gbp", "coarse step",
        "LM polish (2 iterations)"]
    assert r["slice"]["bit_identical"] and r["slice"]["ok"]
    assert len(r["errs"]) == 12 and r["errs"][-1] < r["err_initialise"]
    assert r["pk_elements"] == 109 * r["padded"]
    state_b = sum(n for _, _, n in r["state"]) / r["padded"]
    assert state_b >= 436
    assert any("derived[" in f for f, _, _ in r["graph"])
    assert any(line.startswith("== GBPState") for line in ml.report(r))


def test_exact_edge_graph_is_the_polish_graph():
    """The ledger's polish graph, cut from the padded graph, equals the
    one ``drivers.ba._polish_problem`` builds."""
    prob = balio.synthetic_problem_large(*SMALL_SHAPE)
    cfg = GBPConfig()
    cut = ml.exact_edge_graph(fg.build_graph(prob, cfg, "cpu"),
                              prob.n_edges)
    built, _ = ba._polish_problem(prob, cfg, "cpu")
    a, b = ml.tally(cut), ml.tally(built)
    assert [r[:2] for r in a] == [r[:2] for r in b]
    for f in fg.GRAPH_FIELDS:
        x, y = getattr(cut, f), getattr(built, f)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f
    for side in ("cam_seg", "lmk_seg"):
        for f in ("ptr", "var"):
            assert torch.equal(getattr(getattr(cut, side), f),
                               getattr(getattr(built, side), f))


def test_venice_like_shape():
    assert ml.venice_like_shape(4.97) == (1775, 994000, 5)
    c, l, k = ml.venice_like_shape(1.0, 7)
    assert k == 7 and abs(l * k - 1e6) <= k


def _write_trace(path, events):
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


def test_busy_share_on_a_hand_made_trace(tmp_path):
    """Two sweep kernels 0-10 and 30-40 us, a reduce 10-20 us, a copy
    15-25 us (overlapping it) and an event outside the span: busy 35 of
    the 40 us span (0-25 and 30-40)."""
    ev = [dict(ph="X", cat="kernel", name="gbp::sweep_kernel(args)", ts=0,
               dur=10),
          dict(ph="X", cat="kernel", name="gbp::reduce_seq(args)", ts=10,
               dur=10),
          dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoD", ts=15, dur=10),
          dict(ph="X", cat="kernel", name="gbp::sweep_kernel(args)", ts=30,
               dur=10),
          dict(ph="X", cat="kernel", name="late", ts=50, dur=5),
          dict(ph="X", cat="cpu_op", name="aten::add", ts=0, dur=100),
          dict(ph="i", cat="kernel", name="marker", ts=5)]
    trace = str(tmp_path / "t.json")
    _write_trace(trace, ev)
    span, busy, top = ps.busy_share(trace, ps.SWEEP_MARK)
    assert span == pytest.approx(0.040)
    assert busy == pytest.approx(35 / 40)
    assert top[0] == ("gbp::sweep_kernel(args)", pytest.approx(0.020), 2)
    per = ps.kernel_times(trace)
    assert per["late"] == (5, 1)
    assert per["gbp::sweep_kernel(args)"] == (20, 2)
    assert "aten::add" not in per
    with pytest.raises(ValueError):
        ps.busy_share(trace, "no_such_kernel")


def test_profile_sweep_on_a_recorded_cpu_trace():
    """profile_run on the CPU: the trace's top-level host operators, each
    once (their times add up to at most the span, which they cover at
    most whole), and the report's lines."""
    cfg = GBPConfig(accel_every=0)
    prob = balio.synthetic_problem_large(*SMALL_SHAPE)
    graph = fg.build_graph(prob, cfg, "cpu")
    state = gbp.initialise(fg.init_state(prob, cfg, "cpu"), graph, cfg)
    r = ps.profile_run(state, graph, cfg, 3, diagnostics=True)
    assert r["device"] == "cpu" and r["sweeps"] == 3
    assert 0.0 < r["busy"] <= 1.0
    names = [k[0] for k in r["kernels"]]
    assert "aten::index_add_" in names
    assert sum(k[2] for k in r["kernels"]) == pytest.approx(1.0)
    top_us = sum(k[1] for k in r["kernels"]) * 3
    assert top_us <= r["span_ms"] * 1e3 * (1 + 1e-9)
    # the plain segmented sum: two index_add_ a sweep (cameras, landmarks)
    n = dict((k[0], k[3]) for k in r["kernels"])["aten::index_add_"]
    assert n == pytest.approx(2.0)
    lines = ps.report(r)
    assert lines[-1].startswith("busy ") and lines[-1].endswith("cpu")


def test_tool_mains_run_on_the_cpu(monkeypatch, capsys):
    """Each tool's command line on the CPU at a tiny size."""
    monkeypatch.setenv("GBP_PLATFORM", "cpu")
    assert ml.main(["0.002", "--obs", "5", "--sweeps", "3"]) == 0
    out = capsys.readouterr().out
    assert "== GBPState" in out and "stage run_gbp" in out
    assert ps.main(["fr1desk", "2"]) == 0
    assert "us/sweep" in capsys.readouterr().out
    assert ps.main(["nowhere"]) == 2
    assert os.environ["GBP_PLATFORM"] == "cpu"
