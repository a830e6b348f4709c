"""The port's measurement tools bench_sweep, count_edge_ops, bench_ablate,
bench_scaling and scaling_model (``gbp_poplar_tpu_torch/tools/``) on the
CPU, against the JAX package's scripts where they compute a result (the
benchmark itself is tests/test_torch_bench.py's).

The sanity solve of ``bench_sweep`` is held against the JAX script's
60-iteration solve; the per-edge operation tally against the JAX
``scripts/count_edge_ops.py``'s ``count()``; the all-reduce payload that
``scaling_model`` measures against the bytes of the tensors one sharded
sweep sums. Timing is not tested (a CPU time says nothing of a card).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from gbp_poplar_tpu.config import GBPConfig as JaxConfig
from gbp_poplar_tpu.core import build_graph as jax_build_graph
from gbp_poplar_tpu.core import gbp as jax_gbp
from gbp_poplar_tpu.core import init_state as jax_init_state
from gbp_poplar_tpu.utils import balio as jax_balio
from gbp_poplar_tpu_torch import GBPConfig
from gbp_poplar_tpu_torch.core import build_graph, factor_graph as fg
from gbp_poplar_tpu_torch.core import gbp, init_state
from gbp_poplar_tpu_torch.tools import bench_ablate, bench_scaling
from gbp_poplar_tpu_torch.tools import bench_sweep, count_edge_ops
from gbp_poplar_tpu_torch.tools import scaling_model
from gbp_poplar_tpu_torch.utils import balio

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# final errors of two float32 solves of the same problem, relative (the
# PX_RTOL of tests/test_torch_tools.py)
PX_RTOL = 1e-3
# the per-edge operation totals of the two tallies: a jaxpr and aten
# dispatch see different operation sets (``rsub``, ``clamp_min`` and
# composite ``isfinite`` here; ``convert_element_type`` and ``select_n``
# there), measured 2.1 % and 2.7 % apart
OPS_RTOL = 0.05
SMALL_SHAPE = (12, 300, 5)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(_REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_sweep_sanity_matches_jax_solve(capsys):
    """The sanity solve's first and last errors against the JAX script's
    (``gbp.solve`` of 60 iterations from a fresh state), by outcome."""
    prob = balio.synthetic_problem_large(*SMALL_SHAPE)
    r = bench_sweep.bench(prob, "small", GBPConfig(), 2, sanity=True,
                          device="cpu")
    assert r["edges"] == fg.padded_n_edges(prob, GBPConfig())
    assert r["sweeps"] == 2 and r["ms_per_sweep"] > 0
    assert "small" in capsys.readouterr().out

    jprob = jax_balio.synthetic_problem_large(*SMALL_SHAPE)
    jcfg = JaxConfig()
    _, diag = jax_gbp.solve(jax_init_state(jprob, jcfg),
                            jax_build_graph(jprob, jcfg), jcfg,
                            n_iters=bench_sweep.SANITY_ITERS)
    errs = np.asarray(diag.reproj_err)
    assert r["err_first"] == pytest.approx(float(errs[0]), rel=PX_RTOL)
    assert r["err_last"] == pytest.approx(float(errs[-1]), rel=PX_RTOL)
    assert r["err_last"] < r["err_first"]


def test_bench_sweep_scale_skips_absent_sequences(monkeypatch, capsys):
    """``scale`` names each absent TUM sequence and goes on to the ladder
    (shrunk here to one small rung)."""
    monkeypatch.setattr(bench_sweep, "LADDER", ((12, 300, 5, "rung"),))
    monkeypatch.setenv("GBP_SEQUENCES_DIR", os.path.join(_REPO, "absent"))
    monkeypatch.setattr(balio, "_SEQUENCE_DIRS", [os.path.join(_REPO,
                                                               "absent")])
    rows = bench_sweep.bench_names(["scale"], device="cpu")
    out = capsys.readouterr().out
    for seq in bench_sweep.SEQUENCES:
        assert f"{seq}: not found, skipping" in out
    assert [r["name"] for r in rows] == ["rung"]
    assert "err_first" in rows[0]


@pytest.mark.parametrize("snavely", [False, True])
def test_count_edge_ops_matches_jax_script(snavely):
    """Per-edge totals (one-class + transcendental) in both premu modes
    within OPS_RTOL of the JAX script's, and the same per edge at 256 and
    1,024 edges."""
    jax_count = _script("count_edge_ops")
    cfg = GBPConfig()
    for premu in (False, True):
        ones, trans = count_edge_ops.count(cfg, 1024, snavely, premu)
        j1, jt = jax_count.count(JaxConfig(), 1024, snavely, premu)
        total = sum(ones.values()) + sum(trans.values())
        want = sum(j1.values()) + sum(jt.values())
        assert total == pytest.approx(want, rel=OPS_RTOL), premu
        assert not [n for n in ones if n.startswith("?")], ones
        assert count_edge_ops.count(cfg, 256, snavely, premu) == (ones,
                                                                  trans)


def test_count_edge_ops_surfaces_unknown_operations():
    x = torch.ones(8)
    ones, trans = count_edge_ops.tally(
        lambda: (torch.erf(x) + x.view(2, 4).reshape(8), torch.sqrt(x)))
    assert ones == {"?erf": 8, "add": 8} and trans == {"sqrt": 8}
    r = count_edge_ops.edge_ops(e=256, device="cpu")
    assert r["rates"] is None and set(r["modes"]) == {"per_edge_means",
                                                      "premu"}
    assert "needs a card" in "\n".join(count_edge_ops.report(r))


def test_ops_ms_is_the_slower_pipe():
    rates = count_edge_ops.Rates(one=2e12, trans=1e12, sms=1, clock_mhz=1.0,
                                 source="test")
    assert count_edge_ops.ops_ms(4e9, 1e9, rates) == pytest.approx(2.0)
    assert count_edge_ops.ops_ms(1e9, 3e9, rates) == pytest.approx(3.0)


def test_bench_ablate_runs_and_full_is_the_sweep(capsys):
    """All six programs run; ``full`` leaves the state that k hand
    ``gbp_sweep`` calls leave, to the bit."""
    prob = balio.synthetic_problem_large(*SMALL_SHAPE)
    r = bench_ablate.ablate(prob, "small", k=2, device="cpu")
    assert list(r["ms"]) == list(bench_ablate.PROGRAMS)
    assert all(v > 0 for v in r["ms"].values())
    assert "gath+kern" in capsys.readouterr().out

    cfg = GBPConfig()
    graph = build_graph(prob, cfg, "cpu")
    state = gbp.initialise(init_state(prob, cfg, "cpu"), graph, cfg)
    hand = state.clone()
    for _ in range(3):
        hand = gbp.gbp_sweep(hand, graph, cfg)
    progs = bench_ablate.programs(state, graph, cfg, 3)
    out = progs["full"](state.clone())
    got, want = fg.state_to_numpy(out), fg.state_to_numpy(hand)
    for f in fg.STATE_FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    # the unfused programs change the messages, the gathers nothing
    s = state.clone()
    progs["gather"](s)
    np.testing.assert_array_equal(s.pk.numpy(), state.pk.numpy())
    s = progs["kernel"](state.clone())
    assert not torch.equal(s.pk, state.pk)


@pytest.mark.parametrize("mode", bench_scaling.MODES)
def test_scaling_model_payload_is_the_all_reduced_bytes(mode):
    """One sharded sweep on 2 gloo CPU ranks all-reduces the partial
    belief sums once: cameras and landmarks (27 C + 9 L floats) edge
    sharded, the cameras alone (27 C) map sharded."""
    prob = balio.synthetic_problem_large(*SMALL_SHAPE)
    calls = scaling_model.measure_payload(prob, mode)
    c, l = prob.n_keyframes, prob.n_points
    want = 4 * (27 * c + 9 * l) if mode == "edges" else 4 * 27 * c
    assert calls == [want]
    import torch.distributed as dist
    assert dist.all_reduce.__name__ == "all_reduce"


def test_scaling_model_and_bench_scaling_on_cpu_ranks(capsys):
    """The model's prediction from given T1 and latency; bench_scaling at
    1 and 2 gloo CPU ranks, with each N's all-reduce time a sweep."""
    eff, comm_us = scaling_model.predict(1.0, 450_000, 1, 100.0, 2)
    assert comm_us == pytest.approx(100.0 + 1.0)
    assert eff == pytest.approx(1.0 / (1.0 + 2 * 101e-6 / 1e-3))
    assert scaling_model.predict(1.0, 450_000, 1, 100.0, 1) == (1.0, 0.0)

    prob = balio.synthetic_problem_large(*SMALL_SHAPE)
    r = bench_scaling.scaling(prob, "small", n_sweeps=2, device="cpu",
                              max_n=2)
    assert list(r["rows"]) == [1, 2]
    assert r["rows"][1]["efficiency"] == 1.0
    assert all(v["sweeps_per_sec"] > 0 and v["all_reduce_ms_per_sweep"] > 0
               for v in r["rows"].values())
    assert "not a card's speed" in capsys.readouterr().out


def test_the_latency_is_the_timed_all_reduce_of_the_payload(monkeypatch):
    """``measure_latency_us`` times core/comm.py's ``all_sum`` of one
    buffer of the payload's bytes with ``bench_scaling.all_reduce_ms``
    (the timer of chip_smoke.py phase 14 (a) and of bench_scaling at N),
    ALL_REDUCE_REPS calls after a warm-up; on the CPU host and device
    times are the host's, one number."""
    seen = []
    real = bench_scaling.comm.all_sum

    def spy(group, tensors, *a, **kw):
        seen.append([t.numel() for t in tensors])
        return real(group, tensors, *a, **kw)

    monkeypatch.setattr(bench_scaling.comm, "all_sum", spy)
    us = scaling_model.measure_latency_us(4096, device="cpu")
    assert us > 0 and np.isfinite(us)
    assert seen == [[1024]] * (1 + bench_scaling.ALL_REDUCE_REPS)
