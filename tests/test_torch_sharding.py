"""The port's edge-sharded solve (parallel/sharding.py, parallel/launch.py)
on gloo process groups of 2 and 3 CPU ranks, against the port's
single-device solve and the JAX package's sharded solver on its virtual
CPU mesh.

The ranks are processes started by ``parallel.run`` (spawned), so this
module imports JAX only inside the tests: a rank imports it to find its
function and must start fast. Every run has a deadline (RANK_TIMEOUT): a
deadlock fails in seconds.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gbp_poplar_tpu_torch import parallel
from gbp_poplar_tpu_torch.config import GBPConfig
from gbp_poplar_tpu_torch.core import build_graph, gbp, init_state
from gbp_poplar_tpu_torch.core import factor_graph as fg
from gbp_poplar_tpu_torch.ops import reduce_kernel
from gbp_poplar_tpu_torch.utils import balio

torch.set_num_threads(1)

RANK_TIMEOUT = 60.0
# 180 edges padded to 256: two ranks split the real edges 128 / 52, three
# 86 / 86 / 8 after a padding of 2 (256 is not a multiple of 3)
PAD = 256
# sweeps of the solves compared by outcome; the accelerator and the
# coarse corrector over 3 groups step once, after sweep 160
N_SOLVE = 200
SOLVE_PX = 0.01
# beliefs after a sweep: summed in another order, to 1e-5 of sum |terms|
BELIEF_RTOL = 1e-5
# against the JAX sharded solver (a separate float32 implementation)
JAX_RTOL = 1e-4


def _problem():
    return balio.synthetic_problem(n_keyframes=6, n_points=60, seed=0,
                                   pixel_noise=0.5)


def _cfg(**kw):
    return GBPConfig(edge_pad_multiple=PAD, **kw)


def _host(state):
    return {f.name: getattr(state, f.name).numpy().copy()
            for f in dataclasses.fields(state)}


def _edge_rank(rank):
    """Each rank: initialise + one sweep of both pipelines, and an N_SOLVE
    solve with the accelerator and the coarse corrector; the gathered
    states and the errors, as NumPy."""
    torch.set_num_threads(1)
    prob = _problem()
    out = {}
    for fused in (True, False):
        cfg = _cfg(fused=fused)
        graph = build_graph(prob, cfg, rank.device)
        solver = parallel.make_sharded_solver(rank.group, cfg)
        g, s = solver.prepare(graph, init_state(prob, cfg, rank.device))
        s = solver.sweep(solver.initialise(s, g), g)
        out[fused] = _host(solver.gather(s, graph.n_edges))
        out[f"listed{fused}"] = g.cam_seg.var.shape[0]
    cfg = _cfg(coarse_groups=3)
    solver = parallel.make_sharded_solver(rank.group, cfg)
    g, s = solver.prepare(build_graph(prob, cfg, rank.device),
                          init_state(prob, cfg, rank.device))
    _, diag = solver.solve(s, g, N_SOLVE)
    out["err"] = diag.reproj_err.numpy()
    out["n_relins"] = diag.n_relins.numpy()
    return out


@pytest.fixture(scope="module", params=[2, 3])
def edge_run(request):
    n = request.param
    return n, parallel.run(_edge_rank, n, device_type="cpu",
                           timeout=RANK_TIMEOUT)


def _single_sweep(fused: bool):
    prob = _problem()
    cfg = _cfg(fused=fused)
    graph = build_graph(prob, cfg, "cpu")
    s = gbp.gbp_sweep(gbp.initialise(init_state(prob, cfg, "cpu"), graph,
                                     cfg), graph, cfg)
    return graph, s


@pytest.mark.parametrize("fused", [True, False])
def test_first_sweep_matches_single_device(edge_run, fused):
    """After initialise the messages are zero, so the first sweep's edge
    fields are the single-device sweep's to the bit; the beliefs, summed
    per rank and then over the ranks, to BELIEF_RTOL of sum |terms|."""
    n, results = edge_run
    got = results[0][fused]
    graph, s1 = _single_sweep(fused)
    for f in ("pk", "damping_count", "robust", "active"):
        np.testing.assert_array_equal(got[f], getattr(s1, f).numpy(), f)
    for bel, prior, seg, rows in (
            ("cam_bel", s1.cam_prior, graph.cam_seg, fg.MSG_CAM_ROWS),
            ("lmk_bel", s1.lmk_prior, graph.lmk_seg, fg.MSG_LMK_ROWS)):
        scale = reduce_kernel.segment_sum_reference(
            s1.pk[rows[0]:rows[1]].abs(), seg, prior.abs()).numpy()
        gap = np.abs(got[bel] - getattr(s1, bel).numpy())
        assert (gap <= BELIEF_RTOL * scale).all(), (bel, gap.max())
    # every rank gathered the same whole state
    for r in results[1:]:
        np.testing.assert_array_equal(r[fused]["pk"], got["pk"])


def test_blocks_list_only_real_edges(edge_run):
    """The ranks' segments together list the 180 real edges: the padding
    in the last block is never listed."""
    n, results = edge_run
    assert sum(r["listedTrue"] for r in results) == _problem().n_edges
    assert results[-1]["listedTrue"] < (-(-PAD // n))


def test_solve_matches_single_device(edge_run):
    """N_SOLVE sweeps with the accelerator and the coarse corrector: the
    same errors as the single-device solve within SOLVE_PX, on every
    rank the same telemetry."""
    n, results = edge_run
    prob = _problem()
    cfg = _cfg(coarse_groups=3)
    _, diag = gbp.solve(init_state(prob, cfg, "cpu"),
                        build_graph(prob, cfg, "cpu"), cfg, N_SOLVE)
    err = diag.reproj_err.numpy()
    got = results[0]["err"]
    assert np.isfinite(got).all()
    assert np.abs(got - err).max() < SOLVE_PX, np.abs(got - err).max()
    for r in results[1:]:
        np.testing.assert_array_equal(r["err"], got)
        np.testing.assert_array_equal(r["n_relins"], results[0]["n_relins"])


def test_matches_the_jax_sharded_solver(edge_run):
    """initialise + one sweep against the JAX package's sharded solver at
    the same rank count on its virtual CPU mesh, normalised by each
    field's largest value."""
    from gbp_poplar_tpu.config import GBPConfig as JaxConfig
    from gbp_poplar_tpu.core import build_graph as jax_graph
    from gbp_poplar_tpu.core import init_state as jax_state
    from gbp_poplar_tpu.parallel import make_mesh, make_sharded_solver

    n, results = edge_run
    got = results[0][True]
    prob = _problem()
    cfg = JaxConfig(edge_pad_multiple=PAD)
    solver = make_sharded_solver(make_mesh(n), cfg)
    g2, st2 = solver.prepare(jax_graph(prob, cfg), jax_state(prob, cfg))
    want = solver.sweep(solver.initialise(st2, g2), g2)
    e = prob.n_edges
    port = {"cam_eta": got["cam_bel"][:6], "cam_lam": got["cam_bel"][6:],
            "lmk_eta": got["lmk_bel"][:3], "lmk_lam": got["lmk_bel"][3:]}
    for name, (a, b) in fg.EDGE_PACK_OFFSETS.items():
        port[name] = got["pk"][a:b][..., :e]
    for name, val in port.items():
        w = np.asarray(getattr(want, name))
        w = w[..., :e] if name in fg.EDGE_PACK_OFFSETS else w
        w = w.reshape(val.shape)
        scale = max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(val / scale, w / scale, rtol=0,
                                   atol=JAX_RTOL, err_msg=name)


def test_pad_edges_matches_jax():
    """pad_edges field by field against the JAX function on the same
    arrays (a pinhole and a Snavely problem: the padding carries camera
    0's intrinsics), exactly; the padded state's fields too."""
    from gbp_poplar_tpu.config import GBPConfig as JaxConfig
    from gbp_poplar_tpu.core import build_graph as jax_graph
    from gbp_poplar_tpu.core import init_state as jax_state
    from gbp_poplar_tpu.parallel import pad_edges as jax_pad

    for prob in (_problem(), balio.synthetic_problem_snavely(
            8, 80, pixel_noise=0.3, seed=3)):
        jcfg = JaxConfig(edge_pad_multiple=PAD)
        jg, js = jax_graph(prob, jcfg), jax_state(prob, jcfg)
        graph = fg.graph_from_numpy(
            {f: np.asarray(getattr(jg, f)) for f in fg.GRAPH_FIELDS
             if getattr(jg, f) is not None}, "cpu")
        state = fg.state_from_numpy(
            {f: np.asarray(getattr(js, f)) for f in fg.STATE_FIELDS}, "cpu")
        for n in (2, 3, 7):
            jg2, js2, jpad = jax_pad(jg, js, n)
            g2, s2, pad = parallel.pad_edges(graph, state, n)
            assert pad == jpad and g2.n_edges % n == 0
            for f in ("cam_idx", "lmk_idx", "meas", "meas_var", "intr"):
                a, b = getattr(g2, f), getattr(jg2, f)
                if b is None:
                    assert a is None
                    continue
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), f)
            got = fg.state_to_numpy(s2)
            for f in fg.STATE_FIELDS:
                np.testing.assert_array_equal(
                    got[f], np.asarray(getattr(js2, f), got[f].dtype), f)


def test_port_padding_is_inert():
    """A solve on the graph padded to a multiple of 7 (its segments list
    the same real edges) is the unpadded solve to the bit, and the padding
    emits no message."""
    prob = _problem()
    cfg = _cfg()
    graph, state = build_graph(prob, cfg, "cpu"), init_state(prob, cfg,
                                                             "cpu")
    gp, sp, pad = parallel.pad_edges(graph, state.clone(), 7)
    assert pad > 0
    fa, da = gbp.solve(state, graph, cfg, 30)
    fb, db = gbp.solve(sp, gp, cfg, 30)
    np.testing.assert_array_equal(db.reproj_err.numpy(),
                                  da.reproj_err.numpy())
    np.testing.assert_array_equal(fb.cam_bel.numpy(), fa.cam_bel.numpy())
    np.testing.assert_array_equal(fb.pk[:, :graph.n_edges].numpy(),
                                  fa.pk.numpy())
    msgs = fb.pk[fg.MSG_CAM_ROWS[0]:fg.MSG_LMK_ROWS[1], graph.n_edges:]
    assert (msgs == 0).all()


def _fail_on_rank_one(rank):
    if rank.rank == 1:
        raise ValueError("rank one fails")
    import torch.distributed as dist
    dist.barrier(group=rank.group)


def test_a_failing_rank_ends_the_run():
    """An exception on one rank ends the whole run with an error that
    carries its traceback, well before the deadline."""
    import time

    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank one fails"):
        parallel.run(_fail_on_rank_one, 2, device_type="cpu",
                     timeout=RANK_TIMEOUT)
    assert time.perf_counter() - t0 < RANK_TIMEOUT


def _device_type(rank):
    return rank.device.type


def test_the_ranks_take_the_drivers_device(monkeypatch):
    """Without ``device_type`` the ranks run where the drivers would: on
    the CPU under GBP_PLATFORM=cpu, and with no card and no GBP_PLATFORM
    the run stops with an error instead of falling back to the CPU."""
    monkeypatch.setenv("GBP_PLATFORM", "cpu")
    assert parallel.run(_device_type, 1, timeout=RANK_TIMEOUT) == ["cpu"]
    monkeypatch.delenv("GBP_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        parallel.run(_device_type, 1, timeout=RANK_TIMEOUT)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.run(_device_type, 1, device_type="cuda",
                     timeout=RANK_TIMEOUT)
