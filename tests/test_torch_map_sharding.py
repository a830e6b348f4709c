"""The port's map-partitioned solve (parallel/map_sharding.py) on gloo
process groups of 2 and 3 CPU ranks: the partitioned layout against the
JAX package's, the block segments, one sweep and a solve against the
single-device solve, and a keyframe insertion against the JAX package's
map-sharded ``insert_keyframe`` on its virtual CPU mesh.

JAX is imported inside the tests only (the spawned ranks import this
module); every run has a deadline (RANK_TIMEOUT).
"""

import dataclasses

import numpy as np
import pytest
import torch

from gbp_poplar_tpu_torch import parallel
from gbp_poplar_tpu_torch.config import GBPConfig
from gbp_poplar_tpu_torch.core import build_graph, gbp, init_state
from gbp_poplar_tpu_torch.core import factor_graph as fg
from gbp_poplar_tpu_torch.core.factor_graph import build_segments
from gbp_poplar_tpu_torch.utils import balio, flags as flags_lib

torch.set_num_threads(1)

RANK_TIMEOUT = 60.0
PAD = 256
N_SOLVE = 100
SOLVE_PX = 0.01
BELIEF_RTOL = 1e-5          # camera beliefs, of sum |terms|
# against the JAX insertion, of each field's max: its priors, beliefs and
# means; the factors relinearised at those means amplify their last-bit
# differences (measured 2e-5) and are held at the sweep comparisons' 1e-4
INSERT_RTOL = 1e-5
FACTOR_RTOL = 1e-4
SLAM_SWEEPS = 20            # before the insertion
AV_DEPTH = 6.0


def _problem():
    return balio.synthetic_problem(n_keyframes=6, n_points=60, seed=0,
                                   pixel_noise=0.5)


def _cfg(**kw):
    return GBPConfig(edge_pad_multiple=PAD, **kw)


def _host(state):
    return {f.name: getattr(state, f.name).numpy().copy()
            for f in dataclasses.fields(state)}


def _map_rank(rank):
    """Each rank: initialise + one sweep, an N_SOLVE solve, and SLAM_SWEEPS
    of a SLAM state then keyframe 2's insertion; the gathered partitioned
    states and the errors, as NumPy."""
    torch.set_num_threads(1)
    prob = _problem()
    cfg = _cfg()
    solver = parallel.make_map_sharded_solver(rank.group, cfg)
    out = {}
    g, s = solver.prepare(build_graph(prob, cfg, rank.device),
                          init_state(prob, cfg, rank.device))
    s = solver.sweep(solver.initialise(s, g), g)
    out["sweep"] = _host(solver.gather(s))
    g, s = solver.prepare(build_graph(prob, cfg, rank.device),
                          init_state(prob, cfg, rank.device))
    _, diag = solver.solve(s, g, N_SOLVE)
    out["err"] = diag.reproj_err.numpy()
    flags = flags_lib.create_flags(prob, cfg.steps)
    g, s = solver.prepare(build_graph(prob, cfg, rank.device),
                          init_state(prob, cfg, rank.device, flags=flags))
    s, _ = solver.run(solver.initialise(s, g), g, SLAM_SWEEPS)
    out["before"] = _host(solver.gather(s))
    s = solver.insert_keyframe(s, g, 2, AV_DEPTH)
    out["after"] = _host(solver.gather(s))
    return out


@pytest.fixture(scope="module", params=[2, 3])
def map_run(request):
    n = request.param
    return n, parallel.run(_map_rank, n, device_type="cpu",
                           timeout=RANK_TIMEOUT)


def _placement(n):
    """(order, dest): where partition_by_landmark puts the real edges."""
    prob = _problem()
    graph = build_graph(prob, _cfg(), "cpu")
    pg, _ = parallel.partition_by_landmark(graph, init_state(prob, _cfg(),
                                                             "cpu"), n)
    lmk = graph.lmk_idx.numpy()[:prob.n_edges]
    l_blk = pg.n_points // n
    shard = np.minimum(lmk // l_blk, n - 1)
    counts = np.bincount(shard, minlength=n)
    order = np.argsort(shard, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)])
    e_blk = pg.n_edges // n
    dest = shard[order] * e_blk + np.arange(prob.n_edges) - starts[
        shard[order]]
    return order, dest, counts


def test_partition_matches_jax():
    """partition_by_landmark field by field against the JAX function on
    the same arrays, exactly, at 2, 3 and 4 blocks."""
    from gbp_poplar_tpu.config import GBPConfig as JaxConfig
    from gbp_poplar_tpu.core import build_graph as jax_graph
    from gbp_poplar_tpu.core import init_state as jax_state
    from gbp_poplar_tpu.parallel import partition_by_landmark as jax_part

    prob = _problem()
    jcfg = JaxConfig(edge_pad_multiple=PAD)
    jg, js = jax_graph(prob, jcfg), jax_state(prob, jcfg)
    graph = fg.graph_from_numpy(
        {f: np.asarray(getattr(jg, f)) for f in fg.GRAPH_FIELDS
         if getattr(jg, f) is not None}, "cpu")
    state = fg.state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in fg.STATE_FIELDS}, "cpu")
    for n in (2, 3, 4):
        jg2, js2 = jax_part(jg, js, n)
        g2, s2 = parallel.partition_by_landmark(graph, state, n)
        assert g2.cam_seg is None and g2.lmk_seg is None
        for f in fg.GRAPH_FIELDS:
            a, b = getattr(g2, f), getattr(jg2, f)
            if b is None:
                assert a is None, f
                continue
            a = a.numpy() if isinstance(a, torch.Tensor) else a
            np.testing.assert_array_equal(a, np.asarray(b), f)
        got = fg.state_to_numpy(s2)
        for f in fg.STATE_FIELDS:
            np.testing.assert_array_equal(
                got[f], np.asarray(getattr(js2, f), got[f].dtype), f)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_rebuilt_segments_equal_the_originals(n):
    """The block segments rebuilt from the plain arrays (a checkpoint's)
    equal the ones built from the edge counts the partition knew."""
    prob = _problem()
    graph = build_graph(prob, _cfg(), "cpu")
    pg, _ = parallel.partition_by_landmark(
        graph, init_state(prob, _cfg(), "cpu"), n)
    _, _, counts = _placement(n)
    e_blk, l_blk = pg.n_edges // n, pg.n_points // n
    rebuilt = parallel.rebuild_partitioned_segments(pg, n)
    for s, (cam_seg, lmk_seg) in enumerate(rebuilt):
        blk = slice(s * e_blk, (s + 1) * e_blk)
        want = (build_segments(pg.cam_idx.numpy()[blk], pg.n_keyframes,
                               counts[s], "cpu"),
                build_segments(pg.lmk_idx.numpy()[blk], l_blk, counts[s],
                               "cpu"))
        for got, ref in zip((cam_seg, lmk_seg), want):
            for f in ("ptr", "perm", "var"):
                a, b = getattr(got, f), getattr(ref, f)
                assert (a is None) == (b is None)
                if a is not None:
                    assert torch.equal(a, b), f
            assert (got.plan is None) == (ref.plan is None)
            if ref.plan is not None:
                for f in ("order", "chunk_runs", "run_start", "var_ptr",
                          "var_runs"):
                    assert torch.equal(getattr(got.plan, f),
                                       getattr(ref.plan, f)), f


def test_first_sweep_matches_single_device(map_run):
    """initialise + one sweep: the edge fields, moved back to the graph's
    order, are the single-device sweep's to the bit; each landmark's sum
    is whole on its rank in the same order, so the landmark beliefs are
    bit-identical too; the camera beliefs within BELIEF_RTOL of sum
    |terms|."""
    n, results = map_run
    got = results[0]["sweep"]
    prob = _problem()
    cfg = _cfg()
    graph = build_graph(prob, cfg, "cpu")
    s1 = gbp.gbp_sweep(gbp.initialise(init_state(prob, cfg, "cpu"), graph,
                                      cfg), graph, cfg)
    order, dest, _ = _placement(n)
    for f in ("pk", "damping_count", "robust", "active"):
        np.testing.assert_array_equal(got[f][..., dest],
                                      getattr(s1, f).numpy()[..., order], f)
    np.testing.assert_array_equal(got["lmk_bel"][:, :prob.n_points],
                                  s1.lmk_bel.numpy())
    from gbp_poplar_tpu_torch.ops import reduce_kernel
    rows = s1.pk[fg.MSG_CAM_ROWS[0]:fg.MSG_CAM_ROWS[1]]
    scale = reduce_kernel.segment_sum_reference(
        rows.abs(), graph.cam_seg, s1.cam_prior.abs()).numpy()
    gap = np.abs(got["cam_bel"] - s1.cam_bel.numpy())
    assert (gap <= BELIEF_RTOL * scale).all(), gap.max()


def test_solve_matches_single_device(map_run):
    n, results = map_run
    prob = _problem()
    cfg = _cfg()
    _, diag = gbp.solve(init_state(prob, cfg, "cpu"),
                        build_graph(prob, cfg, "cpu"), cfg, N_SOLVE)
    got = results[0]["err"]
    assert np.isfinite(got).all()
    assert np.abs(got - diag.reproj_err.numpy()).max() < SOLVE_PX
    for r in results[1:]:
        np.testing.assert_array_equal(r["err"], got)


def test_insertion_matches_the_jax_map_sharded_one(map_run):
    """Keyframe 2's insertion on the same partitioned state, against the
    JAX package's map-sharded ``insert_keyframe`` at the same rank count:
    the new landmarks at the depth averaged over the ranks, the priors,
    flags, beliefs and means to INSERT_RTOL of each field's largest value,
    the factors relinearised at them to FACTOR_RTOL."""
    from gbp_poplar_tpu.config import GBPConfig as JaxConfig
    from gbp_poplar_tpu.core import build_graph as jax_graph
    from gbp_poplar_tpu.core import init_state as jax_state
    from gbp_poplar_tpu.core.factor_graph import GBPState as JaxState
    from gbp_poplar_tpu.parallel import (make_map_sharded_solver, make_mesh,
                                         partition_by_landmark as jax_part)

    n, results = map_run
    before, after = results[0]["before"], results[0]["after"]
    prob = _problem()
    jcfg = JaxConfig(edge_pad_multiple=PAD)
    flags = flags_lib.create_flags(prob, jcfg.steps)
    jg, _ = jax_part(jax_graph(prob, jcfg),
                     jax_state(prob, jcfg, flags=flags), n)
    fields = fg.state_to_numpy(fg.GBPState(**{
        k: torch.tensor(v) for k, v in before.items()}))
    solver = make_map_sharded_solver(make_mesh(n), jcfg)
    want = solver.insert_keyframe(JaxState(**fields), jg, 2, AV_DEPTH)
    got = fg.state_to_numpy(fg.GBPState(**{
        k: torch.tensor(v) for k, v in after.items()}))
    assert not np.array_equal(got["lmk_prior_eta"], fields["lmk_prior_eta"])
    for f in fg.STATE_FIELDS:
        w = np.asarray(getattr(want, f)).astype(got[f].dtype)
        if got[f].dtype.kind in "biu":
            np.testing.assert_array_equal(got[f], w, f)
            continue
        scale = max(np.abs(w).max(), 1e-30)
        tol = FACTOR_RTOL if f.startswith("f_") else INSERT_RTOL
        np.testing.assert_allclose(got[f] / scale, w / scale, rtol=0,
                                   atol=tol, err_msg=f)
