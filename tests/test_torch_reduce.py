"""The chunk plan of H3's two-pass sum over permuted segments
(core/factor_graph.chunk_plan), checked on the CPU.

The plan is built once per graph in NumPy; the kernel (csrc/reduce.cu)
trusts it: every listed edge in exactly one run, the runs of a chunk in
variable order, the edges of a run ascending, each variable's runs listed
once in chunk order, so each sum has one fixed order. The sums themselves are held against the plain version in
tests/test_torch_kernel_math.py (host build) and on the card.
"""

import numpy as np
import pytest
import torch

from gbp_poplar_tpu_torch.config import GBPConfig
from gbp_poplar_tpu_torch.core import coarse
from gbp_poplar_tpu_torch.core import factor_graph as fg
from gbp_poplar_tpu_torch.utils import balio

torch.set_num_threads(1)


def _graph(shuffle: bool, n_keyframes=30, n_points=4000):
    prob = balio.synthetic_problem_large(n_keyframes=n_keyframes,
                                         n_points=n_points, obs_per_lmk=5,
                                         seed=4)
    if shuffle:
        perm = np.random.default_rng(4).permutation(prob.n_keyframes)
        prob.cam_idx = perm[prob.cam_idx].astype(prob.cam_idx.dtype)
    return fg.build_graph(prob, GBPConfig(edge_pad_multiple=1), "cpu")


def _edge_vars(seg):
    """The variable of each listed edge, in edge order."""
    var = np.empty(seg.var.shape[0], np.int64)
    var[seg.perm.numpy()] = seg.var.numpy()
    return var


def _check_plan(seg):
    plan = seg.plan
    var = _edge_vars(seg)
    n, k = len(var), plan.chunk
    order = plan.order.numpy().astype(np.int64)
    chunk_runs = plan.chunk_runs.numpy()
    run_start = plan.run_start.numpy()
    assert plan.n_chunks == -(-n // k)
    assert chunk_runs[0] == 0 and chunk_runs[-1] == plan.n_runs
    run_var = np.empty(plan.n_runs, np.int64)
    run_chunk = np.empty(plan.n_runs, np.int64)
    seen = np.zeros(n, np.int64)
    for c in range(plan.n_chunks):
        e0, count = c * k, min(k, n - c * k)
        edges = e0 + order[e0:e0 + count]
        seen[edges] += 1
        starts = run_start[chunk_runs[c]:chunk_runs[c + 1]]
        assert starts[0] == 0 and np.all(np.diff(starts) > 0)
        ends = np.append(starts[1:], count)
        for j, (b, e) in enumerate(zip(starts, ends)):
            run = edges[b:e]
            v = var[run[0]]
            # the run is exactly chunk c's edges of variable v, ascending
            want = e0 + np.flatnonzero(var[e0:e0 + count] == v)
            np.testing.assert_array_equal(run, want)
            run_var[chunk_runs[c] + j] = v
            run_chunk[chunk_runs[c] + j] = c
        # runs in variable order inside the chunk
        assert np.all(np.diff(run_var[chunk_runs[c]:chunk_runs[c + 1]]) > 0)
    np.testing.assert_array_equal(seen, 1)
    # each variable's runs, every run once, in ascending chunk order
    var_ptr, var_runs = plan.var_ptr.numpy(), plan.var_runs.numpy()
    np.testing.assert_array_equal(np.sort(var_runs), np.arange(plan.n_runs))
    for v in range(seg.n_var):
        runs = var_runs[var_ptr[v]:var_ptr[v + 1]]
        assert np.all(run_var[runs] == v)
        assert np.all(np.diff(run_chunk[runs]) > 0)


@pytest.mark.parametrize("kind", ["cameras shuffled", "cameras in order",
                                  "camera groups", "landmark groups",
                                  "group pairs", "keyframes by group"])
def test_chunk_plan_lists_every_edge_once_in_order(kind):
    graph = _graph(shuffle=kind != "cameras in order")
    groups = coarse.group_segments(graph, 4)
    seg = {"cameras shuffled": graph.cam_seg,
           "cameras in order": graph.cam_seg,
           "camera groups": groups.edge_cam,
           "landmark groups": groups.lmk,
           "group pairs": groups.edge_pair,
           "keyframes by group": groups.cam}[kind]
    if kind == "keyframes by group":
        # already in group order: contiguous, no permutation and no plan
        assert seg.perm is None and seg.plan is None
        return
    assert seg.perm is not None and seg.plan is not None
    _check_plan(seg)


def test_chunk_plan_sizes():
    """Chunks of PLAN_CHUNK edges whatever the number of variables, the
    offsets in int16, one run per (chunk, variable) present; no plan for
    contiguous segments."""
    rng = np.random.default_rng(0)
    for n_var in (16, 1778, 5000):
        ids = rng.integers(0, n_var, 40000)
        plan = fg.chunk_plan(ids, n_var, "cpu")
        assert plan.chunk == fg.PLAN_CHUNK and plan.order.dtype == torch.int16
        assert int(plan.order.max()) < plan.chunk
        pairs = {(e // plan.chunk, v) for e, v in enumerate(ids.tolist())}
        assert plan.n_runs == len(pairs)
    graph = _graph(shuffle=True, n_points=4001)
    assert graph.lmk_seg.perm is None and graph.lmk_seg.plan is None
    assert graph.n_edges % 2 == 1         # an odd, ragged last chunk
    _check_plan(graph.cam_seg)


@pytest.mark.parametrize("kind", ["cameras shuffled", "group pairs"])
def test_plain_segment_sum_keeps_its_cpu_bits(kind):
    """The plain segmented sum on the CPU (``segment_sum_reference``; on a
    card it runs under PyTorch's deterministic algorithms instead) adds a
    variable's edges one at a time in listed order, then the prior: the
    same bits as NumPy's unbuffered ``np.add.at`` in float32, on permuted
    segments of hundreds of edges per variable whose terms span six
    decades, so that any other order would show."""
    from gbp_poplar_tpu_torch.ops import reduce_kernel

    g = _graph(True)
    seg = (g.cam_seg if kind == "cameras shuffled"
           else coarse.group_segments(g, 4).edge_pair)
    assert seg.perm is not None
    n = seg.var.shape[0]
    assert n / seg.n_var > 500
    rng = np.random.default_rng(9)
    rows = (rng.normal(0, 1, (27, n)) * 10.0 ** rng.integers(-3, 3, (27, n))
            ).astype(np.float32)
    prior = rng.normal(0, 1, (27, seg.n_var)).astype(np.float32)
    got = reduce_kernel.segment_sum(torch.tensor(rows), seg,
                                    torch.tensor(prior))
    want = np.zeros((27, seg.n_var), np.float32)
    np.add.at(want, (slice(None), seg.var.numpy()),
              rows[:, seg.perm.numpy()])
    want = prior + want
    np.testing.assert_array_equal(got.numpy(), want)
    exact = prior + np.zeros((27, seg.n_var))
    np.add.at(exact, (slice(None), seg.var.numpy()),
              rows[:, seg.perm.numpy()].astype(np.float64))
    assert not np.array_equal(want, exact.astype(np.float32))
