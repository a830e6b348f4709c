"""The solver's spans (utils/trace.py) and the trace readers built on them
(tools/profile_sweep.py ``span_table``, ``idle_by_span``).

With no sink on a span is one shared no-op; collecting changes no bit of
a solve; the spans' calls follow the solve's schedule (one per step, never
one per sweep); a CPU ``torch.profiler`` trace holds them as user
annotations, nested as the calls nest; and the readers attribute a
hand-written trace's device events to the spans that issued them.
"""

import json
import os
import pathlib

import pytest
import torch

from gbp_poplar_tpu_torch import GBPConfig, InitConfig
from gbp_poplar_tpu_torch.core import factor_graph as fg
from gbp_poplar_tpu_torch.core import gauss_newton as gn
from gbp_poplar_tpu_torch.core import gbp, slam
from gbp_poplar_tpu_torch.tools import profile_sweep as ps
from gbp_poplar_tpu_torch.utils import balio, flags, priors, trace

torch.set_num_threads(1)

PAD = 64
SCHEDULE = dict(edge_pad_multiple=PAD, accel_every=4, accel_start=6,
                coarse_groups=2)


@pytest.fixture(scope="module")
def problem():
    return priors.apply_init_noise(
        balio.synthetic_problem_large(8, 120, 4, seed=0),
        InitConfig(trans_noise=0.05, rot_noise=0.5, lmk_noise=0.05, seed=0))


def _initialised(problem, cfg):
    graph = fg.build_graph(problem, cfg, "cpu")
    state = gbp.initialise(fg.init_state(problem, cfg, "cpu"), graph, cfg)
    return graph, state


def _live_chunks(cfg: GBPConfig, n: int, offset: int) -> tuple[int, int]:
    """(accelerator chunks, live ones) of one ``run_gbp`` call, from its
    documented schedule: after ``2 steps - offset`` annealed sweeps, chunks
    of ``accel_every`` when at least two fit; a chunk is live when it ends
    at or after ``accel_start``."""
    warm = min(n, max(0, 2 * cfg.steps - offset))
    n2, off2, ce = n - warm, offset + warm, cfg.accel_every
    chunks = n2 // ce if ce > 0 and n2 >= 2 * ce else 0
    return chunks, sum(off2 + (c + 1) * ce >= cfg.accel_start
                       for c in range(chunks))


def test_no_sink_gives_the_shared_noop():
    assert not torch.autograd._profiler_enabled()
    s = trace.span("gbp.x")
    assert s is trace.OFF and trace.span("gbp.y") is s
    with s as entered:
        assert entered is s
    with trace.collect() as totals:
        assert trace.span("gbp.x") is not trace.OFF
    assert trace.span("gbp.x") is trace.OFF
    assert totals == {}


def test_collect_counts_nested_spans_and_restores_the_outer_sink():
    with trace.collect() as outer:
        with trace.span("gbp.a"):
            with trace.collect() as inner:
                with trace.span("gbp.b"):
                    pass
            with trace.span("gbp.b"):
                pass
        with pytest.raises(ValueError):
            with trace.span("gbp.c"):
                raise ValueError
    assert set(inner) == {"gbp.b"} and inner["gbp.b"][1] == 1
    assert {k: n for k, (_, n) in outer.items()} == {
        "gbp.a": 1, "gbp.b": 1, "gbp.c": 1}
    assert all(s >= 0 for s, _ in outer.values())
    assert outer["gbp.a"][0] >= outer["gbp.b"][0]


@pytest.mark.parametrize("n,offset", [(24, 0), (16, 8)])
def test_collecting_changes_no_bit_of_a_solve(problem, n, offset):
    cfg = GBPConfig(**SCHEDULE)
    out = []
    for on in (False, True):
        graph, state = _initialised(problem, cfg)
        log = []
        if on:
            with trace.collect() as totals:
                state, diag = gbp.run_gbp(state, graph, cfg, n,
                                          iter_offset=offset, accel_log=log)
            assert totals["gbp.accel_step"][1] == len(log) > 0
        else:
            state, diag = gbp.run_gbp(state, graph, cfg, n,
                                      iter_offset=offset, accel_log=log)
        out.append((state, diag, log))
    (s0, d0, l0), (s1, d1, l1) = out
    for f in fg.STATE_FIELDS:
        assert torch.equal(getattr(s0, f), getattr(s1, f)), f
    for a, b in zip(d0, d1):
        assert a is b is None or torch.equal(a, b)
    assert [k for k, _ in l0] == [k for k, _ in l1]


@pytest.mark.parametrize("n,offset,accel_start", [
    (24, 0, 6), (24, 0, 20), (16, 8, 6), (6, 0, 6)])
def test_span_calls_follow_the_schedule(problem, n, offset, accel_start):
    cfg = GBPConfig(**dict(SCHEDULE, accel_start=accel_start))
    graph, state = _initialised(problem, cfg)
    chunks, live = _live_chunks(cfg, n, offset)
    with trace.collect() as totals:
        gbp.run_gbp(state, graph, cfg, n, iter_offset=offset)
    calls = {k: c for k, (_, c) in totals.items()}
    assert calls.get("gbp.accel_step", 0) == live
    assert calls.get("gbp.coarse_step", 0) == live
    assert calls.get("gbp.coarse_increment", 0) == live
    assert calls["gbp.run_gbp"] == 1
    # one span per call of run_gbp's inner sweeps(), whatever its length:
    # the annealed ones, the dead chunks (two calls), each live chunk and
    # the leftover
    dead = chunks - live
    want = 1 + (2 if dead else 0) + live + 1 if chunks else 2
    assert calls["gbp.sweeps"] == want


def test_lm_iterations_are_spans(problem):
    cfg = GBPConfig()
    with trace.collect() as totals:
        gn.solve_problem(problem, cfg, "cpu", n_lm_iters=3)
    calls = {k: c for k, (_, c) in totals.items()}
    assert calls == {"gbp.build_graph": 1, "gbp.solve_lm": 1,
                     "gbp.lm_iter": 3}
    assert totals["gbp.solve_lm"][0] >= totals["gbp.lm_iter"][0]


def test_slam_segments_and_insertions_are_spans():
    problem = balio.synthetic_problem(n_keyframes=5, n_points=40, seed=2,
                                      pixel_noise=0.5)
    cfg = GBPConfig()
    graph = fg.build_graph(problem, cfg, "cpu")
    state = fg.init_state(problem, cfg, "cpu",
                          flags=flags.create_flags(problem, cfg.steps))
    with trace.collect() as totals:
        slam.solve_slam(state, graph, cfg, iters_between_kfs=5,
                        av_depth=6.0)
    calls = {k: c for k, (_, c) in totals.items()}
    assert calls["gbp.segment"] == calls["gbp.run_gbp"] == 4
    assert calls["gbp.insert_keyframe"] == 3
    assert calls["gbp.initialise"] == 1
    assert "gbp.accel_step" not in calls      # 5 sweeps: no chunks


def test_profiler_trace_holds_the_spans(problem, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    cfg = GBPConfig(**SCHEDULE)
    graph, state = _initialised(problem, cfg)
    path = str(tmp_path / "trace.json")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gbp.run_gbp(state, graph, cfg, 24)
    prof.export_chrome_trace(path)
    with open(path) as f:
        evs = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    marks = [e for e in evs if e.get("cat") == "user_annotation"
             and e["name"].startswith("gbp.")]
    _, live = _live_chunks(cfg, 24, 0)
    names = [e["name"] for e in marks]
    assert names.count("gbp.accel_step") == live > 0
    table = ps.span_table(path)
    assert table["gbp.accel_step"][0] == live
    assert table["gbp.run_gbp"][0] == 1
    # every coarse increment lies inside a coarse step, every step inside
    # the run
    run = next(e for e in marks if e["name"] == "gbp.run_gbp")
    steps = [e for e in marks if e["name"] == "gbp.coarse_step"]
    for e in marks:
        assert run["ts"] <= e["ts"] <= e["ts"] + e["dur"] <= (
            run["ts"] + run["dur"])
        if e["name"] == "gbp.coarse_increment":
            assert any(s["ts"] <= e["ts"] and e["ts"] + e["dur"]
                       <= s["ts"] + s["dur"] for s in steps)
    # no device here: no launches to attribute
    assert all(k == 0 for _, k, _, _ in table.values())


def test_no_span_in_an_ops_wrapper():
    ops = pathlib.Path(ps.__file__).parents[1] / "ops"
    for f in ops.glob("*.py"):
        text = f.read_text()
        for word in ("utils import trace", "utils.trace", "span("):
            assert word not in text, (f.name, word)


# ---------------------------------------------------------------------------
# the readers on a hand-written chrome trace (µs)
# ---------------------------------------------------------------------------

def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def _launch(ts, corr, tid=1):
    return _ev("cuda_runtime", "cudaLaunchKernel", ts, 2, tid,
               correlation=corr)


def _kernel(name, ts, dur, corr, cat="kernel"):
    return _ev(cat, name, ts, dur, tid=7, correlation=corr)


def _hand_trace(with_spans: bool = True) -> list:
    """A run (0-1000) holding two accelerator steps and a coarse step
    whose increment is nested in it, on thread 1; one launch on thread 2
    during the coarse step (not inside it: another thread); one kernel
    whose runtime call is not in the trace."""
    spans = [
        _ev("user_annotation", "gbp.run_gbp", 0, 1000),
        _ev("user_annotation", "gbp.accel_step", 100, 100),
        _ev("user_annotation", "gbp.accel_step", 300, 100),
        _ev("user_annotation", "gbp.coarse_step", 500, 300),
        _ev("user_annotation", "gbp.coarse_increment", 550, 100),
        _ev("user_annotation", "bench.gbp", 0, 1000),   # not a program span
    ]
    host = [
        _ev("cpu_op", "aten::mul", 110, 20),
        _launch(115, 1),
        _ev("cpu_op", "aten::add", 310, 20),
        _ev("cpu_op", "aten::index", 440, 40),
        _launch(312, 2), _launch(320, 3),
        _launch(560, 4), _launch(600, 5), _launch(700, 6),
        _launch(610, 7, tid=2),
        _launch(900, 8),
        _ev("cuda_runtime", "cudaStreamSynchronize", 950, 20, correlation=99),
    ]
    device = [
        _kernel("sweep_kernel", 120, 30, 1),
        _kernel("k2", 330, 10, 2), _kernel("copy", 345, 5, 3, "gpu_memcpy"),
        _kernel("k4", 570, 20, 4), _kernel("k5", 620, 10, 5),
        _kernel("set", 710, 10, 6, "gpu_memset"),
        _kernel("k7", 640, 10, 7), _kernel("k8", 910, 40, 8),
        _kernel("orphan", 980, 10, 1234),
    ]
    return (spans if with_spans else spans[-1:]) + host + device


def test_span_table_attributes_device_events_by_correlation():
    table = ps.span_table(_hand_trace())
    assert set(table) == {"gbp.run_gbp", "gbp.accel_step",
                          "gbp.coarse_step", "gbp.coarse_increment"}
    assert table["gbp.accel_step"][:3] == (2, 3, pytest.approx(45e-6))
    assert table["gbp.coarse_increment"][:3] == (1, 2, pytest.approx(30e-6))
    # a nested span's events count for its parent too
    assert table["gbp.coarse_step"][:3] == (1, 3, pytest.approx(40e-6))
    # thread 2's launch and the orphan are no span's; k8 only the run's
    assert table["gbp.run_gbp"][:3] == (1, 7, pytest.approx(125e-6))
    assert table["gbp.accel_step"][3] == pytest.approx(200e-6)
    assert "gbp.lm_iter" not in table


def test_span_table_reads_a_file(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": _hand_trace() + [
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 1, "id": 1}]}))
    assert ps.span_table(str(path)) == ps.span_table(_hand_trace())


def test_idle_by_span_names_gaps_after_the_innermost_span():
    gaps = ps.idle_by_span(_hand_trace(), 0, 1000)
    # gaps (mid): 0-120 (60), 150-330 (240), 720-910 (815), 950-980,
    # 990-1000 in the run alone; 340-345 in the second accelerator step;
    # 350-570 (460) in the run under aten::index; 590-620, 630-640 in the
    # increment; 650-710 (680) in the coarse step after its increment
    assert dict(gaps) == pytest.approx({
        "gbp.run_gbp > python": 530e-6,
        "gbp.run_gbp > aten::index": 220e-6,
        "gbp.coarse_step > python": 60e-6,
        "gbp.coarse_increment > python": 40e-6,
        "gbp.accel_step > python": 5e-6})
    assert [k for k, _ in gaps][:2] == ["gbp.run_gbp > python",
                                        "gbp.run_gbp > aten::index"]
    busy = 30 + 10 + 5 + 20 + 10 + 10 + 10 + 40 + 10
    assert sum(v for _, v in gaps) == pytest.approx((1000 - busy) * 1e-6)
    # without the program's spans the gaps are named by the host alone
    bare = dict(ps.idle_by_span(_hand_trace(with_spans=False), 0, 1000))
    assert bare == pytest.approx({"python": 635e-6,
                                  "aten::index": 220e-6})
    assert ps.span_table(_hand_trace(with_spans=False)) == {}


def test_the_profile_tool_still_reads_a_trace_without_spans(tmp_path):
    """busy_share and kernel_times read the same numbers whether the
    trace holds the solver's spans or not."""
    paths = []
    for with_spans in (True, False):
        p = str(tmp_path / f"{with_spans}.json")
        with open(p, "w") as f:
            json.dump({"traceEvents": _hand_trace(with_spans)}, f)
        paths.append(p)
    assert ps.busy_share(paths[0], None) == ps.busy_share(paths[1], None)
    assert ps.kernel_times(paths[0]) == ps.kernel_times(paths[1])
    assert os.path.getsize(paths[0]) > os.path.getsize(paths[1])
