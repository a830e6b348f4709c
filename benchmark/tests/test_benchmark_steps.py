"""The program's own steps reach the per-layer readers: ``tracing.
program_steps`` gives each ``gbp.*`` span's calls, launches, device
events and device seconds in a chrome trace; ``run_cell`` collects the
spans' host totals around the traced window alone (``Run.program``),
unchanged; and each per-step reader gives its number, or None where its
span was not read."""

import json
import time

import pytest
import torch

import harness
import steps
import tracing
from gbp_poplar_tpu_torch.utils import trace as program_trace
from tiny import tiny_cell


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def _call(name, ts, corr, tid=1):
    cat = "cuda_driver" if name.startswith("cu") and not name.startswith(
        "cuda") else "cuda_runtime"
    return _ev(cat, name, ts, 4, tid=tid, correlation=corr)


def _dev(name, ts, dur, corr, cat="kernel"):
    return _ev(cat, name, ts, dur, tid=7, correlation=corr)


def _events() -> list:
    """A solve's steps on thread 1: a run of sweeps (eager launches, a
    set, a synchronisation), an accelerator step that captures (three
    recorded calls, no device events) and replays, a second that replays
    (its graph's kernels carry the graph launch's correlation id), and an
    LM iteration; a launch outside every span, one on another thread inside
    the sweeps' time, and the device's own copy of a span's name."""
    return [
        _ev("user_annotation", "bench.unit", 0, 3000),
        _ev("user_annotation", "gbp.run_gbp", 0, 1000),
        _ev("user_annotation", "gbp.sweeps", 10, 290),
        _ev("user_annotation", "gbp.accel_step", 400, 200),
        _ev("user_annotation", "gbp.accel_capture", 410, 90),
        _ev("user_annotation", "gbp.accel_step", 700, 100),
        _ev("user_annotation", "gbp.solve_lm", 1050, 350),
        _ev("user_annotation", "gbp.lm_iter", 1100, 200),
        _ev("cpu_op", "aten::add", 100, 20),
        _ev("gpu_user_annotation", "gbp.sweeps", 20, 200, tid=7),
        # the sweeps
        _call("cudaLaunchKernel", 20, 1),
        _call("cudaLaunchKernel", 30, 2),
        _call("cudaMemsetAsync", 40, 3),
        _call("cudaStreamSynchronize", 50, 4),
        _call("cudaLaunchKernel", 60, 5),
        _dev("gbp::sweep_kernel<gbp::SweepParams>", 25, 50, 1),
        _dev("gbp::reduce_chunks<float>", 80, 10, 2),
        _dev("Memset (Device)", 95, 2, 3, cat="gpu_memset"),
        _dev("gbp::sweep_kernel<gbp::SweepParams>", 100, 50, 5),
        # the first accelerator step: a capture records, then a replay
        _call("cudaLaunchKernel", 420, 6),
        _call("cudaLaunchKernel", 430, 7),
        _call("cudaMemcpyAsync", 440, 8),
        _call("cudaMemcpyAsync", 510, 9),
        _call("cudaGraphLaunch", 520, 10),
        _dev("Memcpy DtoD (Device -> Device)", 512, 3, 9, cat="gpu_memcpy"),
        _dev("accel_a", 525, 20, 10),
        _dev("accel_b", 545, 30, 10),
        # the second: a replay and a clone by the driver's launch
        _call("cudaMemcpyAsync", 710, 11),
        _call("cudaGraphLaunch", 720, 12),
        _call("cuLaunchKernel", 730, 13),
        _dev("Memcpy DtoD (Device -> Device)", 712, 3, 11, cat="gpu_memcpy"),
        _dev("accel_a", 725, 20, 12),
        _dev("accel_b", 745, 30, 12),
        _dev("clone", 780, 5, 13),
        # the LM iteration
        _call("cudaLaunchKernel", 1150, 14),
        _call("cudaMemcpyAsync", 1200, 15),
        _dev("lm_kernel", 1160, 40, 14),
        _dev("Memcpy DtoH (Device -> Pageable)", 1210, 6, 15,
             cat="gpu_memcpy"),
        # outside every span, and on another thread
        _call("cudaLaunchKernel", 2000, 16),
        _dev("late", 2010, 10, 16),
        _call("cudaLaunchKernel", 30, 17, tid=2),
        _dev("other_thread", 40, 10, 17),
    ]


# span: (calls, launches, device events, device µs)
BY_HAND = {
    "gbp.sweeps": (1, 4, 4, 50 + 10 + 2 + 50),
    "gbp.accel_capture": (1, 3, 0, 0),
    "gbp.accel_step": (2, 3 + 2 + 3, 7, 3 + 20 + 30 + 3 + 20 + 30 + 5),
    "gbp.run_gbp": (1, 12, 11, 112 + 111),
    "gbp.lm_iter": (1, 2, 2, 46),
    "gbp.solve_lm": (1, 2, 2, 46),
}


@pytest.fixture
def hand_steps(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _events()}))
    return tracing.program_steps(str(path))


def test_program_steps_count_by_hand(hand_steps):
    assert set(hand_steps) == set(BY_HAND)
    for name, (calls, launches, events, device_us) in BY_HAND.items():
        st = hand_steps[name]
        assert (st.calls, st.launches, st.events) == (calls, launches,
                                                      events), name
        assert st.device_s == pytest.approx(device_us / 1e6), name
    assert hand_steps["gbp.sweeps"].kernels == {
        "gbp::sweep_kernel<gbp::SweepParams>": 2,
        "gbp::reduce_chunks<float>": 1, "Memset (Device)": 1}


def test_program_steps_reads_a_file_and_its_events_alike(hand_steps):
    assert tracing.program_steps(_events()) == hand_steps


def _run(program=None, step_table=None) -> harness.Run:
    return harness.Run(setup_s=1.0, window_s=1.0, spans={}, counts={},
                       latencies=[], peak_bytes=0, shape=None,
                       program=program, steps=step_table)


PROGRAM = {"gbp.accel_step": (0.054, 27), "gbp.accel_eager": (0.02, 1),
           "gbp.accel_capture": (0.01, 1), "gbp.coarse_step": (0.9, 27),
           "gbp.lm_iter": (1.35, 15), "gbp.sweeps": (0.3, 45)}


def test_each_reader_gives_its_number_by_hand(hand_steps):
    run = _run(PROGRAM, hand_steps)
    want = {
        "accel_ms.ba": 1e3 * 0.054 / 27,
        "accel_replay_share.slam": 100.0 * (1 - 2 / 27),
        "coarse_ms.ba": 1e3 * 0.9 / 27,
        "lm_iter_ms.ba": 1e3 * 1.35 / 15,
        "accel_launches.slam": 8 / 2,
        "sweep_launches.slam": 4 / 2,
        "lm_launches.ba": 2 / 1,
    }
    for name, value in want.items():
        assert harness.reader(name)(run) == pytest.approx(value), name
    # no coarse step in the profiled unit
    assert harness.reader("coarse_launches.ba")(run) is None
    # replays only: a share of 100 %
    assert harness.reader("accel_replay_share.gbp")(_run(
        {"gbp.accel_step": (0.01, 4)})) == 100.0


READERS = {  # reader: the span it reads, in Run.program or Run.steps
    "accel_ms": ("program", steps.ACCEL),
    "accel_replay_share": ("program", steps.ACCEL),
    "coarse_ms": ("program", steps.COARSE),
    "lm_iter_ms": ("program", steps.LM_ITER),
    "accel_launches": ("steps", steps.ACCEL),
    "sweep_launches": ("steps", steps.SWEEPS),
    "coarse_launches": ("steps", steps.COARSE),
    "lm_launches": ("steps", steps.LM_ITER),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_gives_none_where_its_span_was_not_read(name, hand_steps):
    read = harness.reader(name)
    where, span = READERS[name]
    full = {"program": PROGRAM, "steps": dict(hand_steps, **{
        steps.COARSE: tracing.Step(calls=3, launches=9)})}

    def run_with(table):
        parts = dict(full, **{where: table})
        return _run(parts["program"], parts["steps"])

    assert read(run_with(full[where])) is not None
    # the span absent, nothing read (an untraced run, a trace with no
    # device), the span with no calls
    assert read(run_with({k: v for k, v in full[where].items()
                          if k != span})) is None
    assert read(run_with(None)) is None
    empty = (0.0, 0) if where == "program" else tracing.Step()
    assert read(run_with(dict(full[where], **{span: empty}))) is None


def test_sweep_launches_needs_h1_in_its_sweeps(hand_steps):
    table = dict(hand_steps)
    table[steps.SWEEPS] = tracing.Step(calls=1, launches=5, events=1,
                                       kernels={"reduce_seq": 1})
    assert harness.reader("sweep_launches.slam")(_run(None, table)) is None


def _capture_runs(monkeypatch) -> list:
    """The ``Run`` objects ``run_cell`` hands its readers."""
    runs, real = [], harness.reader

    def reader(name):
        read = real(name)

        def wrapped(run):
            runs.append(run)
            return read(run)
        return wrapped

    monkeypatch.setattr(harness, "reader", reader)
    return runs


def _count_collects(monkeypatch) -> list:
    entered, real = [], program_trace.collect

    def collect():
        entered.append(1)
        return real()

    monkeypatch.setattr(program_trace, "collect", collect)
    return entered


@pytest.mark.parametrize("traced", [False, True])
def test_a_tiny_run_collects_the_program_spans_when_traced(monkeypatch,
                                                           traced):
    runs = _capture_runs(monkeypatch)
    entered = _count_collects(monkeypatch)
    cell = tiny_cell("ladybug-ba")
    out = harness.run_cell(cell, 2 ** 31 + 23, 0.3, traced,
                           torch.device("cpu"), time.perf_counter())
    assert runs and all(r is runs[0] for r in runs)
    run = runs[0]
    if not traced:
        assert entered == [] and run.program is None and run.steps is None
        return
    assert entered == [1]
    assert {steps.SWEEPS, steps.COARSE, steps.LM_ITER,
            "gbp.run_gbp"} <= set(run.program)
    for name, (s, n) in run.program.items():
        assert name.startswith("gbp.") and s >= 0.0 and n >= 1
    # the CPU trace holds no CUDA runtime call: no launch is read
    assert run.steps is None
    for name in ("coarse_launches.ba", "lm_launches.ba"):
        assert name not in out["metrics"]
    for name in ("coarse_ms.ba", "lm_iter_ms.ba"):
        assert out["metrics"][name]["value"] > 0.0


def test_an_entry_put_into_the_totals_reaches_a_reader_unchanged(
        monkeypatch):
    """What the program adds to the collected totals besides its spans (a
    counter, say) reaches ``Run.program`` as it was put there."""
    from gbp_poplar_tpu_torch.core import gbp

    runs = _capture_runs(monkeypatch)
    stand_in = {"runs": [3, 1, 4]}
    real = gbp.solve

    def solve(*args, **kwargs):
        if program_trace._totals is not None:
            program_trace._totals["gbp.stand_in"] = stand_in
        return real(*args, **kwargs)

    monkeypatch.setattr(gbp, "solve", solve)
    harness.run_cell(tiny_cell("ladybug-gbp"), 2 ** 31 + 29, 0.3, True,
                     torch.device("cpu"), time.perf_counter())
    assert runs[0].program["gbp.stand_in"] is stand_in
    assert "gbp.run_gbp" in runs[0].program
