"""The program's own spans (``gbp.*`` user annotations, from
``gbp_poplar_tpu_torch/utils/trace.py``) and the CUDA runtime's events in
a traced unit leave every reading of ``tracing.py`` as it was: the trace
it loads, the device's busy time, the kernel times and the breakdown are
those of the same trace without them."""

import json

import tracing


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def _trace(program: bool) -> list:
    """A unit (0-1000 µs) with the benchmark's marks, host operators and
    device events; with ``program``, the solver's spans around them and
    the runtime calls that launched the device events."""
    evs = [
        _ev("user_annotation", "bench.unit", 0, 1000),
        _ev("user_annotation", "bench.gbp", 50, 600),
        _ev("user_annotation", "bench.polish", 700, 250),
        _ev("cpu_op", "aten::mul", 100, 40),
        _ev("cpu_op", "aten::add", 350, 50),
        _ev("cpu_op", "aten::index", 900, 60),
        _ev("kernel", "gbp::sweep_kernel", 150, 60, tid=7, correlation=1),
        _ev("kernel", "gbp::reduce_chunks", 215, 20, tid=7, correlation=2),
        _ev("gpu_memcpy", "Memcpy DtoH", 500, 10, tid=7, correlation=3),
        _ev("kernel", "elementwise", 830, 40, tid=7, correlation=4),
    ]
    if program:
        evs += [
            _ev("user_annotation", "gbp.run_gbp", 60, 580),
            _ev("user_annotation", "gbp.sweeps", 90, 200),
            _ev("user_annotation", "gbp.accel_step", 380, 100),
            _ev("user_annotation", "gbp.solve_lm", 710, 230),
            _ev("user_annotation", "gbp.lm_iter", 715, 200),
            _ev("cuda_runtime", "cudaLaunchKernel", 145, 3, correlation=1),
            _ev("cuda_runtime", "cudaLaunchKernel", 149, 3, correlation=2),
            _ev("cuda_runtime", "cudaMemcpyAsync", 490, 25, correlation=3),
            _ev("cuda_driver", "cuLaunchKernel", 820, 3, correlation=4),
            _ev("gpu_user_annotation", "gbp.sweeps", 150, 85, tid=7),
        ]
    return evs


def _load(tmp_path, program: bool) -> tracing.Trace:
    path = tmp_path / f"{program}.json"
    path.write_text(json.dumps({"traceEvents": _trace(program)}))
    return tracing.load(str(path))


def test_program_spans_leave_the_trace_as_it_was(tmp_path):
    bare, spanned = _load(tmp_path, False), _load(tmp_path, True)
    assert spanned == bare
    assert [m["name"] for m in spanned.marks] == [
        "bench.unit", "bench.gbp", "bench.polish"]
    assert tracing.busy_s(spanned) == tracing.busy_s(bare) == (
        60 + 20 + 10 + 40) / 1e6
    assert tracing.kernel_times(spanned) == tracing.kernel_times(bare)
    assert tracing.breakdown(spanned) == tracing.breakdown(bare)
    # the gaps are named after the benchmark's marks alone, as before
    assert {k for k, _ in tracing.idle_by_host(spanned)} == {
        "bench.unit > python", "bench.gbp > python", "bench.gbp > aten::add",
        "bench.polish > aten::index"}
