"""What the per-step readers (``metrics/<name>.py``) share: a span of the
program (``gbp.*``, ``gbp_poplar_tpu_torch/utils/trace.py``) read per
call, from the traced window's collected totals (``Run.program``:
{span: (host seconds, calls)}) or from the profiled unit's trace
(``Run.steps``: {span: ``tracing.Step``}). Each gives None where the run
read no such thing or the span has no calls."""

ACCEL = "gbp.accel_step"
ACCEL_EAGER = "gbp.accel_eager"
ACCEL_CAPTURE = "gbp.accel_capture"
COARSE = "gbp.coarse_step"
LM_ITER = "gbp.lm_iter"
SWEEPS = "gbp.sweeps"
H1 = "sweep_kernel"       # H1's device events (csrc/sweep.cu sweep_kernel)


def calls(run, span: str) -> int | None:
    """The span's calls in the traced window (None: nothing collected)."""
    if run.program is None:
        return None
    return run.program.get(span, (0.0, 0))[1]


def host_ms(run, span: str) -> float | None:
    """Host ms a call of the span in the traced window: the time the host
    spent issuing the step and any wait the step makes itself."""
    if run.program is None or span not in run.program:
        return None
    s, n = run.program[span]
    return 1e3 * s / n if n else None


def step(run, span: str):
    """The span's ``tracing.Step`` in the profiled unit, if it was called."""
    st = None if run.steps is None else run.steps.get(span)
    return st if st is not None and st.calls else None


def launches(run, span: str) -> float | None:
    """Launches a call of the span in the profiled unit."""
    st = step(run, span)
    return st.launches / st.calls if st is not None else None
