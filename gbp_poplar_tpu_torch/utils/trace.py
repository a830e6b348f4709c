"""Spans of the solver's steps: one API, two sinks.

    with trace.span("gbp.accel_step"):
        ...

    @trace.spanned("gbp.build_graph")
    def build_graph(...): ...

A span marks one step of a solve, named ``gbp.`` and the function that
does the work (README.md's section on the port lists them). It goes to each
sink that is on:

- while a ``torch.profiler`` session runs, it is a ``record_function``:
  a ``user_annotation`` event in the same chrome trace as the device
  kernels, on that trace's clock, nested as the calls nest (the drivers'
  ``--profile``; ``tools/profile_sweep.span_table`` reads it);
- inside ``with collect() as totals:``, it adds its seconds by the host's
  clock (``time.perf_counter``, no device synchronisation: the time the
  host spent issuing the step, and any wait the step makes itself) and one
  call to ``totals[name] = (seconds, calls)``.

With neither on, ``span`` reads two flags and returns one shared no-op
object. Under the profiler a span costs ~15 µs, so spans mark steps (a
run of sweeps, an accelerator or coarse step, an LM iteration), never a
single sweep or an ops/ wrapper.
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch

_totals: dict | None = None      # the innermost collect()'s, while it runs


class _Off:
    """The span when no sink is on."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Span:
    __slots__ = ("name", "totals", "mark", "t0")

    def __init__(self, name: str, totals, profiling: bool):
        self.name, self.totals = name, totals
        self.mark = (torch.autograd.profiler.record_function(name)
                     if profiling else None)

    def __enter__(self):
        if self.mark is not None:
            self.mark.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.mark is not None:
            self.mark.__exit__(*exc)
        if self.totals is not None:
            s, n = self.totals.get(self.name, (0.0, 0))
            self.totals[self.name] = (s + dt, n + 1)
        return False


def span(name: str):
    """A context manager marking one step (see the module's docstring)."""
    profiling = torch.autograd._profiler_enabled()
    if _totals is None and not profiling:
        return OFF
    return _Span(name, _totals, profiling)


def spanned(name: str):
    """Decorator: every call of the function is ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def collect():
    """Collect the spans of the block: yields {name: (host seconds,
    calls)}, filled as the spans close."""
    global _totals
    outer, _totals = _totals, {}
    try:
        yield _totals
    finally:
        _totals = outer
