"""The port's fixed-point accelerator and chunked ``run_gbp`` against the
JAX package.

``_accel_step`` is compared from the same (state, snap, avg), taken at
real chunk boundaries of a solve whose accelerator meets all three
outcomes: no aligned displacement (gain 0), a jump rejected by the cost
guard, and a jump accepted. Its discrete decisions rest on global float32
sums (rates, costs) that the two stacks add in other orders, so costs are
held to COST_RTOL, the shifted fields to SWEEP_RTOL of their magnitude,
the gain to a float64 NumPy evaluation of its formula within GAIN_RTOL,
and every decision must be equal. Whole solves are compared by outcome:
the final error within the tolerances of tests/test_torch_gbp.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gbp_poplar_tpu as jax_pkg
from gbp_poplar_tpu.config import GBPConfig as JaxConfig
from gbp_poplar_tpu.config import InitConfig as JaxInitConfig
from gbp_poplar_tpu.core import build_graph as jax_build_graph
from gbp_poplar_tpu.core import factor_graph as jax_fg
from gbp_poplar_tpu.core import gbp as jax_gbp
from gbp_poplar_tpu.core import init_state as jax_init_state
from gbp_poplar_tpu.utils import balio as jax_balio
from gbp_poplar_tpu.utils import priors as jax_priors
from gbp_poplar_tpu_torch import GBPConfig, InitConfig, solve_ba
from gbp_poplar_tpu_torch.core import factor_graph as fg
from gbp_poplar_tpu_torch.core import gbp
from gbp_poplar_tpu_torch.utils import balio, priors

torch.set_num_threads(1)

# float32 sums of a few thousand terms in another order, and the prior
# quadratic's cancellation (strong anchor priors): measured 8.3e-8
COST_RTOL = 1e-5
# one accelerator step: the shift is gain * Lambda @ d, d a difference of
# chunk averages; measured 8.4e-8 of the field's magnitude
SWEEP_RTOL = 1e-5
# gain = r / (1 - r) from float32 sums, against float64: the rate's
# rounding amplified by 1 / (1 - r); measured 2.4e-7
GAIN_RTOL = 1e-4
SOLVE_ATOL_PX = 0.01         # as tests/test_torch_gbp.py
SOLVE_RTOL = 0.01
PAD = 256
ACCEL = dict(accel_every=8, accel_start=10)


def _noisy():
    """Ladybug-like visibility at 20 keyframes (3,000 edges), landmarks
    perturbed by 5 cm. In the first 40 sweeps the accelerator meets an
    unaligned chunk (sweep 18), a jump the cost guard rejects (sweep 26,
    cost up by 2.6e-6 relative) and one it accepts (sweep 34, down by
    2.4e-6): both margins are ~25 times the two stacks' cost agreement."""
    kw = dict(n_keyframes=20, n_points=600, obs_per_lmk=5, seed=0)
    tp = priors.apply_init_noise(balio.synthetic_problem_large(**kw),
                                 InitConfig(lmk_noise=0.05, seed=0))
    jp = jax_priors.apply_init_noise(jax_balio.synthetic_problem_large(**kw),
                                     JaxInitConfig(lmk_noise=0.05, seed=0))
    return tp, jp


def _jax_state(fields):
    return jax_fg.GBPState(**{f: jnp.asarray(fields[f])
                              for f in fg.STATE_FIELDS})


@pytest.fixture(scope="module")
def boundaries():
    """The port's solve of the noisy problem, recording the inputs of
    every ``_accel_step``: (port problem, JAX problem, [(state fields,
    snap, avg, AccelStep)])."""
    tp, jp = _noisy()
    cfg = GBPConfig(edge_pad_multiple=PAD, **ACCEL)
    g = fg.build_graph(tp, cfg, "cpu")
    s = gbp.initialise(fg.init_state(tp, cfg, "cpu"), g, cfg)
    steps = []
    real = gbp._accel_step

    def spy(state, snap, avg, graph, cfg_, degs, **kw):
        rec = (fg.state_to_numpy(state), [x.numpy().copy() for x in snap],
               [x.numpy().copy() for x in avg])
        out = real(state, snap, avg, graph, cfg_, degs, **kw)
        steps.append(rec + (out[2],))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gbp, "_accel_step", spy)
        gbp.run_gbp(s, g, cfg, 40, with_diagnostics=False)
    return tp, jp, steps


def _gain64(snap, avg, cfg):
    """The extrapolation gain of ``_accel_step``, in float64 NumPy."""
    dc = avg[0].astype(np.float64) - snap[0]
    dprev = snap[2].astype(np.float64)
    num, den, cur = (dc * dprev).sum(), (dprev * dprev).sum(), (dc * dc).sum()
    if not (den > 0 and cur > 0):
        return 0.0
    r = num / den
    if not (num * num / (den * cur) > 0.8 and r > 0.1):
        return 0.0
    r = min(r, cfg.accel_max_rate)
    gain = r / (1.0 - r)
    step = gain * np.sqrt((dc * dc).sum(axis=0).max())
    return gain * min(1.0, cfg.accel_max_step / max(step, 1e-30))


def test_map_cost_matches_jax(boundaries):
    tp, jp, steps = boundaries
    jc = JaxConfig(edge_pad_multiple=PAD, **ACCEL)
    tc = GBPConfig(edge_pad_multiple=PAD, **ACCEL)
    jg = jax_build_graph(jp, jc)
    g = fg.build_graph(tp, tc, "cpu")
    for fields, _, _, _ in steps:
        want = float(jax_gbp.map_cost(_jax_state(fields), jg, jc))
        got = gbp.map_cost(fg.state_from_numpy(fields, "cpu"), g, tc).item()
        np.testing.assert_allclose(got, want, rtol=COST_RTOL)


@pytest.mark.parametrize("case", ["unaligned", "rejected", "accepted"])
def test_accel_step_matches_jax(boundaries, case):
    tp, jp, steps = boundaries
    jc = JaxConfig(edge_pad_multiple=PAD, **ACCEL)
    tc = GBPConfig(edge_pad_multiple=PAD, **ACCEL)
    # the first boundary of each outcome in the recorded solve
    pick = {"unaligned": lambda i: float(i.gain) == 0.0,
            "rejected": lambda i: not bool(i.accepted),
            "accepted": lambda i: float(i.gain) > 0 and bool(i.accepted)}
    fields, snap, avg, _ = next(st for st in steps if pick[case](st[3]))
    g = fg.build_graph(tp, tc, "cpu")
    state = fg.state_from_numpy(fields, "cpu")
    t_state, t_snap, info = gbp._accel_step(
        state, tuple(torch.tensor(x) for x in snap),
        tuple(torch.tensor(x) for x in avg), g, tc,
        gbp._active_degrees(state, g, tc))

    jg = jax_build_graph(jp, jc)
    js = _jax_state(fields)
    j_state, j_snap, j_cost = jax_gbp._accel_step(
        js, tuple(jnp.asarray(x) for x in snap),
        tuple(jnp.asarray(x) for x in avg), jg, jc,
        jax_gbp._active_degrees(js, jg, None, False), None, False)

    # the decisions
    moved = not np.array_equal(np.asarray(j_state.cam_eta), fields["cam_eta"])
    assert moved == (case == "accepted")
    assert bool(info.accepted) == (case != "rejected")
    assert (float(info.gain) > 0) == (case != "unaligned")
    np.testing.assert_allclose(float(info.gain), _gain64(snap, avg, tc),
                               rtol=GAIN_RTOL)
    # the costs: JAX returns the kept state's cost; the current one is
    # JAX map_cost at the input state
    np.testing.assert_allclose(
        info.cost_cur.item(), float(jax_gbp.map_cost(js, jg, jc)),
        rtol=COST_RTOL)
    kept = info.cost_cand if bool(info.accepted) else info.cost_cur
    np.testing.assert_allclose(kept.item(), float(j_cost), rtol=COST_RTOL)
    # the shifted fields and the next snap
    out = fg.state_to_numpy(t_state)
    for f in ("cam_eta", "lmk_eta", "msg_c_eta", "msg_l_eta", "cam_lam",
              "msg_c_lam"):
        want = np.asarray(getattr(j_state, f))
        np.testing.assert_allclose(
            out[f], want, rtol=SWEEP_RTOL,
            atol=SWEEP_RTOL * np.abs(want).max(), err_msg=f)
    for a, b in zip(t_snap, j_snap):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=SWEEP_RTOL,
                                   atol=SWEEP_RTOL * np.abs(b).max())


@pytest.fixture(scope="module")
def jax_accel_solve():
    """JAX run_gbp, 48 sweeps with the accelerator, on the noisy problem:
    the per-sweep error."""
    _, jp = _noisy()
    jc = JaxConfig(edge_pad_multiple=PAD, **ACCEL)
    jg = jax_build_graph(jp, jc)
    s = jax.jit(lambda s: jax_gbp.initialise(s, jg, jc))(
        jax_init_state(jp, jc))
    _, d = jax.jit(lambda s: jax_gbp.run_gbp(s, jg, jc, 48))(s)
    return np.asarray(d.reproj_err)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_run_gbp_with_accel_matches_jax(jax_accel_solve, fused):
    """48 sweeps (10 annealed, four chunks of 8 with an accelerator step
    after each, 6 more) from the port's own initialise: the same final
    error as the JAX package, and jumps accepted on the way (measured:
    every sweep's error within 1.2e-5 px of the JAX package's)."""
    tp, _ = _noisy()
    cfg = GBPConfig(edge_pad_multiple=PAD, fused=fused, **ACCEL)
    g = fg.build_graph(tp, cfg, "cpu")
    s = gbp.initialise(fg.init_state(tp, cfg, "cpu"), g, cfg)
    log = []
    _, d = gbp.run_gbp(s, g, cfg, 48, accel_log=log)
    err = d.reproj_err.numpy()
    assert [n for n, _ in log] == [18, 26, 34, 42]
    assert any(float(i.gain) > 0 and bool(i.accepted) for _, i in log)
    assert err.shape == (48,) and err[-1] < err[0]
    np.testing.assert_allclose(err[-1], jax_accel_solve[-1], rtol=SOLVE_RTOL,
                               atol=SOLVE_ATOL_PX)
    np.testing.assert_allclose(err, jax_accel_solve, rtol=0,
                               atol=SOLVE_ATOL_PX)


def test_static_accel_elision(synthetic):
    """Chunks that end before accel_start run as plain sweeps and only the
    last of them averages its means (the JAX package's static dead-chunk
    elision): with iter_offset 10, accel_start 40 and chunks of 8, the
    accelerator steps after sweeps 42, 50 and 58 only, and the solve lands
    where the JAX package's does. With every chunk dead the schedule is
    exactly the accelerator-free one."""
    jc = JaxConfig(accel_every=8, accel_start=40)
    jg = jax_build_graph(synthetic, jc)
    js = jax.jit(lambda s: jax_gbp.initialise(s, jg, jc))(
        jax_init_state(synthetic, jc))
    _, dj = jax.jit(lambda s: jax_gbp.run_gbp(s, jg, jc, 48,
                                               iter_offset=10))(js)
    want = np.asarray(dj.reproj_err)

    def port(**kw):
        cfg = GBPConfig(**kw)
        g = fg.build_graph(synthetic, cfg, "cpu")
        s = gbp.initialise(fg.init_state(synthetic, cfg, "cpu"), g, cfg)
        log = []
        s, d = gbp.run_gbp(s, g, cfg, 48, iter_offset=10, accel_log=log)
        return s, d, log

    _, d, log = port(accel_every=8, accel_start=40)
    assert [n for n, _ in log] == [42, 50, 58]
    np.testing.assert_allclose(d.reproj_err.numpy()[-1], want[-1],
                               rtol=SOLVE_RTOL, atol=SOLVE_ATOL_PX)
    s_dead, d_dead, log_dead = port(accel_every=8, accel_start=1000)
    s_off, d_off, _ = port(accel_every=0)
    assert log_dead == []
    assert torch.equal(d_dead.reproj_err, d_off.reproj_err)
    for f in ("pk", "damping_count", "robust", "cam_bel", "lmk_bel"):
        assert torch.equal(getattr(s_dead, f), getattr(s_off, f)), f


def test_chunk_means_equal_under_both_pipelines(monkeypatch):
    """The chunk-averaged means the accelerator is fed, and the solve,
    are the same to the bit under ``fused=True`` and ``fused=False``."""
    tp, _ = _noisy()
    real = gbp._accel_step
    seen = {}

    def run(fused):
        avgs = seen.setdefault(fused, [])

        def spy(state, snap, avg, graph, cfg_, degs, **kw):
            avgs.append([x.clone() for x in avg])
            return real(state, snap, avg, graph, cfg_, degs, **kw)

        monkeypatch.setattr(gbp, "_accel_step", spy)
        cfg = GBPConfig(edge_pad_multiple=PAD, fused=fused, **ACCEL)
        g = fg.build_graph(tp, cfg, "cpu")
        s = gbp.initialise(fg.init_state(tp, cfg, "cpu"), g, cfg)
        return gbp.run_gbp(s, g, cfg, 40)

    (sa, da), (sb, db) = run(True), run(False)
    assert len(seen[True]) == len(seen[False]) == 3
    for a, b in zip(seen[True], seen[False]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(da.reproj_err, db.reproj_err)
    assert torch.equal(sa.pk, sb.pk) and torch.equal(sa.cam_bel, sb.cam_bel)


def test_solve_ba_default_config_matches_jax(synthetic):
    """``solve_ba`` with the default GBPConfig() (accelerator on, fused
    sweep) runs, and lands on the JAX package's ``solve_ba`` final error;
    200 sweeps reach one live accelerator step (after sweep 160)."""
    _, _, ej = jax_pkg.solve_ba(synthetic, n_iters=200)
    cam, lmk, et = solve_ba(synthetic, n_iters=200, device="cpu")
    assert et.shape == (200,) and np.isfinite(et).all() and et[-1] < et[0]
    np.testing.assert_allclose(et[-1], np.asarray(ej)[-1], rtol=SOLVE_RTOL,
                               atol=SOLVE_ATOL_PX)
    assert GBPConfig().accel_every == 50         # the accelerator is on


def _accel_calls(rank, kernels, verbose=False):
    """The span calls of a 40-sweep run_gbp of the noisy problem on
    ``rank``'s CPU, edge-sharded over its group (None: one device; with
    ``verbose``, ``verbose_means``), and whether the state holds no
    captured step, accelerator or sweeps."""
    from gbp_poplar_tpu_torch import parallel
    from gbp_poplar_tpu_torch.utils import trace

    tp, _ = _noisy()
    cfg = GBPConfig(edge_pad_multiple=PAD, kernels=kernels, **ACCEL)
    g = fg.build_graph(tp, cfg, "cpu")
    s = fg.init_state(tp, cfg, "cpu")
    with trace.collect() as totals:
        if rank is None:
            s = gbp.initialise(s, g, cfg)
            s, _ = gbp.run_gbp(s, g, cfg, 40, verbose_means=verbose)
        else:
            solver = parallel.make_sharded_solver(rank.group, cfg)
            g, s = solver.prepare(g, s)
            s, _ = solver.solve(s, g, 40)
    return ({k: n for k, (_, n) in totals.items()},
            s.accel_graph is None and s.sweep_graphs is None)


@pytest.mark.parametrize("case", ["auto", "reference", "group"])
def test_accel_steps_run_eagerly_off_the_card(case):
    """Off the card every accelerator step runs eagerly: each
    ``gbp.accel_step`` holds one ``gbp.accel_eager``, none a capture, and
    no state holds a captured step; so with ``kernels="reference"`` and
    with a process group (the sharded solvers, here one gloo rank)."""
    from gbp_poplar_tpu_torch import parallel

    if case == "group":
        ((calls, none),) = parallel.run(_accel_calls, 1, args=("auto",),
                                        device_type="cpu")
    else:
        calls, none = _accel_calls(None, case)
    assert calls["gbp.accel_step"] == calls["gbp.accel_eager"] == 3
    assert "gbp.accel_capture" not in calls and none


def test_clone_carries_no_captured_step():
    """A captured step is its state's alone: ``clone()``,
    ``dataclasses.replace`` and ``state_to_numpy`` leave it behind."""
    import dataclasses

    tp, _ = _noisy()
    cfg = GBPConfig(edge_pad_multiple=PAD, **ACCEL)
    s = fg.init_state(tp, cfg, "cpu")
    assert s.accel_graph is None
    s.accel_graph = held = object()
    assert s.clone().accel_graph is None
    assert dataclasses.replace(s).accel_graph is None
    assert set(fg.state_to_numpy(s)) == set(fg.STATE_FIELDS)
    assert s.accel_graph is held


@pytest.mark.parametrize("case", ["auto", "reference", "group", "verbose"])
def test_sweeps_run_eagerly_off_the_card(case):
    """Off the card every run of sweeps runs eagerly: each ``gbp.sweeps``
    (the annealed run, three live chunks, the leftover) holds one
    ``gbp.sweeps_eager``, none a capture, and no state holds a captured
    run; so with ``kernels="reference"``, with a process group (the
    sharded solvers, here one gloo rank) and with ``verbose_means``."""
    from gbp_poplar_tpu_torch import parallel

    if case == "group":
        ((calls, none),) = parallel.run(_accel_calls, 1, args=("auto",),
                                        device_type="cpu")
    else:
        calls, none = _accel_calls(
            None, "reference" if case == "reference" else "auto",
            verbose=case == "verbose")
    assert calls["gbp.sweeps"] == calls["gbp.sweeps_eager"] == 5
    assert "gbp.sweeps_capture" not in calls and none


def test_clone_carries_no_captured_sweeps():
    """Captured runs of sweeps are their state's alone: ``clone()``,
    ``dataclasses.replace`` and ``state_to_numpy`` leave them behind, and
    no state shares another's table of them."""
    import dataclasses

    tp, _ = _noisy()
    cfg = GBPConfig(edge_pad_multiple=PAD, **ACCEL)
    s = fg.init_state(tp, cfg, "cpu")
    assert s.sweep_graphs is None
    s.sweep_graphs = held = {(8, True): object()}
    assert s.clone().sweep_graphs is None
    assert dataclasses.replace(s).sweep_graphs is None
    assert set(fg.state_to_numpy(s)) == set(fg.STATE_FIELDS)
    assert s.sweep_graphs is held and fg.GBPState.sweep_graphs is None


class _StandIn(gbp._SweepGraph):
    """A captured run of sweeps with its capture and replay stood in for
    (the CPU has no CUDA graphs): the capture records the run, a replay
    runs it eagerly with its telemetry at the solve's row offset."""

    def capture(self, state, graph, cfg, n, collect, diag):
        self.graph = (graph, cfg, n, collect, diag)

    def replay(self, state, rows, done):
        graph, cfg, n, collect, diag = self.graph

        def row(s, tables, j):
            gbp._diag_sums(s, graph, cfg, out=rows[done + j])

        return gbp._sweep_run(state, graph, cfg, n, collect,
                              row if diag else None, False)


def test_sweep_capture_rule(monkeypatch):
    """The rule that decides a run of sweeps' path, on the CPU with the
    capture and replay stood in for (``_StandIn``) and the state taken as
    capturable: an anneal-free run runs eagerly the first time its state
    sees its (n, collect), is captured the second time and replayed after;
    a replaced tensor that the graph reads in place makes the next run
    eager (the graph dropped) and the one after recapture; annealed and
    empty runs and ``verbose_means`` stay eager. The telemetry lands in
    each solve's own rows: state and rows equal an all-eager sequence's."""
    from gbp_poplar_tpu_torch.utils import trace

    tp, _ = _noisy()
    cfg = GBPConfig(edge_pad_multiple=PAD, accel_every=0)
    g = fg.build_graph(tp, cfg, "cpu")
    # (sweeps, iter_offset, verbose_means) of each run_gbp call; the path
    # of its last run of sweeps (the first call's first run is annealed)
    plan = [(18, 0, False, "eager"), (8, 18, False, "capture"),
            (8, 26, False, "replay"), (8, 34, False, "replace"),
            (8, 42, False, "capture"), (8, 50, True, "eager"),
            (8, 58, False, "replay")]

    def solve(capturable):
        monkeypatch.setattr(gbp, "_capturable",
                            lambda state, cfg, group: capturable)
        s = gbp.initialise(fg.init_state(tp, cfg, "cpu"), g, cfg)
        out = []
        for n, offset, verbose, path in plan:
            if path == "replace":
                s.robust = s.robust.clone()
            with trace.collect() as totals:
                s, d = gbp.run_gbp(s, g, cfg, n, iter_offset=offset,
                                   verbose_means=verbose)
            out.append(({k: c for k, (_, c) in totals.items()},
                        [t.clone() for t in d[:4]]))
        return s, out

    monkeypatch.setattr(gbp, "_SweepGraph", _StandIn)
    s, got = solve(True)
    s0, want = solve(False)
    for (calls, rows), (calls0, rows0), (_, offset, _, path) in zip(
            got, want, plan):
        # every call runs two runs of sweeps: annealed or empty, then 8
        assert calls["gbp.sweeps"] == calls0["gbp.sweeps"] == 2
        assert calls0["gbp.sweeps_eager"] == 2
        eager = {"eager": 2, "replace": 2}.get(path, 1)
        assert calls["gbp.sweeps_eager"] == eager, offset
        assert calls.get("gbp.sweeps_capture", 0) == (path == "capture")
        for x, y in zip(rows, rows0, strict=True):
            assert torch.equal(x, y), offset
    for f in fg.STATE_FIELDS:
        assert torch.equal(getattr(s, f), getattr(s0, f)), f
    (held,) = s.sweep_graphs.values()
    assert isinstance(held, _StandIn) and held.graph[2:4] == (8, False)
    assert s0.sweep_graphs is None


def _outputs(out) -> list:
    """The tensors a recorded step returns, in order (a state: its
    beliefs)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _outputs(o)]
    if isinstance(out, fg.GBPState):
        return [out.cam_bel, out.lmk_bel]
    return []


class _Rerun:
    """``gbp._Captured``'s capture and replay on the CPU, with a graph's
    memory rules: the body's inputs are the step's own buffers, what the
    capture returns keeps its storage and each replay writes its results
    there, and the capture changes nothing (the tensors it reads in place
    are restored)."""

    class pool:
        class stream:
            cuda_stream = 0

    def _claim(self, state):
        return self.pool.stream

    def _record(self, inputs, body):
        self.ins = [t.clone() for t in inputs]
        self.body, self.graph = body, "recorded"
        baked = [r() for r in self.refs if r is not None]
        baked = [t for t in baked if isinstance(t, torch.Tensor)]
        saved = [t.clone() for t in baked]
        out = body(*[t.clone() for t in self.ins])
        for t, v in zip(baked, saved):
            t.copy_(v)
        self.outs = _outputs(out)
        return out

    def _replay(self, inputs):
        for buf, t in zip(self.ins, inputs):
            if buf is not t:
                buf.copy_(t)
        for o, t in zip(self.outs, _outputs(self.body(*self.ins)),
                        strict=True):
            o.copy_(t)


def test_replayed_steps_buffers_equal_eager(monkeypatch):
    """The captured steps' buffers on the CPU (``_Rerun``): three run_gbp
    calls as the ba driver's spans, with an in-place write to the priors
    between two, replay the accelerator step and the (8, collect) runs
    of sweeps from buffers the state is handed, and end where the
    all-eager solve does, state and every accel_log entry to the bit; the
    state reads the run's prior buffers."""
    from gbp_poplar_tpu_torch.ops import cost_kernel

    tp, _ = _noisy()
    cfg = GBPConfig(edge_pad_multiple=PAD, **ACCEL)
    g = fg.build_graph(tp, cfg, "cpu")

    def solve(capturable):
        monkeypatch.setattr(gbp, "_capturable",
                            lambda state, cfg, group: capturable)
        s = gbp.initialise(fg.init_state(tp, cfg, "cpu"), g, cfg)
        log = []
        for offset in range(0, 120, 40):
            s, _ = gbp.run_gbp(s, g, cfg, 40, iter_offset=offset,
                               with_diagnostics=False, accel_log=log)
            s.lmk_prior[:, 0] *= 1.5
        return s, log

    for name in ("_claim", "_record", "_replay"):
        monkeypatch.setattr(gbp._Captured, name, getattr(_Rerun, name))
    monkeypatch.setattr(gbp._Captured, "pool", _Rerun.pool, raising=False)
    monkeypatch.setattr(cost_kernel, "scratch", lambda *args: None)
    s, log = solve(True)
    s0, log0 = solve(False)
    for f in fg.STATE_FIELDS:
        assert torch.equal(getattr(s, f), getattr(s0, f)), f
    assert len(log) == len(log0) == 13
    for (n, info), (n0, info0) in zip(log, log0):
        assert n == n0
        for x, y in zip(info[:4], info0[:4]):
            assert torch.equal(x, y), n
    held = s.sweep_graphs[(8, True)]
    assert held.graph == "recorded" and s.accel_graph.graph == "recorded"
    assert s.cam_prior is held.ins[2] and s.lmk_prior is held.ins[3]
