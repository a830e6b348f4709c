"""``sweep_replay_share`` reads the share of the window's runs of sweeps
(``gbp.sweeps``) that were replayed, neither run eagerly
(``gbp.sweeps_eager``) nor captured (``gbp.sweeps_capture``), from the
collected program spans (``Run.program``), and nothing where the window
has no run of sweeps or the program marks none eager."""

import pytest

import harness

SHARE = ("sweep_replay_share.slam", "sweep_replay_share.gbp")


def _run(program) -> harness.Run:
    return harness.Run(setup_s=1.0, window_s=1.0, spans={}, counts={},
                       latencies=[], peak_bytes=0, shape=None,
                       program=program, steps=None)


@pytest.mark.parametrize("name", SHARE)
def test_share_of_replayed_runs(name):
    # a fr1desk pass: 62 segments of 15 runs, 65 eager, 3 captured
    program = {"gbp.sweeps": (6.2, 930), "gbp.sweeps_eager": (1.3, 65),
               "gbp.sweeps_capture": (0.06, 3), "gbp.run_gbp": (9.0, 62)}
    assert harness.reader(name)(_run(program)) == pytest.approx(
        100.0 * (1 - 68 / 930))
    # no capture in the window: the eager runs alone
    del program["gbp.sweeps_capture"]
    assert harness.reader(name)(_run(program)) == pytest.approx(
        100.0 * (1 - 65 / 930))
    # every run eager: no replay
    assert harness.reader(name)(_run({
        "gbp.sweeps": (1.0, 31), "gbp.sweeps_eager": (1.0, 31)})) == 0.0


@pytest.mark.parametrize("program", [
    None,                                               # an untraced run
    {},                                                 # no span collected
    {"gbp.sweeps": (0.0, 0), "gbp.sweeps_eager": (0.0, 0)},   # no calls
    {"gbp.run_gbp": (1.0, 1)},                          # no run of sweeps
    {"gbp.sweeps": (1.0, 31), "gbp.run_gbp": (1.0, 1)},  # none marked
])
@pytest.mark.parametrize("name", SHARE)
def test_nothing_read_without_marked_runs(name, program):
    assert harness.reader(name)(_run(program)) is None
