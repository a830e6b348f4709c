"""The comparison that decides ``correct`` fails what it must: the control
(the reference in the program's place, in bfloat16) and the faults a run
of these cells can have, each planted under the timed path of a tiny run
on the CPU (the harness's look for a card skipped). A cell on one card
has no exchange between cards to leave out."""

import os
import time

import pytest
import torch

import check
import control
import faults
import gen
import harness
from tiny import WORKLOADS, tiny_cell

CPU = torch.device("cpu")


def _run(cell, seconds=1.0):
    return harness.run_cell(cell, 2 ** 31 + 21, seconds, False, CPU,
                            time.perf_counter())


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_fails_the_limits(workload):
    cell = tiny_cell(workload)
    problem = gen.make_problem(cell.config, 5)
    judge = check.Judge(problem, cell.config, CPU,
                        cell.traffic.get("av_depth", 1.0))
    answers = control.control_answers(cell, problem, judge, 5)
    rows = harness.procedure(cell.traffic["procedure"]).rows(judge, answers)
    checks, failed = check.judge(rows, cell.limits)
    assert failed == len(answers) > 0
    assert any(c["value"] > c["limit"] for c in checks.values())


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_planted_fault_comes_out_not_correct(workload, fault, monkeypatch):
    cell = tiny_cell(workload)
    faults.FAULTS[fault](monkeypatch.setattr)
    out = _run(cell, seconds=6.0 if cell.traffic["procedure"] == "keyframes"
               else 0.5)
    assert out["attempted"] >= 1
    assert not out["correct"] and out["failed"] >= 1


def test_control_reads_the_faults_and_restores_the_program():
    """``control.py --faults`` reads each fault through the timed path and
    leaves the program as it found it."""
    import units
    from gbp_poplar_tpu_torch.core import gbp

    before = (gbp.run_gbp, units.program_problem)
    cell = tiny_cell("ladybug-gbp")
    lines = control.readings(cell, [2 ** 31 + 3], CPU, True, False,
                             sorted(faults.FAULTS), log=open(os.devnull, "w"))
    assert [ln["side"] for ln in lines] == ["program"] + [
        "fault:" + f for f in sorted(faults.FAULTS)]
    assert lines[0]["failed"] == 0
    assert all(ln["failed"] >= 1 for ln in lines[1:])
    assert (gbp.run_gbp, units.program_problem) == before
