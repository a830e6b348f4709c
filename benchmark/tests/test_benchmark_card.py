"""On a card: one short run of the shortest cell through ``run.py``, and
the control read at the cell's own size. Run there with
``python -m pytest -m cuda benchmark/tests/test_benchmark_card.py``."""

import json
import os
import subprocess
import sys

import pytest
import torch

import harness

ROOT = harness.ROOT


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_a_short_run_is_correct(card):
    proc = subprocess.run(
        [sys.executable, os.path.join(harness.BENCH, "run.py"), "--workload",
         "ladybug-gbp", "--seed", str(2 ** 31 + 77), "--seconds", "3",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert line["device"]["kind"] == torch.cuda.get_device_name(0)


@pytest.mark.cuda
def test_the_control_fails_at_the_cells_size(card):
    import check
    import control
    import gen

    cell = harness.load_cell("ladybug-gbp")
    problem = gen.make_problem(cell.config, 3)
    judge = check.Judge(problem, cell.config, card)
    answers = control.control_answers(cell, problem, judge, 3)
    rows = harness.procedure(cell.traffic["procedure"]).rows(judge, answers)
    _, failed = check.judge(rows, cell.limits)
    assert failed == len(answers) > 0
