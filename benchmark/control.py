"""Readings for the limits of ``correct``: the program's numbers, the
control's and the planted faults' over many seeds in one process.

    python3 benchmark/control.py --workload ladybug-ba --seeds 1 2 3 \
        [--program] [--control] [--faults unchanged half_batch altered] \
        [--out FILE]

For each seed it makes the cell's problem and the reference's view of it
(``check.Judge``), then:

- ``--program``: one unit of the cell's timed path (``Unit.once``: one
  solve, or one whole SLAM pass keeping the sampled keyframes' means),
  after one warm-up unit in the process, judged as ``run.py`` judges its
  window;
- ``--control``: the reference put in the program's place and computed in
  bfloat16 (the procedure's ``control``: ``reference.solve`` with
  ``edge_dtype=torch.bfloat16``, the per-edge projection, residuals and
  Jacobians in bfloat16, sums and solves in float32), judged the same way;
- ``--faults``: one unit of the timed path with each named fault of
  ``faults.py`` planted underneath, judged the same way.

It prints one JSON line per seed and side, with the worst of each number,
and appends them to ``--out``. ``run.py`` never runs these. On a card they
run at the cell's own size; the tests run them at a tiny size on the CPU.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402

import check  # noqa: E402
import gen  # noqa: E402
import harness  # noqa: E402


def worst(rows: list[dict]) -> dict:
    """The worst of each number over the rows."""
    return {n: c["value"] for n, c in check.judge(rows, {})[0].items()}


def control_answers(cell, problem, judge, seed: int) -> list:
    """The control's answers in the program's place."""
    proc = harness.procedure(cell.traffic["procedure"])
    return proc.control(judge, cell.traffic, problem, seed)


def program_answers(cell, problem, dev, seed: int, warm: bool) -> list:
    """The answers of one unit of the cell's timed path."""
    import units

    proc = harness.procedure(cell.traffic["procedure"])
    unit = proc.Unit(cell.config, cell.traffic, problem, dev, seed)
    if warm:
        unit.warm_up(units.Recorder(dev))
    unit.once(units.Recorder(dev))
    return unit.answers


def readings(cell, seeds, dev, program: bool, control: bool,
             faults=(), out=None, log=sys.stdout) -> list[dict]:
    import faults as faults_lib

    proc = harness.procedure(cell.traffic["procedure"])
    sides = ([("program", None)] if program else []) + (
        [("control", None)] if control else []) + [
        ("fault:" + f, f) for f in faults]
    lines = []
    for i, seed in enumerate(seeds):
        problem = gen.make_problem(cell.config, seed)
        jd = check.Judge(problem, cell.config, dev,
                         cell.traffic.get("av_depth", 1.0))
        for side, fault in sides:
            t0 = time.perf_counter()
            if side == "control":
                answers = control_answers(cell, problem, jd, seed)
            elif fault is None:
                answers = program_answers(cell, problem, dev, seed,
                                          warm=i == 0)
            else:
                with faults_lib.planted(fault):
                    answers = program_answers(cell, problem, dev, seed,
                                              warm=False)
            rows = proc.rows(jd, answers)
            checks, failed = check.judge(rows, cell.limits)
            line = {"workload": cell.workload["name"], "seed": seed,
                    "side": side, "answers": len(rows), "failed": failed,
                    "worst": worst(rows),
                    "seconds": time.perf_counter() - t0}
            lines.append(line)
            print(json.dumps(harness.finite(line)), file=log, flush=True)
            if out:
                with open(out, "a") as f:
                    f.write(json.dumps(harness.finite(line)) + "\n")
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: the readings are taken on a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    readings(cell, args.seeds, torch.device("cuda", 0), args.program,
             args.control, args.faults, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
