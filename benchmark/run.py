"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload ladybug-ba --seed 7 --seconds 10 \
        --trace 0

From the root of a checkout. The cells, their configurations, traffic,
limits and metrics are named in ``BENCHMARK.json`` and found by
``harness.py``. The run needs a CUDA card (it never falls back to the
CPU): it sets up (imports, the CUDA context, the kernel library, the
problem from ``--seed``, one warm-up unit at the cell's shapes), runs the
cell's units back to back for ``--seconds``, and with ``--trace 1``
times one more bounded unit unprofiled, then profiles it. Then it checks
what the timed path returned against the plain reference and prints, as
the last line of its standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its limit
(also the last lines of its standard error). It exits with 2 without a
card, and with 3 if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    import harness

    cell = harness.load_cell(args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2
    print(f"card: {harness.power_line()}", file=sys.stderr)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"error: loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(harness.finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
