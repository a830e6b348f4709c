"""A cell of ``BENCHMARK.json`` cut to a size the CPU runs in seconds, for
the tests: the same files, fewer keyframes, landmarks, observations and
sweeps."""

import harness

WORKLOADS = [w["name"] for w in harness.load_json(
    harness.os.path.join(harness.ROOT, "BENCHMARK.json"))["workloads"]]
SIZES = {"n_keyframes": 8, "n_points": 150, "n_observations": 650}
# the generator key that makes a test configuration a photo collection (gen.py)
COLLECTION = {"visibility": "collection"}
TRAFFIC = {"cold-solve": {"n_iters": 300, "solver": {"coarse_groups": 4}},
           "gbp-solve": {"n_iters": 300},
           "keyframes": {"solver": {"iters_between_kfs": 60},
                         "warmup_keyframes": 2, "trace_keyframes": 2,
                         "sample_keyframes": 3}}


def tiny_cell(workload: str) -> harness.Cell:
    cell = harness.load_cell(workload)
    cell.config.update(SIZES)
    cut = dict(TRAFFIC[cell.workload["traffic"]])
    cell.traffic.setdefault("solver", {}).update(cut.pop("solver", {}))
    cell.traffic.update(cut)
    return cell
