"""BENCHMARK.json keeps the contract, the harness finds every cell's files
by name, and a run prints the result line the driver reads."""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import harness
from tiny import COLLECTION, SIZES, TRAFFIC, tiny_cell

ROOT = harness.ROOT
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def _line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["command"][0] == "python3" and len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    for word in BENCH["command"]:
        assert _line_ok(word)
        if os.sep in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])


def test_configs_and_cells():
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line_ok(c["source"])
        assert _line_ok(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line_ok(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert len(set(WORKLOADS)) == len(WORKLOADS)


def test_metrics():
    e2e, layer = BENCH["end_to_end"], BENCH["per_layer"]
    names = [m["name"] for m in e2e + layer]
    assert len(set(names)) == len(names)
    assert "setup_s" in names
    layers = {}
    for m in e2e + layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", WORKLOADS)) <= set(WORKLOADS)
        assert os.path.exists(os.path.join(
            harness.BENCH, "metrics", m["name"].split(".")[0] + ".py"))
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    moved = {m["name"] for m in e2e}
    for m in layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in moved and _line_ok(m["layer"])
        layers.setdefault(m["layer"], m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload", WORKLOADS)
def test_each_cell_finds_its_files_and_reports_enough(workload):
    import check

    cell = harness.load_cell(workload)
    assert cell.config["name"] == cell.workload["config"]
    proc = harness.procedure(cell.traffic["procedure"])
    assert isinstance(proc.KIND, str) and callable(proc.Unit)
    assert callable(proc.rows) and callable(proc.control)
    e2e = [m["name"] for m in cell.metrics if m["name"] not in cell.per_layer]
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.metrics:
        assert callable(harness.reader(m["name"]))
    assert cell.limits and "gbp_gap" in cell.limits
    for name, lim in cell.limits.items():
        assert name in check.NAMES
        assert lim > 0


def test_every_traffic_file_is_data_naming_a_procedure():
    folder = os.path.join(harness.BENCH, "traffic")
    procs = {f[:-3] for f in os.listdir(os.path.join(harness.BENCH,
                                                      "procedures"))
             if f.endswith(".py")}
    for name in os.listdir(folder):
        assert name.endswith(".json")
        traffic = harness.load_json(os.path.join(folder, name))
        assert traffic["procedure"] in procs and _line_ok(traffic["why"])


def test_a_reader_is_found_by_the_name_up_to_its_first_dot():
    for name in ("gbp_ms_per_sweep.slam", "gbp_ms_per_sweep.ba",
                 "gbp_ms_per_sweep"):
        read = harness.reader(name)
        assert read.__module__ == "bench_metrics_gbp_ms_per_sweep"
    with pytest.raises(FileNotFoundError):
        harness.reader("no_such_metric.ba")


def test_keyframe_sample_is_drawn_from_the_seed():
    sample = harness.procedure("keyframes").keyframe_sample
    a = sample(2 ** 31 + 9, 63, 8)
    assert a == sample(2 ** 31 + 9, 63, 8)
    assert a[-1] == 62 and len(a) == 9 and min(a) >= 1
    assert a != sample(2 ** 31 + 10, 63, 8)


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run_prints_the_result_line(trace):
    cell = tiny_cell("ladybug-ba")
    out = harness.run_cell(cell, 2 ** 31 + 7, 0.5, bool(trace),
                           torch.device("cpu"), time.perf_counter())
    line = json.loads(json.dumps(harness.finite(out)))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert set(line) <= {"correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"}
    assert line["attempted"] >= 1
    assert set(line["checks"]) == set(cell.limits)
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    want = cell.per_layer if trace else {"setup_s", "solve_s"}
    # device readings (peak, kernel shares, idle) are never taken on a CPU
    assert set(line["metrics"]) <= set(want)
    assert "busy_s" not in line["device"]


def test_run_without_a_card_exits_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run(
        [sys.executable, os.path.join(harness.BENCH, "run.py"), "--workload",
         WORKLOADS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_a_collection_cell_needs_only_new_files(tmp_path):
    """A photo-collection configuration under ``gbp-solve`` runs from new
    files and entries alone: a root holding BENCHMARK.json with the new
    entries, the configuration's file and the cell's limits, loaded by
    ``load_cell``, generated, solved once by the procedure on the CPU and
    judged."""
    import check
    import gen
    import units

    folder = tmp_path / os.path.relpath(harness.BENCH, ROOT)
    for sub in ("configs", "limits", "traffic"):
        (folder / sub).mkdir(parents=True)
    config = harness.load_json(os.path.join(harness.BENCH, "configs",
                                            "bal-ladybug-1723.json"))
    config.update(name="tiny-collection", **SIZES)
    config["generator"].update(COLLECTION)
    (folder / "configs" / "tiny-collection.json").write_text(
        json.dumps(config))
    (folder / "traffic" / "gbp-solve.json").write_text(json.dumps(
        harness.load_json(os.path.join(harness.BENCH, "traffic",
                                       "gbp-solve.json"))))
    (folder / "limits" / "tiny-collection-gbp.json").write_text(json.dumps(
        harness.load_json(os.path.join(harness.BENCH, "limits",
                                       "ladybug-gbp.json"))))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({
        "name": "tiny-collection", "source": "a test's photo collection",
        "file": f"{folder.name}/configs/tiny-collection.json",
        "reduced": list(SIZES), "why": "a photo collection at tiny sizes"})
    bench["workloads"].append({
        "name": "tiny-collection-gbp", "config": "tiny-collection",
        "traffic": "gbp-solve", "chips": 1, "why": "a collection's sweeps"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.load_cell("tiny-collection-gbp", str(tmp_path))
    assert cell.config["generator"]["visibility"] == "collection"
    assert cell.limits == harness.load_cell("ladybug-gbp").limits
    cell.traffic.update(TRAFFIC["gbp-solve"])
    dev, seed = torch.device("cpu"), 2 ** 31 + 11
    problem = gen.make_problem(cell.config, seed)
    proc = harness.procedure(cell.traffic["procedure"])
    unit = proc.Unit(cell.config, cell.traffic, problem, dev, seed)
    unit.once(units.Recorder(dev))
    judge = check.Judge(problem, cell.config, dev)
    checks, failed = check.judge(proc.rows(judge, unit.answers), cell.limits)
    assert set(checks) == set(cell.limits)
    for c in checks.values():
        assert np.isfinite(c["value"])
    assert failed == 0
