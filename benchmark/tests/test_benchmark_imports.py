"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Module names are compared whole
by their top-level part: ``gbp_poplar_tpu_torch`` begins with the JAX
package's name and is not it."""

import json
import os
import subprocess
import sys
import types

import harness

BENCH = harness.BENCH
PROGRAM = "gbp_poplar_tpu_torch"


def _loaded_after(code: str) -> set:
    """Top-level names in sys.modules after ``code`` in a fresh process."""
    script = (f"import sys; sys.path[:0] = [{BENCH!r}, "
              f"{os.path.dirname(BENCH)!r}]\n{code}\n"
              "import json; print(json.dumps(sorted({m.split('.')[0] "
              "for m in sys.modules})))")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=600, cwd=os.path.dirname(BENCH))
    assert proc.returncode == 0, proc.stderr[-2000:]
    return set(json.loads(proc.stdout.splitlines()[-1]))


def test_the_check_compares_whole_top_level_names():
    saved = dict(sys.modules)
    try:
        for name in ("gbp_poplar_tpu_torch_extra", "jaxtyping", "flaxen"):
            sys.modules.setdefault(name, types.ModuleType(name))
        assert harness.forbidden_modules() == []
        sys.modules["gbp_poplar_tpu.core"] = types.ModuleType("x")
        assert harness.forbidden_modules() == ["gbp_poplar_tpu"]
        sys.modules["jax"] = types.ModuleType("jax")
        assert harness.forbidden_modules() == ["gbp_poplar_tpu", "jax"]
    finally:
        for name in set(sys.modules) - set(saved):
            del sys.modules[name]


def test_a_whole_tiny_run_loads_no_jax():
    loaded = _loaded_after(
        "import time, torch, sys\n"
        f"sys.path.insert(0, {os.path.join(BENCH, 'tests')!r})\n"
        "import harness\nfrom tiny import tiny_cell\n"
        "harness.run_cell(tiny_cell('ladybug-ba'), 3, 0.2, True, "
        "torch.device('cpu'), time.perf_counter())\n"
        "import control")
    assert PROGRAM in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("import reference, check, gen, roofline, tracing")
    assert not loaded & ({PROGRAM} | set(harness.FORBIDDEN))
