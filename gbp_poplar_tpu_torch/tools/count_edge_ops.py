"""Per-edge operation count of the sweep body, and the H100's bound on it.

    python -m gbp_poplar_tpu_torch.tools.count_edge_ops [--snavely] [--detail]
    GBP_PLATFORM=cpu python -m gbp_poplar_tpu_torch.tools.count_edge_ops

The counterpart of the JAX package's ``scripts/count_edge_ops.py``. It
runs ``core.gbp.edge_math`` (the plain version of H1 and H4, operation for
operation the JAX function) on zero inputs of ``E`` edges under a
``TorchDispatchMode`` and tallies every aten operation by the elements it
writes, per edge, in the JAX script's classes:

  - one-class (``ONE``): add, multiply, compare, select, ... one float32
    instruction per element;
  - transcendental (``TRANS``): sqrt, reciprocal, divide, sin, cos, exp,
    log, pow, ...: the special-function unit's pipe;
  - free (``FREE``): views, packing, tensor creation and data movement
    (select, slice, unbind, stack, cat, zeros_like, _to_copy,
    index_select, ...), which a kernel's bound counts as bytes;
  - anything else counted as one-class under ``?name``, so that an
    operation this table does not know shows instead of skewing a class.

Both modes of the JAX script: ``premu=None`` (the unfused sweep, H4,
solving the means per edge) and ``premu`` [10, E] (the fused sweep, H1,
on the means the belief tables hold). A jaxpr and aten dispatch see
different operation sets (``torch.where`` evaluates both branches, as
``select_n`` does; ``rsub`` and ``clamp_min`` have no jaxpr twin), so the
two tallies agree on the totals, not name by name.

The bound replaces the JAX script's TPU model with the H100's, from the
card itself (``card_rates``): one-class operations at 128 float32 lanes
per SM per clock, transcendental ones at the 16 special-function results
per SM per clock (the CUDA C++ Programming Guide's arithmetic throughput
table for compute capability 9.0), times the card's SM count (torch) and
its maximum SM clock (nvidia-smi). The data sheet's 67 TFLOP/s float32 is
the same lanes counting a fused multiply-add as two operations; the
kernels are built with ``-fmad=false``, so each counted operation is one
instruction. The two pipes run side by side, so the least time is the
larger of the two (``ops_ms``). chip_smoke.py bounds each kernel's
operations with this tally and these rates.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import subprocess
import sys
from collections import Counter

import numpy as np
import torch

from ..config import GBPConfig
from . import device_label, resolve_device

# elementwise operations counted as one float32 operation per element
ONE = frozenset({
    "add", "sub", "rsub", "mul", "neg", "abs", "sign", "sgn", "where",
    "eq", "ne", "lt", "le", "gt", "ge", "minimum", "maximum", "clamp",
    "clamp_min", "clamp_max", "isfinite", "isnan", "isinf", "bitwise_and",
    "bitwise_or", "bitwise_not", "bitwise_xor", "logical_and",
    "logical_or", "logical_not", "logical_xor", "masked_fill", "lerp",
    "square", "sum", "prod", "all", "any", "amax", "amin", "floor", "ceil",
    "round", "trunc",
})
# transcendental-class operations (the special-function unit's pipe)
TRANS = frozenset({
    "sqrt", "rsqrt", "reciprocal", "div", "sin", "cos", "tan", "exp",
    "exp2", "expm1", "log", "log2", "log1p", "pow", "tanh", "atan2",
})
# views, packing, tensor creation and data movement: no operation
FREE = frozenset({
    "select", "slice", "unbind", "stack", "cat", "view", "reshape",
    "_unsafe_view", "expand", "squeeze", "unsqueeze", "t", "transpose",
    "permute", "alias", "detach", "split", "split_with_sizes", "narrow",
    "as_strided", "unfold", "clone", "copy", "contiguous", "_to_copy",
    "lift_fresh", "scalar_tensor", "zeros", "ones", "empty", "full",
    "zeros_like", "ones_like", "empty_like", "full_like", "new_zeros",
    "new_ones", "new_empty", "new_full", "fill", "index_select", "gather",
    "index", "index_put", "scatter", "repeat", "flip", "_local_scalar_dense",
})

EDGES = 1024
LADYBUG_EDGES = 1_092_608      # the Ladybug shape's padded edges
TUM_EDGES = 13_312             # the fr1desk shape's padded edges
# per SM per clock at compute capability 9.0 (CUDA C++ Programming Guide,
# arithmetic instructions): float32 add/multiply lanes, and the results
# of the special-function unit (reciprocal, sqrt, sin, cos, exp2, log2)
FP32_LANES_PER_SM = 128
SFU_PER_SM = 16
# H100 SXM's maximum SM clock (NVIDIA's data sheet), used only where
# nvidia-smi cannot be read
DATASHEET_SM_MHZ = 1980.0


def tally(fn) -> tuple[Counter, Counter]:
    """(one-class, transcendental) elements written by ``fn()``'s aten
    operations, by operation name (in-place variants under their name;
    unknown operations as ``?name`` in the first)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    ones: Counter = Counter()
    trans: Counter = Counter()

    class Tally(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            if name in FREE:
                return out
            n = sum(t.numel() for t in (
                out if isinstance(out, (tuple, list)) else (out,))
                if isinstance(t, torch.Tensor))
            if name in TRANS:
                trans[name] += n
            else:
                ones[name if name in ONE else f"?{name}"] += n
            return out

    with Tally():
        fn()
    return ones, trans


def edge_math_args(e: int, snavely: bool, premu: bool, device):
    """``edge_math``'s inputs for ``e`` edges, zeros as the JAX script's
    (beliefs, factors, messages; active edges, unit variance)."""
    def z(n):
        return torch.zeros((n, e), device=device)

    args = (z(27), z(9), z(2), torch.ones(e, device=device),
            z(6), z(3), z(21), z(18), z(6), z(6), z(21), z(3), z(6),
            torch.zeros(e, device=device),
            torch.zeros(e, dtype=torch.int32, device=device),
            z(9), z(9), torch.zeros(e, dtype=torch.bool, device=device),
            torch.ones(e, dtype=torch.int32, device=device))
    k = np.eye(3, dtype=np.float32)
    return args, k, z(3) if snavely else None, z(10) if premu else None


def count(cfg: GBPConfig, e: int, snavely: bool, premu: bool,
          device="cpu") -> tuple[dict, dict]:
    """(one-class, transcendental) operations per edge of one
    ``edge_math`` call over ``e`` edges, by operation name."""
    from ..core.gbp import edge_math

    args, k, intr, pm = edge_math_args(e, snavely, premu, device)
    ones, trans = tally(lambda: edge_math(*args, k, cfg, premu=pm,
                                          intr=intr))
    return ({n: v / e for n, v in ones.items()},
            {n: v / e for n, v in trans.items()})


@dataclasses.dataclass(frozen=True)
class Rates:
    """A card's operation rates (per second) and where they come from."""

    one: float
    trans: float
    sms: int
    clock_mhz: float
    source: str


@functools.cache
def card_rates(index: int = 0) -> Rates:
    """The rates of card ``index``: its SM count from torch, its maximum
    SM clock from nvidia-smi (the data sheet's where that fails)."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    source = "nvidia-smi clocks.max.sm"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits", "-i", str(index)],
            capture_output=True, text=True, timeout=30)
        mhz = float(out.stdout.split()[0])
    except (OSError, subprocess.TimeoutExpired, ValueError, IndexError):
        mhz, source = DATASHEET_SM_MHZ, "the data sheet's maximum SM clock"
    hz = mhz * 1e6
    return Rates(FP32_LANES_PER_SM * sms * hz, SFU_PER_SM * sms * hz, sms,
                 mhz, source)


def ops_ms(n_one: float, n_trans: float, rates: Rates) -> float:
    """The least time (ms) for ``n_one`` one-class and ``n_trans``
    transcendental operations: the slower of the two pipes."""
    return max(n_one / rates.one, n_trans / rates.trans) * 1e3


def edge_ops(snavely: bool = False, e: int = EDGES, device=None) -> dict:
    """Both modes' tallies per edge on the device, and, on a card, each
    mode's bound at the fr1desk and Ladybug shapes."""
    dev = resolve_device(device)
    rates = card_rates(dev.index or 0) if dev.type == "cuda" else None
    cfg = GBPConfig()
    modes = {}
    for mode, premu in (("per_edge_means", False), ("premu", True)):
        ones, trans = count(cfg, e, snavely, premu, dev)
        n1, nt = sum(ones.values()), sum(trans.values())
        row = {"one": n1, "trans": nt, "ones": ones, "transcendental": trans}
        if rates is not None:
            row["bound_us_tum"] = ops_ms(n1 * TUM_EDGES, nt * TUM_EDGES,
                                         rates) * 1e3
            row["bound_ms_ladybug"] = ops_ms(n1 * LADYBUG_EDGES,
                                             nt * LADYBUG_EDGES, rates)
        modes[mode] = row
    return {"device": device_label(dev), "edges": e, "snavely": snavely,
            "rates": None if rates is None else dataclasses.asdict(rates),
            "modes": modes}


def report(r: dict, detail: bool = False) -> list[str]:
    labels = {"per_edge_means": "edge_math (per-edge mean solves)",
              "premu": "edge_math (premu: table-gathered means)"}
    lines = []
    for mode, row in r["modes"].items():
        line = (f"{labels[mode]:42s} {row['one']:7.0f} one-class + "
                f"{row['trans']:5.1f} trans ops/edge")
        if "bound_ms_ladybug" in row:
            line += (f" | H100 ops bound: {row['bound_us_tum']:6.2f} us @"
                     f"{TUM_EDGES} edges, {row['bound_ms_ladybug']:7.4f} ms "
                     f"@{LADYBUG_EDGES}")
        lines.append(line)
        if detail:
            for name, v in sorted(row["ones"].items(), key=lambda kv: -kv[1]):
                lines.append(f"    {name:24s} {v:8.1f}")
            for name, v in sorted(row["transcendental"].items(),
                                  key=lambda kv: -kv[1]):
                lines.append(f"    [trans] {name:16s} {v:8.1f}")
    rt = r["rates"]
    if rt is None:
        lines.append("H100 bound: needs a card (its SM count and clock)")
    else:
        lines.append(
            f"rates: {rt['one'] / 1e12:.2f} T one-class/s ({FP32_LANES_PER_SM}"
            f" lanes x {rt['sms']} SMs x {rt['clock_mhz']:.0f} MHz), "
            f"{rt['trans'] / 1e12:.3f} T trans/s ({SFU_PER_SM} SFU results "
            f"per SM per clock); clock from {rt['source']}")
    lines.append(f"tallied at {r['edges']} edges on {r['device']}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--snavely", action="store_true")
    ap.add_argument("--detail", action="store_true",
                    help="per-operation breakdown")
    args = ap.parse_args(argv)
    for line in report(edge_ops(args.snavely), args.detail):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
