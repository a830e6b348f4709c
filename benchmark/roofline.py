"""Bytes the algorithm must move, and the card's peak bandwidth.

Copies of chip_smoke.py's ``sweep_bytes`` (its fused sweep) and
``reduce_work`` (each input read once, each output written once) and of
its ``least_ms`` at the published HBM3 bandwidth, kept here so that a
change to the program cannot move the yardstick. They take the graph's sizes (``Shape``), not the
program's objects. Every kernel of the sweep is bound by bytes (PERF.md
§3), so the bound here is bytes alone.
"""

from __future__ import annotations

import dataclasses

# H100 SXM, NVIDIA's data sheet, at its full 700 W power limit
HBM_BYTES_PER_S = 3.35e12

# the sweep's packed per-edge state and the belief tables' rows (floats),
# as the solver lays them out (core/factor_graph.py, ops/table_kernel.py)
EDGE_PACK_ROWS = 109
CAM_COMP, LMK_COMP = 27, 9
CAM_WIDTH, LMK_WIDTH = 36, 16


@dataclasses.dataclass(frozen=True)
class Side:
    """One variable kind's segmented sum: listed edges, variables, and
    whether the edges are listed through a permutation."""

    n_listed: int
    n_var: int
    permuted: bool


@dataclasses.dataclass(frozen=True)
class Shape:
    n_edges: int          # padded edge axis
    n_keyframes: int
    n_points: int
    snavely: bool
    cam: Side
    lmk: Side


def sweep_bytes(s: Shape) -> int:
    """Bytes one fused sweep must move: the packed state, counter and flag
    read and written, the per-edge constants and ids read, and the belief
    tables read once."""
    per_edge = (2 * 4 * EDGE_PACK_ROWS + 2 * 4 + 2 * 1   # pk, dc, rb
                + 4 + 2 * 4 + 4                          # active, meas
                + (12 if s.snavely else 0)               # intrinsics
                + 8)                                     # cam/lmk ids
    return (s.n_edges * per_edge
            + 4 * (s.n_keyframes * CAM_WIDTH + s.n_points * LMK_WIDTH))


def reduce_bytes(side: Side, comp: int) -> int:
    """Bytes of one segmented sum with a prior: the listed edges' rows and
    their index (the permutation, or the CSR offsets of a contiguous kind)
    read once, the prior read and the sums written."""
    index = 4 * side.n_listed if side.permuted else 4 * (side.n_var + 1)
    return 4 * comp * side.n_listed + index + 2 * 4 * comp * side.n_var


def belief_update_bytes(s: Shape) -> int:
    """Both kinds' sums of one belief update."""
    return reduce_bytes(s.cam, CAM_COMP) + reduce_bytes(s.lmk, LMK_COMP)


def least_ms(n_bytes: float) -> float:
    """The least time (ms) the card could take to move ``n_bytes``."""
    return n_bytes / HBM_BYTES_PER_S * 1e3
