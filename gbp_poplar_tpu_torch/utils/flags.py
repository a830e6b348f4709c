"""Activation / prior-weakening flag schedules for incremental SLAM.

NumPy equivalents of the reference's host-side flag schedulers
(reference: ba/dataio.cpp:455-508), the same module as the JAX package's
``utils/flags.py``. The solver keeps these flags in its on-device state, so
keyframe insertion is a masked update, not a graph rebuild — the same trick
the reference uses (pre-built graph, flags streamed).

Semantics:
  - ``active_flag[e] = 1`` once the edge's keyframe has been activated.
  - ``cam/lmk_weaken_flag[v] = steps`` schedules `steps` applications of the
    per-variable annealing scaling to the variable's prior (applied every
    2nd iteration by the solver; reference: ba/ba.cpp:1003-1006,
    gbp_codelets.cpp:176-197).
  - ``lmk_active_flag`` tracks cumulative activation so newly-observed
    landmarks (flag == steps after an update) can be identified; the
    reference's out-of-bounds indexing in initialise_new_kf (ba/util.cpp:215)
    is *not* replicated — we implement the intent (flag == steps means newly
    observed this keyframe).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .balio import BAProblem


class SlamFlags(NamedTuple):
    active_flag: np.ndarray      # [E] uint32
    cam_weaken_flag: np.ndarray  # [C] uint32
    lmk_weaken_flag: np.ndarray  # [L] uint32
    lmk_active_flag: np.ndarray  # [L] uint32 (cumulative)


def create_flags(problem: BAProblem, steps: int) -> SlamFlags:
    """Initial SLAM flags: keyframes 0 and 1 active
    (reference: ba/dataio.cpp:455-475)."""
    active = np.zeros(problem.n_edges, np.uint32)
    cam_weaken = np.zeros(problem.n_keyframes, np.uint32)
    lmk_weaken = np.zeros(problem.n_points, np.uint32)

    cam_weaken[0:2] = steps
    first_two = (problem.cam_idx == 0) | (problem.cam_idx == 1)
    active[first_two] = 1
    lmk_weaken[problem.lmk_idx[first_two]] = steps
    lmk_active = lmk_weaken.copy()
    return SlamFlags(active, cam_weaken, lmk_weaken, lmk_active)


def update_flags(
    problem: BAProblem, flags: SlamFlags, steps: int, data_counter: int
) -> tuple[SlamFlags, int]:
    """Activate keyframe ``data_counter + 1`` and its landmarks
    (reference: ba/dataio.cpp:477-508).

    Returns (new_flags, n_new_landmarks).
    """
    active = flags.active_flag.copy()
    lmk_weaken = flags.lmk_weaken_flag.copy()
    lmk_active = flags.lmk_active_flag.copy()

    new_kf = data_counter + 1
    active[problem.cam_idx == new_kf] = 1
    seen = problem.cam_idx <= new_kf
    lmk_weaken[problem.lmk_idx[seen]] = steps

    cam_weaken = np.zeros(problem.n_keyframes, np.uint32)
    cam_weaken[new_kf] = steps

    # Landmarks already activated keep weaken_flag 0; only new ones weaken.
    lmk_weaken = lmk_weaken - lmk_active
    lmk_active = lmk_active + lmk_weaken

    n_new = int(lmk_weaken.sum()) // steps
    return SlamFlags(active, cam_weaken, lmk_weaken, lmk_active), n_new


def ba_flags(problem: BAProblem, steps: int) -> SlamFlags:
    """Batch-BA flags: everything active, all priors weakened
    (reference: ba/ba.cpp:588-590)."""
    return SlamFlags(
        active_flag=np.ones(problem.n_edges, np.uint32),
        cam_weaken_flag=np.full(problem.n_keyframes, steps, np.uint32),
        lmk_weaken_flag=np.full(problem.n_points, steps, np.uint32),
        lmk_active_flag=np.full(problem.n_points, steps, np.uint32),
    )
