"""Belief read-out: per-variable means as host arrays."""

from __future__ import annotations

import numpy as np

from ..core.factor_graph import CAM_DOF, LMK_DOF, GBPState
from ..ops import table_kernel


def belief_means(state: GBPState) -> tuple[np.ndarray, np.ndarray]:
    """(cam_mu [C, 6], lmk_mu [L, 3]) from the current beliefs, as
    ``gbp_poplar_tpu.utils.analysis.belief_means``."""
    cam_mu = table_kernel.variable_means(state.cam_bel, CAM_DOF)
    lmk_mu = table_kernel.variable_means(state.lmk_bel, LMK_DOF)
    return cam_mu.T.cpu().numpy(), lmk_mu.T.cpu().numpy()
