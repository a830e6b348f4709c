"""Solver core: factor graph and state, the batch GBP solve with its
accelerator and coarse corrector (gbp, coarse), the LM/Schur oracle
(gauss_newton) and the intrinsics refit (intrinsics)."""

from .factor_graph import (GBPGraph, GBPState, build_graph,  # noqa: F401
                           graph_from_numpy, init_state, state_from_numpy,
                           state_to_numpy)
from . import coarse, gauss_newton, gbp, intrinsics  # noqa: F401
