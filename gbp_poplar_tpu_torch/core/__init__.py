"""Solver core: factor graph, state and the batch GBP solve."""

from .factor_graph import (GBPGraph, GBPState, build_graph,  # noqa: F401
                           graph_from_numpy, init_state, state_from_numpy,
                           state_to_numpy)
