"""The edge-sharded solve over the ranks of a ``torch.distributed`` group.

The PyTorch counterpart of ``gbp_poplar_tpu/parallel/sharding.py``:

  - the edge axis is split into one contiguous block per rank; every
    per-edge step (relinearisation, the messages, the damping state) runs
    on the rank's own block, with the single-device code and kernels;
  - every variable's belief and prior is whole on every rank; each rank
    sums its block's messages per variable (H3, without the prior), one
    ``all_reduce`` sums the partial sums over the ranks, and then the
    prior is added (core/gbp.update_beliefs with ``group``). The payload
    per sweep is (27 C + 9 L) floats, whatever the number of edges.

The edges are padded to a multiple of the rank count with inert edges
(``active = 0``), which emit zero messages and never relinearise. Placement
is slicing on the host side: rank r's block is an ordinary ``GBPGraph`` /
``GBPState`` whose segments list the block's real edges, so its camera
side, whose ids are not in order, gets its own chunk plan.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..config import GBPConfig
from ..core import gbp
from ..core.factor_graph import GBPGraph, GBPState, build_segments


def real_edge_count(cam_idx, lmk_idx) -> int:
    """Number of edges before the trailing inert-padding run.

    build_graph pads the edge axis with (cam 0, lmk 0) inert edges. Real
    edges are (landmark, keyframe)-sorted, so a trailing (0, 0) run can
    only be padding (a real (0, 0) edge sorts first)."""
    nz = np.flatnonzero((np.asarray(cam_idx) != 0)
                        | (np.asarray(lmk_idx) != 0))
    return int(nz[-1]) + 1 if nz.size else 0


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _pad_cols(x: torch.Tensor, pad: int, fill=0) -> torch.Tensor:
    """``x`` with ``pad`` columns of ``fill`` appended on its last axis."""
    tail = torch.full(x.shape[:-1] + (pad,), fill, dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, tail], dim=-1)


def pad_edges(graph: GBPGraph, state: GBPState,
              n_shards: int) -> tuple[GBPGraph, GBPState, int]:
    """Pad the edge axis to a multiple of ``n_shards`` with inactive edges.

    The padding points at keyframe 0 / landmark 0, carries ``meas_var =
    1`` and camera 0's intrinsics (the intrinsics refit's per-camera
    maximum would otherwise take in a foreign value), and ``active = 0``,
    so every message it emits is zero; its state fields are zero, as the
    JAX function pads them. The segments are kept: they list the real
    edges, a prefix of the padded axis. Returns (graph, state, padding)."""
    pad = (-graph.n_edges) % n_shards
    if pad == 0:
        return graph, state, 0
    intr = graph.intr
    if intr is not None:
        ci = _host(graph.cam_idx)
        i0 = int(np.argmax(ci == 0)) if (ci == 0).any() else 0
        intr = torch.cat([intr, intr[:, i0:i0 + 1].expand(3, pad)], dim=1)
    graph = dataclasses.replace(
        graph, cam_idx=_pad_cols(graph.cam_idx, pad),
        lmk_idx=_pad_cols(graph.lmk_idx, pad),
        meas=_pad_cols(graph.meas, pad),
        meas_var=_pad_cols(graph.meas_var, pad, 1.0), intr=intr, derived={})
    state = dataclasses.replace(
        state, pk=_pad_cols(state.pk, pad),
        damping_count=_pad_cols(state.damping_count, pad),
        robust=_pad_cols(state.robust, pad, False),
        active=_pad_cols(state.active, pad))
    return graph, state, pad


def _own(x: torch.Tensor, device) -> torch.Tensor:
    """A contiguous copy of ``x`` on ``device`` that shares no memory with
    it (rank blocks are updated in place)."""
    return x.detach().to(device).clone(memory_format=torch.contiguous_format)


def edge_block(graph: GBPGraph, state: GBPState, n_shards: int,
               rank: int) -> tuple[GBPGraph, GBPState]:
    """Rank ``rank``'s block of a graph and state padded to a multiple of
    ``n_shards`` (``pad_edges``): its contiguous run of edges, every
    variable whole, as a local graph and state, copies on the graph's
    device. Its segments list the block's edges below the graph's own
    listed count, so padding is never listed."""
    device = graph.cam_idx.device
    e_loc = graph.n_edges // n_shards
    lo, hi = rank * e_loc, (rank + 1) * e_loc
    n_real = min(max(graph.cam_seg.var.shape[0] - lo, 0), e_loc)
    ci, li = _host(graph.cam_idx[lo:hi]), _host(graph.lmk_idx[lo:hi])
    local = dataclasses.replace(
        graph, cam_idx=_own(graph.cam_idx[lo:hi], device),
        lmk_idx=_own(graph.lmk_idx[lo:hi], device),
        meas=_own(graph.meas[:, lo:hi], device),
        meas_var=_own(graph.meas_var[lo:hi], device),
        intr=None if graph.intr is None else _own(graph.intr[:, lo:hi],
                                                  device),
        cam_scaling=_own(graph.cam_scaling, device),
        lmk_scaling=_own(graph.lmk_scaling, device),
        first_kf=_own(graph.first_kf, device),
        first_uv=_own(graph.first_uv, device),
        cam_seg=build_segments(ci, graph.n_keyframes, n_real, device),
        lmk_seg=build_segments(li, graph.n_points, n_real, device),
        derived={})
    return local, _state_block(state, slice(lo, hi), slice(None), device)


def _state_block(state: GBPState, cols, lmk_cols, device) -> GBPState:
    """The state's edge columns ``cols`` and landmark columns ``lmk_cols``,
    every camera field whole, as an independent copy on ``device``."""
    return GBPState(
        cam_bel=_own(state.cam_bel, device),
        lmk_bel=_own(state.lmk_bel[:, lmk_cols], device),
        cam_prior=_own(state.cam_prior, device),
        lmk_prior=_own(state.lmk_prior[:, lmk_cols], device),
        pk=_own(state.pk[:, cols], device),
        damping_count=_own(state.damping_count[cols], device),
        robust=_own(state.robust[cols], device),
        active=_own(state.active[cols], device),
        cam_weaken=_own(state.cam_weaken, device),
        lmk_weaken=_own(state.lmk_weaken[lmk_cols], device))


def gather_cols(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along the last axis in rank order
    (the blocks are of one shape on every rank), on ``x``'s device. Under
    gloo the blocks go through host memory; bool travels as uint8."""
    stage = dist.get_backend(group) == dist.Backend.GLOO
    src = x.to(torch.uint8) if x.dtype == torch.bool else x
    src = (src.cpu() if stage else src).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=-1).to(device=x.device, dtype=x.dtype)


def gather_state(state: GBPState, group, n_edges: int) -> GBPState:
    """The whole state from the ranks' blocks (the counterpart of the JAX
    driver's ``_Sharded.unprep``): every edge field concatenated in rank
    order and cut to the first ``n_edges`` edges, the padding dropped; the
    variables as this rank holds them, since every rank holds them whole.
    A collective: every rank calls it."""
    def edges(x):
        return gather_cols(x, group)[..., :n_edges]

    return dataclasses.replace(
        state, pk=edges(state.pk), damping_count=edges(state.damping_count),
        robust=edges(state.robust), active=edges(state.active))


@dataclasses.dataclass(frozen=True)
class ShardedSolver:
    """The edge-sharded entry points of one rank of ``group`` for ``cfg``.

    Build with :func:`make_sharded_solver`; ``prepare`` the whole graph and
    state (on the rank's device) into the rank's block, then pass the
    block to the other methods. Every rank calls every method, in the same
    order: each one issues collectives."""

    group: object
    cfg: GBPConfig

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    @property
    def world(self) -> int:
        return dist.get_world_size(self.group)

    def prepare(self, graph: GBPGraph, state: GBPState):
        """(local graph, local state): the edges padded to a multiple of
        the rank count, this rank's block."""
        graph, state, _ = pad_edges(graph, state, self.world)
        return edge_block(graph, state, self.world, self.rank)

    def initialise(self, state: GBPState, graph: GBPGraph) -> GBPState:
        return gbp.initialise(state, graph, self.cfg, self.group)

    def sweep(self, state: GBPState, graph: GBPGraph) -> GBPState:
        return gbp.gbp_sweep(state, graph, self.cfg, self.group)

    def run(self, state: GBPState, graph: GBPGraph, n_iters: int,
            iter_offset: int = 0, **kw):
        """``gbp.run_gbp`` on the rank's block. The offset is a host
        integer, so the annealing warm-up the JAX solver is given as
        ``warm`` is ``min(n_iters, 2 steps - iter_offset)`` here too."""
        return gbp.run_gbp(state, graph, self.cfg, n_iters,
                           iter_offset=iter_offset, group=self.group, **kw)

    def solve(self, state: GBPState, graph: GBPGraph,
              n_iters: int | None = None):
        return gbp.solve(state, graph, self.cfg, n_iters, self.group)

    def gather(self, state: GBPState, n_edges: int) -> GBPState:
        """The whole state, its first ``n_edges`` edges (``gather_state``)."""
        return gather_state(state, self.group, n_edges)


def make_sharded_solver(group, cfg: GBPConfig) -> ShardedSolver:
    """The edge-sharded solver of this process's rank in ``group``. The
    body every rank runs is the single-device code (core/gbp.py) with
    ``group`` threading one ``all_reduce`` into each reduction."""
    return ShardedSolver(group=group, cfg=cfg)
