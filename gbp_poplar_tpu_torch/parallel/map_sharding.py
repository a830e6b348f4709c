"""The map-partitioned solve: landmark blocks split over the ranks,
keyframes whole on every rank.

The PyTorch counterpart of ``gbp_poplar_tpu/parallel/map_sharding.py``:

  - the landmarks are cut into contiguous blocks of equal size; rank s
    owns block s's beliefs, priors and flags and every edge that observes
    one of its landmarks (an edge touches one landmark, so the landmark
    side has no cut), with block-local landmark ids;
  - the landmark sums stay on their rank; the keyframes are the boundary
    variables, whose partial sums one ``all_reduce`` a sweep adds up:
    27 C floats, whatever the number of landmarks and edges.

A partitioned layout (``partition_by_landmark``) is the JAX package's:
rank s's edges at [s e_blk, (s+1) e_blk), its landmarks at [s l_blk,
(s+1) l_blk), the global landmark order plus dummy landmarks at the end.
A map-sharded checkpoint holds that layout whole, so it resumes at the same
rank count in either package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..config import GBPConfig
from ..core import gbp, slam
from ..core.factor_graph import GBPGraph, GBPState, build_segments
from ..ops import planes as pl
from .sharding import _host, _own, _state_block, gather_cols, real_edge_count


def partition_by_landmark(graph: GBPGraph, state: GBPState,
                          n_shards: int) -> tuple[GBPGraph, GBPState]:
    """The partitioned layout of a graph and state (host-side), placed as
    the JAX function places it: the real edges in a stable order by block
    (so each block keeps the landmark-sorted order), block-local landmark
    ids, every block padded to the largest with inert edges (``active =
    0``, ``meas_var = 1``, intrinsics 1), the build's trailing padding
    dropped; the landmark axis padded to a multiple of ``n_shards`` with
    dummy landmarks (identity prior, ``first_kf = C``, scaling 1, never
    observed). The tensors stay on the input's device. Its landmark ids
    are block-local, so it has no segments of its own (``cam_seg`` and
    ``lmk_seg`` are None): ``rebuild_partitioned_segments`` gives each
    block's."""
    lmk_idx = _host(graph.lmk_idx)
    e = real_edge_count(_host(graph.cam_idx), lmk_idx)
    lmk_idx = lmk_idx[:e]
    n_l = graph.n_points
    l_blk = -(-n_l // n_shards)
    l_pad = n_shards * l_blk - n_l
    shard = np.minimum(lmk_idx // l_blk, n_shards - 1)
    counts = np.bincount(shard, minlength=n_shards)
    e_blk = int(counts.max())
    order = np.argsort(shard, kind="stable")
    starts = np.zeros(n_shards + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    dest = shard[order] * e_blk + (np.arange(e) - starts[shard[order]])
    dev = graph.cam_idx.device

    def place(x, fill=0):
        x = _host(x) if isinstance(x, torch.Tensor) else x
        out = np.full(x.shape[:-1] + (n_shards * e_blk,), fill, x.dtype)
        out[..., dest] = x[..., order]
        return torch.as_tensor(out, device=dev)

    def pad_lmk(x, fill=0):
        x = _host(x)
        widths = [(0, 0)] * (x.ndim - 1) + [(0, l_pad)]
        return torch.as_tensor(np.pad(x, widths, constant_values=fill),
                               device=dev)

    lmk_local = (lmk_idx - shard * l_blk).astype(np.int32)
    pgraph = dataclasses.replace(
        graph, cam_idx=place(graph.cam_idx),
        lmk_idx=place(lmk_local),
        meas=place(graph.meas), meas_var=place(graph.meas_var, 1.0),
        intr=None if graph.intr is None else place(graph.intr, 1.0),
        lmk_scaling=pad_lmk(graph.lmk_scaling, 1.0),
        first_kf=pad_lmk(graph.first_kf, graph.n_keyframes),
        first_uv=pad_lmk(graph.first_uv), cam_seg=None, lmk_seg=None,
        derived={})
    lmk_prior = pad_lmk(state.lmk_prior)
    if l_pad:
        # dummy landmarks need an invertible prior: identity Lambda
        diag = [3 + pl.sym_slot(i, i) for i in range(3)]
        lmk_prior[diag, n_l:] = 1.0
    pstate = GBPState(
        cam_bel=state.cam_bel, lmk_bel=pad_lmk(state.lmk_bel),
        cam_prior=state.cam_prior, lmk_prior=lmk_prior,
        pk=place(state.pk), damping_count=place(state.damping_count),
        robust=place(state.robust, False), active=place(state.active),
        cam_weaken=state.cam_weaken, lmk_weaken=pad_lmk(state.lmk_weaken))
    return pgraph, pstate


def rebuild_partitioned_segments(pgraph: GBPGraph, n_shards: int,
                                 blocks=None):
    """The segments ``(cam_seg, lmk_seg)`` of each block of a partitioned
    graph (``blocks``, default all), e.g. one loaded from a checkpoint,
    which keeps only plain arrays. A block's real edges are a prefix of it
    in landmark order, so a trailing (keyframe 0, local landmark 0) run is
    its inert fill (``real_edge_count``'s rule); the segments list the
    rest, and the camera side, whose ids are not in order, gets its chunk
    plan. The counterpart of ``rebuild_partitioned_windows``."""
    e_blk = pgraph.n_edges // n_shards
    l_blk = pgraph.n_points // n_shards
    ci, li = _host(pgraph.cam_idx), _host(pgraph.lmk_idx)
    dev = pgraph.cam_idx.device
    out = []
    for s in range(n_shards) if blocks is None else blocks:
        c = ci[s * e_blk:(s + 1) * e_blk]
        lk = li[s * e_blk:(s + 1) * e_blk]
        n_real = real_edge_count(c, lk)
        out.append((build_segments(c, pgraph.n_keyframes, n_real, dev),
                    build_segments(lk, l_blk, n_real, dev)))
    return out


def map_block(pgraph: GBPGraph, pstate: GBPState, n_shards: int,
              rank: int) -> tuple[GBPGraph, GBPState]:
    """Rank ``rank``'s block of a partitioned layout as a local graph and
    state, copies on the layout's device: its edges and landmarks, every
    keyframe whole, with the block's segments."""
    device = pgraph.cam_idx.device
    e_blk = pgraph.n_edges // n_shards
    l_blk = pgraph.n_points // n_shards
    cols = slice(rank * e_blk, (rank + 1) * e_blk)
    lcols = slice(rank * l_blk, (rank + 1) * l_blk)
    ((cam_seg, lmk_seg),) = rebuild_partitioned_segments(pgraph, n_shards,
                                                         [rank])
    local = dataclasses.replace(
        pgraph, cam_idx=_own(pgraph.cam_idx[cols], device),
        lmk_idx=_own(pgraph.lmk_idx[cols], device),
        meas=_own(pgraph.meas[:, cols], device),
        meas_var=_own(pgraph.meas_var[cols], device),
        intr=None if pgraph.intr is None else _own(pgraph.intr[:, cols],
                                                   device),
        cam_scaling=_own(pgraph.cam_scaling, device),
        lmk_scaling=_own(pgraph.lmk_scaling[lcols], device),
        first_kf=_own(pgraph.first_kf[lcols], device),
        first_uv=_own(pgraph.first_uv[:, lcols], device),
        cam_seg=cam_seg, lmk_seg=lmk_seg, derived={})
    return local, _state_block(pstate, cols, lcols, device)


def gather_partitioned(state: GBPState, group) -> GBPState:
    """The whole partitioned state from the ranks' blocks: edge and
    landmark fields concatenated in rank order, the keyframes as this rank
    holds them (whole on every rank). A collective: every rank calls it."""
    def cat(x):
        return gather_cols(x, group)

    return dataclasses.replace(
        state, lmk_bel=cat(state.lmk_bel), lmk_prior=cat(state.lmk_prior),
        pk=cat(state.pk), damping_count=cat(state.damping_count),
        robust=cat(state.robust), active=cat(state.active),
        lmk_weaken=cat(state.lmk_weaken))


@dataclasses.dataclass(frozen=True)
class MapShardedSolver:
    """The map-partitioned entry points of one rank of ``group`` for
    ``cfg``. Every rank calls every method, in the same order."""

    group: object
    cfg: GBPConfig

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    @property
    def world(self) -> int:
        return dist.get_world_size(self.group)

    def prepare(self, graph: GBPGraph, state: GBPState,
                partitioned: bool = False):
        """(local graph, local state) of this rank from the whole graph and
        state, or, with ``partitioned``, from a partitioned layout (a
        map-sharded checkpoint's)."""
        if not partitioned:
            graph, state = partition_by_landmark(graph, state, self.world)
        return map_block(graph, state, self.world, self.rank)

    def initialise(self, state: GBPState, graph: GBPGraph) -> GBPState:
        return gbp.initialise(state, graph, self.cfg, self.group, True)

    def sweep(self, state: GBPState, graph: GBPGraph) -> GBPState:
        return gbp.gbp_sweep(state, graph, self.cfg, self.group, True)

    def run(self, state: GBPState, graph: GBPGraph, n_iters: int,
            iter_offset: int = 0, **kw):
        return gbp.run_gbp(state, graph, self.cfg, n_iters,
                           iter_offset=iter_offset, group=self.group,
                           lmk_sharded=True, **kw)

    def solve(self, state: GBPState, graph: GBPGraph,
              n_iters: int | None = None):
        return gbp.solve(state, graph, self.cfg, n_iters, self.group, True)

    def insert_keyframe(self, state: GBPState, graph: GBPGraph, new_kf: int,
                        av_depth: float = 1.0) -> GBPState:
        return slam.insert_keyframe(state, graph, self.cfg, new_kf, av_depth,
                                    self.group, True)

    def gather(self, state: GBPState) -> GBPState:
        """The whole partitioned state (``gather_partitioned``)."""
        return gather_partitioned(state, self.group)


def make_map_sharded_solver(group, cfg: GBPConfig) -> MapShardedSolver:
    return MapShardedSolver(group=group, cfg=cfg)
