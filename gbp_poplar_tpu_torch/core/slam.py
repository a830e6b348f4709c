"""Incremental SLAM: the factor graph grows one keyframe at a time.

The PyTorch counterpart of ``gbp_poplar_tpu/core/slam.py``. The full graph
is built once; flags in the state say which edges take part. Every
``iters_between_kfs`` sweeps the next keyframe is inserted
(``insert_keyframe``): its edges become active, its prior is centred on the
previous keyframe's solved belief, landmarks it sees first are placed on
their first pixel ray at the map's median depth, the annealing of exactly
those variables restarts, and so does the undamped phase everywhere. All of
it runs on the state's device, on the state in place; a segment of sweeps
is one ``gbp.run_gbp`` call, as in batch bundle adjustment.

One difference of form: the JAX package's depth median is
``jnp.nanmedian``, which averages the two middle values of an even count;
``torch.nanmedian`` returns the lower one, so ``_depth_median`` computes
the JAX definition.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import GBPConfig
from ..ops import planes as pl
from ..utils import trace
from . import comm, gbp
from .factor_graph import GBPGraph, GBPState


def _depth_median(z: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmedian(where(valid, z, nan))``: the mean of the two middle
    values of the valid ``z`` ((low + high) * 0.5, the middle one for an
    odd count), NaN when none is valid. No host synchronisation."""
    n = valid.sum()
    srt = torch.sort(torch.where(valid, z, torch.inf)).values
    low = torch.clamp_min(torch.div(n - 1, 2, rounding_mode="floor"), 0)
    high = torch.clamp_min(torch.div(n, 2, rounding_mode="floor"), 0)
    mid = (srt[low] + srt[torch.clamp_max(high, z.shape[0] - 1)]) * 0.5
    return torch.where(n > 0, mid, torch.nan)


@trace.spanned("gbp.insert_keyframe")
def insert_keyframe(state: GBPState, graph: GBPGraph, cfg: GBPConfig,
                    new_kf: int, av_depth: float = 1.0, group=None,
                    lmk_sharded: bool = False) -> GBPState:
    """Activate keyframe ``new_kf``'s edges and hand off the priors, in
    place on ``state`` (which is returned). The JAX package's
    ``insert_keyframe``, operation for operation; ``new_kf`` >= 2, so the
    padding edges (keyframe id 0) never activate. With ``group`` (a rank of
    the sharded solvers, parallel/) the new landmarks' depth is the JAX
    function's sharded one: the mean of the valid depths summed over the
    ranks, not the median."""
    dtype = state.cam_bel.dtype
    dev = state.cam_bel.device

    newly_active = graph.cam_idx == new_kf
    state.active.copy_(torch.where(newly_active, 1, state.active))

    # the new keyframe's prior mean <- the previous keyframe's belief mean;
    # a non-finite one (a near-singular belief) falls back to the previous
    # keyframe's prior mean, which is always finite
    col = slice(new_kf - 1, new_kf)
    mu_prev = pl.solve_sym(pl.unpack_sym(state.cam_lam[:, col], 6),
                           pl.unpack_vec(state.cam_eta[:, col], 6))
    handoff_ok = torch.isfinite(sum(torch.abs(m) for m in mu_prev))
    prev_prior_mu = pl.solve_sym(
        pl.unpack_sym(state.cam_prior_lam[:, col], 6),
        pl.unpack_vec(state.cam_prior_eta[:, col], 6))
    mu_prev = [torch.where(handoff_ok, m, p)
               for m, p in zip(mu_prev, prev_prior_mu)]
    new_prior_lam = pl.unpack_sym(state.cam_prior_lam[:, new_kf:new_kf + 1],
                                  6)
    state.cam_prior_eta[:, new_kf:new_kf + 1] = pl.pack_vec(
        pl.matvec(new_prior_lam, mu_prev)).to(dtype)

    # landmarks first seen by the new keyframe: on their first measured
    # pixel ray, at the median depth (previous keyframe's frame) of the
    # established landmarks; av_depth when there is none or it is <= 0.1
    new_lmk = graph.first_kf == new_kf
    r_prev = pl.so3_exp(mu_prev[3:6])
    lmk_mu = pl.matvec(pl.inv_sym3(pl.unpack_sym(state.lmk_lam, 3)),
                       pl.unpack_vec(state.lmk_eta, 3))
    z_est = (r_prev[2][0] * lmk_mu[0] + r_prev[2][1] * lmk_mu[1]
             + r_prev[2][2] * lmk_mu[2] + mu_prev[2])
    valid = ((graph.first_kf < new_kf) & torch.isfinite(z_est)
             & (z_est > 0.1) & (z_est < 100.0))
    if group is None:
        depth = _depth_median(z_est, valid)
    else:
        z_sum, n = comm.all_sum(
            group, [torch.sum(torch.where(valid, z_est, 0.0)),
                    torch.sum(valid.to(dtype))], torch.float64)
        depth = z_sum / torch.clamp_min(n, 1.0)
    depth = torch.where(torch.isfinite(depth) & (depth > 0.1), depth,
                        torch.tensor(av_depth, dtype=dtype, device=dev))

    # world point of the pixel ray at `depth`: y_w = R^T (d K^-1 uv1 - t)
    fx, fy = float(graph.k[0, 0]), float(graph.k[1, 1])
    cx, cy = float(graph.k[0, 2]), float(graph.k[1, 2])
    y_cam = [depth * (graph.first_uv[0] - cx) / fx,
             depth * (graph.first_uv[1] - cy) / fy,
             depth.expand(graph.first_uv.shape[1])]
    p_minus_t = [y_cam[i] - mu_prev[i] for i in range(3)]
    y_new = pl.mat_t_vec(r_prev, p_minus_t)
    new_lmk_eta = pl.pack_vec(pl.matvec(
        pl.unpack_sym(state.lmk_prior_lam, 3), y_new))
    state.lmk_prior_eta.copy_(torch.where(new_lmk, new_lmk_eta,
                                          state.lmk_prior_eta))

    # anneal only the new keyframe and its new landmarks
    state.cam_weaken[new_kf] = cfg.steps
    state.lmk_weaken.copy_(torch.where(new_lmk, cfg.steps, state.lmk_weaken))

    # restart the undamped phase everywhere (under the gn schedule
    # iters_before_damping is 0: damping comes back on the next sweep)
    state.damping.zero_()
    state.damping_count.fill_(-cfg.iters_before_damping)

    # refresh the beliefs with the new priors, then linearise the
    # just-activated factors at them
    state = gbp.update_beliefs(state, graph, cfg, group, lmk_sharded)
    return gbp.relinearise_masked(state, graph, cfg, newly_active)


class SlamResult(NamedTuple):
    state: GBPState
    reproj_err: np.ndarray   # [n_segments, iters_between_kfs]
    cost: np.ndarray
    n_relins: np.ndarray
    n_robust: np.ndarray


def solve_slam(
    state: GBPState,
    graph: GBPGraph,
    cfg: GBPConfig,
    n_keyframes: int | None = None,
    iters_between_kfs: int | None = None,
    av_depth: float = 1.0,
    with_diagnostics: bool = True,
    progress=None,
    start_kf: int = 1,
    runner=None,
    inserter=None,
    initialiser=None,
    segment_callback=None,
) -> SlamResult:
    """The incremental solve: segment k (k = 1 .. n_keyframes-1) runs
    ``iters_between_kfs`` sweeps with keyframes 0..k active, then keyframe
    k+1 is inserted, so the last segment refines the whole graph.

    ``state`` carries SLAM flags (utils/flags.create_flags: keyframes 0 and
    1 active). ``runner(state) -> (state, Diagnostics or None)``,
    ``inserter(state, k) -> state`` and ``initialiser(state) -> state``
    replace the default steps. ``start_kf > 1`` resumes at that segment
    from a state that already holds keyframe ``start_kf``'s insertion (as
    checkpoints are written), without initialising. ``progress(k, diag)``
    fires after segment k's sweeps, with diagnostics on;
    ``segment_callback(k, state)`` after segment k's insertion (or after
    the last segment)."""
    n_kf = graph.n_keyframes if n_keyframes is None else n_keyframes
    ibk = (cfg.iters_between_kfs if iters_between_kfs is None
           else iters_between_kfs)
    if runner is None:
        def runner(s):
            return gbp.run_gbp(s, graph, cfg, ibk,
                               with_diagnostics=with_diagnostics)
    if inserter is None:
        def inserter(s, k):
            return insert_keyframe(s, graph, cfg, k, av_depth)
    if initialiser is None:
        def initialiser(s):
            return gbp.initialise(s, graph, cfg)

    if start_kf <= 1:
        state = initialiser(state)

    errs, costs, relins, robusts = [], [], [], []
    for k in range(max(1, start_kf), n_kf):
        with trace.span("gbp.segment"):
            state, diag = runner(state)
            if with_diagnostics:
                errs.append(diag.reproj_err.cpu().numpy())
                costs.append(diag.cost.cpu().numpy())
                relins.append(diag.n_relins.cpu().numpy())
                robusts.append(diag.n_robust.cpu().numpy())
                if progress is not None:
                    progress(k, diag)
            if k + 1 < n_kf:
                state = inserter(state, k + 1)
            if segment_callback is not None:
                segment_callback(k, state)

    def stack(xs):
        return np.stack(xs) if xs else np.zeros((0, ibk))

    return SlamResult(state=state, reproj_err=stack(errs), cost=stack(costs),
                      n_relins=stack(relins), n_robust=stack(robusts))
