"""Per-camera intrinsics refinement for Snavely/BAL problems.

The PyTorch counterpart of ``gbp_poplar_tpu/core/intrinsics.py`` (its
module docstring gives the reasoning): between GBP execution chunks the ba
driver's ``--refine_intrinsics`` solves, per camera, the damped 3-parameter
Gauss-Newton system for (f, k1, k2) at the current belief means, and keeps
the step only when the MAP objective falls (block-coordinate descent). The
per-edge gradient of the Snavely model is closed-form:

  uv = f * dist(rho) * p,  dist = 1 + k1 rho + k2 rho^2,  p = -(x/z, y/z)
  d uv / d f  = dist * p,  d uv / d k1 = f rho p,  d uv / d k2 = f rho^2 p

The per-camera sums go through the deterministic segmented sum (H3) over
the graph's camera segments.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import GBPConfig
from ..ops import lie, projection, reduce_kernel
from . import gbp
from .factor_graph import GBPGraph, GBPState


def refit_intrinsics(state: GBPState, graph: GBPGraph, cfg: GBPConfig):
    """One damped GN step on every camera's (f, k1, k2) at the current
    means. ``graph.intr`` [3, E] must be present. Returns (new_intr
    [3, E], accepted: 0-d bool tensor); new_intr is graph.intr's values
    when neither candidate step (scale 1 or 0.25) lowers ``gbp.map_cost``."""
    if graph.intr is None:
        raise ValueError("refit_intrinsics needs a Snavely problem "
                         "(per-edge intrinsics)")
    c = graph.n_keyframes
    cam_mu, lmk_mu = gbp._variable_means(state)
    cam_e = cam_mu.T.index_select(0, graph.cam_idx)         # [E, 6]
    lmk_e = lmk_mu.T.index_select(0, graph.lmk_idx)         # [E, 3]
    f, k1, k2 = graph.intr

    y_cf = lie.w2c_apply(cam_e, lmk_e)
    z = y_cf[..., 2]
    px = -y_cf[..., 0] / z
    py = -y_cf[..., 1] / z
    rho = px * px + py * py
    dist = 1.0 + rho * (k1 + k2 * rho)
    ru = graph.meas[0] - f * dist * px
    rv = graph.meas[1] - f * dist * py

    # Huber-IRLS weight at the current residual (the factors' rule)
    err = torch.sqrt(ru * ru + rv * rv)
    var, _ = projection.huber_meas_var(err, graph.meas_var, cfg.huber_nstds)
    ok = ((state.active > 0) & (torch.abs(z) > cfg.min_depth)
          & torch.isfinite(err) & torch.isfinite(rho))
    w = torch.where(ok, 1.0 / var, 0.0)

    ju = torch.stack([dist * px, f * rho * px, f * rho * rho * px], -1)
    jv = torch.stack([dist * py, f * rho * py, f * rho * rho * py], -1)
    ju = torch.where(ok[:, None] & torch.isfinite(ju), ju, 0.0)
    jv = torch.where(ok[:, None] & torch.isfinite(jv), jv, 0.0)
    ru = torch.where(ok & torch.isfinite(ru), ru, 0.0)
    rv = torch.where(ok & torch.isfinite(rv), rv, 0.0)
    jtj = (ju[:, :, None] * ju[:, None, :]
           + jv[:, :, None] * jv[:, None, :]) * w[:, None, None]
    jtr = (ju * ru[:, None] + jv * rv[:, None]) * w[:, None]
    sums = reduce_kernel.segment_sum(
        torch.cat([jtj.reshape(-1, 9), jtr], 1).T.contiguous(),
        graph.cam_seg, reference=cfg.kernels == "reference")    # [12, C]
    a = sums[:9].T.reshape(c, 3, 3)
    b = sums[9:].T

    # damped solve; cameras without active edges get a zero step
    damp = 1e-3 * torch.clamp_min(torch.diagonal(a, dim1=-2, dim2=-1),
                                  1e-8) + 1e-8
    a = a + torch.diag_embed(damp)
    fin = (torch.isfinite(a).all(dim=-1).all(dim=-1)
           & torch.isfinite(b).all(dim=-1))
    eye = torch.eye(3, dtype=a.dtype, device=a.device).expand_as(a)
    a = torch.where(fin[:, None, None], a, eye)
    b = torch.where(fin[:, None], b, 0.0)
    delta, info = torch.linalg.solve_ex(a, b)
    delta = torch.where((info == 0)[:, None] & torch.isfinite(delta),
                        delta, 0.0)

    # per-camera values (every edge of a camera carries the same one)
    idx = graph.cam_idx.long()[:, None].expand(-1, 3)
    per_cam = torch.full((c, 3), -torch.inf, dtype=a.dtype, device=a.device)
    per_cam = per_cam.scatter_reduce(0, idx, graph.intr.T, "amax")
    per_cam = torch.where(torch.isfinite(per_cam), per_cam, 0.0)

    def candidate(scale: float):
        new = per_cam + scale * delta
        # keep the focal positive
        return torch.cat([torch.clamp_min(new[:, :1], 1.0), new[:, 1:]], 1)

    def cost_of(per_cam_new):
        intr_new = per_cam_new.index_select(0, graph.cam_idx).T
        return gbp.map_cost(state, dataclasses.replace(graph, intr=intr_new),
                            cfg)

    cost0 = gbp.map_cost(state, graph, cfg)
    cand1, cand2 = candidate(1.0), candidate(0.25)
    c1, c2 = cost_of(cand1), cost_of(cand2)
    first = c1 <= c2
    best = torch.where(first, c1, c2)
    pick = torch.where(first, cand1, cand2)
    accepted = torch.isfinite(best) & (best < cost0)
    new_per_cam = torch.where(accepted, pick, per_cam)
    return new_per_cam.index_select(0, graph.cam_idx).T.contiguous(), accepted
