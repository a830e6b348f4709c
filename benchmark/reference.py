"""The plain reference: bundle adjustment's objective and its optimum.

Straightforward PyTorch, independent of the program: it imports nothing of
``gbp_poplar_tpu_torch`` (nor JAX) and takes nothing the program made. It
reads the generated problem (``gen.Problem``) and, only to judge them, the
means the program returned.

- ``Edges``: the problem's observations (or a subset of them) on a device.
- ``priors``: the MAP objective's Gaussian priors as the configuration
  states them: centred on the initial estimate, each variable's precision
  (the largest entry of its edges' 2x9 reprojection Jacobians, with the
  rotation perturbed locally)^2 / ``meas_var``, weakened by
  ``weaker_factor``^2, the first ``anchor_cams`` keyframes held at
  1 / ``first_cam_prior_std``^2 (the priors the solver's annealing ends
  with).
- ``cost``: the MAP objective in float64: the sum over edges of the
  whitened Huber loss of the reprojection residual (``meas_var`` px^2,
  ``nstds`` standard deviations), the mean residual norm, and the priors'
  part over the edges' variables.
- ``solve``: Levenberg-Marquardt with an exact Schur complement (dense
  reduced camera system, Cholesky) and iteratively reweighted Huber
  weights, from the problem's initial estimate. In float64 it gives the
  optimum the program's means are held against. With ``edge_dtype`` lower
  (the per-edge projection, residuals and Jacobians in bfloat16, sums and
  solves in float32) it is the control of ``check.py``.
- ``slam_priors``, ``slam_chain``: incremental SLAM's segments, under the
  priors each insertion hands on.

Camera model: ``y_cam = R(w) y + t`` for pose (t, w). Pinhole:
``u = fx x/z + cx``. Snavely (BAL): ``p = -(x, y)/z``,
``u = f (1 + k1 |p|^2 + k2 |p|^4) p``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import jacfwd, vmap


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def rotate(w, y):
    """R(w) y by Rodrigues' formula, with its series near w = 0."""
    th2 = (w * w).sum(-1, keepdim=True)
    small = th2 < 1e-12
    th2s = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(th2s)
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2s)
    wy = _cross(w, y)
    return y + a * wy + b * _cross(w, wy)


def project(cam, lmk, intr, k):
    """Pixels [..., 2] of ``lmk`` [..., 3] seen from ``cam`` [..., 6];
    ``intr`` [..., 3] (f, k1, k2) for the Snavely model, else None and
    ``k`` = (fx, fy, cx, cy)."""
    y = rotate(cam[..., 3:], lmk) + cam[..., :3]
    if intr is None:
        fx, fy, cx, cy = k
        return torch.stack([fx * y[..., 0] / y[..., 2] + cx,
                            fy * y[..., 1] / y[..., 2] + cy], -1)
    p = -y[..., :2] / y[..., 2:3]
    rho = (p * p).sum(-1, keepdim=True)
    dist = 1.0 + rho * (intr[..., 1:2] + intr[..., 2:3] * rho)
    return intr[..., 0:1] * dist * p


@dataclasses.dataclass
class Edges:
    """Observations on a device: variable ids compacted to the variables
    the edges touch (``cams``, ``lmks`` map back to the problem's ids)."""

    cam: torch.Tensor      # [E] int64, compact
    lmk: torch.Tensor      # [E] int64, compact, edges grouped by landmark
    meas: torch.Tensor     # [E, 2] float64
    intr: torch.Tensor | None   # [E, 3] float64 or None
    k: tuple               # (fx, fy, cx, cy)
    cams: np.ndarray       # [C'] problem camera ids
    lmks: np.ndarray       # [L'] problem landmark ids

    @property
    def n_edges(self) -> int:
        return self.cam.shape[0]


def edges(problem, device, mask: np.ndarray | None = None) -> Edges:
    """The problem's edges (those where ``mask`` holds), on ``device``."""
    sel = (np.arange(problem.n_edges) if mask is None
           else np.flatnonzero(mask))
    ci = problem.cam_idx[sel].astype(np.int64)
    li = problem.lmk_idx[sel].astype(np.int64)
    order = np.lexsort((ci, li))
    sel, ci, li = sel[order], ci[order], li[order]
    cams, cam_c = np.unique(ci, return_inverse=True)
    lmks, lmk_c = np.unique(li, return_inverse=True)
    kk = problem.k
    intr = (None if problem.intrinsics is None else torch.as_tensor(
        problem.intrinsics[ci], dtype=torch.float64, device=device))
    return Edges(cam=torch.as_tensor(cam_c, device=device),
                 lmk=torch.as_tensor(lmk_c, device=device),
                 meas=torch.as_tensor(problem.measurements[sel],
                                      dtype=torch.float64, device=device),
                 intr=intr,
                 k=(float(kk[0, 0]), float(kk[1, 1]), float(kk[0, 2]),
                    float(kk[1, 2])),
                 cams=cams, lmks=lmks)


def _whitened(r, meas_var, nstds):
    """(Huber loss per edge, IRLS weight per edge) of residuals [E, 2]."""
    err = torch.sqrt((r * r).sum(-1) / meas_var)
    robust = err > nstds
    loss = torch.where(robust, nstds * err - 0.5 * nstds * nstds,
                       0.5 * err * err)
    w = torch.where(robust, nstds / torch.where(robust, err, 1.0), 1.0)
    return loss, w / meas_var


@dataclasses.dataclass
class Priors:
    """Problem-indexed prior precisions and means (float64 tensors)."""

    cam_lam: torch.Tensor   # [C]
    lmk_lam: torch.Tensor   # [L]
    cam_mu: torch.Tensor    # [C, 6]
    lmk_mu: torch.Tensor    # [L, 3]


def priors(problem, device, meas_var: float, weaker_factor: float,
           first_cam_prior_std: float, anchor_cams: int,
           block: int = 1 << 19) -> Priors:
    """The configuration's annealed priors over all of ``problem``'s
    edges (see the module docstring)."""
    e = edges(problem, device)
    cam0 = torch.as_tensor(problem.cam_init, dtype=torch.float64,
                           device=device)
    lmk0 = torch.as_tensor(problem.lmk_init, dtype=torch.float64,
                           device=device)
    cam_ids = torch.as_tensor(e.cams, device=device)[e.cam]
    lmk_ids = torch.as_tensor(e.lmks, device=device)[e.lmk]
    snavely = e.intr is not None

    def in_camera(y, i):
        # the projection of a camera-frame point
        return project(torch.zeros(6, dtype=y.dtype, device=y.device), y,
                       i if snavely else None, e.k)

    eye = torch.eye(3, dtype=torch.float64, device=device)
    big = torch.zeros(e.n_edges, dtype=torch.float64, device=device)
    for a in range(0, e.n_edges, block):
        s = slice(a, a + block)
        c, l = cam0[cam_ids[s]], lmk0[lmk_ids[s]]
        w = c[:, 3:]
        rot = rotate(w[:, None, :].expand(-1, 3, -1), eye.expand(
            w.shape[0], 3, 3)).transpose(1, 2)          # R, columns R e_j
        ry = rotate(w, l)
        intr = (torch.zeros_like(c[:, :3]) if e.intr is None else e.intr[s])
        jp = vmap(jacfwd(in_camera))(ry + c[:, :3], intr)   # [n, 2, 3]
        hat = torch.zeros(w.shape[0], 3, 3, dtype=torch.float64,
                          device=device)
        hat[:, 0, 1], hat[:, 0, 2] = -ry[:, 2], ry[:, 1]
        hat[:, 1, 0], hat[:, 1, 2] = ry[:, 2], -ry[:, 0]
        hat[:, 2, 0], hat[:, 2, 1] = -ry[:, 1], ry[:, 0]
        j = torch.cat([jp, -(jp @ hat), jp @ rot], -1)
        big[s] = j.abs().amax(dim=(1, 2))
    cam_max = torch.zeros(problem.n_keyframes, dtype=torch.float64,
                          device=device).scatter_reduce(0, cam_ids, big,
                                                        "amax")
    lmk_max = torch.zeros(problem.n_points, dtype=torch.float64,
                          device=device).scatter_reduce(0, lmk_ids, big,
                                                        "amax")
    weak = weaker_factor ** 2
    cam_lam = cam_max ** 2 / meas_var / weak
    cam_lam[:anchor_cams] = 1.0 / first_cam_prior_std ** 2
    return Priors(cam_lam=cam_lam, lmk_lam=lmk_max ** 2 / meas_var / weak,
                  cam_mu=cam0, lmk_mu=lmk0)


def _rotation(w: np.ndarray) -> np.ndarray:
    """R(w) as a [3, 3] float64 matrix."""
    eye = torch.eye(3, dtype=torch.float64)
    return rotate(torch.as_tensor(w, dtype=torch.float64).expand(3, 3),
                  eye).T.numpy()


def slam_priors(problem, pri: Priors, k: int, history: dict,
                av_depth: float) -> Priors:
    """The priors of incremental SLAM's segment ``k``: ``pri``'s precisions
    (the annealing ends there for every variable), and its means except
    where an insertion set them. Keyframe j >= 2 was inserted with the
    previous keyframe's mean after segment j - 1 (``history[j - 1]``, the
    program's answer, (cam [C, 6], lmk [L, 3])), or that keyframe's own
    prior mean where it is not finite; a landmark first seen by keyframe j
    was put on its first pixel ray at the median depth, in keyframe
    j - 1's frame, of the landmarks seen before (the mean of the two middle
    ones of an even count; ``av_depth`` when there is none or it is not
    above 0.1). Pinhole only, as incremental SLAM."""
    n_l = problem.n_points
    cam_mu = pri.cam_mu.cpu().numpy().copy()
    lmk_mu = pri.lmk_mu.cpu().numpy().copy()
    ci = problem.cam_idx.astype(np.int64)
    li = problem.lmk_idx.astype(np.int64)
    first_kf = np.full(n_l, problem.n_keyframes)
    np.minimum.at(first_kf, li, ci)
    order = np.lexsort((ci, li))
    first_uv = problem.measurements[
        order[np.searchsorted(li[order], np.arange(n_l))]]
    kk = problem.k
    for j in range(2, k + 1):
        cam_prev, lmk_prev = history[j - 1]
        mu = np.asarray(cam_prev[j - 1], np.float64)
        if not np.all(np.isfinite(mu)):
            mu = cam_mu[j - 1]
        cam_mu[j] = mu
        rot = _rotation(mu[3:])
        z = np.asarray(lmk_prev, np.float64) @ rot[2] + mu[2]
        valid = (first_kf < j) & np.isfinite(z) & (z > 0.1) & (z < 100.0)
        depth = float(np.median(z[valid])) if valid.any() else np.nan
        if not (np.isfinite(depth) and depth > 0.1):
            depth = av_depth
        new = first_kf == j
        uv = first_uv[new]
        y_cam = np.stack([depth * (uv[:, 0] - kk[0, 2]) / kk[0, 0],
                          depth * (uv[:, 1] - kk[1, 2]) / kk[1, 1],
                          np.full(uv.shape[0], depth)], 1)
        lmk_mu[new] = (y_cam - mu[:3]) @ rot
    dev = pri.cam_mu.device
    return Priors(cam_lam=pri.cam_lam, lmk_lam=pri.lmk_lam,
                  cam_mu=torch.as_tensor(cam_mu, device=dev),
                  lmk_mu=torch.as_tensor(lmk_mu, device=dev))


def slam_chain(problem, pri: Priors, av_depth: float, meas_var: float,
               nstds: float, edge_dtype=torch.float64) -> dict:
    """The reference's own incremental SLAM, which takes nothing from the
    program: segment k = 1 .. n - 1 solved over the edges active then
    (keyframes 0 .. k) under the priors its own earlier answers hand on
    (``slam_priors``). Returns {k: (cam [C, 6], lmk [L, 3])}."""
    dev = pri.cam_mu.device
    history = {}
    for k in range(1, problem.n_keyframes):
        p_k = slam_priors(problem, pri, k, history, av_depth)
        e = edges(problem, dev, problem.cam_idx <= k)
        cam, lmk, _ = solve(e, p_k.cam_mu.cpu().numpy(),
                            p_k.lmk_mu.cpu().numpy(), meas_var, nstds, p_k,
                            edge_dtype=edge_dtype)
        history[k] = (cam, lmk)
    return history


def _prior_part(e: Edges, pri: Priors | None):
    """The priors of ``e``'s variables, compacted: (cam_lam, cam_mu,
    lmk_lam, lmk_mu), or None."""
    if pri is None:
        return None
    dev = e.cam.device
    ci = torch.as_tensor(e.cams, device=dev)
    li = torch.as_tensor(e.lmks, device=dev)
    return pri.cam_lam[ci], pri.cam_mu[ci], pri.lmk_lam[li], pri.lmk_mu[li]


def _prior_cost(part, cams, lmks):
    if part is None:
        return 0.0
    c_lam, c_mu, l_lam, l_mu = (x.to(cams.dtype) for x in part)
    dc, dl = cams - c_mu, lmks - l_mu
    return 0.5 * ((c_lam[:, None] * dc * dc).sum()
                  + (l_lam[:, None] * dl * dl).sum())


def cost(e: Edges, cam_means, lmk_means, meas_var: float, nstds: float,
         pri: Priors | None = None, dtype=torch.float64,
         block: int = 1 << 20) -> tuple[float, float, float]:
    """(sum of whitened Huber losses, mean residual norm, the priors' part)
    at the problem-indexed means ``cam_means`` [C, 6], ``lmk_means`` [L, 3]
    (NumPy or tensors), the residuals computed in ``dtype`` and summed in
    float64; NaN where a residual is not finite."""
    dev = e.cam.device
    cams = torch.as_tensor(np.asarray(cam_means)[e.cams], dtype=torch.float64,
                           device=dev)
    lmks = torch.as_tensor(np.asarray(lmk_means)[e.lmks], dtype=torch.float64,
                           device=dev)
    total, norms = 0.0, 0.0
    for a in range(0, e.n_edges, block):
        s = slice(a, a + block)
        r = e.meas[s].to(dtype) - project(
            cams[e.cam[s]].to(dtype), lmks[e.lmk[s]].to(dtype),
            None if e.intr is None else e.intr[s].to(dtype), e.k)
        r = r.double()
        loss, _ = _whitened(r, meas_var, nstds)
        total += float(loss.sum())
        norms += float(torch.sqrt((r * r).sum(-1)).sum())
    return (total, norms / max(1, e.n_edges),
            float(_prior_cost(_prior_part(e, pri), cams, lmks)))


def _pairs(lmk: torch.Tensor):
    """(e1, e2) of every ordered pair of edges that share a landmark
    (edges grouped by landmark)."""
    counts = torch.bincount(lmk)
    start = torch.cumsum(counts, 0) - counts
    sq = counts * counts
    owner = torch.repeat_interleave(torch.arange(counts.shape[0],
                                                 device=lmk.device), sq)
    q = torch.arange(int(sq.sum()), device=lmk.device) \
        - torch.repeat_interleave(torch.cumsum(sq, 0) - sq, sq)
    t = counts[owner]
    return start[owner] + q // t, start[owner] + q % t


def _linearise(e: Edges, cams, lmks, edge_dtype, acc_dtype, meas_var, nstds):
    """Residuals, Jacobians of the projection, IRLS weights and the Huber
    cost, computed in ``edge_dtype`` and returned in ``acc_dtype``."""
    intr = (torch.zeros_like(e.meas[:, :1]).expand(-1, 3)
            if e.intr is None else e.intr).to(edge_dtype)
    snavely = e.intr is not None

    def one(c, l, i):
        return project(c, l, i if snavely else None, e.k)

    c_e = cams[e.cam].to(edge_dtype)
    l_e = lmks[e.lmk].to(edge_dtype)
    jc, jl = vmap(jacfwd(one, argnums=(0, 1)))(c_e, l_e, intr)
    r = e.meas.to(edge_dtype) - vmap(one)(c_e, l_e, intr)
    loss, w = _whitened(r, meas_var, nstds)
    return (r.to(acc_dtype), jc.to(acc_dtype), jl.to(acc_dtype),
            w.to(acc_dtype), loss.to(acc_dtype).sum())


def _cost_only(e, cams, lmks, edge_dtype, acc_dtype, meas_var, nstds,
               part):
    intr = None if e.intr is None else e.intr.to(edge_dtype)
    r = e.meas.to(edge_dtype) - project(cams[e.cam].to(edge_dtype),
                                        lmks[e.lmk].to(edge_dtype), intr, e.k)
    loss, _ = _whitened(r, meas_var, nstds)
    return loss.to(acc_dtype).sum() + _prior_cost(part, cams, lmks)


def solve(e: Edges, cam0, lmk0, meas_var: float, nstds: float,
          pri: Priors | None = None, edge_dtype=torch.float64,
          max_iters: int = 30, pair_block: int = 1 << 20):
    """Levenberg-Marquardt on the MAP objective (the edges ``e`` and, if
    given, the priors of their variables) from the problem-indexed means
    (cam0 [C, 6], lmk0 [L, 3]). Returns the problem-indexed means with the
    edges' variables moved (NumPy, float64) and the objective the solver
    saw last. Sums and solves run in float64, or float32 when
    ``edge_dtype`` is lower."""
    dev = e.cam.device
    acc = torch.float64 if edge_dtype == torch.float64 else torch.float32
    cams = torch.as_tensor(np.asarray(cam0)[e.cams], dtype=acc, device=dev)
    lmks = torch.as_tensor(np.asarray(lmk0)[e.lmks], dtype=acc, device=dev)
    nc, nl = cams.shape[0], lmks.shape[0]
    e1, e2 = _pairs(e.lmk)
    part = _prior_part(e, pri)
    if part is not None:
        c_lam, c_mu, l_lam, l_mu = (x.to(acc) for x in part)
    eye6 = torch.eye(6, dtype=acc, device=dev)
    eye3 = torch.eye(3, dtype=acc, device=dev)
    lam = 1e-4
    cur = None
    for _ in range(max_iters):
        r, jc, jl, w, cur = _linearise(e, cams, lmks, edge_dtype, acc,
                                       meas_var, nstds)
        cur = cur + _prior_cost(part, cams, lmks)
        wjc = w[:, None, None] * jc
        wjl = w[:, None, None] * jl
        u = torch.zeros(nc, 6, 6, dtype=acc, device=dev).index_add_(
            0, e.cam, wjc.transpose(1, 2) @ jc)
        v = torch.zeros(nl, 3, 3, dtype=acc, device=dev).index_add_(
            0, e.lmk, wjl.transpose(1, 2) @ jl)
        wx = wjc.transpose(1, 2) @ jl                        # [E, 6, 3]
        bc = torch.zeros(nc, 6, dtype=acc, device=dev).index_add_(
            0, e.cam, (wjc.transpose(1, 2) @ r[..., None])[..., 0])
        bl = torch.zeros(nl, 3, dtype=acc, device=dev).index_add_(
            0, e.lmk, (wjl.transpose(1, 2) @ r[..., None])[..., 0])
        if part is not None:
            u = u + c_lam[:, None, None] * eye6
            v = v + l_lam[:, None, None] * eye3
            bc = bc - c_lam[:, None] * (cams - c_mu)
            bl = bl - l_lam[:, None] * (lmks - l_mu)
        accepted = False
        while not accepted and lam < 1e12:
            ud = u + lam * torch.diag_embed(torch.diagonal(u, 0, 1, 2)) \
                + 1e-9 * eye6
            vinv = torch.linalg.inv(
                v + lam * torch.diag_embed(torch.diagonal(v, 0, 1, 2))
                + 1e-9 * eye3)
            y = wx @ vinv[e.lmk]                             # [E, 6, 3]
            s = torch.zeros(nc * nc, 6, 6, dtype=acc, device=dev)
            for a in range(0, e1.shape[0], pair_block):
                p1, p2 = e1[a:a + pair_block], e2[a:a + pair_block]
                s.index_add_(0, e.cam[p1] * nc + e.cam[p2],
                             -(y[p1] @ wx[p2].transpose(1, 2)))
            s = s.view(nc, nc, 6, 6)
            idx = torch.arange(nc, device=dev)
            s[idx, idx] += ud
            rhs = bc - torch.zeros_like(bc).index_add_(
                0, e.cam, (y @ bl[e.lmk][..., None])[..., 0])
            chol, info = torch.linalg.cholesky_ex(
                s.permute(0, 2, 1, 3).reshape(6 * nc, 6 * nc))
            del s
            if int(info) != 0:
                lam *= 10.0
                continue
            dxc = torch.cholesky_solve(rhs.reshape(-1, 1), chol).view(nc, 6)
            back = torch.zeros_like(bl).index_add_(
                0, e.lmk, (wx.transpose(1, 2) @ dxc[e.cam][..., None])[..., 0])
            dxl = (vinv @ (bl - back)[..., None])[..., 0]
            cams_new, lmks_new = cams + dxc, lmks + dxl
            new = _cost_only(e, cams_new, lmks_new, edge_dtype, acc,
                             meas_var, nstds, part)
            if bool(torch.isfinite(new)) and bool(new < cur):
                accepted = True
                rel = float((cur - new) / cur)
                cams, lmks, cur = cams_new, lmks_new, new
                lam = max(lam / 3.0, 1e-9)
            else:
                lam *= 5.0
        if not accepted or rel < 1e-12:
            break
    cam_out = np.array(cam0, dtype=np.float64, copy=True)
    lmk_out = np.array(lmk0, dtype=np.float64, copy=True)
    cam_out[e.cams] = cams.double().cpu().numpy()
    lmk_out[e.lmks] = lmks.double().cpu().numpy()
    return cam_out, lmk_out, float(cur)
