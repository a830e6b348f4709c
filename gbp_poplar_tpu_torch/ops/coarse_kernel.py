"""The coarse step's per-edge system blocks (H7).

Replaces the per-edge part of ``gbp_poplar_tpu/core/coarse.py::
coarse_increment`` (an XLA fusion inside the jitted chunk there, no
Pallas kernel): for every real edge, at the sanitised belief means, the
projection's Jacobians reduced onto the two groups' rigid motions, b_c =
J_c S_cam[c] and b_l = J_l [I | -hat(y)], and the Huber-IRLS-weighted
products that ``core.coarse.coarse_increment`` sums per group into its
6G x 6G system. Returned as plane-major float32 [90, n_real], rows
(``ROWS``):

  - ``aa`` w b_c^T b_c, 21 symmetric slots (ops/planes.SYM6_IDX order),
    then ``rc`` w b_c^T r (6): summed by the camera's group;
  - ``bb`` w b_l^T b_l, 21 slots, then ``rl`` w b_l^T r (6): by the
    landmark's group;
  - ``ab`` w b_c^T b_l, 36 row-major: by the (camera, landmark) group pair.

Each group of rows is one contiguous row-slice, which H3 (ops/
reduce_kernel.segment_sum) sums over the group segments as it is.

Kernel (csrc/coarse.cu, body csrc/coarse.cuh): one thread per edge, the
terms written as planes. Bound on the H100: bytes, the 360 B of terms an
edge written once (the inputs are 24 B an edge and the variables' means
and bases). The plain version (``coarse_edge_blocks_reference``) is the
increment's per-edge code as it was: gathers, batched 2x6 products over
[E, 6, 6] and the transposes to planes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _cuda, lie, projection
from .planes import SYM6_IDX

TERMS = 90
# the rows of each group sum (csrc/coarse.cuh COARSE_*)
ROWS = {"cam": slice(0, 27), "lmk": slice(27, 54), "pair": slice(54, 90)}


class CoarseArgs(ctypes.Structure):
    """Mirror of ``CoarseArgs`` in csrc/coarse.cuh (passed by pointer,
    copied into the launch by value)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "cam_mu", "lmk_mu", "s_cam", "cam_idx", "lmk_idx", "meas", "meas_var",
        "intr", "active", "out")] + [
        (name, ctypes.c_longlong) for name in (
            "n_cams", "n_lmks", "n_edges", "n_real")] + [
        (name, ctypes.c_float) for name in (
            "fx", "fy", "cx", "cy", "nstds", "huber_c", "min_depth")]


def lmk_rigid_basis(lmk_mu: torch.Tensor) -> torch.Tensor:
    """[L, 3, 6]: dy/dxi for y -> y + xi_t + xi_w x y, i.e. [I3 | -hat(y)]."""
    eye = torch.eye(3, dtype=lmk_mu.dtype,
                    device=lmk_mu.device).expand(lmk_mu.shape[0], 3, 3)
    return torch.cat([eye, -lie.so3_hat(lmk_mu)], dim=-1)


def _fin(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, 0.0)


def _sym_planes(m: torch.Tensor) -> torch.Tensor:
    """[n, 6, 6] -> its lower-triangle slots as planes [21, n]."""
    i, j = zip(*SYM6_IDX)
    return m[:, list(i), list(j)].T


def coarse_edge_blocks_reference(cam_mu, lmk_mu, s_cam, state, graph, cfg,
                                 n_real: int) -> torch.Tensor:
    """Plain PyTorch version: the per-edge terms of the first ``n_real``
    edges as the increment computed them (per-edge gathers, batched
    products), laid out as the kernel's planes [90, n_real]."""
    camr = _fin(cam_mu.T)                             # [C, 6] row-major
    lmkr = _fin(lmk_mu.T)                             # [L, 3]
    ci, li = graph.cam_idx[:n_real], graph.lmk_idx[:n_real]
    cam_e = camr.index_select(0, ci)                  # [E, 6]
    lmk_e = lmkr.index_select(0, li)                  # [E, 3]
    intr_e = None if graph.intr is None else graph.intr[:, :n_real].T
    j_c, j_l = projection.reproj_jacobians(cam_e, lmk_e, graph.k, intr_e)
    r = graph.meas[:, :n_real].T - projection.project(cam_e, lmk_e, graph.k,
                                                      intr_e)
    err = torch.sqrt(torch.sum(r * r, dim=-1))
    var, _ = projection.huber_meas_var(err, graph.meas_var[:n_real],
                                       cfg.huber_nstds)
    # an edge whose landmark grazes the camera plane (Jacobian ~ f/z
    # explodes) is dropped on its own, so it cannot poison the assembled
    # solve and have its guard zero the whole correction
    z_cf = lie.w2c_apply(cam_e, lmk_e)[..., 2]
    act = ((state.active[:n_real] > 0) & torch.isfinite(r).all(dim=-1)
           & (torch.abs(z_cf) > cfg.min_depth)
           & torch.isfinite(j_c).all(dim=-1).all(dim=-1)
           & torch.isfinite(j_l).all(dim=-1).all(dim=-1))
    w = torch.where(act, 1.0 / var, 0.0)[:, None, None]           # [E,1,1]
    r = torch.where(act[:, None], r, 0.0)
    m = act[:, None, None]
    s_lmk = lmk_rigid_basis(lmk_e)                                # [E,3,6]
    b_c = torch.where(m, j_c @ s_cam.index_select(0, ci), 0.0)    # [E,2,6]
    b_l = torch.where(m, j_l @ s_lmk, 0.0)                        # [E,2,6]
    b_ct, b_lt = b_c.transpose(-1, -2), b_l.transpose(-1, -2)

    # a finite but huge Jacobian can still overflow a product, so each
    # edge's terms are sanitised on their own
    aa = _fin(b_ct @ b_c * w)
    bb = _fin(b_lt @ b_l * w)
    ab = _fin(b_ct @ b_l * w)
    rc = _fin((b_ct @ r[..., None])[..., 0] * w[..., 0])
    rl = _fin((b_lt @ r[..., None])[..., 0] * w[..., 0])
    return torch.cat([_sym_planes(aa), rc.T, _sym_planes(bb), rl.T,
                      ab.reshape(-1, 36).T]).contiguous()


def coarse_args(cam_mu, lmk_mu, s_cam, state, graph, cfg, intr,
                out: torch.Tensor) -> CoarseArgs:
    """The kernel's operands: pointers into the (checked, contiguous)
    tensors, ``intr`` standing for ``graph.intr``; the terms of the first
    ``out.shape[1]`` edges into ``out``."""
    k = graph.k
    nstds = cfg.huber_nstds
    return CoarseArgs(
        cam_mu.data_ptr(), lmk_mu.data_ptr(), s_cam.data_ptr(),
        graph.cam_idx.data_ptr(), graph.lmk_idx.data_ptr(),
        graph.meas.data_ptr(), graph.meas_var.data_ptr(),
        _cuda.ptr(intr), state.active.data_ptr(), out.data_ptr(),
        graph.n_keyframes, graph.n_points, graph.n_edges, out.shape[1],
        float(k[0][0]), float(k[1][1]), float(k[0][2]), float(k[1][2]),
        nstds, 0.5 * nstds * nstds, cfg.min_depth)


def coarse_edge_blocks(cam_mu: torch.Tensor, lmk_mu: torch.Tensor,
                       s_cam: torch.Tensor, state, graph, cfg,
                       reference: bool = False) -> torch.Tensor:
    """The per-edge terms [90, n_real] of the graph's real edges (those its
    segments list) at the belief means ``cam_mu`` [6, C] and ``lmk_mu``
    [3, L] (unsanitised), with the cameras' rigid basis ``s_cam`` [C, 6, 6]
    (sanitised). CPU tensors (or ``reference``) take the plain version;
    CUDA tensors launch csrc/coarse.cu once."""
    n_real = graph.cam_seg.var.shape[0]
    device = cam_mu.device
    if reference or device.type == "cpu":
        return coarse_edge_blocks_reference(cam_mu, lmk_mu, s_cam, state,
                                            graph, cfg, n_real)
    if device.type != "cuda":
        raise ValueError(f"coarse_edge_blocks: unsupported device {device}")
    c, l, e = graph.n_keyframes, graph.n_points, graph.n_edges
    for what, t, shape, dtype in (
            ("cam_idx", graph.cam_idx, (e,), torch.int32),
            ("lmk_idx", graph.lmk_idx, (e,), torch.int32),
            ("meas", graph.meas, (2, e), torch.float32),
            ("meas_var", graph.meas_var, (e,), torch.float32),
            ("active", state.active, (e,), torch.int32)):
        _cuda.check_tensor("coarse_edge_blocks", what, t, shape, dtype,
                           device)
    # the operands callers derive (means, the basis, a refit's intrinsics)
    # may be strided views: contiguous copies of those
    op = functools.partial(_cuda.operand, "coarse_edge_blocks")
    cam_mu = op("cam_mu", cam_mu, (6, c), torch.float32, device)
    lmk_mu = op("lmk_mu", lmk_mu, (3, l), torch.float32, device)
    s_cam = op("s_cam", s_cam, (c, 6, 6), torch.float32, device)
    intr = (None if graph.intr is None else
            op("intr", graph.intr, (3, e), torch.float32, device))
    out = torch.empty((TERMS, n_real), dtype=torch.float32, device=device)
    if n_real == 0:
        return out
    args = coarse_args(cam_mu, lmk_mu, s_cam, state, graph, cfg, intr, out)
    err = _cuda.library().gbp_coarse_launch(ctypes.addressof(args),
                                            _cuda.stream_ptr(out))
    _cuda.check(err, "coarse kernel")
    coarse_edge_blocks.launches += 1
    return out


coarse_edge_blocks.launches = 0
