"""The robust data term of the MAP cost at K sets of means (H8).

Replaces the data term of ``gbp_poplar_tpu/core/gbp.py::_cost_parts``
(with ``map_cost``; an XLA fusion inside the jitted chunk there, no
Pallas kernel): at each set's belief means, per edge the projection, the
residual whitened by the measurement variance and its Huber loss, summed
over the active edges not marked ``bad`` whose loss is finite. The
accelerator step prices K = 2 sets (the current means and its candidate),
the coarse step 2 or 3 (the current means unless its caller priced them,
and its two scales), ``map_cost`` one.

Kernel (csrc/cost.cu, bodies csrc/cost.cuh): one launch for all K sets,
each set's camera and landmark means read per edge from its own planes
(no stacked [9K, E] gather); H6's partition and fixed-order reduction
(4 edges a thread, blocks of 256, warp shuffles, the warps in order, the
last block by ticket adding the partials in block order), in float64, so
the K sums are the same from run to run, equal sets give equal sums, and
each is within 1e-6 of the sum of |loss| of the plain version's float32
sum. Bound on the H100: bytes (24 B an edge, the sets' means once).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _cuda
from . import planes as pl

MAX_SETS = 3


class CostArgs(ctypes.Structure):
    """Mirror of ``CostArgs`` in csrc/cost.cuh (passed by pointer, copied
    into the launch by value)."""

    _fields_ = [("cam", ctypes.c_void_p * MAX_SETS),
                ("lmk", ctypes.c_void_p * MAX_SETS)] + [
        (name, ctypes.c_void_p) for name in (
            "cam_idx", "lmk_idx", "meas", "meas_var", "intr", "active",
            "bad")] + [
        (name, ctypes.c_longlong) for name in (
            "n_edges", "n_cams", "n_lmks")] + [
        (name, ctypes.c_float) for name in (
            "fx", "fy", "cx", "cy", "nstds", "huber_c")] + [
        ("n_sets", ctypes.c_int)]


def robust_term(state, graph, mu_c, mu_l, nstds: float,
                bad: torch.Tensor | None = None) -> torch.Tensor:
    """The summed Huber loss at the per-edge means ``mu_c`` [6, E] and
    ``mu_l`` [3, E] (the plain version's body for one set)."""
    (u, v), _, _ = pl.project(
        pl.unpack_vec(mu_c, 6), pl.unpack_vec(mu_l, 3), graph.k,
        None if graph.intr is None else pl.unpack_vec(graph.intr, 3))
    ru = graph.meas[0] - u
    rv = graph.meas[1] - v
    err2 = (ru * ru + rv * rv) / graph.meas_var
    err = torch.sqrt(err2)
    k = nstds
    loss = torch.where(err > k, k * err - 0.5 * k * k, 0.5 * err2)
    ok = (state.active > 0) & torch.isfinite(loss)
    if bad is not None:
        ok = ok & ~bad
    return torch.sum(torch.where(ok, loss, 0.0))


def cost_sums_reference(state, graph, means, nstds: float,
                        bad: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version: each set's means gathered per edge
    (``index_select``) and its float32 sum (``robust_term``); [K]."""
    return torch.stack([
        robust_term(state, graph, cam.index_select(1, graph.cam_idx),
                    lmk.index_select(1, graph.lmk_idx), nstds, bad)
        for cam, lmk in means])


def cost_args(state, graph, means, nstds: float, bad, intr) -> CostArgs:
    """The kernel's operands: pointers into the (checked, contiguous)
    tensors; ``intr`` stands for ``graph.intr``."""
    pad = [None] * (MAX_SETS - len(means))
    sets = ctypes.c_void_p * MAX_SETS
    k = graph.k
    return CostArgs(
        sets(*[cam.data_ptr() for cam, _ in means], *pad),
        sets(*[lmk.data_ptr() for _, lmk in means], *pad),
        graph.cam_idx.data_ptr(), graph.lmk_idx.data_ptr(),
        graph.meas.data_ptr(), graph.meas_var.data_ptr(),
        _cuda.ptr(intr), state.active.data_ptr(), _cuda.ptr(bad),
        graph.n_edges, graph.n_keyframes, graph.n_points, float(k[0][0]),
        float(k[1][1]), float(k[0][2]), float(k[1][2]), nstds,
        0.5 * nstds * nstds, len(means))


def cost_sums(state, graph, means, nstds: float,
              bad: torch.Tensor | None = None,
              reference: bool = False) -> torch.Tensor:
    """The summed Huber loss of ``graph``'s edges at each of the K <= 3
    sets of ``means`` (pairs of belief-mean planes cam [6, C], lmk [3,
    L]), float32 [K]. ``bad``: [E] bool, edges left out. CPU tensors (or
    ``reference``) take the plain version; CUDA tensors launch
    csrc/cost.cu once."""
    device = state.active.device
    if reference or device.type == "cpu":
        return cost_sums_reference(state, graph, means, nstds, bad)
    if device.type != "cuda":
        raise ValueError(f"cost_sums: unsupported device {device}")
    if not 1 <= len(means) <= MAX_SETS:
        raise ValueError(f"cost_sums: 1 to {MAX_SETS} sets of means, got "
                         f"{len(means)}")
    c, l, e = graph.n_keyframes, graph.n_points, graph.n_edges
    for what, t, shape, dtype in (
            ("cam_idx", graph.cam_idx, (e,), torch.int32),
            ("lmk_idx", graph.lmk_idx, (e,), torch.int32),
            ("meas", graph.meas, (2, e), torch.float32),
            ("meas_var", graph.meas_var, (e,), torch.float32),
            ("active", state.active, (e,), torch.int32)):
        _cuda.check_tensor("cost_sums", what, t, shape, dtype, device)
    # the operands callers derive (means, a refit's intrinsics, a mask)
    # may be strided views: contiguous copies of those
    op = functools.partial(_cuda.operand, "cost_sums")
    means = [(op(f"means[{i}] cameras", cam, (6, c), torch.float32, device),
              op(f"means[{i}] landmarks", lmk, (3, l), torch.float32, device))
             for i, (cam, lmk) in enumerate(means)]
    intr = (None if graph.intr is None else
            op("intr", graph.intr, (3, e), torch.float32, device))
    if bad is not None:
        bad = op("bad", bad, (e,), torch.bool, device)
    out = torch.empty(len(means), dtype=torch.float32, device=device)
    lib = _cuda.library()
    stream = _cuda.stream_ptr(out)
    scratch = _cuda.shared_scratch(device, stream, MAX_SETS,
                                   lib.gbp_diag_blocks(e))
    args = cost_args(state, graph, means, nstds, bad, intr)
    err = lib.gbp_cost_launch(ctypes.addressof(args),
                              scratch.partial.data_ptr(),
                              scratch.ticket.data_ptr(), out.data_ptr(),
                              stream)
    _cuda.check(err, "cost kernel")
    cost_sums.launches += 1
    return out


cost_sums.launches = 0
