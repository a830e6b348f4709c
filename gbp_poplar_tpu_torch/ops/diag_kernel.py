"""The per-sweep telemetry sums over edges (H6).

Replaces what the JAX package computes inside the body of each
``lax.scan`` of its solve: ``gbp_poplar_tpu/core/gbp.py::diagnostics``
with ``reprojection_error`` (one XLA fusion there, no Pallas kernel). Per
edge: the adjacent belief means, the projection, the residual norm and
the validity mask; over all edges, five sums, in this order (``SUMS``):

  - ``n_active``: edges that are active, whose adjacent means and residual
    norm are finite, and that are not marked bad;
  - ``sum_norm``: the sum of their residual norms;
  - ``cost``: 0.5 times the sum of their squared norms;
  - ``n_relins``: active edges that just relinearised (``damping_count ==
    -num_undamped_iters``);
  - ``n_robust``: active edges with the Huber weight on.

The result is a float64 [5] tensor (counts exact), written into ``out`` if
given: ``core.gbp.run_gbp`` passes row j of one [n, 5] buffer per solve.

Kernel (csrc/diag.cu, bodies in csrc/diag.cuh): reads the belief tables
that ops/table_kernel.build_tables (H2) builds after the sweep, whose mean
is ``variable_means``'s wherever finite and whose flag excludes an edge
with a non-finite mean (the plain version's unsanitised mean gives that
edge a non-finite norm instead); projects with the sweep's projection
(planes.cuh ``project``); sums in two passes in one fixed order (a block
per 2,048 edges with a fixed tree, then the blocks in order), all five in
float64, so the result is the same from run to run and the float sums are
within 1e-5 of the sum of |terms| of the plain version's float32 sums.
Bound on the H100: bytes (25 B an edge, the means and flags of the tables
once).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.factor_graph import CAM_DOF, LMK_DOF
from . import _cuda
from . import planes as pl
from . import table_kernel
from .table_kernel import CAM_WIDTH, LMK_WIDTH

SUMS = ("n_active", "sum_norm", "cost", "n_relins", "n_robust")


class DiagArgs(ctypes.Structure):
    """Mirror of ``DiagArgs`` in csrc/diag.cuh (passed by pointer, copied
    into the launch by value)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "cam_tbl", "lmk_tbl", "cam_idx", "lmk_idx", "meas", "intr", "active",
        "damping_count", "robust", "bad")] + [
        ("n_edges", ctypes.c_longlong)] + [
        (name, ctypes.c_float) for name in ("fx", "fy", "cx", "cy")] + [
        ("num_undamped_iters", ctypes.c_int)]


def edge_sums_reference(state, graph, num_undamped_iters: int,
                        bad: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version: the unsanitised means per variable, gathered
    per edge, projected; float32 sums (the counts' as integers), returned
    as float64 [5]."""
    cam_mu = table_kernel.variable_means(state.cam_bel, CAM_DOF)
    lmk_mu = table_kernel.variable_means(state.lmk_bel, LMK_DOF)
    mu_c = cam_mu.index_select(1, graph.cam_idx)
    mu_l = lmk_mu.index_select(1, graph.lmk_idx)
    (u, v), _, _ = pl.project(
        pl.unpack_vec(mu_c, 6), pl.unpack_vec(mu_l, 3), graph.k,
        None if graph.intr is None else pl.unpack_vec(graph.intr, 3))
    ru = graph.meas[0] - u
    rv = graph.meas[1] - v
    norm = torch.sqrt(ru * ru + rv * rv)
    act = state.active > 0
    valid = act & torch.isfinite(norm)
    if bad is not None:
        valid = valid & ~bad
    norm = torch.where(valid, norm, 0.0)
    n_active = torch.sum(valid.to(norm.dtype))
    sum_norm = torch.sum(norm)
    cost = 0.5 * torch.sum(norm * norm)
    n_relins = torch.sum((state.damping_count == -num_undamped_iters) & act)
    n_robust = torch.sum(state.robust & act)
    return torch.stack([x.to(torch.float64) for x in
                        (n_active, sum_norm, cost, n_relins, n_robust)])


def diag_args(state, graph, tables, num_undamped_iters: int,
              bad=None) -> DiagArgs:
    """The kernel's operands: pointers into the (checked) tensors."""
    cam_tbl, lmk_tbl = tables
    k = graph.k
    return DiagArgs(
        cam_tbl.data_ptr(), lmk_tbl.data_ptr(), graph.cam_idx.data_ptr(),
        graph.lmk_idx.data_ptr(), graph.meas.data_ptr(),
        _cuda.ptr(graph.intr), state.active.data_ptr(),
        state.damping_count.data_ptr(), state.robust.data_ptr(),
        _cuda.ptr(bad), graph.n_edges, float(k[0][0]), float(k[1][1]),
        float(k[0][2]), float(k[1][2]), num_undamped_iters)


def _check(what, t, shape, dtype, device) -> None:
    if (tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous()
            or t.device != device):
        raise ValueError(f"edge_sums: {what} must be contiguous {dtype} "
                         f"{shape} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def edge_sums(state, graph, num_undamped_iters: int,
              bad: torch.Tensor | None = None, tables=None,
              out: torch.Tensor | None = None,
              reference: bool = False) -> torch.Tensor:
    """The five sums (``SUMS``) over ``graph``'s edges of ``state``, a
    float64 [5] tensor, written into ``out`` (contiguous float64 [5] on the
    state's device) if given. ``bad``: [E] bool, edges excluded from the
    residual sums. ``tables``: the (cam_tbl, lmk_tbl) of
    ``table_kernel.build_tables`` on the state's current beliefs, built
    here if None. CPU tensors (or ``reference``) take the plain version;
    CUDA tensors launch csrc/diag.cu."""
    device = state.pk.device
    if reference or device.type == "cpu":
        sums = edge_sums_reference(state, graph, num_undamped_iters, bad)
        return sums if out is None else out.copy_(sums)
    if device.type != "cuda":
        raise ValueError(f"edge_sums: unsupported device {device}")
    if tables is None:
        tables = table_kernel.build_tables(state.cam_bel, state.lmk_bel)
    cam_tbl, lmk_tbl = tables
    e = graph.n_edges
    for what, t, shape, dtype in (
            ("cam_tbl", cam_tbl, (graph.n_keyframes, CAM_WIDTH),
             torch.float32),
            ("lmk_tbl", lmk_tbl, (graph.n_points, LMK_WIDTH), torch.float32),
            ("cam_idx", graph.cam_idx, (e,), torch.int32),
            ("lmk_idx", graph.lmk_idx, (e,), torch.int32),
            ("meas", graph.meas, (2, e), torch.float32),
            ("active", state.active, (e,), torch.int32),
            ("damping_count", state.damping_count, (e,), torch.int32),
            ("robust", state.robust, (e,), torch.bool)):
        _check(what, t, shape, dtype, device)
    if graph.intr is not None:
        _check("intr", graph.intr, (3, e), torch.float32, device)
    if bad is not None:
        _check("bad", bad, (e,), torch.bool, device)
    if out is None:
        out = torch.empty(len(SUMS), dtype=torch.float64, device=device)
    else:
        _check("out", out, (len(SUMS),), torch.float64, device)
    lib = _cuda.library()
    partial = torch.empty(len(SUMS) * max(lib.gbp_diag_blocks(e), 1),
                          dtype=torch.float64, device=device)
    args = diag_args(state, graph, tables, num_undamped_iters, bad)
    err = lib.gbp_diag_launch(ctypes.addressof(args), partial.data_ptr(),
                              out.data_ptr(), _cuda.stream_ptr(out))
    _cuda.check(err, "diag kernel")
    edge_sums.launches += 1
    return out


edge_sums.launches = 0
