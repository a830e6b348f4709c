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
given. ``core.gbp.run_gbp`` sets the kernel up once per solve
(``DiagLaunch``) and writes row j of one [n, 5] buffer after sweep j with
one ctypes call; ``edge_sums`` sets it up for one call.

Kernel (csrc/diag.cu, bodies in csrc/diag.cuh): reads the belief tables
that ops/table_kernel.build_tables (H2) builds after the sweep, whose mean
is ``variable_means``'s wherever finite and whose flag excludes an edge
with a non-finite mean (the plain version's unsanitised mean gives that
edge a non-finite norm instead); projects with the sweep's projection
(planes.cuh ``project``); sums in one launch in one fixed order (4 edges a
thread, warp shuffles and the warps in order per block of 1,024 edges,
then the block that finishes last adds the partials in block order), all
five in float64, so the result is the same from run to run and the float
sums are within 1e-5 of the sum of |terms| of the plain version's float32
sums. Bound on the H100: bytes (25 B an edge, the means and flags of the
tables once).
"""

from __future__ import annotations

import ctypes
import functools

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
    """The kernel's operands: pointers into the (checked) tensors; the
    table pointers null when ``tables`` is None (``DiagLaunch`` sets them
    per call)."""
    cam_tbl, lmk_tbl = (None, None) if tables is None else tables
    k = graph.k
    return DiagArgs(
        _cuda.ptr(cam_tbl), _cuda.ptr(lmk_tbl), graph.cam_idx.data_ptr(),
        graph.lmk_idx.data_ptr(), graph.meas.data_ptr(),
        _cuda.ptr(graph.intr), state.active.data_ptr(),
        state.damping_count.data_ptr(), state.robust.data_ptr(),
        _cuda.ptr(bad), graph.n_edges, float(k[0][0]), float(k[1][1]),
        float(k[0][2]), float(k[1][2]), num_undamped_iters)


_check = functools.partial(_cuda.check_tensor, "edge_sums")


class DiagLaunch:
    """H6 set up once for a solve: the checks of the state's and graph's
    edge fields and of ``out``, the kernel's operands (``DiagArgs``), the
    partials and ticket (``scratch``, allocated here if None or too small)
    and the address of ``out`` (float64 [n, 5] or [5], contiguous on the
    card) are built here, and a call ``launch(state, tables, j)`` sets the
    two table pointers, points the kernel at row j of ``out`` and makes one
    ctypes call. ``tables`` are H2's (ops/table_kernel.build_tables) on
    this graph's variables; they are not checked per call. Each call
    compares the pointers it holds into the state (``active``,
    ``damping_count``, ``robust``), the graph and ``bad`` with the live
    tensors' and sets up again on a mismatch, so a replaced tensor is never
    read through an old pointer. The launch goes on ``stream`` (a raw
    cudaStream_t), by default the stream that was current here."""

    def __init__(self, state, graph, num_undamped_iters: int,
                 out: torch.Tensor, bad: torch.Tensor | None = None,
                 scratch: _cuda.Scratch | None = None,
                 stream: int | None = None):
        device = state.pk.device
        if device.type != "cuda":
            raise ValueError(f"edge_sums: unsupported device {device}")
        if (out.dtype != torch.float64 or out.dim() not in (1, 2)
                or out.shape[-1] != len(SUMS) or not out.is_contiguous()
                or out.device != device):
            raise ValueError(f"edge_sums: out must be contiguous float64 "
                             f"[n, {len(SUMS)}] or [{len(SUMS)}] on {device}"
                             f", got {out.dtype} {tuple(out.shape)} on "
                             f"{out.device}")
        self.graph, self.bad, self.device = graph, bad, device
        self.num_undamped_iters = num_undamped_iters
        self.scratch = scratch
        self._out = out.data_ptr()
        self._rows = 1 if out.dim() == 1 else out.shape[0]
        self._row_bytes = out.element_size() * len(SUMS)
        self._stream = _cuda.stream_ptr(out) if stream is None else stream
        lib = _cuda.library()
        self._blocks, self._launch = lib.gbp_diag_blocks, lib.gbp_diag_launch
        self._prepare(state)

    def _pointers(self, state) -> tuple:
        g, bad = self.graph, self.bad
        return (state.active.data_ptr(), state.damping_count.data_ptr(),
                state.robust.data_ptr(), g.cam_idx.data_ptr(),
                g.lmk_idx.data_ptr(), g.meas.data_ptr(),
                None if g.intr is None else g.intr.data_ptr(),
                None if bad is None else bad.data_ptr())

    def _prepare(self, state) -> None:
        g, device, e = self.graph, self.device, self.graph.n_edges
        for what, t, shape, dtype in (
                ("cam_idx", g.cam_idx, (e,), torch.int32),
                ("lmk_idx", g.lmk_idx, (e,), torch.int32),
                ("meas", g.meas, (2, e), torch.float32),
                ("active", state.active, (e,), torch.int32),
                ("damping_count", state.damping_count, (e,), torch.int32),
                ("robust", state.robust, (e,), torch.bool)):
            _check(what, t, shape, dtype, device)
        if g.intr is not None:
            _check("intr", g.intr, (3, e), torch.float32, device)
        if self.bad is not None:
            _check("bad", self.bad, (e,), torch.bool, device)
        blocks = self._blocks(e)
        if self.scratch is None or not self.scratch.fits(len(SUMS), blocks):
            self.scratch = _cuda.Scratch(device, len(SUMS), blocks)
        self.args = diag_args(state, g, None, self.num_undamped_iters,
                              self.bad)
        self._call = (ctypes.addressof(self.args),
                      self.scratch.partial.data_ptr(),
                      self.scratch.ticket.data_ptr())
        self._live = self._pointers(state)

    def __call__(self, state, tables, j: int = 0) -> None:
        """The five sums of ``state`` on ``tables`` into row ``j``."""
        if self._pointers(state) != self._live:
            self._prepare(state)
        self._run(tables, j)

    def _run(self, tables, j: int) -> None:
        if not 0 <= j < self._rows:
            raise IndexError(f"edge_sums: row {j} of {self._rows}")
        args = self.args
        args.cam_tbl = tables[0].data_ptr()
        args.lmk_tbl = tables[1].data_ptr()
        err = self._launch(*self._call, self._out + self._row_bytes * j,
                           self._stream)
        if err:
            _cuda.check(err, "diag kernel")
        edge_sums.launches += 1


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
    CUDA tensors launch csrc/diag.cu once (a ``DiagLaunch`` set up for
    this call, on the scratch its stream shares)."""
    device = state.pk.device
    if reference or device.type == "cpu":
        sums = edge_sums_reference(state, graph, num_undamped_iters, bad)
        return sums if out is None else out.copy_(sums)
    if device.type != "cuda":
        raise ValueError(f"edge_sums: unsupported device {device}")
    if tables is None:
        tables = table_kernel.build_tables(state.cam_bel, state.lmk_bel)
    _check("cam_tbl", tables[0], (graph.n_keyframes, CAM_WIDTH),
           torch.float32, device)
    _check("lmk_tbl", tables[1], (graph.n_points, LMK_WIDTH), torch.float32,
           device)
    if out is None:
        out = torch.empty(len(SUMS), dtype=torch.float64, device=device)
    else:
        _check("out", out, (len(SUMS),), torch.float64, device)
    stream = _cuda.stream_ptr(out)
    scratch = _cuda.shared_scratch(device, stream, len(SUMS),
                                   _cuda.library().gbp_diag_blocks(
                                       graph.n_edges))
    DiagLaunch(state, graph, num_undamped_iters, out, bad, scratch,
               stream)._run(tables, 0)
    return out


edge_sums.launches = 0
