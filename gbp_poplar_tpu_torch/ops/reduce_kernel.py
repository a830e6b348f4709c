"""Per-variable sums of edge message planes (the belief reduction, H3), and
the gather of per-variable planes to the edges (H5, at the end).

Replaces ``gbp_poplar_tpu/ops/reduce_kernel.py::_reduce_kernel`` with
``blocked_reduce`` and ``combine_partials`` (the one-hot MXU contraction
over landmark-sorted edge blocks), and the fused sweep kernel's reduction
epilogue with ``combine_grid_any``: message planes [comp, E] summed per
variable into [comp, V], optionally on top of a prior (belief = prior +
sum of incoming messages).

Kernel (csrc/reduce.cu): a deterministic CSR segmented sum. Each variable's
edges are a contiguous run of the landmark-sorted edge order (landmarks)
or of a stable camera-sorted permutation (cameras), so every output is one
sequential sum in ascending edge order and the result is the same from run
to run. Bound on the H100: bytes: each sweep reads the 36 message rows
once (about 144 B per edge) and writes 36 rows per variable. Design: one
thread per (component, variable) pair for short segments (landmarks:
about 7 edges), consecutive threads on consecutive variables; for long
segments (cameras: hundreds of edges) one warp per pair, lanes striding
the segment and a fixed shuffle tree combining the lane sums, so the
order stays fixed.
"""

from __future__ import annotations

import torch

from . import _cuda

# Mean edges per variable at or above which a warp shares one segment.
WARP_SEGMENT_MIN = 64


def segment_sum_reference(planes: torch.Tensor, seg,
                          prior: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` of the listed edges' columns
    (sequential in listed order on the CPU)."""
    cols = (planes[:, :seg.var.shape[0]] if seg.perm is None
            else planes.index_select(1, seg.perm))
    out = torch.zeros((planes.shape[0], seg.n_var), dtype=planes.dtype,
                      device=planes.device)
    out.index_add_(1, seg.var, cols)
    return out if prior is None else prior + out


def segment_sum(planes: torch.Tensor, seg, prior: torch.Tensor | None = None,
                reference: bool = False) -> torch.Tensor:
    """Sum ``planes`` [comp, E] (rows may be a row-slice of a larger
    [*, E] tensor) per variable of ``seg`` -> [comp, V], plus ``prior``
    [comp, V] if given. CPU tensors (or ``reference``) take the plain
    version; CUDA tensors launch csrc/reduce.cu."""
    if reference or planes.device.type == "cpu":
        return segment_sum_reference(planes, seg, prior)
    comp, e = planes.shape
    n_var = seg.n_var
    if planes.device.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {planes.device}")
    if planes.dtype != torch.float32 or planes.stride(1) != 1:
        raise ValueError("segment_sum: planes must be float32 with "
                         "contiguous rows")
    if seg.ptr.device != planes.device or seg.ptr.dtype != torch.int32:
        raise ValueError("segment_sum: segments must be int32 on the same "
                         "device")
    if prior is not None and (prior.shape != (comp, n_var)
                              or not prior.is_contiguous()
                              or prior.dtype != torch.float32):
        raise ValueError("segment_sum: prior must be contiguous float32 "
                         f"[{comp}, {n_var}]")
    n_listed = seg.var.shape[0]
    group = 32 if n_listed >= WARP_SEGMENT_MIN * max(n_var, 1) else 1
    out = torch.empty((comp, n_var), dtype=torch.float32,
                      device=planes.device)
    lib = _cuda.library()
    err = lib.gbp_reduce_launch(
        planes.data_ptr(), planes.stride(0), comp, seg.ptr.data_ptr(),
        _cuda.ptr(seg.perm), n_var, _cuda.ptr(prior), out.data_ptr(), group,
        _cuda.stream_ptr(planes))
    _cuda.check(err, "reduce kernel")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0


# ---------------------------------------------------------------------------
# the belief gather (H5), the inverse direction of the reduction
# ---------------------------------------------------------------------------
#
# Replaces ``gbp_poplar_tpu/ops/reduce_kernel.py::_gather_kernel`` with
# ``blocked_gather`` (one-hot MXU contraction against a DMA'd variable
# window per edge block): per-variable planes [comp, V] copied to the
# edges, [comp, E], for the unfused sweep (core/gbp.gbp_sweep with
# ``cfg.fused=False``). Kernel (csrc/gather.cu): one thread per edge,
# looping over the components. Bound on the H100: bytes (read 4 B and
# write 4 B per component and edge, plus the index). Design: writes are
# coalesced across a warp; landmark-side reads are nearly sequential since
# the edges are landmark-sorted; the camera source is a few hundred KB and
# stays in L1/L2. Every lane gets its variable's column, padding edges
# included (blocked_gather gave 0 outside a block's window).

def gather_reference(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``index_select`` along the variable axis."""
    return src.index_select(1, idx)


def gather(src: torch.Tensor, idx: torch.Tensor,
           reference: bool = False) -> torch.Tensor:
    """Columns of ``src`` [comp, V] per edge: ``out[:, e] = src[:, idx[e]]``,
    [comp, E]. CPU tensors (or ``reference``) take the plain version; CUDA
    tensors launch csrc/gather.cu."""
    if reference or src.device.type == "cpu":
        return gather_reference(src, idx)
    if src.device.type != "cuda":
        raise ValueError(f"gather: unsupported device {src.device}")
    if (src.dtype != torch.float32 or src.dim() != 2
            or not src.is_contiguous()):
        raise ValueError("gather: src must be a contiguous float32 "
                         f"[comp, V], got {src.dtype} {tuple(src.shape)}")
    if (idx.dtype != torch.int32 or idx.dim() != 1
            or not idx.is_contiguous() or idx.device != src.device):
        raise ValueError("gather: idx must be a contiguous int32 [E] on "
                         "the same device")
    comp, n_var = src.shape
    n_edges = idx.shape[0]
    out = torch.empty((comp, n_edges), dtype=torch.float32,
                      device=src.device)
    lib = _cuda.library()
    err = lib.gbp_gather_launch(src.data_ptr(), n_var, comp, idx.data_ptr(),
                                out.data_ptr(), n_edges, _cuda.stream_ptr(src))
    _cuda.check(err, "gather kernel")
    gather.launches += 1
    return out


gather.launches = 0
