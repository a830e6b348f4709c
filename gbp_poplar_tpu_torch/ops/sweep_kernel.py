"""The per-edge GBP sweep: relinearisation state machine plus all four
factor-to-variable messages, written over the packed edge state in place.
Two kernels: the fused sweep (H1, below) and the unfused sweep on gathered
belief planes (H4, ``sweep_planes`` at the end).

Replaces ``gbp_poplar_tpu/ops/sweep_kernel.py::_fused_kernel`` as reached
from both ``sweep_fused_pallas`` (annealed iterations) and
``sweep_fused_packed`` (the hot loop): per edge, gather the camera and
landmark belief rows with their pre-solved means and validity flags (the
tables of ops/table_kernel.py), run ``core.gbp.edge_math`` with those
means, and write the 12 packed f32 fields, the damping counter and the
robust flag back. The per-variable message sums that the TPU kernel
accumulated in its epilogue are left to ops/reduce_kernel.py.

Kernels (csrc/sweep.cu, with the edge math in csrc/edge_math.cuh, the
small-matrix algebra in csrc/planes.cuh and the bulk copies in
csrc/bulk.cuh). Bound on the H100: bytes. Each edge reads and writes its
109 packed rows (872 B), the counter and flag, and reads 5 more words and
either two ids and two table rows (H1: 906 B per edge plus the tables
once) or its 36 gathered belief values (H4: 1,042 B per edge), against
about 1,900 float operations (H4: about 2,200, the means solved per edge).
Design, shared by both: persistent blocks, one per SM, of 7 warps; each
warp walks over tiles of 32 edges and keeps its next tile in flight in a
ring of two shared-memory stages, filled by 1-D bulk copies (one per row)
whose bytes an mbarrier counts. The edge math reads its column from the
stage, writes the new values straight to the global state (coalesced per
row), and parks the new factor values in the stage rather than in
registers. Tiles that are partial or not 16-byte aligned (an edge count
that is not a multiple of 4) are copied lane by lane in the kernel. The
plane layout [row, E] keeps every access coalesced; H1's belief rows come
by indexed 16-byte loads from the small tables (consecutive edges share a
landmark and a handful of cameras, so they hit in L1/L2); H4's gathered
values by 36 coalesced loads per lane, issued before the lane waits for
its stage. No windows, one-hot gathers or brick layout: those answered
TPU limits the H100 does not have. The arithmetic is edge_math's in both
kernels, so H1 and H4 agree to the bit; registers and spills are recorded
by the build (ops/_cuda.py).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.factor_graph import CAM_COMP, EDGE_PACK_ROWS, LMK_COMP
from . import _cuda
from .table_kernel import CAM_WIDTH, LMK_WIDTH


class SweepParams(ctypes.Structure):
    """Mirror of ``SweepParams`` in csrc/edge_math.cuh (passed by pointer,
    copied into the launch by value)."""

    _fields_ = [(name, ctypes.c_float) for name in (
        "fx", "fy", "cx", "cy", "eta_damping", "dmu_thr2", "drift_thr2",
        "min_depth", "nstds", "huber_c", "jit6", "jit3")] + [
        (name, ctypes.c_int) for name in (
            "num_undamped_iters", "relin_count_threshold",
            "behind_camera_rescue_iters", "flags")]


# SweepParams.flags bits (csrc/edge_math.cuh)
F_LAMBDA_DAMPING = 1 << 0
F_RESET_DAMPING = 1 << 1
F_RELIN_EVERY_ITER = 1 << 2
F_RELIN_BEHIND_CAMERA = 1 << 3
F_DRIFT = 1 << 4
F_MIN_DEPTH = 1 << 5
F_HAS_INTR = 1 << 6
F_JITTER = 1 << 7


def sweep_params(cfg, k, has_intr: bool) -> SweepParams:
    """The kernel's POD config block: one build serves every config."""
    flags = ((F_LAMBDA_DAMPING if cfg.lambda_damping else 0)
             | (F_RESET_DAMPING if (cfg.reset_damping_on_relin
                                    and not cfg.relin_every_iter) else 0)
             | (F_RELIN_EVERY_ITER if cfg.relin_every_iter else 0)
             | (F_RELIN_BEHIND_CAMERA if cfg.relin_behind_camera else 0)
             | (F_DRIFT if cfg.relin_drift_threshold > 0.0 else 0)
             | (F_MIN_DEPTH if cfg.min_depth > 0.0 else 0)
             | (F_HAS_INTR if has_intr else 0)
             | (F_JITTER if cfg.cavity_jitter > 0.0 else 0))
    nstds = cfg.huber_nstds
    return SweepParams(
        fx=float(k[0][0]), fy=float(k[1][1]), cx=float(k[0][2]),
        cy=float(k[1][2]),
        eta_damping=cfg.eta_damping,
        dmu_thr2=cfg.dmu_threshold * cfg.dmu_threshold,
        drift_thr2=cfg.relin_drift_threshold * cfg.relin_drift_threshold,
        min_depth=cfg.min_depth,
        nstds=nstds, huber_c=0.5 * nstds * nstds,
        jit6=cfg.cavity_jitter / 6, jit3=cfg.cavity_jitter / 3,
        num_undamped_iters=cfg.num_undamped_iters,
        relin_count_threshold=cfg.relin_count_threshold,
        behind_camera_rescue_iters=cfg.behind_camera_rescue_iters,
        flags=flags)


def _edge_math_inplace(state, graph, bc, bl, cfg, premu) -> None:
    """Run ``core.gbp.edge_math`` on planes and write its outputs back into
    the state (the plain versions of both kernels)."""
    from ..core.gbp import edge_math

    outs = edge_math(
        bc, bl, graph.meas, graph.meas_var,
        state.f_eta_c, state.f_eta_l, state.f_lam_cc, state.f_lam_cl,
        state.f_lam_ll, state.msg_c_eta, state.msg_c_lam, state.msg_l_eta,
        state.msg_l_lam, state.damping, state.damping_count, state.mu,
        state.lin_mu, state.robust, state.active, graph.k, cfg,
        intr=graph.intr, premu=premu)
    (f_eta_c, f_eta_l, f_lam_cc, f_lam_cl, f_lam_ll, msg_c_eta, msg_c_lam,
     msg_l_eta, msg_l_lam, damping, damping_count, new_mu, lin_mu,
     robust) = outs
    new_pk = torch.cat([f_eta_c, f_eta_l, f_lam_cc, f_lam_cl, f_lam_ll,
                        msg_c_eta, msg_c_lam, msg_l_eta, msg_l_lam,
                        damping[None], new_mu, lin_mu])
    state.pk.copy_(new_pk)
    state.damping_count.copy_(damping_count)
    state.robust.copy_(robust)


def sweep_reference(state, graph, cam_tbl: torch.Tensor,
                    lmk_tbl: torch.Tensor, cfg) -> None:
    """Plain PyTorch version: gather the table rows, run
    ``core.gbp.edge_math`` on planes, write the results in place."""
    bc = cam_tbl.index_select(0, graph.cam_idx).T          # [36, E]
    bl = lmk_tbl.index_select(0, graph.lmk_idx).T          # [16, E]
    premu = torch.cat([bc[CAM_COMP:CAM_COMP + 6], bl[LMK_COMP:LMK_COMP + 3],
                       (bc[CAM_COMP + 6] * bl[LMK_COMP + 3])[None]])
    _edge_math_inplace(state, graph, bc[:CAM_COMP], bl[:LMK_COMP], cfg, premu)


def _check_edge_args(what: str, state, graph, extra) -> None:
    """Raise unless every kernel operand is a contiguous tensor of the
    expected dtype and shape on the state's device."""
    pk, e = state.pk, graph.n_edges
    checks = [
        (pk, (EDGE_PACK_ROWS, e), torch.float32),
        (state.damping_count, (e,), torch.int32),
        (state.robust, (e,), torch.bool),
        (state.active, (e,), torch.int32),
        (graph.meas, (2, e), torch.float32),
        (graph.meas_var, (e,), torch.float32),
        *extra,
    ]
    if graph.intr is not None:
        checks.append((graph.intr, (3, e), torch.float32))
    for t, shape, dtype in checks:
        if (tuple(t.shape) != shape or t.dtype != dtype
                or not t.is_contiguous() or t.device != pk.device):
            raise ValueError(
                f"{what}: expected contiguous {dtype} {shape} on {pk.device},"
                f" got {t.dtype} {tuple(t.shape)} on {t.device}")


def sweep(state, graph, cam_tbl: torch.Tensor, lmk_tbl: torch.Tensor, cfg,
          reference: bool = False) -> None:
    """One sweep of every edge, in place on ``state.pk``,
    ``state.damping_count`` and ``state.robust``. ``cam_tbl`` [C, 36] and
    ``lmk_tbl`` [L, 16] come from ops/table_kernel.build_tables. CPU tensors
    (or ``reference``) take the plain version; CUDA tensors launch
    csrc/sweep.cu."""
    pk = state.pk
    if reference or pk.device.type == "cpu":
        sweep_reference(state, graph, cam_tbl, lmk_tbl, cfg)
        return
    if pk.device.type != "cuda":
        raise ValueError(f"sweep: unsupported device {pk.device}")
    e = graph.n_edges
    _check_edge_args("sweep", state, graph, [
        (graph.cam_idx, (e,), torch.int32),
        (graph.lmk_idx, (e,), torch.int32),
        (cam_tbl, (graph.n_keyframes, CAM_WIDTH), torch.float32),
        (lmk_tbl, (graph.n_points, LMK_WIDTH), torch.float32)])
    params = sweep_params(cfg, graph.k, graph.intr is not None)
    lib = _cuda.library()
    err = lib.gbp_sweep_launch(
        ctypes.addressof(params), pk.data_ptr(), state.damping_count.data_ptr(),
        state.robust.data_ptr(), state.active.data_ptr(),
        graph.meas.data_ptr(), graph.meas_var.data_ptr(),
        _cuda.ptr(graph.intr), graph.cam_idx.data_ptr(),
        graph.lmk_idx.data_ptr(), cam_tbl.data_ptr(), lmk_tbl.data_ptr(), e,
        _cuda.stream_ptr(pk))
    _cuda.check(err, "sweep kernel")
    sweep.launches += 1


sweep.launches = 0


# ---------------------------------------------------------------------------
# the unfused sweep (H4)
# ---------------------------------------------------------------------------
#
# Replaces ``gbp_poplar_tpu/ops/sweep_kernel.py::_kernel`` as reached from
# ``sweep_edge_math_pallas``: ``edge_math`` without pre-solved means on
# belief planes gathered per edge beforehand (ops/reduce_kernel.gather), as
# the JAX package's unfused pipeline runs it (graphs without fused-sweep
# windows, or ``pallas_fused=False``). Kernel: csrc/sweep.cu
# ``sweep_planes_kernel``, H1's tile walk (stages, bulk copies,
# ``TileColumn``) with the intrinsics staged and the gathered values loaded
# per lane; the means are solved per edge by csrc/planes.cuh
# ``belief_mean``, the routine the table build (H2) uses, so H4 and H1 give
# the same result on the same state. Bound on the H100: bytes, H1's packed
# state per edge plus the 144 B of gathered planes. What it does not copy
# from the TPU kernel: the brick layout, the sub-blocks, the gather-native
# edge-major input and the block grid.

def sweep_planes_reference(state, graph, bc: torch.Tensor, bl: torch.Tensor,
                           cfg) -> None:
    """Plain PyTorch version: ``core.gbp.edge_math`` with ``premu=None``."""
    _edge_math_inplace(state, graph, bc, bl, cfg, None)


def sweep_planes(state, graph, bc: torch.Tensor, bl: torch.Tensor, cfg,
                 reference: bool = False) -> None:
    """One unfused sweep of every edge, in place on ``state.pk``,
    ``state.damping_count`` and ``state.robust``, from the gathered belief
    planes ``bc`` [27, E] and ``bl`` [9, E] (eta | packed Lambda). CPU
    tensors (or ``reference``) take the plain version; CUDA tensors launch
    csrc/sweep.cu ``sweep_planes_kernel``."""
    pk = state.pk
    if reference or pk.device.type == "cpu":
        sweep_planes_reference(state, graph, bc, bl, cfg)
        return
    if pk.device.type != "cuda":
        raise ValueError(f"sweep_planes: unsupported device {pk.device}")
    e = graph.n_edges
    _check_edge_args("sweep_planes", state, graph, [
        (bc, (CAM_COMP, e), torch.float32),
        (bl, (LMK_COMP, e), torch.float32)])
    params = sweep_params(cfg, graph.k, graph.intr is not None)
    lib = _cuda.library()
    err = lib.gbp_sweep_planes_launch(
        ctypes.addressof(params), pk.data_ptr(), state.damping_count.data_ptr(),
        state.robust.data_ptr(), state.active.data_ptr(),
        graph.meas.data_ptr(), graph.meas_var.data_ptr(),
        _cuda.ptr(graph.intr), bc.data_ptr(), bl.data_ptr(), e,
        _cuda.stream_ptr(pk))
    _cuda.check(err, "sweep_planes kernel")
    sweep_planes.launches += 1


sweep_planes.launches = 0

