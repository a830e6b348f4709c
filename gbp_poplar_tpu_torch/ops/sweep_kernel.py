"""The fused per-edge GBP sweep: relinearisation state machine plus all four
factor-to-variable messages, written over the packed edge state in place.

Replaces ``gbp_poplar_tpu/ops/sweep_kernel.py::_fused_kernel`` as reached
from both ``sweep_fused_pallas`` (annealed iterations) and
``sweep_fused_packed`` (the hot loop): per edge, gather the camera and
landmark belief rows with their pre-solved means and validity flags (the
tables of ops/table_kernel.py), run ``core.gbp.edge_math`` with those
means, and write the 12 packed f32 fields, the damping counter and the
robust flag back. The per-variable message sums that the TPU kernel
accumulated in its epilogue are left to ops/reduce_kernel.py.

Kernel (csrc/sweep.cu, with the edge math in csrc/edge_math.cuh and the
small-matrix algebra in csrc/planes.cuh): one thread per edge. Bound on
the H100: bytes. Each edge reads and writes its 109 packed rows (872 B),
the counter and flag, and reads 6 more constant rows and two table rows:
about 1 KB per edge per sweep, against roughly 2,000 flops. Design: the
plane layout [row, E] makes every packed-row access coalesced across a
warp; the belief rows come by direct indexed 16-byte loads from the small
tables (consecutive edges share a landmark and a handful of cameras, so
they hit in L1/L2); the state is updated in place, which is safe because
each thread touches only its own edge. No windows, one-hot gathers or
brick layout: those answered TPU limits the H100 does not have. The
``edge_math`` body keeps about 300 values live per edge; the registers and
spills that costs are recorded by the build (ops/_cuda.py).
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


def sweep_reference(state, graph, cam_tbl: torch.Tensor,
                    lmk_tbl: torch.Tensor, cfg) -> None:
    """Plain PyTorch version: gather the table rows, run
    ``core.gbp.edge_math`` on planes, write the results in place."""
    from ..core.gbp import edge_math

    bc = cam_tbl.index_select(0, graph.cam_idx).T          # [36, E]
    bl = lmk_tbl.index_select(0, graph.lmk_idx).T          # [16, E]
    premu = torch.cat([bc[CAM_COMP:CAM_COMP + 6], bl[LMK_COMP:LMK_COMP + 3],
                       (bc[CAM_COMP + 6] * bl[LMK_COMP + 3])[None]])
    outs = edge_math(
        bc[:CAM_COMP], bl[:LMK_COMP], graph.meas, graph.meas_var,
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


def sweep(state, graph, cam_tbl: torch.Tensor, lmk_tbl: torch.Tensor, cfg,
          reference: bool = False) -> None:
    """One sweep of every edge, in place on ``state.pk``,
    ``state.damping_count`` and ``state.robust``. ``cam_tbl`` [C, 36] and
    ``lmk_tbl`` [L, 16] come from ops/table_kernel.build_table. CPU tensors
    (or ``reference``) take the plain version; CUDA tensors launch
    csrc/sweep.cu."""
    pk = state.pk
    if reference or pk.device.type == "cpu":
        sweep_reference(state, graph, cam_tbl, lmk_tbl, cfg)
        return
    if pk.device.type != "cuda":
        raise ValueError(f"sweep: unsupported device {pk.device}")
    e = graph.n_edges
    checks = [
        (pk, (EDGE_PACK_ROWS, e), torch.float32),
        (state.damping_count, (e,), torch.int32),
        (state.robust, (e,), torch.bool),
        (state.active, (e,), torch.int32),
        (graph.meas, (2, e), torch.float32),
        (graph.meas_var, (e,), torch.float32),
        (graph.cam_idx, (e,), torch.int32),
        (graph.lmk_idx, (e,), torch.int32),
        (cam_tbl, (graph.n_keyframes, CAM_WIDTH), torch.float32),
        (lmk_tbl, (graph.n_points, LMK_WIDTH), torch.float32),
    ]
    if graph.intr is not None:
        checks.append((graph.intr, (3, e), torch.float32))
    for t, shape, dtype in checks:
        if (tuple(t.shape) != shape or t.dtype != dtype
                or not t.is_contiguous() or t.device != pk.device):
            raise ValueError(
                f"sweep: expected contiguous {dtype} {shape} on {pk.device},"
                f" got {t.dtype} {tuple(t.shape)} on {t.device}")
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

