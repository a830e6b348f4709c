"""Per-variable belief tables: beliefs, their means and a validity flag.

Replaces ``gbp_poplar_tpu/ops/table_kernel.py::_kernel`` (the landmark
premu table build, ``build_lmk_table``) and the camera-side XLA glue of
``gbp_poplar_tpu/core/gbp.py::_make_tables``. For each variable the row
is ``[eta | packed Lambda | mean | valid | 0-pad]``:

  - cameras: 6 + 21 + 6 + 1 = 34 values, padded to CAM_WIDTH = 36 floats
    (144 B, a whole number of 16-byte vector loads);
  - landmarks: 3 + 6 + 3 + 1 = 13 values, padded to LMK_WIDTH = 16.

The mean is the 6x6 Cholesky solve (cameras) or the 3x3 adjugate inverse
(landmarks) of the belief, as ``planes.solve_sym`` / ``planes.inv_sym3``.
Sanitise rule, exactly the JAX package's ``_sanitize_means``: a mean with
any non-finite component is zeroed whole and flagged invalid; the test is
finiteness only.

Kernel (csrc/table.cu, the per-variable body in csrc/table.cuh): both
kinds in one launch, blocks of 128 variables, the camera blocks first.
Bound on the H100: bytes (read 27 or 9 floats, write 36 or 16 per
variable); the 6x6 solve is about 200 flops per camera and there are only
thousands of cameras. Design: the tables are row-major [V, width] so the
sweep kernel reads a variable's whole row with aligned 16-byte loads; a
block stages its rows in shared memory and writes its contiguous part of
the table as consecutive 16-byte vectors across its threads. One call
(``build_tables``) and one launch per build serve both kinds.
"""

from __future__ import annotations

import torch

from . import _cuda
from . import planes as pl

CAM_WIDTH = 36
LMK_WIDTH = 16


def _layout(d: int):
    n_sym = pl.N_SYM6 if d == 6 else pl.N_SYM3
    return d + n_sym, (CAM_WIDTH if d == 6 else LMK_WIDTH)


def variable_means(bel: torch.Tensor, d: int) -> torch.Tensor:
    """Belief means [d, V] from a [d + n_sym, V] belief (unsanitised)."""
    eta = pl.unpack_vec(bel[:d], d)
    lam = pl.unpack_sym(bel[d:], d)
    if d == 6:
        mu = pl.solve_sym(lam, eta)
    else:
        mu = pl.matvec(pl.inv_sym3(lam), eta)
    return pl.pack_vec(mu)


def build_table_reference(bel: torch.Tensor, d: int) -> torch.Tensor:
    """Plain PyTorch version of the table build."""
    comp, width = _layout(d)
    mu = variable_means(bel, d)
    ok = torch.isfinite(mu).all(dim=0, keepdim=True)
    mu = torch.where(ok, mu, 0.0)
    pad = torch.zeros((width - comp - d - 1, bel.shape[1]), dtype=bel.dtype,
                      device=bel.device)
    return torch.cat([bel, mu, ok.to(bel.dtype), pad]).T.contiguous()


def _check_belief(bel: torch.Tensor, d: int, device) -> None:
    comp, _ = _layout(d)
    if bel.device != device:
        raise ValueError(f"build_tables: beliefs on {bel.device} and {device}")
    if (bel.dtype != torch.float32 or bel.dim() != 2 or bel.shape[0] != comp
            or not bel.is_contiguous()):
        raise ValueError(f"build_tables: belief must be contiguous float32 "
                         f"[{comp}, V], got {tuple(bel.shape)} {bel.dtype}")


def _launch(cam_bel: torch.Tensor, lmk_bel: torch.Tensor):
    """One launch of csrc/table.cu for both kinds; a kind with no
    variables ([comp, 0]) gets no blocks."""
    device = cam_bel.device
    if device.type != "cuda":
        raise ValueError(f"build_tables: unsupported device {device}")
    out, args = [], []
    for bel, d in ((cam_bel, 6), (lmk_bel, 3)):
        _check_belief(bel, d, device)
        tbl = torch.empty((bel.shape[1], _layout(d)[1]), dtype=torch.float32,
                          device=device)
        out.append(tbl)
        args += [bel.data_ptr(), bel.shape[1], tbl.data_ptr()]
    err = _cuda.library().gbp_tables_launch(*args, _cuda.stream_ptr(cam_bel))
    _cuda.check(err, "table kernel")
    build_tables.launches += 1
    return tuple(out)


def build_tables(cam_bel: torch.Tensor, lmk_bel: torch.Tensor,
                 reference: bool = False):
    """(cam_tbl [C, 36], lmk_tbl [L, 16]) from the camera belief [27, C]
    and the landmark belief [9, L]. CPU tensors (or ``reference``) take the
    plain version, ``build_table_reference`` per kind; CUDA tensors launch
    csrc/table.cu once for both. One kind alone is built by passing the
    other with no variables (``bel[:, :0]``)."""
    if reference or cam_bel.device.type == "cpu":
        if lmk_bel.device != cam_bel.device:
            raise ValueError(f"build_tables: beliefs on {cam_bel.device} "
                             f"and {lmk_bel.device}")
        return build_table_reference(cam_bel, 6), build_table_reference(
            lmk_bel, 3)
    return _launch(cam_bel, lmk_bel)


build_tables.launches = 0
