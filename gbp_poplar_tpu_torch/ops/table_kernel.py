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

Kernel (csrc/table.cu): one thread per variable. Bound on the H100:
bytes (read 27 or 9 floats, write 36 or 16); the 6x6 solve is about 200
flops per camera and there are only thousands of cameras. Design: the
tables are row-major [V, width] so the sweep kernel reads a variable's
whole row with aligned 16-byte loads; the write of a row by one thread is
strided across threads but the tables are small (22 MB at 1.09M edges).
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


def build_table(bel: torch.Tensor, d: int,
                reference: bool = False) -> torch.Tensor:
    """[V, width] table from a [d + n_sym, V] belief (``d`` = 6 cameras,
    3 landmarks). CPU tensors (or ``reference``) take the plain version;
    CUDA tensors launch csrc/table.cu."""
    if reference or bel.device.type == "cpu":
        return build_table_reference(bel, d)
    comp, width = _layout(d)
    if bel.device.type != "cuda":
        raise ValueError(f"build_table: unsupported device {bel.device}")
    if (bel.dtype != torch.float32 or bel.shape[0] != comp
            or not bel.is_contiguous()):
        raise ValueError(f"build_table: belief must be contiguous float32 "
                         f"[{comp}, V], got {tuple(bel.shape)} {bel.dtype}")
    n_var = bel.shape[1]
    tbl = torch.empty((n_var, width), dtype=torch.float32, device=bel.device)
    lib = _cuda.library()
    err = lib.gbp_table_launch(d, bel.data_ptr(), n_var, tbl.data_ptr(),
                               width, _cuda.stream_ptr(bel))
    _cuda.check(err, "table kernel")
    build_table.launches += 1
    return tbl


build_table.launches = 0
