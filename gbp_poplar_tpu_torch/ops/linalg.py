"""Batched small-matrix linear algebra on dense [..., d, d] tensors.

The counterpart of ``gbp_poplar_tpu/ops/linalg.py`` for the functions the
port uses: batched products, the closed-form 3x3 inverse, the 6x6 inverse
of a symmetric positive-definite matrix, and the information-to-mean
conversion (reference: ba/bafuncs.cpp:2-15). The solver itself works on
plane tensors (ops/planes.py); these dense forms serve the LM oracle's
block-Jacobi preconditioner and the offline analysis (utils/analysis.py).

``inv6x6`` is the JAX package's algorithm, an equilibrated Cholesky
unrolled into elementwise operations; ``inv6x6_cholesky_ex`` (the LM
solver's) factors with ``torch.linalg.cholesky_ex`` instead. The analysis
helpers take the unrolled form because the library factorisations of the
card and the host round differently, and on blocks at the edge of
positive definiteness they disagreed on whether a block factors at all
(the rank-2 message precisions of ``utils.analysis.message_kl_trace``:
658 and 3,009 of 1,092,608 edges finite on an H100 and on its host's CPU,
chip_smoke.py phase 13). The elementwise factorisation and its triangular
inverse give the same bits on both devices (a division and a correctly
rounded square root where the JAX function takes ``rsqrt``), so both
decide positive definiteness alike; only the closing product L^-T L^-1 is
a batched matmul. On SPD blocks with condition numbers kappa from 10 to
1e5 the unrolled form agrees with the JAX function to 1e-7 kappa of the
inverse's largest entry (measured 1.6e-8 kappa,
tests/test_torch_utils_aux.py).
"""

from __future__ import annotations

import torch


def bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched matrix multiply: [..., m, k] @ [..., k, n] -> [..., m, n]."""
    return a @ b


def bmv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector: [..., m, k] @ [..., k] -> [..., m]."""
    return (a @ v[..., None])[..., 0]


def transpose(a: torch.Tensor) -> torch.Tensor:
    return a.transpose(-1, -2)


def inv3x3(a: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate/determinant inverse of [..., 3, 3] (any 3x3,
    not only symmetric ones)."""
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c02 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c10 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c20 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    c21 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    det = a[..., 0, 0] * c00 + a[..., 0, 1] * c10 + a[..., 0, 2] * c20
    inv_det = 1.0 / det
    adj = torch.stack([torch.stack([c00, c01, c02], dim=-1),
                       torch.stack([c10, c11, c12], dim=-1),
                       torch.stack([c20, c21, c22], dim=-1)], dim=-2)
    return adj * inv_det[..., None, None]


def cholesky6x6(a: torch.Tensor) -> torch.Tensor:
    """Unrolled Cholesky factor L (lower) of SPD [..., 6, 6]: elementwise
    operations only, in the JAX function's order; a non-positive pivot
    gives NaN (its square root) or inf and NaN (a zero pivot)."""
    l_cols = []           # l_cols[j][i - j] = L[i, j] for i >= j
    for j in range(6):
        d = a[..., j, j]
        for k in range(j):
            d = d - l_cols[k][j - k] * l_cols[k][j - k]
        d = torch.sqrt(d)
        inv_d = 1.0 / d
        col = [d]
        for i in range(j + 1, 6):
            v = a[..., i, j]
            for k in range(j):
                v = v - l_cols[k][i - k] * l_cols[k][j - k]
            col.append(v * inv_d)
        l_cols.append(col)
    zero = torch.zeros_like(a[..., 0, 0])
    return torch.stack([torch.stack([l_cols[j][i - j] if i >= j else zero
                                     for j in range(6)], dim=-1)
                        for i in range(6)], dim=-2)


def _inv_lower6x6(l: torch.Tensor) -> torch.Tensor:
    """Inverse of lower-triangular [..., 6, 6] by forward substitution."""
    inv_diag = [1.0 / l[..., i, i] for i in range(6)]
    zero = torch.zeros_like(l[..., 0, 0])
    m = [[zero] * 6 for _ in range(6)]      # m[i][j] = (L^-1)[i, j]
    for i in range(6):
        m[i][i] = inv_diag[i]
        for j in range(i - 1, -1, -1):
            acc = zero
            for k in range(j, i):
                acc = acc + l[..., i, k] * m[k][j]
            m[i][j] = -acc * inv_diag[i]
    return torch.stack([torch.stack(m[i], dim=-1) for i in range(6)],
                       dim=-2)


def inv6x6(a: torch.Tensor) -> torch.Tensor:
    """Inverse of SPD [..., 6, 6] blocks by an equilibrated, unrolled
    Cholesky (A -> D A D, D = diag(A)^-1/2, which removes the unit
    mismatch of the translation and rotation blocks), A^-1 =
    D (L^-T L^-1) D; NaN where a pivot is not positive."""
    d = 1.0 / torch.sqrt(torch.abs(torch.diagonal(a, dim1=-2, dim2=-1))
                         + 1e-30)
    a_eq = a * d[..., :, None] * d[..., None, :]
    l_inv = _inv_lower6x6(cholesky6x6(a_eq))
    inv_eq = bmm(transpose(l_inv), l_inv)
    return inv_eq * d[..., :, None] * d[..., None, :]


def inv6x6_cholesky_ex(a: torch.Tensor) -> torch.Tensor:
    """``inv6x6`` by the library factorisation (``torch.linalg.cholesky_ex``
    and ``cholesky_solve``, one call each per batch), the same
    equilibration; NaN where the factorisation fails. The LM solver's
    block-Jacobi preconditioner (core/gauss_newton.py) uses it: its accept
    decisions are held against the JAX package's up to the first float32
    tie, and the unrolled form's rounding moves that tie. On the LM's S
    blocks it decides definiteness as the unrolled form does, on an H100
    and on its host alike: no block fails along the Ladybug and Venice
    polishes, and on near-singular blocks the same blocks fail
    (tests/test_torch_cuda.py, chip_smoke.py's ``C3 census``)."""
    d = torch.rsqrt(torch.abs(torch.diagonal(a, dim1=-2, dim2=-1)) + 1e-30)
    a_eq = a * d[..., :, None] * d[..., None, :]
    chol, info = torch.linalg.cholesky_ex(a_eq)
    eye = torch.eye(6, dtype=a.dtype, device=a.device).expand_as(a)
    inv = torch.cholesky_solve(eye, chol) * d[..., :, None] * d[..., None, :]
    return torch.where((info == 0)[..., None, None], inv, torch.nan)


def inv_dxd(a: torch.Tensor) -> torch.Tensor:
    """Dispatch on the trailing dimension: 3 -> inv3x3, 6 -> inv6x6,
    otherwise ``torch.linalg.inv``."""
    d = a.shape[-1]
    if d == 3:
        return inv3x3(a)
    if d == 6:
        return inv6x6(a)
    return torch.linalg.inv(a)


def inf_to_mean(eta: torch.Tensor, lam: torch.Tensor):
    """(eta [..., d], Lambda [..., d, d]) -> (mu, Sigma): Sigma = Lambda^-1,
    mu = Sigma eta."""
    sigma = inv_dxd(lam)
    return bmv(sigma, eta), sigma


def inf_to_mu(eta: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Mean only: Lambda^-1 eta."""
    return bmv(inv_dxd(lam), eta)
