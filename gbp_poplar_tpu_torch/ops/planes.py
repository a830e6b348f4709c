"""Plane-layout (structure-of-arrays) small-matrix algebra on torch tensors.

The PyTorch counterpart of ``gbp_poplar_tpu/ops/planes.py``: a symmetric
6x6 field over E edges is a packed [21, E] tensor whose rows are [E]
vectors, and every small-matrix operation unrolls into elementwise
arithmetic on those rows. On a GPU the layout is what makes the edge axis
coalesce; the CUDA kernels (csrc/planes.cuh) run the same formulas per
thread on scalars.

Each function keeps the operation order of its JAX counterpart, term for
term, so that the plain PyTorch path, the JAX package and the kernels
round alike: the solves divide (never a multiply by a cached reciprocal);
a reciprocal is multiplied only where the JAX function multiplies by one
(the Cholesky column scaling, the adjugate inverse); sums run left to
right, and selects are ``torch.where``.

Conventions:
  - a "vec" is a Python list of d tensors, each shaped [...] (usually [E])
  - a "mat" is a list of lists, mat[i][j]
  - symmetric matrices are packed row-major over the lower triangle:
    (i, j), i >= j  ->  slot i*(i+1)/2 + j  (21 slots for 6x6, 6 for 3x3)
  - packed storage is a single tensor [n_slots, N]
"""

from __future__ import annotations

import torch

SYM6_IDX = [(i, j) for i in range(6) for j in range(i + 1)]   # 21
SYM3_IDX = [(i, j) for i in range(3) for j in range(i + 1)]   # 6
N_SYM6 = len(SYM6_IDX)
N_SYM3 = len(SYM3_IDX)


def sym_slot(i: int, j: int) -> int:
    if i < j:
        i, j = j, i
    return i * (i + 1) // 2 + j


# ---------------------------------------------------------------------------
# pack / unpack
# ---------------------------------------------------------------------------

def unpack_sym(p: torch.Tensor, d: int) -> list[list[torch.Tensor]]:
    """Packed [n_slots, N] -> symmetric mat of shared [N] row views."""
    idx = SYM6_IDX if d == 6 else SYM3_IDX
    m = [[None] * d for _ in range(d)]
    for s, (i, j) in enumerate(idx):
        m[i][j] = p[s]
        m[j][i] = m[i][j]
    return m


def unpack_sym_dense(p: torch.Tensor, d: int) -> torch.Tensor:
    """Packed symmetric [n_slots, N] -> dense [N, d, d]."""
    rows = unpack_sym(p, d)
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def pack_sym(m: list[list[torch.Tensor]], d: int) -> torch.Tensor:
    idx = SYM6_IDX if d == 6 else SYM3_IDX
    return torch.stack([m[i][j] for (i, j) in idx])


def unpack_full(p: torch.Tensor, rows: int, cols: int):
    """Packed [rows*cols, N] row-major -> mat of [N] row views."""
    return [[p[i * cols + j] for j in range(cols)] for i in range(rows)]


def pack_full(m: list[list[torch.Tensor]]) -> torch.Tensor:
    return torch.stack([x for row in m for x in row])


def unpack_vec(p: torch.Tensor, d: int) -> list[torch.Tensor]:
    return [p[i] for i in range(d)]


def pack_vec(v: list[torch.Tensor]) -> torch.Tensor:
    return torch.stack(v)


# ---------------------------------------------------------------------------
# elementary mat/vec algebra on plane lists (unrolled, elementwise)
# ---------------------------------------------------------------------------

def matvec(m, v):
    out = []
    for i in range(len(m)):
        acc = m[i][0] * v[0]
        for k in range(1, len(v)):
            acc = acc + m[i][k] * v[k]
        out.append(acc)
    return out


def matmul(a, b):
    rows, inner, cols = len(a), len(b), len(b[0])
    out = [[None] * cols for _ in range(rows)]
    for i in range(rows):
        for j in range(cols):
            acc = a[i][0] * b[0][j]
            for k in range(1, inner):
                acc = acc + a[i][k] * b[k][j]
            out[i][j] = acc
    return out


def vdot(a, b):
    acc = a[0] * b[0]
    for k in range(1, len(a)):
        acc = acc + a[k] * b[k]
    return acc


def vsub(a, b):
    return [x - y for x, y in zip(a, b)]


# ---------------------------------------------------------------------------
# symmetric solves / inverses
# ---------------------------------------------------------------------------

def add_rel_jitter(m, rel_eps: float):
    """Tikhonov jitter relative to the mean diagonal (cavity guard)."""
    if rel_eps <= 0.0:
        return m
    d = len(m)
    mean_diag = m[0][0]
    for i in range(1, d):
        mean_diag = mean_diag + m[i][i]
    jit = (rel_eps / d) * torch.abs(mean_diag)
    out = [row[:] for row in m]
    for i in range(d):
        out[i][i] = out[i][i] + jit
    return out


def cholesky_with_pivot(m):
    """(L, minimum pre-sqrt pivot) of a symmetric matrix.

    min_pivot > 0 iff the matrix is positive definite. ``torch.minimum``
    and ``torch.clamp_min`` propagate NaN, as ``jnp.minimum`` and
    ``jnp.maximum`` do, so a NaN entry reaches the pivot test."""
    d = len(m)
    l = [[None] * d for _ in range(d)]
    min_pivot = None
    for j in range(d):
        s = m[j][j]
        for k in range(j):
            s = s - l[j][k] * l[j][k]
        min_pivot = s if min_pivot is None else torch.minimum(min_pivot, s)
        # clamp keeps the factorisation finite past a bad pivot; callers
        # discard those lanes via min_pivot
        diag = torch.sqrt(torch.clamp_min(s, 1e-30))
        l[j][j] = diag
        inv_d = 1.0 / diag
        for i in range(j + 1, d):
            v = m[i][j]
            for k in range(j):
                v = v - l[i][k] * l[j][k]
            l[i][j] = v * inv_d
    return l, min_pivot


def chol_solve(l, rhs):
    """Solve (L L^T) x = b given the Cholesky factor (true divides)."""
    d = len(l)
    y = [None] * d
    for i in range(d):
        s = rhs[i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s / l[i][i]
    x = [None] * d
    for i in range(d - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, d):
            s = s - l[k][i] * x[k]
        x[i] = s / l[i][i]
    return x


def solve_sym(m, rhs):
    return chol_solve(cholesky_with_pivot(m)[0], rhs)


def inv_sym3_posdef(m):
    """(inverse, positive-definite mask) of symmetric 3x3 by the adjugate;
    the Sylvester test reuses the cofactors."""
    a, b, c = m[0][0], m[0][1], m[0][2]
    d, e = m[1][1], m[1][2]
    f = m[2][2]
    c00 = d * f - e * e
    c01 = c * e - b * f
    c02 = b * e - c * d
    c11 = a * f - c * c
    c12 = b * c - a * e
    c22 = a * d - b * b
    det = a * c00 + b * c01 + c * c02
    ok = (a > 0) & (c22 > 0) & (det > 0)
    inv_det = 1.0 / det
    return [
        [c00 * inv_det, c01 * inv_det, c02 * inv_det],
        [c01 * inv_det, c11 * inv_det, c12 * inv_det],
        [c02 * inv_det, c12 * inv_det, c22 * inv_det],
    ], ok


def inv_sym3(m):
    return inv_sym3_posdef(m)[0]


# ---------------------------------------------------------------------------
# SO(3) / projection measurement model in planes
# ---------------------------------------------------------------------------

_SMALL_THETA = 1e-6


def so3_exp(w):
    """Rodrigues' formula, unrolled, with the small-angle branch."""
    theta_sq = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
    theta = torch.sqrt(theta_sq)
    small = theta < _SMALL_THETA
    th = torch.where(small, 1.0, theta)
    th_sq = torch.where(small, 1.0, theta_sq)
    a = torch.where(small, 1.0, torch.sin(th) / th)
    b = torch.where(small, 0.5, (1.0 - torch.cos(th)) / th_sq)
    one = torch.ones_like(w[0])
    wx, wy, wz = w
    xx, yy, zz = wx * wx, wy * wy, wz * wz
    xy, xz, yz = wx * wy, wx * wz, wy * wz
    return [
        [one - b * (yy + zz), -a * wz + b * xy, a * wy + b * xz],
        [a * wz + b * xy, one - b * (xx + zz), -a * wx + b * yz],
        [-a * wy + b * xz, a * wx + b * yz, one - b * (xx + yy)],
    ]


def hat(v):
    zero = torch.zeros_like(v[0])
    return [
        [zero, -v[2], v[1]],
        [v[2], zero, -v[0]],
        [-v[1], v[0], zero],
    ]


def w2c_apply(cam, y):
    """y_cam = R y + t; returns (y_cf vec3, R)."""
    r = so3_exp(cam[3:6])
    ry = matvec(r, y)
    return [ry[i] + cam[i] for i in range(3)], r


def project(cam, lmk, k, intr=None):
    """(u, v) pixel planes + (y_cf, R) intermediates.

    ``k`` is the [3, 3] shared pinhole intrinsics as host numbers (a NumPy
    array); ``intr`` = [f, k1, k2] per-edge planes selects the
    Snavely/BAL model (camera looks down -z)."""
    y_cf, r = w2c_apply(cam, lmk)
    inv_z = 1.0 / y_cf[2]
    if intr is None:
        u = float(k[0][0]) * y_cf[0] * inv_z + float(k[0][2])
        v = float(k[1][1]) * y_cf[1] * inv_z + float(k[1][2])
    else:
        f, d1, d2 = intr
        px = -y_cf[0] * inv_z
        py = -y_cf[1] * inv_z
        rho = px * px + py * py
        dist = 1.0 + rho * (d1 + d2 * rho)
        u = f * dist * px
        v = f * dist * py
    return (u, v), y_cf, r


def linearise(cam, lmk, k, meas_u, meas_v, meas_var, nstds: float,
              intr=None):
    """Fused reprojection-factor relinearisation in planes.

    Returns (eta_c[6], eta_l[3], lam_cc mat6, lam_cl mat6x3, lam_ll mat3,
    robust [E], y_cf vec3), as ``gbp_poplar_tpu.ops.planes.linearise``."""
    (u, v), y_cf, r = project(cam, lmk, k, intr)
    inv_z = 1.0 / y_cf[2]
    inv_z2 = inv_z * inv_z
    zero = torch.zeros_like(u)

    if intr is None:
        fx, fy = float(k[0][0]), float(k[1][1])
        j_proj = [
            [fx * inv_z, zero, -fx * y_cf[0] * inv_z2],
            [zero, fy * inv_z, -fy * y_cf[1] * inv_z2],
        ]
    else:
        f, d1, d2 = intr
        px = -y_cf[0] * inv_z
        py = -y_cf[1] * inv_z
        rho = px * px + py * py
        dist = 1.0 + rho * (d1 + d2 * rho)
        g = d1 + 2.0 * d2 * rho
        dpx = [-inv_z, zero, y_cf[0] * inv_z2]
        dpy = [zero, -inv_z, y_cf[1] * inv_z2]
        drho = [2.0 * (px * dpx[i] + py * dpy[i]) for i in range(3)]
        j_proj = [
            [f * (dist * dpx[i] + px * g * drho[i]) for i in range(3)],
            [f * (dist * dpy[i] + py * g * drho[i]) for i in range(3)],
        ]

    # landmark block: J_proj @ R
    j_lmk = matmul(j_proj, r)

    # rotation block via the global axis-angle derivative
    # dRy/dw = -R hat(y) ((R^T - I) hat(w) + w w^T) / ||w||^2
    # with the exact w->0 limit -hat(y)
    w = cam[3:6]
    theta_sq = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
    small = theta_sq < 1e-12
    denom = torch.where(small, 1.0, theta_sq)
    w_hat = hat(w)
    y_hat = hat(lmk)
    one = torch.ones_like(u)
    rt_minus_i = [[r[j][i] - (one if i == j else zero) for j in range(3)]
                  for i in range(3)]
    numer = matmul(rt_minus_i, w_hat)
    for i in range(3):
        for j in range(3):
            numer[i][j] = numer[i][j] + w[i] * w[j]
    r_yhat = matmul(r, y_hat)
    d_ry_dw_full = matmul(r_yhat, numer)
    d_ry_dw = [[torch.where(small, -y_hat[i][j],
                            -d_ry_dw_full[i][j] / denom)
                for j in range(3)] for i in range(3)]
    j_rot = matmul(j_proj, d_ry_dw)

    # J_kf = [J_proj | J_rot]  (2 x 6)
    j_kf = [j_proj[0] + j_rot[0], j_proj[1] + j_rot[1]]

    # residual-side vector b = J x0 + z - h(x0)
    jx0_u = vdot(j_kf[0], cam) + vdot(j_lmk[0], lmk)
    jx0_v = vdot(j_kf[1], cam) + vdot(j_lmk[1], lmk)
    b_u = jx0_u + meas_u - u
    b_v = jx0_v + meas_v - v

    # Huber variance inflation
    ru = meas_u - u
    rv = meas_v - v
    err = torch.sqrt(ru * ru + rv * rv)
    sigma = torch.sqrt(meas_var)
    robust = err > nstds * sigma
    denom_h = 2.0 * (nstds * sigma * err - 0.5 * nstds * nstds * meas_var)
    denom_h = torch.where(robust, denom_h, 1.0)
    var = torch.where(robust, meas_var * err * err / denom_h, meas_var)
    inv_var = 1.0 / var

    eta_c = [(j_kf[0][i] * b_u + j_kf[1][i] * b_v) * inv_var
             for i in range(6)]
    eta_l = [(j_lmk[0][i] * b_u + j_lmk[1][i] * b_v) * inv_var
             for i in range(3)]
    lam_cc = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            val = (j_kf[0][i] * j_kf[0][j] + j_kf[1][i] * j_kf[1][j]) * inv_var
            lam_cc[i][j] = val
            lam_cc[j][i] = val
    lam_ll = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(i + 1):
            val = (j_lmk[0][i] * j_lmk[0][j]
                   + j_lmk[1][i] * j_lmk[1][j]) * inv_var
            lam_ll[i][j] = val
            lam_ll[j][i] = val
    lam_cl = [[(j_kf[0][i] * j_lmk[0][j] + j_kf[1][i] * j_lmk[1][j]) * inv_var
               for j in range(3)] for i in range(6)]
    return eta_c, eta_l, lam_cc, lam_cl, lam_ll, robust, y_cf
