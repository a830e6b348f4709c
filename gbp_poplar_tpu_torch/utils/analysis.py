"""Offline analysis: belief means, Gaussian KL divergences, message traces.

The counterpart of ``gbp_poplar_tpu/utils/analysis.py``: the reference's
analysis hooks (KL_divergence / symmetricKL between information-form
Gaussians, ba/util.cpp:225-250; belief dumps, ba/dataio.cpp:165-260; the
per-edge message traces of save_message_KL, ba/dataio.cpp:262-327),
batched. Matrices are dense [..., d, d] (ops/planes.unpack_sym_dense);
results come back as host NumPy arrays where the JAX functions return
them so.

A message's precision has rank at most 2 (one 2-D measurement), and its
float32 entries make it indefinite at rounding level, far above the
eps * I = 1e-6 that ``message_kl_trace`` adds. Where the regularised
precision is not positive definite, the camera side's KL is NaN (its 6x6
Cholesky fails) and the landmark side's is finite but no divergence (the
3x3 adjugate inverse does not fail; the value can be negative), here as
in the JAX package.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from ..ops import linalg, table_kernel
from ..ops import planes as pl

if TYPE_CHECKING:  # utils <-> core import cycle at run time
    from ..core.factor_graph import GBPState


def belief_means(state: GBPState) -> tuple[np.ndarray, np.ndarray]:
    """(cam_mu [C, 6], lmk_mu [L, 3]) from the current beliefs, as
    ``gbp_poplar_tpu.utils.analysis.belief_means``."""
    cam_mu = table_kernel.variable_means(state.cam_bel, 6)
    lmk_mu = table_kernel.variable_means(state.lmk_bel, 3)
    return cam_mu.T.cpu().numpy(), lmk_mu.T.cpu().numpy()


def kl_divergence(eta0: torch.Tensor, lam0: torch.Tensor,
                  eta1: torch.Tensor, lam1: torch.Tensor) -> torch.Tensor:
    """KL(N0 || N1) of information-form Gaussians (eta [..., d], Lambda
    [..., d, d]), batched."""
    d = eta0.shape[-1]
    mu0, sig0 = linalg.inf_to_mean(eta0, lam0)
    mu1, sig1 = linalg.inf_to_mean(eta1, lam1)
    dmu = mu1 - mu0
    tr = torch.einsum("...ij,...ji->...", lam1, sig0)
    quad = torch.einsum("...i,...ij,...j->...", dmu, lam1, dmu)
    logdet0 = torch.linalg.slogdet(sig0).logabsdet
    logdet1 = torch.linalg.slogdet(sig1).logabsdet
    return 0.5 * (tr + quad - d + logdet1 - logdet0)


def symmetric_kl(eta0: torch.Tensor, lam0: torch.Tensor,
                 eta1: torch.Tensor, lam1: torch.Tensor) -> torch.Tensor:
    """0.5 * (KL(N0 || N1) + KL(N1 || N0))."""
    return 0.5 * (kl_divergence(eta0, lam0, eta1, lam1)
                  + kl_divergence(eta1, lam1, eta0, lam0))


def message_norms(state: GBPState) -> dict[str, np.ndarray]:
    """Per-edge eta-message norms in both directions [E]."""
    return {
        "to_cam": torch.linalg.vector_norm(state.msg_c_eta, dim=0)
        .cpu().numpy(),
        "to_lmk": torch.linalg.vector_norm(state.msg_l_eta, dim=0)
        .cpu().numpy(),
    }


def message_kl_trace(prev_state: GBPState,
                     state: GBPState) -> dict[str, np.ndarray]:
    """Symmetric KL per edge between consecutive messages [E], each
    precision regularised by eps * I = 1e-6 (see the module docstring)."""
    eps = 1e-6

    def dense(lam_planes, d):
        m = pl.unpack_sym_dense(lam_planes, d)
        return m + eps * torch.eye(d, dtype=m.dtype, device=m.device)

    kl_cam = symmetric_kl(
        prev_state.msg_c_eta.T, dense(prev_state.msg_c_lam, 6),
        state.msg_c_eta.T, dense(state.msg_c_lam, 6))
    kl_lmk = symmetric_kl(
        prev_state.msg_l_eta.T, dense(prev_state.msg_l_lam, 3),
        state.msg_l_eta.T, dense(state.msg_l_lam, 3))
    return {"to_cam": kl_cam.cpu().numpy(), "to_lmk": kl_lmk.cpu().numpy()}


def save_beliefs(path: str, state: GBPState) -> None:
    """Write the beliefs (eta, Lambda planes) to an npz with the JAX
    package's keys, as host float32."""
    np.savez(path, **{f: getattr(state, f).cpu().numpy()
                      for f in ("cam_eta", "cam_lam", "lmk_eta", "lmk_lam")})
