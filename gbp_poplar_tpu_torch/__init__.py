"""gbp_poplar_tpu_torch — Gaussian Belief Propagation bundle adjustment in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package ``gbp_poplar_tpu``, which stays the reference:
the same factor graph in the same plane layout, the same per-edge sweep
body, held against the JAX functions on the same inputs by the tests in
tests/test_torch_*.py. This package never imports JAX.

Ported so far: the batch GBP bundle-adjustment solve without the
fixed-point accelerator and the coarse corrector (``accel_every=0``,
``coarse_groups=0``). ROADMAP.md lists what remains.
"""

import torch

from .config import GBPConfig, InitConfig  # noqa: F401

# fp32 throughout: no TF32 in matrix products or convolutions
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def load_bal(path_or_name: str):
    """Load a BAL-format problem (file path or sequence name)."""
    from .utils import balio

    return balio.load_bal(path_or_name)


def solve_ba(problem, cfg: GBPConfig | None = None, n_iters: int = 1000,
             device: torch.device | str = "cuda"):
    """One-call batch bundle adjustment on ``device``.

    Returns (cam_means [C,6], lmk_means [L,3], per-iteration mean
    reprojection error [n_iters]) as NumPy arrays. ``cfg`` defaults to
    the JAX package's defaults, whose accelerator (``accel_every=50``) is
    not ported yet: pass ``GBPConfig(accel_every=0)``."""
    from .core import build_graph, gbp, init_state
    from .utils import analysis

    cfg = cfg or GBPConfig()
    graph = build_graph(problem, cfg, device)
    state = init_state(problem, cfg, device)
    final, diag = gbp.solve(state, graph, cfg, n_iters=n_iters)
    cam_mu, lmk_mu = analysis.belief_means(final)
    return cam_mu, lmk_mu, diag.reproj_err.cpu().numpy()
