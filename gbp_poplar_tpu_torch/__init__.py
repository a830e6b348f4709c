"""gbp_poplar_tpu_torch — Gaussian Belief Propagation bundle adjustment in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package ``gbp_poplar_tpu``, which stays the reference:
the same factor graph in the same plane layout, the same per-edge sweep
body, held against the JAX functions on the same inputs by the tests in
tests/test_torch_*.py. This package never imports JAX.

Ported so far: the batch GBP bundle-adjustment solve with the fixed-point
accelerator and the coarse corrector, on the fused and the unfused sweep
pipeline; the Levenberg-Marquardt/Schur oracle (core/gauss_newton.py) and
the intrinsics refit; checkpoints in the JAX package's format; trajectory
evaluation; and the ``ba`` command line with the JAX driver's flags and
defaults (``python -m gbp_poplar_tpu_torch.drivers.ba``). Not yet: SLAM,
sharding over several devices. ROADMAP.md lists what remains.
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
    ``GBPConfig()``, the JAX package's defaults: the fixed-point
    accelerator every 50 sweeps from sweep 150, the fused sweep."""
    from .core import build_graph, gbp, init_state
    from .utils import analysis

    cfg = cfg or GBPConfig()
    graph = build_graph(problem, cfg, device)
    state = init_state(problem, cfg, device)
    final, diag = gbp.solve(state, graph, cfg, n_iters=n_iters)
    cam_mu, lmk_mu = analysis.belief_means(final)
    return cam_mu, lmk_mu, diag.reproj_err.cpu().numpy()
