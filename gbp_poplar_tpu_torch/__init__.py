"""gbp_poplar_tpu_torch — Gaussian Belief Propagation bundle adjustment in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package ``gbp_poplar_tpu``, which stays the reference:
the same factor graph in the same plane layout, the same per-edge sweep
body, held against the JAX functions on the same inputs by the tests in
tests/test_torch_*.py. This package never imports JAX.

Ported so far: the batch GBP bundle-adjustment solve with the fixed-point
accelerator and the coarse corrector, on the fused and the unfused sweep
pipeline; incremental SLAM (core/slam.py: keyframe insertion, resume by
keyframe); the Levenberg-Marquardt/Schur oracle (core/gauss_newton.py) and
the intrinsics refit; checkpoints in the JAX package's format; trajectory
evaluation; the ``ba`` and ``slam`` command lines with the JAX drivers'
flags and defaults (``python -m gbp_poplar_tpu_torch.drivers.ba``,
``... .drivers.slam``); the library around them: known-bad association
masks (``core.factor_graph.bad_edge_mask`` and the ``bad`` argument of
``core.gbp.reprojection_error`` / ``map_cost``), prior re-centring and
weakening (``core.gbp.recenter_priors``, ``weaken_priors``), the dense
linearisation and transforms (``ops.projection.linearise_factor``,
``ops.lie.tranf_*``, ``ops.linalg``), KL and message traces
(``utils.analysis``), edge dumps (``utils.debug``), the native BAL
parser (``native/balio.cpp``), and sharding over the ranks of a
``torch.distributed`` group (``parallel``: the edge-sharded solve and
map-partitioned SLAM, the drivers' ``--devices N``); the entry points of
the JAX package's ``__graft_entry__.py`` (``entry``: one sweep on a tiny
problem, ``dryrun_multichip``) and its sequence-free scripts (``tools``:
``validate_scale``, ``memory_ledger``, ``profile_sweep``, each run as
``python -m gbp_poplar_tpu_torch.tools.<name>``, on the CPU with
``GBP_PLATFORM=cpu``). Not yet: a benchmark. ROADMAP.md lists what
remains.
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


def solve_slam(problem, cfg: GBPConfig | None = None,
               iters_between_kfs: int = 700, av_depth: float = 1.0,
               device: torch.device | str = "cuda"):
    """One-call incremental SLAM (keyframe at a time) on ``device``.

    Returns (cam_means [C,6], lmk_means [L,3], per-segment reprojection
    error [n_keyframes-1, iters_between_kfs]) as NumPy arrays. ``cfg``
    defaults to the JAX package's: ``GBPConfig()`` with drift
    relinearisation and Lambda damping."""
    import dataclasses

    from .core import build_graph, init_state, slam
    from .utils import analysis, flags as flags_lib

    cfg = cfg or dataclasses.replace(
        GBPConfig(), relin_drift_threshold=0.05, lambda_damping=True)
    graph = build_graph(problem, cfg, device)
    flags = flags_lib.create_flags(problem, cfg.steps)
    state = init_state(problem, cfg, device, flags=flags)
    result = slam.solve_slam(state, graph, cfg,
                             iters_between_kfs=iters_between_kfs,
                             av_depth=av_depth)
    cam_mu, lmk_mu = analysis.belief_means(result.state)
    return cam_mu, lmk_mu, result.reproj_err
