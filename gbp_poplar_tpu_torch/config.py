"""Solver configuration.

The algorithm fields are those of ``gbp_poplar_tpu.config.GBPConfig`` and
``InitConfig``, with the same names, defaults and meaning (see that module
for the reference citations and the reasoning behind each default), for
the batch solve and for incremental SLAM alike (``iters_between_kfs``,
and the depth guard's ``relin_behind_camera`` and
``behind_camera_rescue_iters``, which the slam driver sets). The
JAX package's execution knobs (``use_pallas``, ``pallas_*``,
``table_carry``) describe TPU kernel variants; here they are replaced by
two: ``kernels`` (CUDA kernels or plain versions) and ``fused`` (the
counterpart of ``pallas_fused``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GBPConfig:
    """Hyper-parameters of the GBP bundle-adjustment solver."""

    # --- measurement model ---
    meas_var: float = 4.0              # px^2
    huber_nstds: float = 2.5

    # --- message damping / relinearisation state machine ---
    eta_damping: float = 0.4
    num_undamped_iters: int = 8
    dmu_threshold: float = 3e-3
    min_linear_iters: int = 10
    iters_before_damping: int = 15

    # --- stability extensions (see gbp_poplar_tpu/config.py) ---
    # damp Lambda messages with the same factor as eta
    lambda_damping: bool = True
    # also relinearise when the mean drifted this far from the stored
    # linearisation point; <= 0 disables
    relin_drift_threshold: float = 0.05
    # reset damping to 0 for freshly relinearised factors
    reset_damping_on_relin: bool = True
    # relinearise every active factor every sweep
    relin_every_iter: bool = False

    # --- prior annealing ---
    steps: int = 5
    prior_std_weaker_factor: float = 100.0
    first_cam_prior_std: float = 0.01
    num_anchor_cams: int = 2

    # --- solver loop ---
    n_iters: int = 1500
    iters_between_kfs: int = 700       # SLAM: sweeps per keyframe segment

    # --- fixed-point acceleration and coarse correction ---
    # Every accel_every anneal-free sweeps the belief means are extrapolated
    # along their chunk-averaged displacement (core/gbp._accel_step); <= 0
    # disables. With coarse_groups > 0 each live accelerator step is
    # followed by a rigid correction of that many keyframe groups
    # (core/gbp._coarse_step, core/coarse.py); like the JAX package, it
    # never runs with accel_every <= 0. The defaults stay those of the JAX
    # package so that one config means the same solve in both packages.
    accel_every: int = 50
    accel_start: int = 150
    accel_max_rate: float = 0.98
    accel_max_step: float = 0.5
    coarse_groups: int = 0

    # --- robustness guards ---
    cavity_jitter: float = 1e-6
    min_depth: float = 0.05
    relin_behind_camera: bool = True
    behind_camera_rescue_iters: int = 0

    # --- execution ---
    # Pad the edge axis to a multiple of this with inert inactive edges.
    edge_pad_multiple: int = 1024
    # "auto": the hand-written CUDA kernels for CUDA tensors and their plain
    # PyTorch versions for CPU tensors. "reference": the plain versions on
    # any device (tests and chip_smoke.py compare the two on the card).
    kernels: str = "auto"
    # The sweep pipeline, the counterpart of the JAX package's pallas_fused.
    # True: belief tables, then the fused per-edge sweep that reads them by
    # index (H2 + H1). False: the unfused pipeline, beliefs gathered per
    # edge, then the per-edge sweep with per-edge mean solves (H5 + H4).
    # Both end in the belief reduction (H3) and give the same result. The
    # JAX "auto" means "fused when the graph has fused-sweep windows"; the
    # fused kernel here gathers by index and needs no windows, so "auto"
    # and True are the same thing and only the two booleans exist.
    fused: bool = True

    def __post_init__(self):
        if self.kernels not in ("auto", "reference"):
            raise ValueError(
                f"kernels must be 'auto' or 'reference', not {self.kernels!r}")

    @property
    def relin_count_threshold(self) -> int:
        """damping_count must exceed this for relinearisation."""
        return self.min_linear_iters - self.num_undamped_iters


@dataclasses.dataclass(frozen=True)
class InitConfig:
    """Problem initialisation options."""

    trans_noise: float = 0.0
    rot_noise: float = 0.0             # degrees std
    lmk_noise: float = 0.0
    av_depth_on: bool = False
    av_depth: float = 1.0
    seed: int = 0
