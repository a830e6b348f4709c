"""What the sequence-level tools share: the ``k=v`` override parser, the
MAP objective split into its robust and prior parts, and the cold GN
oracle.

The JAX package's TUM scripts parse their config overrides in two ways
(``type(cur)(float(v))`` in diagnose_accuracy, exp_ate_grid and
exp_drift_phase; a typed parse that rejects unknown fields in
tune_schedule). ``parse_overrides`` accepts the syntax of both: ints
(``16`` or ``16.0``), floats, bools as ``0``/``false``/``False`` (anything
else is true), and plain strings for the port's ``kernels`` field. The
JAX package's TPU kernel knobs have no meaning here and are refused by
name.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterable

import torch

from ..config import GBPConfig
from ..core import build_graph, gauss_newton as gn, gbp, init_state
from . import resolve_device, timed

# the TUM sequences the scripts default to, smallest first
SEQUENCES = ("fr2robot2", "fr1xyz", "fr1desk")
# the cold GN oracle's LM iterations in diagnose_accuracy, exp_ate_grid and
# exp_drift_phase (float32 cold starts need at least 60)
ORACLE_LM_ITERS = 60
FALSE_WORDS = ("0", "false", "False")
# ROADMAP "Do not port": the JAX package's TPU kernel variants
JAX_ONLY_PREFIXES = ("use_pallas", "pallas_", "table_carry")


def parse_overrides(spec: str | Iterable[str]) -> dict:
    """GBPConfig overrides from ``"k=v,k=v"`` (``"base"`` or ``""``: none)
    or from a list of ``"k=v"`` items. Raises ValueError on a field the
    port's GBPConfig lacks, naming it."""
    if isinstance(spec, str):
        spec = [] if spec in ("", "base") else spec.split(",")
    fields = {f.name for f in dataclasses.fields(GBPConfig)}
    defaults = GBPConfig()
    out = {}
    for kv in filter(None, spec):
        k, _, v = kv.partition("=")
        if k not in fields:
            if k.startswith(JAX_ONLY_PREFIXES):
                raise ValueError(
                    f"{k} is a TPU kernel option of the JAX package; the "
                    "port chooses its kernels with kernels=auto|reference "
                    "and its pipeline with fused=0|1")
            raise ValueError(f"unknown GBPConfig field: {k}")
        cur = getattr(defaults, k)
        if isinstance(cur, bool):
            out[k] = v not in FALSE_WORDS
        elif isinstance(cur, int):
            out[k] = int(float(v))
        elif isinstance(cur, float):
            out[k] = float(v)
        else:
            out[k] = v
    return out


def _planes(x, dev) -> torch.Tensor:
    """[V, d] means (NumPy or torch) as float32 [d, V] planes on dev."""
    return torch.as_tensor(x, dtype=torch.float32, device=dev).T


class MapObjective:
    """The MAP cost of ``problem`` (whitened Huber losses plus the annealed
    Gaussian priors) on its exact-edge graph, built once; the objective
    the GBP fixed point, the polish and the GN oracle share."""

    def __init__(self, problem, cfg: GBPConfig, device):
        from ..drivers.ba import _polish_problem

        self.cfg = cfg
        self.graph, self.priors = _polish_problem(problem, cfg, device)

    def split(self, cam, lmk) -> tuple[float, float]:
        """(robust, prior) parts at cam [C, 6], lmk [L, 3]."""
        dev = self.graph.cam_idx.device
        camT, lmkT = _planes(cam, dev), _planes(lmk, dev)
        loss, _ = gn._residual_sums_planes(camT, lmkT, self.graph,
                                           self.cfg.huber_nstds)
        return (float(loss),
                float(gn._prior_cost_planes(camT, lmkT, self.priors)))

    def __call__(self, cam, lmk) -> float:
        return sum(self.split(cam, lmk))


def gn_oracle(problem, cfg: GBPConfig, n_lm_iters: int = ORACLE_LM_ITERS,
              cg_iters: int = 50, device=None) -> gn.GNResult:
    """The cold GN solve of ``problem`` from its means
    (``gauss_newton.solve_problem``), run once per problem."""
    return gn.solve_problem(problem, cfg, resolve_device(device),
                            n_lm_iters=n_lm_iters, cg_iters=cg_iters)


def warm_up(prob, cfg: GBPConfig, dev) -> float:
    """Seconds, on a card, to build the CUDA kernels and run ``cfg``'s
    solve of ``prob`` once, untimed, through its first accelerator and
    coarse step: the first use of the kernels and of the libraries the
    solve calls, which a tool keeps out of its first timed solve (the JAX
    scripts' times hold the compile). 0 on the CPU, where nothing is
    built."""
    if dev.type != "cuda":
        return 0.0
    from ..ops import _cuda

    def run():
        _cuda.library()
        graph = build_graph(prob, cfg, dev)
        gbp.solve(init_state(prob, cfg, dev), graph, cfg,
                  n_iters=cfg.accel_start + 2 * max(cfg.accel_every, 1))

    return timed(dev, run)[1]
