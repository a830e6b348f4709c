"""Tools around the solver: the port's counterparts of the JAX package's
sequence-free scripts, each a module with a function that returns its
numbers as a dict and a ``main(argv)`` for ``python -m``:

  - ``validate_scale``: GBP against the Levenberg-Marquardt oracle at
    1M+ edges (MAP cost ratios, ATE, the LM preconditioner's census);
  - ``memory_ledger``: the device memory of every graph and state tensor
    by field, and the peak per stage of a solve;
  - ``profile_sweep``: device time per kernel inside ``run_gbp`` by
    ``torch.profiler``, and the device's busy share.

Each runs on the drivers' device (``drivers.common.select_device``:
``cuda:0``, the CPU only under ``GBP_PLATFORM=cpu``, an error without a
card) unless the caller passes ``device``.
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, or the drivers' device when None."""
    if device is None:
        from ..drivers.common import select_device
        return select_device()
    return torch.device(device)


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_label(dev: torch.device) -> str:
    """What a measurement ran on: nvidia-smi's ``name, power.limit`` of a
    card (its torch name if nvidia-smi cannot be run), or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(dev.index or 0)],
            capture_output=True, text=True, timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return torch.cuda.get_device_name(dev)
