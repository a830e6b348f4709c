"""Checkpoint / resume of the full solver state, in the JAX package's format.

A checkpoint is one .npz file (``gbp_poplar_tpu/utils/checkpoint.py``):
``state.<field>`` for every GBPState field of the JAX package, optionally
``graph.<field>`` for the plain graph arrays, and ``__meta__``, a JSON
object (format version, the step, the config) stored as bytes. A
checkpoint written by either package resumes in the other; within the port
a resumed solve is bit-exact, since every field round-trips losslessly and
the derived structures (segments) are rebuilt from the same arrays.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..config import GBPConfig

_META_KEY = "__meta__"
_FORMAT_VERSION = 1
# the JAX package's execution knobs (TPU kernel variants), which a JAX
# checkpoint's config carries and the port has no use for
_JAX_ONLY_PREFIXES = ("use_pallas", "pallas_", "table_carry")


def save_checkpoint(path: str, state, graph=None, step: int = 0,
                    cfg: GBPConfig | None = None) -> None:
    """Write the state (and optionally the graph's plain arrays and the
    config) to ``path`` atomically (a temporary file, then a rename)."""
    from ..core.factor_graph import GRAPH_FIELDS, state_to_numpy

    arrays = {f"state.{f}": a for f, a in state_to_numpy(state).items()}
    if graph is not None:
        for f in GRAPH_FIELDS:
            val = getattr(graph, f)
            if val is None:
                continue
            arrays[f"graph.{f}"] = (val.detach().cpu().numpy()
                                    if isinstance(val, torch.Tensor)
                                    else np.asarray(val))
    meta = {"version": _FORMAT_VERSION, "step": int(step)}
    if cfg is not None:
        meta["config"] = dataclasses.asdict(cfg)
    arrays[_META_KEY] = np.frombuffer(json.dumps(meta).encode(),
                                      dtype=np.uint8)
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    # np.savez appends .npz to a path without it
    os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)


def load_checkpoint(path: str, device: torch.device | str):
    """Read (state, graph or None, meta) from a checkpoint of either
    package, the tensors on ``device``."""
    from ..core.factor_graph import graph_from_numpy, state_from_numpy

    with np.load(path) as z:
        meta = json.loads(bytes(z[_META_KEY]).decode())
        if meta.get("version") != _FORMAT_VERSION:
            raise ValueError(
                f"unsupported checkpoint version {meta.get('version')}")
        fields = {k: z[k] for k in z.files if k != _META_KEY}
    state = state_from_numpy(fields, device)
    graph = (graph_from_numpy(fields, device) if "graph.cam_idx" in fields
             else None)
    return state, graph, meta


def load_config(meta: dict) -> GBPConfig | None:
    """The GBPConfig stored in checkpoint metadata, if any. The JAX
    package's TPU execution knobs (``use_pallas``, ``pallas_*``,
    ``table_carry``) are dropped; the port's ``kernels`` and ``fused``
    keep their defaults unless the checkpoint is the port's own."""
    if "config" not in meta:
        return None
    cfg = {k: v for k, v in meta["config"].items()
           if not k.startswith(_JAX_ONLY_PREFIXES)}
    return GBPConfig(**cfg)
