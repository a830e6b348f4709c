"""Sums over the ranks of a ``torch.distributed`` process group.

The sharded solvers (parallel/sharding.py, parallel/map_sharding.py) run
the single-device code on each rank with a ``group`` argument; wherever the
JAX package ``psum``s over its mesh axis, the port calls one of these, one
collective for all the tensors of that site. Every rank issues the same
calls in the same order: the loop structure is decided on the host from
integers every rank shares, never from a value a rank computed alone.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_sum(group, tensors, dtype: torch.dtype | None = None):
    """Each tensor summed over the ranks of ``group``, in one ``all_reduce``
    of a fresh buffer (the inputs are not modified). With ``dtype`` the sum
    runs in that type and each result is cast back to its own: the scalar
    statistics and costs go through float64, so counts stay exact and a
    float32 value is unchanged at one rank."""
    dtype = dtype or tensors[0].dtype
    buf = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
    dist.all_reduce(buf, group=group)
    out, o = [], 0
    for t in tensors:
        out.append(buf[o:o + t.numel()].view(t.shape).to(t.dtype))
        o += t.numel()
    return out


def all_max(group, x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the ranks of ``group``."""
    buf = x.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=group)
    return buf
