"""Plane algebra, measurement model and the hand-written CUDA kernels.

Kernel modules (sweep_kernel, table_kernel, reduce_kernel) build and load
their CUDA library only when a CUDA tensor first reaches them."""

from . import lie, linalg, planes, projection  # noqa: F401
