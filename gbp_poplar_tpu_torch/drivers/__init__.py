"""Command-line drivers (``python -m gbp_poplar_tpu_torch.drivers.ba``)."""
