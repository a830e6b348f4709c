"""Host-side I/O, flags, priors, analysis and evaluation helpers."""
