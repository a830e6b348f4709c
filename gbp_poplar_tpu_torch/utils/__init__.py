"""Host-side I/O, flags, priors, analysis, debug and evaluation helpers."""

from . import (analysis, balio, checkpoint, debug, evaluation,  # noqa: F401
               flags, priors, trace)
