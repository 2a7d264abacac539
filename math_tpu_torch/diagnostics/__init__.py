"""Convergence diagnostics (counterpart: ``math_tpu/diagnostics``)."""

from math_tpu_torch.diagnostics.convergence import (  # noqa: F401
    ess,
    ess_bulk,
    ess_tail,
    rhat,
    split_rhat,
    summary,
)
