"""Diagnostics: convergence, PSIS, PSIS-LOO / WAIC and simulation-based
calibration (counterpart: ``math_tpu/diagnostics``)."""

from math_tpu_torch.diagnostics.convergence import (  # noqa: F401
    ess,
    ess_bulk,
    ess_tail,
    rhat,
    split_rhat,
    summary,
)
from math_tpu_torch.diagnostics.psis import gpd_fit, psis_smooth  # noqa: F401
from math_tpu_torch.diagnostics.sbc import SbcResult, sbc_rank, sbc_uniformity  # noqa: F401
from math_tpu_torch.diagnostics.loo import (  # noqa: F401
    LooComparison,
    LooResult,
    WaicResult,
    loo,
    loo_compare,
    pointwise_log_lik,
    waic,
)
