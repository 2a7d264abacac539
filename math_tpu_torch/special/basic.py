"""Elementary special functions (counterpart: ``math_tpu/special/basic.py``).

Only what the ported densities use so far: the constants and ``log1m_exp``.
"""

from __future__ import annotations

import math

import torch

LOG_TWO = math.log(2.0)
LOG_TWO_PI = math.log(2.0 * math.pi)
LOG_SQRT_TWO_PI = 0.5 * math.log(2.0 * math.pi)


def log1m_exp(x):
    """log(1 - exp(x)) for x < 0, stable both near 0 and -inf; NaN for x >= 0.

    Ref: ``log1m_exp.hpp`` -- switchover at -log(2) between
    ``log(-expm1(x))`` and ``log1p(-exp(x))``.
    """
    # Clamp the argument fed to each branch so the unselected branch never
    # produces nan (which would poison gradients through torch.where).
    hi_side = x > -LOG_TWO
    safe_hi = torch.where(hi_side, x, -LOG_TWO)
    safe_lo = torch.where(hi_side, -LOG_TWO, x)
    out = torch.where(hi_side, torch.log(-torch.expm1(safe_hi)), torch.log1p(-torch.exp(safe_lo)))
    return torch.where(x < 0, out, math.nan)
