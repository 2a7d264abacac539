"""Scalar special functions (counterpart: ``math_tpu/special``).

Only the constants and functions the ported densities use so far; the
function library follows with the densities that need it.
"""

from math_tpu_torch.special.basic import LOG_SQRT_TWO_PI, LOG_TWO, LOG_TWO_PI, log1m_exp  # noqa: F401
