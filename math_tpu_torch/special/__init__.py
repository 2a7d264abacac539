"""Scalar special functions (counterpart: ``math_tpu/special``).

Only the constants the ported densities use so far; the function library
follows with the densities that need it.
"""

import math

LOG_TWO = math.log(2.0)
LOG_TWO_PI = math.log(2.0 * math.pi)
LOG_SQRT_TWO_PI = 0.5 * math.log(2.0 * math.pi)
