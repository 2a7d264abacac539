"""Constraint transforms (counterpart: ``math_tpu/transforms``)."""

from math_tpu_torch.transforms.scalar import (  # noqa: F401
    identity_constrain,
    identity_free,
    lb_constrain,
    lb_constrain_lp,
    lb_free,
)
from math_tpu_torch.transforms.api import Identity, LowerBound, Transform  # noqa: F401
