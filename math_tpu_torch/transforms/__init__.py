"""Constraint transforms (counterpart: ``math_tpu/transforms``)."""

from math_tpu_torch.transforms.scalar import (  # noqa: F401
    identity_constrain,
    identity_free,
    lb_constrain,
    lb_constrain_lp,
    lb_free,
)
from math_tpu_torch.transforms.vector import (  # noqa: F401
    ordered_constrain,
    ordered_constrain_lp,
    ordered_free,
    positive_ordered_constrain,
    positive_ordered_constrain_lp,
    positive_ordered_free,
)
from math_tpu_torch.transforms.api import Identity, LowerBound, Ordered, PositiveOrdered, Transform  # noqa: F401
