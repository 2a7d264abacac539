"""Object API over the free-function transforms, for the model layer.

Counterpart: ``math_tpu/transforms/api.py``.  A ``Transform`` maps an
unconstrained real block of shape ``unconstrained_shape`` to a constrained
value of shape ``shape`` and knows its log|det J|.  Blocks may carry leading
chain axes; ``constrain_lp(x, batch_ndims=b)`` then returns one log-Jacobian
per chain.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from math_tpu_torch.transforms import scalar as _s
from math_tpu_torch.transforms import vector as _v


@dataclasses.dataclass(frozen=True)
class Transform:
    """Base: identity over an arbitrary shape."""

    shape: Tuple[int, ...] = ()

    @property
    def unconstrained_shape(self) -> Tuple[int, ...]:
        return self.shape

    def constrain(self, x):
        return x

    def constrain_lp(self, x, *, batch_ndims=0):
        return x, torch.zeros(x.shape[:batch_ndims], dtype=x.dtype, device=x.device)

    def free(self, y):
        return y


class Identity(Transform):
    pass


@dataclasses.dataclass(frozen=True)
class LowerBound(Transform):
    lb: float = 0.0

    def constrain(self, x):
        return _s.lb_constrain(x, self.lb)

    def constrain_lp(self, x, *, batch_ndims=0):
        return _s.lb_constrain_lp(x, self.lb, batch_ndims=batch_ndims)

    def free(self, y):
        return _s.lb_free(y, self.lb)


@dataclasses.dataclass(frozen=True)
class Ordered(Transform):
    def constrain(self, x):
        return _v.ordered_constrain(x)

    def constrain_lp(self, x, *, batch_ndims=0):
        return _v.ordered_constrain_lp(x, batch_ndims=batch_ndims)

    def free(self, y):
        return _v.ordered_free(y)


@dataclasses.dataclass(frozen=True)
class PositiveOrdered(Transform):
    def constrain(self, x):
        return _v.positive_ordered_constrain(x)

    def constrain_lp(self, x, *, batch_ndims=0):
        return _v.positive_ordered_constrain_lp(x, batch_ndims=batch_ndims)

    def free(self, y):
        return _v.positive_ordered_free(y)
