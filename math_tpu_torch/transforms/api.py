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

from math_tpu_torch.transforms import matrix as _m
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
class UpperBound(Transform):
    ub: float = 0.0

    def constrain(self, x):
        return _s.ub_constrain(x, self.ub)

    def constrain_lp(self, x, *, batch_ndims=0):
        return _s.ub_constrain_lp(x, self.ub, batch_ndims=batch_ndims)

    def free(self, y):
        return _s.ub_free(y, self.ub)


@dataclasses.dataclass(frozen=True)
class Bounded(Transform):
    lb: float = 0.0
    ub: float = 1.0

    def constrain(self, x):
        return _s.lub_constrain(x, self.lb, self.ub)

    def constrain_lp(self, x, *, batch_ndims=0):
        return _s.lub_constrain_lp(x, self.lb, self.ub, batch_ndims=batch_ndims)

    def free(self, y):
        return _s.lub_free(y, self.lb, self.ub)


@dataclasses.dataclass(frozen=True)
class OffsetMultiplier(Transform):
    offset: float = 0.0
    multiplier: float = 1.0

    def constrain(self, x):
        return _s.offset_multiplier_constrain(x, self.offset, self.multiplier)

    def constrain_lp(self, x, *, batch_ndims=0):
        return _s.offset_multiplier_constrain_lp(x, self.offset, self.multiplier, batch_ndims=batch_ndims)

    def free(self, y):
        return _s.offset_multiplier_free(y, self.offset, self.multiplier)


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


@dataclasses.dataclass(frozen=True)
class Simplex(Transform):
    """shape = (K,); unconstrained dimension K-1."""

    @property
    def unconstrained_shape(self):
        return (self.shape[-1] - 1,) if self.shape else ()

    def constrain(self, x):
        return _v.simplex_constrain(x)

    def constrain_lp(self, x, *, batch_ndims=0):
        return _v.simplex_constrain_lp(x, batch_ndims=batch_ndims)

    def free(self, y):
        return _v.simplex_free(y)


@dataclasses.dataclass(frozen=True)
class UnitVector(Transform):
    def constrain(self, x):
        return _v.unit_vector_constrain(x)

    def constrain_lp(self, x, *, batch_ndims=0):
        return _v.unit_vector_constrain_lp(x, batch_ndims=batch_ndims)

    def free(self, y):
        return _v.unit_vector_free(y)


@dataclasses.dataclass(frozen=True)
class CholeskyCorr(Transform):
    """shape = (K, K) Cholesky factor of a correlation matrix."""

    @property
    def k(self):
        return self.shape[-1]

    @property
    def unconstrained_shape(self):
        return (self.k * (self.k - 1) // 2,)

    def constrain(self, x):
        return _m.cholesky_corr_constrain(x, self.k)

    def constrain_lp(self, x, *, batch_ndims=0):
        return _m.cholesky_corr_constrain_lp(x, self.k, batch_ndims=batch_ndims)

    def free(self, y):
        return _m.cholesky_corr_free(y, self.k)


@dataclasses.dataclass(frozen=True)
class CorrMatrix(Transform):
    @property
    def k(self):
        return self.shape[-1]

    @property
    def unconstrained_shape(self):
        return (self.k * (self.k - 1) // 2,)

    def constrain(self, x):
        return _m.corr_matrix_constrain(x, self.k)

    def constrain_lp(self, x, *, batch_ndims=0):
        return _m.corr_matrix_constrain_lp(x, self.k, batch_ndims=batch_ndims)

    def free(self, y):
        return _m.corr_matrix_free(y, self.k)


@dataclasses.dataclass(frozen=True)
class CovMatrix(Transform):
    @property
    def k(self):
        return self.shape[-1]

    @property
    def unconstrained_shape(self):
        return (self.k * (self.k + 1) // 2,)

    def constrain(self, x):
        return _m.cov_matrix_constrain(x, self.k)

    def constrain_lp(self, x, *, batch_ndims=0):
        return _m.cov_matrix_constrain_lp(x, self.k, batch_ndims=batch_ndims)

    def free(self, y):
        return _m.cov_matrix_free(y, self.k)


@dataclasses.dataclass(frozen=True)
class CholeskyCov(Transform):
    """shape = (M, N) lower-trapezoid Cholesky factor with positive diagonal."""

    @property
    def unconstrained_shape(self):
        m, n = self.shape[-2], self.shape[-1]
        return (n * (n + 1) // 2 + (m - n) * n,)

    def constrain(self, x):
        return _m.cholesky_factor_constrain(x, self.shape[-2], self.shape[-1])

    def constrain_lp(self, x, *, batch_ndims=0):
        return _m.cholesky_factor_constrain_lp(x, self.shape[-2], self.shape[-1], batch_ndims=batch_ndims)

    def free(self, y):
        return _m.cholesky_factor_free(y, self.shape[-2], self.shape[-1])
