"""Continuous univariate distributions.

Counterpart: ``math_tpu/dists/continuous.py`` (reference:
``stan/math/prim/scal/prob/*_lpdf.hpp``).  Semantics preserved:

- ``*_lpdf(y, ...)`` returns the SUM of elementwise log densities over every
  axis after the first ``batch_ndims`` (0: the scalar the JAX function
  returns; 1: one value per chain).
- ``propto=True`` drops summands via ``include_summand``.
- Invalid parameters yield ``-inf`` with double-where sanitization for
  nan-free gradients.

Ported so far: the densities the eight-schools, GLM, GP and Lotka-Volterra
models use.
"""

from __future__ import annotations

import math

import torch

from math_tpu_torch.special import LOG_SQRT_TWO_PI
from math_tpu_torch.utils.propto import include_summand
from math_tpu_torch.dists._util import bcast, finish, ok_pos, safe

__all__ = ["normal_lpdf", "std_normal_lpdf", "cauchy_lpdf", "inv_gamma_lpdf", "lognormal_lpdf"]


def normal_lpdf(y, mu, sigma, *, propto=False, batch_ndims=0):
    """Ref: normal_lpdf.hpp:36-112."""
    yb, mub, sb = bcast(y, mu, sigma)
    ok = torch.isfinite(yb) & torch.isfinite(mub) & ok_pos(sb)
    s = safe(sb, ok)
    z = (yb - safe(mub, ok, 0.0)) / s
    lp = torch.zeros_like(z)
    if include_summand(propto, y, mu, sigma):
        lp = lp - 0.5 * torch.square(z)
    if include_summand(propto, sigma):
        lp = lp - torch.log(s)
    if include_summand(propto):
        lp = lp - LOG_SQRT_TWO_PI
    return finish(lp, ok, batch_ndims)


def std_normal_lpdf(y, *, propto=False, batch_ndims=0):
    """Ref: std_normal_lpdf.hpp."""
    (yb,) = bcast(y)
    ok = torch.isfinite(yb)
    lp = -0.5 * torch.square(safe(yb, ok, 0.0))
    if include_summand(propto):
        lp = lp - LOG_SQRT_TWO_PI
    return finish(lp, ok, batch_ndims)


def cauchy_lpdf(y, mu, sigma, *, propto=False, batch_ndims=0):
    """Ref: cauchy_lpdf.hpp."""
    yb, mub, sb = bcast(y, mu, sigma)
    ok = torch.isfinite(yb) & torch.isfinite(mub) & ok_pos(sb)
    s = safe(sb, ok)
    z = (yb - safe(mub, ok, 0.0)) / s
    lp = torch.zeros_like(z)
    if include_summand(propto, y, mu, sigma):
        lp = lp - torch.log1p(torch.square(z))
    if include_summand(propto, sigma):
        lp = lp - torch.log(s)
    if include_summand(propto):
        lp = lp - math.log(math.pi)
    return finish(lp, ok, batch_ndims)


def inv_gamma_lpdf(y, alpha, beta, *, propto=False, batch_ndims=0):
    """Ref: inv_gamma_lpdf.hpp."""
    yb, ab, bb = bcast(y, alpha, beta)
    okp = ok_pos(ab) & ok_pos(bb)
    sup = yb > 0
    ok = okp & sup
    a, b, ys = safe(ab, okp), safe(bb, okp), safe(yb, sup)
    lp = torch.zeros_like(yb)
    if include_summand(propto, alpha):
        lp = lp - torch.lgamma(a)
    if include_summand(propto, alpha, beta):
        lp = lp + a * torch.log(b)
    if include_summand(propto, y, alpha):
        lp = lp - (a + 1.0) * torch.log(ys)
    if include_summand(propto, y, beta):
        lp = lp - b / ys
    return finish(lp, ok, batch_ndims)


def lognormal_lpdf(y, mu, sigma, *, propto=False, batch_ndims=0):
    """Ref: lognormal_lpdf.hpp.  ``y <= 0`` lies off the support (-inf); a
    non-finite ``y``, ``mu`` or a bad ``sigma`` gives -inf as well."""
    yb, mub, sb = bcast(y, mu, sigma)
    okp = torch.isfinite(mub) & ok_pos(sb)
    sup = yb > 0
    ok = okp & torch.isfinite(yb)
    ys = safe(yb, sup)
    s = safe(sb, okp)
    z = (torch.log(ys) - safe(mub, okp, 0.0)) / s
    lp = torch.zeros_like(z)
    if include_summand(propto, y, mu, sigma):
        lp = lp - 0.5 * torch.square(z)
    if include_summand(propto, sigma):
        lp = lp - torch.log(s)
    if include_summand(propto, y):
        lp = lp - torch.log(ys)
    if include_summand(propto):
        lp = lp - LOG_SQRT_TWO_PI
    return finish(torch.where(sup, lp, -float("inf")), ok, batch_ndims)
