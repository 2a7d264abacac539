"""Owen's T function (reference: ``prim/scal/fun/owens_t.hpp``).

Counterpart: ``math_tpu/special/owens_t.py``.  The reference delegates to
``boost::math::owens_t``; here we evaluate the defining integral

    T(h, a) = 1/(2*pi) * int_0^a exp(-h^2 (1 + x^2)/2) / (1 + x^2) dx

with fixed-order Gauss-Legendre quadrature after reducing to |a| <= 1 via
the classical identity

    T(h, a) = Phi(h)/2 + Phi(a h)/2 - Phi(h) Phi(a h) - T(a h, 1/a),  a > 0.

The integrand is smooth on [0, 1], so 40 nodes give ~1e-15 relative
accuracy; the node table is built with numpy at import.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from math_tpu_torch.special.basic import _f

__all__ = ["owens_t"]

_NODES, _WEIGHTS = np.polynomial.legendre.leggauss(40)


def _owens_t_unit(h, a):
    """T(h, a) for |a| <= 1 by direct quadrature on [0, a]."""
    nodes = torch.as_tensor(_NODES, dtype=h.dtype, device=h.device)
    weights = torch.as_tensor(_WEIGHTS, dtype=h.dtype, device=h.device)
    h = h[..., None]
    a = a[..., None]
    x = 0.5 * a * (nodes + 1.0)  # map [-1,1] -> [0,a]
    w = 0.5 * a * weights
    integrand = torch.exp(-0.5 * h * h * (1.0 + x * x)) / (1.0 + x * x)
    return torch.sum(w * integrand, -1) / (2.0 * math.pi)


def owens_t(h, a):
    h, a = torch.broadcast_tensors(*_f(h, a))
    # Symmetries: T(h,a) = T(-h,a) = -T(h,-a)
    sign = torch.sign(a)
    habs, aabs = torch.abs(h), torch.abs(a)

    small = aabs <= 1.0
    a_small = torch.where(small, aabs, 1.0)
    t_small = _owens_t_unit(habs, a_small)

    # a > 1: T(h,a) = Phi(h)/2 + Phi(ah)/2 - Phi(h)Phi(ah) - T(ah, 1/a)
    a_big = torch.where(small, 2.0, aabs)
    ah = a_big * habs
    ndtr_h, ndtr_ah = torch.special.ndtr(habs), torch.special.ndtr(ah)
    t_big = 0.5 * ndtr_h + 0.5 * ndtr_ah - ndtr_h * ndtr_ah - _owens_t_unit(ah, 1.0 / a_big)
    return sign * torch.where(small, t_small, t_big)
