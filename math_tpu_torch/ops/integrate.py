"""1-D quadrature with parameter gradients.

Counterpart: ``math_tpu/ops/integrate.py``.  Reference: ``integrate_1d``
(Boost double-exponential quadrature picked by endpoint finiteness,
``prim/arr/functor/integrate_1d.hpp:64-111``; gradient computed as the
quadrature of d f / d theta via nested AD,
``rev/arr/functor/integrate_1d.hpp:31-50``).

Fixed-order tanh-sinh (finite intervals), exp-sinh (half-infinite) and
sinh-sinh (doubly infinite) nodes, 7 levels (step 2^-7 over |t| <= 6) as the
JAX package builds them: the tanh-sinh set from ``special/incbeta.py``'s
builder, the exp-sinh set from ``special/bessel.py``'s, the sinh-sinh set
here.  The integral is a fixed weighted sum of integrand evaluations, so
autograd (and every ``torch.func`` transform) differentiates straight through
it: "gradient of the quadrature" and "quadrature of the gradient" coincide,
which is the identity the reference implements by hand.  In a dtype narrower
than float64 the far nodes whose square overflows it are dropped (``_nodes``):
their terms are 0 in float64 too, and an inf there would give NaN.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from math_tpu_torch.config import get_config
from math_tpu_torch.special.bessel import _exp_sinh
from math_tpu_torch.special.incbeta import _ts_nodes
from math_tpu_torch.utils.batch import plain_tensor

_LEVELS = 7
_SPAN = 6.0


def _tanh_sinh_nodes():
    """Nodes and weights for int_{-1}^{1} g(x) dx."""
    s, w = _ts_nodes(levels=_LEVELS, span=_SPAN)  # on (0, 1)
    return 2.0 * s - 1.0, 2.0 * w


def _exp_sinh_nodes():
    """Nodes and weights for int_0^inf g(x) dx."""
    x, w = _exp_sinh(_LEVELS, _SPAN)
    keep = np.isfinite(x) & np.isfinite(w) & (x > 0) & (w > 1e-300) & (x < 1e300)
    return x[keep], w[keep]


def _sinh_sinh_nodes():
    """Nodes and weights for int_{-inf}^{inf} g(x) dx."""
    h = 0.5**_LEVELS
    kmax = int(np.ceil(_SPAN / h))
    t = np.arange(-kmax, kmax + 1) * h
    with np.errstate(over="ignore"):
        x = np.sinh(0.5 * np.pi * np.sinh(t))
        w = h * 0.5 * np.pi * np.cosh(t) * np.cosh(0.5 * np.pi * np.sinh(t))
    keep = np.isfinite(x) & np.isfinite(w) & (np.abs(x) < 1e300) & (w < 1e300)
    return x[keep], w[keep]


_TS_X, _TS_W = _tanh_sinh_nodes()
_ES_X, _ES_W = _exp_sinh_nodes()
_SS_X, _SS_W = _sinh_sinh_nodes()
_NODES = {}


def _nodes(kind, dtype, device):
    """``(x, w)`` of one node set as tensors of ``dtype`` on ``device``, made
    once.  float64 keeps the reference's set; a narrower dtype drops the
    nodes whose square overflows it (|x| past sqrt(max), ~1.8e19 in float32:
    a Gaussian's exponent there is inf, and its derivative 0 * inf) and the
    weights it cannot hold."""
    key = (kind, dtype, str(device))
    if key not in _NODES:
        x, w = {"ts": (_TS_X, _TS_W), "es": (_ES_X, _ES_W), "ss": (_SS_X, _SS_W)}[kind]
        big = float(torch.finfo(dtype).max)
        keep = (np.abs(x) < (math.inf if dtype == torch.float64 else math.sqrt(big))) & (w < big)
        _NODES[key] = tuple(plain_tensor(torch.as_tensor(v[keep], dtype=dtype, device=device)) for v in (x, w))
    return _NODES[key]


def _dtype_device(theta, device):
    tensors = [t for t in (theta if isinstance(theta, (tuple, list)) else (theta,)) if isinstance(t, torch.Tensor)]
    floats = [t for t in tensors if t.is_floating_point()]
    dtype = floats[0].dtype if floats else torch.float64
    if device is None:
        device = tensors[0].device if tensors else get_config().device
    return dtype, device


def integrate_1d(f, a, b, theta, device=None):
    """integral_a^b f(x, theta) dx; ``a`` / ``b`` may be +-inf (Python floats).

    Endpoint-finiteness dispatch mirrors integrate_1d.hpp:64-111.
    ``f(x, theta)`` must accept a vector of nodes ``x``.  The nodes take the
    dtype and device of ``theta`` (a tensor, or a tuple of them); with no
    tensor in ``theta``, float64 on ``device`` (the card unless
    ``device="cpu"``)."""
    dtype, device = _dtype_device(theta, device)
    a_inf = not isinstance(a, torch.Tensor) and a == -math.inf
    b_inf = not isinstance(b, torch.Tensor) and b == math.inf
    if a_inf and b_inf:
        x, w = _nodes("ss", dtype, device)
        return torch.sum(w * f(x, theta))
    if b_inf:
        x, w = _nodes("es", dtype, device)
        return torch.sum(w * f(a + x, theta))
    if a_inf:
        x, w = _nodes("es", dtype, device)
        return torch.sum(w * f(b - x, theta))
    x, w = _nodes("ts", dtype, device)
    mid = 0.5 * (a + b)
    half = 0.5 * (b - a)
    return half * torch.sum(w * f(mid + half * x, theta))
