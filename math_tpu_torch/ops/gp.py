"""Gaussian-process covariance functions.

Counterpart: ``math_tpu/ops/gp.py`` (reference: ``prim/mat/fun/gp_*_cov.hpp``).
The pairwise squared-distance matrix is one product-shaped computation
(``|x|^2 + |y|^2 - 2 x y^T``), computed once per call: ``x`` is data.

Chain-batched by hand: the hyperparameters ``sigma``, ``length_scale``,
``period`` (and ``jitter`` of ``add_diag``) may be Python numbers or tensors
with leading chain axes ``(C,)``; a tensor with chain axes gives ``(C, N, M)``,
a scalar gives ``(N, M)``.  The gradient with respect to the hyperparameters
comes from autograd over the O(N^2) elementwise expression; there is no custom
kernel here, as in the JAX package: the work is O(N^2) beside the O(N^3)
factorization it feeds.

Inputs: x is (N, D) (or (N,) for 1-D inputs); returns (..., N, N) or (..., N, M).
"""

from __future__ import annotations

import math

import torch


def _as2d(x):
    x = torch.as_tensor(x)
    return x[:, None] if x.ndim == 1 else x


def _mat(v):
    """A hyperparameter against the trailing (N, M) axes: chain axes of a
    tensor stay in front."""
    return v[..., None, None] if isinstance(v, torch.Tensor) and v.ndim else v


def _sq(v):
    return torch.square(v) if isinstance(v, torch.Tensor) else v * v


def sq_dists(x, y=None):
    """Pairwise squared distances by the expansion, in the full precision of
    the inputs: a reduced-precision product perturbs d^2 by ~1e-2, which
    destroys the PSD structure downstream factorizations rely on (TF32 stays
    off for float32 products)."""
    x = _as2d(x)
    y = x if y is None else _as2d(y)
    xx = torch.square(x).sum(-1)
    yy = torch.square(y).sum(-1)
    cross = x @ y.mT
    return torch.clamp_min(xx[:, None] + yy[None, :] - 2.0 * cross, 0.0)


def gp_exp_quad_cov(x, sigma, length_scale, y=None):
    """sigma^2 exp(-d^2 / (2 l^2)) (ref: gp_exp_quad_cov.hpp)."""
    d2 = sq_dists(x, y)
    return _mat(_sq(sigma)) * torch.exp(-0.5 * d2 / _mat(_sq(length_scale)))


def gp_exponential_cov(x, sigma, length_scale, y=None):
    """sigma^2 exp(-d / l) (ref: gp_exponential_cov.hpp)."""
    d = torch.sqrt(sq_dists(x, y) + 1e-36)
    return _mat(_sq(sigma)) * torch.exp(-d / _mat(length_scale))


def gp_matern32_cov(x, sigma, length_scale, y=None):
    """ref: gp_matern32_cov.hpp."""
    d = torch.sqrt(sq_dists(x, y) + 1e-36)
    z = math.sqrt(3.0) * d / _mat(length_scale)
    return _mat(_sq(sigma)) * (1.0 + z) * torch.exp(-z)


def gp_matern52_cov(x, sigma, length_scale, y=None):
    """ref: gp_matern52_cov.hpp."""
    d2 = sq_dists(x, y)
    d = torch.sqrt(d2 + 1e-36)
    z = math.sqrt(5.0) * d / _mat(length_scale)
    return _mat(_sq(sigma)) * (1.0 + z + 5.0 * d2 / (3.0 * _mat(_sq(length_scale)))) * torch.exp(-z)


def gp_periodic_cov(x, sigma, length_scale, period, y=None):
    """sigma^2 exp(-2 sin^2(pi d / p) / l^2) (ref: gp_periodic_cov.hpp)."""
    d = torch.sqrt(sq_dists(x, y) + 1e-36)
    s = torch.sin(math.pi * d / _mat(period))
    return _mat(_sq(sigma)) * torch.exp(-2.0 * torch.square(s / _mat(length_scale)))


def gp_dot_prod_cov(x, sigma, y=None):
    """sigma^2 + x y^T (ref: gp_dot_prod_cov.hpp)."""
    x = _as2d(x)
    y = x if y is None else _as2d(y)
    return _mat(_sq(sigma)) + x @ y.mT


def add_diag(k, jitter):
    """K + jitter I (the ubiquitous numerical stabilizer); ``jitter`` may
    carry the chain axes of ``k``."""
    n = k.shape[-1]
    return k + _mat(jitter) * torch.eye(n, dtype=k.dtype, device=k.device)
