"""Multivariate distributions.

Counterpart: ``math_tpu/dists/multivariate.py`` (reference:
``stan/math/prim/mat/prob/*``).  Ported so far: the multi-normal pair the GP
path uses.  Conventions:

- ``y`` may carry leading batch dimensions; the result is the summed
  log-density over the batch (matching Stan's vectorized overloads).
- ``batch_ndims=1``: the first axis of every tensor argument that has more
  axes than its event shape (``y``, ``mu``: one; ``sigma``, ``L``: two) is the
  chain axis, and the result is one value per chain.
- ``multi_normal_lpdf`` factorizes through ``ops.cholesky.spd_solve_logdiag``
  (the blocked factorization with the hand-written block kernel) at every
  size: the port has no size threshold.
"""

from __future__ import annotations

import torch

from math_tpu_torch.dists._util import as_tensors
from math_tpu_torch.ops.cholesky import spd_solve_logdiag
from math_tpu_torch.special import LOG_TWO_PI
from math_tpu_torch.utils.propto import include_summand

__all__ = ["multi_normal_cholesky_lpdf", "multi_normal_lpdf"]


def _rhs(y, mu, mat, batch_ndims):
    """``(diff^T (lead..., k, nbatch), nbatch, lead)``: the residuals as the
    columns of one right-hand side per chain."""
    if batch_ndims not in (0, 1):
        raise ValueError("multi_normal: batch_ndims must be 0 or 1")
    k = mat.shape[-1]
    diff = y - mu  # (..., k)
    if batch_ndims:
        if diff.ndim == 1:  # shared y and mu: the chain axis comes from the matrix
            if mat.ndim < 3:
                raise ValueError("multi_normal: batch_ndims=1 but no argument has a chain axis")
            diff = diff.expand(mat.shape[0], 1, k)
        else:
            diff = diff.reshape(diff.shape[0], -1, k)
        lead = tuple(diff.shape[:1])
    else:
        diff = diff.reshape(-1, k)
        lead = ()
    return diff.mT, diff.shape[-2], lead


def _assemble(z, slogdiag, nbatch, k, propto, y, mu, mat):
    lp = torch.zeros_like(slogdiag)
    if include_summand(propto, y, mu, mat):
        lp = lp - 0.5 * torch.square(z).sum((-2, -1))
    if include_summand(propto, mat):
        lp = lp - nbatch * slogdiag  # = -nbatch/2 * log|Sigma|
    if include_summand(propto):
        lp = lp - 0.5 * k * nbatch * LOG_TWO_PI
    return lp


def multi_normal_cholesky_lpdf(y, mu, L, *, propto=False, batch_ndims=0):
    """MVN with Cholesky-factored covariance (ref: multi_normal_cholesky_lpdf.hpp)."""
    y_t, mu_t, L_t = as_tensors(y, mu, L)
    rhs, nbatch, lead = _rhs(y_t, mu_t, L_t, batch_ndims)
    z = torch.linalg.solve_triangular(L_t, rhs, upper=False)
    slogdiag = torch.log(torch.diagonal(L_t, dim1=-2, dim2=-1)).sum(-1).expand(lead)
    return _assemble(z, slogdiag, nbatch, L_t.shape[-1], propto, y, mu, L)


def multi_normal_lpdf(y, mu, sigma, *, propto=False, batch_ndims=0):
    """MVN density (ref: multi_normal_lpdf.hpp).  The O(k^3) solve and
    log-determinant come from one blocked factorization
    (``ops.cholesky.spd_solve_logdiag``)."""
    y_t, mu_t, sigma_t = as_tensors(y, mu, sigma)
    rhs, nbatch, lead = _rhs(y_t, mu_t, sigma_t, batch_ndims)
    if sigma_t.ndim == 2 and lead:
        sigma_t = sigma_t.expand(lead + sigma_t.shape)
    z, slogdiag = spd_solve_logdiag(sigma_t, rhs)
    return _assemble(z, slogdiag, nbatch, sigma_t.shape[-1], propto, y, mu, sigma)
