"""Discrete univariate distributions.

Counterpart: ``math_tpu/dists/discrete.py`` (reference:
``prim/scal/prob/neg_binomial_2_log_lpmf.hpp`` and the categorical / ordered
families of ``prim/mat/prob``).  Same conventions as ``continuous.py``: the
sum over every axis after the first ``batch_ndims``, ``propto`` pruning by
``include_summand``, ``-inf`` for invalid parameters or off-support outcomes
with sanitized inputs so gradients stay nan-free.

Ported so far: the densities the GLM likelihoods of ``dists/glm.py`` use.
Outcomes ``y`` are data (numpy arrays or tensors); categories are 1-based.
"""

from __future__ import annotations

import numpy as np
import torch

from math_tpu_torch.special import log1m_exp
from math_tpu_torch.utils.propto import include_summand
from math_tpu_torch.dists._util import as_tensors, bcast, finish, ok_ordered, ok_pos, safe

__all__ = ["neg_binomial_2_log_lpmf", "categorical_logit_lpmf", "ordered_logistic_lpmf"]


def _softplus(t):
    # not F.softplus: its threshold=20 switch differs from the exact form
    return torch.logaddexp(torch.zeros_like(t), t)


def _int_ok(y):
    return torch.isfinite(y) & (y == torch.round(y))


def _category_index(y, device):
    """0-based int64 categories of 1-based outcomes (truncated as JAX's int32 cast)."""
    if isinstance(y, torch.Tensor):
        return y.to(device=device, dtype=torch.int64) - 1
    return torch.as_tensor(np.asarray(y).astype(np.int64), device=device) - 1


def _lead_axes(t, batch_ndims, event_ndims):
    """``t`` (batch..., rest..., last) with singleton axes inserted after the
    batch axes so that ``rest`` lines up with an event of ``event_ndims`` axes."""
    pad = event_ndims - (t.ndim - 1 - batch_ndims)
    if pad <= 0:
        return t
    return t.reshape(t.shape[:batch_ndims] + (1,) * pad + t.shape[batch_ndims:])


def _take_last(table, idx):
    """``table[..., idx]`` for an index tensor broadcast against the leading axes."""
    lead = torch.broadcast_shapes(table.shape[:-1], idx.shape)
    table = table.expand(lead + table.shape[-1:])
    return torch.gather(table, -1, idx.expand(lead)[..., None])[..., 0]


# --- neg_binomial_2_log (ref: neg_binomial_2_log_lpmf.hpp) ------------------


def neg_binomial_2_log_lpmf(y, eta, phi, *, propto=False, batch_ndims=0):
    """Log-mean parameterization, fused stable (ref: neg_binomial_2_log_lpmf.hpp)."""
    yb, eb, pb = bcast(y, eta, phi)
    okp = torch.isfinite(eb) & ok_pos(pb)
    sup = (yb >= 0) & _int_ok(yb)
    ok = okp & sup
    e, p = safe(eb, okp, 0.0), safe(pb, okp)
    ys = torch.clamp(yb, min=0.0)
    log_phi = torch.log(p)
    lse = torch.logaddexp(e, log_phi)
    lp = torch.zeros_like(eb)
    if include_summand(propto, y, phi):
        lp = lp + torch.lgamma(ys + p) - torch.lgamma(p)
    if include_summand(propto, y):
        lp = lp - torch.lgamma(ys + 1.0)
    if include_summand(propto, y, eta, phi):
        lp = lp + ys * (e - lse)
    if include_summand(propto, eta, phi):
        lp = lp + p * (log_phi - lse)
    return finish(lp, ok, batch_ndims)


# --- categorical / ordered (ref: prim/mat/prob/categorical*, ordered*) ------


def categorical_logit_lpmf(y, beta, *, propto=False, batch_ndims=0):
    """Fused log-softmax lookup (ref: categorical_logit_lpmf.hpp).  ``beta``
    is ``(batch..., [event...,] K)``; ``y`` in 1..K over the event."""
    (beta,) = as_tensors(beta)
    yi = _category_index(y, beta.device)
    k = beta.shape[-1]
    ok = (yi >= 0) & (yi < k)
    logsm = _lead_axes(torch.log_softmax(beta, dim=-1), batch_ndims, yi.ndim)
    lp = _take_last(logsm, torch.clamp(yi, 0, k - 1))
    return finish(lp, ok, batch_ndims)


def _log_sigmoid_diff(a, b):
    """log(sigmoid(a) - sigmoid(b)) for a > b, stable."""
    return -_softplus(-a) - _softplus(b) + log1m_exp(torch.clamp(b - a, max=-1e-12))


def ordered_logistic_lpmf(y, eta, c, *, propto=False, batch_ndims=0):
    """y in 1..K, cutpoints c ordered length K-1 (ref: ordered_logistic_lpmf.hpp).
    ``c`` is ``(batch..., K-1)``: one cut vector per chain with ``batch_ndims=1``."""
    eta, c = as_tensors(eta, c)
    yi = _category_index(y, eta.device)
    km1 = c.shape[-1]
    k = km1 + 1
    ok_c = ok_ordered(c)  # one flag per cut vector, then one per chain
    if ok_c.ndim > batch_ndims:
        ok_c = ok_c.flatten(batch_ndims).all(-1)
    event_ndims = max(eta.ndim - batch_ndims, yi.ndim)
    ok = (yi >= 0) & (yi < k) & ok_c.reshape(ok_c.shape + (1,) * event_ndims)
    yc = torch.clamp(yi, 0, k - 1)
    big = torch.full(c.shape[:-1] + (1,), 1e30, dtype=c.dtype, device=c.device)
    cpad = _lead_axes(torch.cat([-big, c, big], dim=-1), batch_ndims, event_ndims)
    c_lo = _take_last(cpad, yc)
    c_hi = _take_last(cpad, yc + 1)
    # P(y=k) = sigmoid(eta - c_{k-1}) - sigmoid(eta - c_k)
    a = eta - c_lo  # larger
    b = eta - c_hi
    lp = torch.where(
        yc == 0,
        -_softplus(eta - c_hi),  # 1 - sigmoid(eta - c_1)
        torch.where(
            yc == k - 1,
            -_softplus(-(eta - c_lo)),
            _log_sigmoid_diff(torch.maximum(a, b), torch.minimum(a, b)),
        ),
    )
    return finish(lp, ok, batch_ndims)
