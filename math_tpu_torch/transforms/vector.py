"""Vector-valued constraint transforms (ordered, simplex, unit vector).

Counterpart: ``math_tpu/transforms/vector.py`` (reference:
``prim/mat/fun/{ordered,positive_ordered,simplex,unit_vector}_constrain.hpp``).
The event axis is the last one; the ``_lp`` variants return the log absolute
Jacobian determinant summed over every axis after the first ``batch_ndims``
(0: the scalar the JAX function returns; 1: one value per chain).
"""

from __future__ import annotations

import torch

from math_tpu_torch.special import log1p_exp
from math_tpu_torch.utils.batch import sum_event

# --- ordered: y1 = x1, y_k = y_{k-1} + exp(x_k) (ref: ordered_constrain) ----


def ordered_constrain(x):
    head = x[..., :1]
    return torch.cat([head, head + torch.cumsum(torch.exp(x[..., 1:]), dim=-1)], dim=-1)


def ordered_constrain_lp(x, *, batch_ndims=0):
    return ordered_constrain(x), sum_event(x[..., 1:], batch_ndims)


def ordered_free(y):
    return torch.cat([y[..., :1], torch.log(torch.diff(y, dim=-1))], dim=-1)


# --- positive_ordered: y_k = sum_{i<=k} exp(x_i) (ref: positive_ordered_*) --


def positive_ordered_constrain(x):
    return torch.cumsum(torch.exp(x), dim=-1)


def positive_ordered_constrain_lp(x, *, batch_ndims=0):
    return positive_ordered_constrain(x), sum_event(x, batch_ndims)


def positive_ordered_free(y):
    return torch.cat([torch.log(y[..., :1]), torch.log(torch.diff(y, dim=-1))], dim=-1)


# --- simplex: centered stick-breaking (ref: simplex_constrain.hpp) ----------


def _simplex_parts(x):
    """Shared pieces: z_k = sigmoid(x_k - log(Km1 - k)), sticks via cumprod."""
    km1 = x.shape[-1]
    k = torch.arange(km1, dtype=x.dtype, device=x.device)
    adj = x - torch.log(km1 - k)  # x_k + eq_share, eq_share = -log(Km1 - k)
    z = torch.sigmoid(adj)
    # stick_len before breaking piece k = prod_{i<k} (1 - z_i)
    one_m_z = 1.0 - z
    stick = torch.cat([torch.ones_like(z[..., :1]), torch.cumprod(one_m_z[..., :-1], dim=-1)], dim=-1)
    y = torch.cat([stick * z, stick[..., -1:] * one_m_z[..., -1:]], dim=-1)
    return y, adj, stick


def simplex_constrain(x):
    return _simplex_parts(x)[0]


def simplex_constrain_lp(x, *, batch_ndims=0):
    """lp += sum_k [ log(stick_k) - log1p_exp(-adj_k) - log1p_exp(adj_k) ].

    Matches ``simplex_constrain(y, lp)`` (ref: simplex_constrain.hpp:62-85).
    """
    y, adj, stick = _simplex_parts(x)
    return y, sum_event(torch.log(stick) - log1p_exp(-adj) - log1p_exp(adj), batch_ndims)


def simplex_free(y):
    """Inverse stick-breaking (ref: ``simplex_free.hpp``)."""
    km1 = y.shape[-1] - 1
    k = torch.arange(km1, dtype=y.dtype, device=y.device)
    # stick remaining before piece k: 1 - sum_{i<k} y_i
    stick = 1.0 - torch.cat([torch.zeros_like(y[..., :1]), torch.cumsum(y[..., :-2], dim=-1)], dim=-1)
    z = y[..., :-1] / stick
    return torch.log(z) - torch.log1p(-z) + torch.log(km1 - k)


# --- unit_vector: y = x/||x||, lp -= ||x||^2/2 (ref: unit_vector_constrain) -


def unit_vector_constrain(x):
    return x / torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))


def unit_vector_constrain_lp(x, *, batch_ndims=0):
    """``(x / ||x||, -||x||^2 / 2)`` with the norm over every axis after the
    first ``batch_ndims``: one vector a chain, as in the JAX function."""
    sn = sum_event(torch.square(x), batch_ndims)
    return x / torch.sqrt(sn).reshape(sn.shape + (1,) * (x.ndim - batch_ndims)), -0.5 * sn


def unit_vector_free(y):
    # Any point on the ray maps to y; the reference uses y itself.
    return y
