"""Scalar (elementwise) constraint transforms.

Counterpart: ``math_tpu/transforms/scalar.py`` (reference:
``prim/scal/fun/*_constrain.hpp`` / ``*_free.hpp``).  All functions broadcast
elementwise; the ``_lp`` variants return the log absolute Jacobian determinant
summed over every axis after the first ``batch_ndims`` (0: the scalar the JAX
function returns; 1: one value per chain).
"""

from __future__ import annotations

import torch

from math_tpu_torch.special import log1m, log1p_exp
from math_tpu_torch.utils.batch import sum_event


def identity_constrain(x):
    return x


def identity_free(y):
    return y


# --- lower bound: y = exp(x) + lb (ref: lb_constrain.hpp) -------------------


def lb_constrain(x, lb):
    return torch.exp(x) + lb


def lb_constrain_lp(x, lb, *, batch_ndims=0):
    return torch.exp(x) + lb, sum_event(x, batch_ndims)


def lb_free(y, lb):
    return torch.log(y - lb)


# --- upper bound: y = ub - exp(x) (ref: ub_constrain.hpp) -------------------


def ub_constrain(x, ub):
    return ub - torch.exp(x)


def ub_constrain_lp(x, ub, *, batch_ndims=0):
    return ub - torch.exp(x), sum_event(x, batch_ndims)


def ub_free(y, ub):
    return torch.log(ub - y)


# --- lower+upper: y = lb + (ub-lb)*sigmoid(x) (ref: lub_constrain.hpp) ------


def lub_constrain(x, lb, ub):
    return lb + (ub - lb) * torch.sigmoid(x)


def lub_constrain_lp(x, lb, ub, *, batch_ndims=0):
    y = lub_constrain(x, lb, ub)
    # lp += log(ub-lb) + log inv_logit(x) + log1m inv_logit(x)
    width = torch.as_tensor(ub - lb, dtype=x.dtype, device=x.device)
    lp = (torch.log(width) - log1p_exp(-x) - log1p_exp(x)).expand(x.shape)
    return y, sum_event(lp, batch_ndims)


def lub_free(y, lb, ub):
    u = (y - lb) / (ub - lb)
    return torch.log(u) - torch.log1p(-u)


# --- offset/multiplier: y = mu + sigma*x (ref: offset_multiplier_constrain) -


def offset_multiplier_constrain(x, mu, sigma):
    return mu + sigma * x


def offset_multiplier_constrain_lp(x, mu, sigma, *, batch_ndims=0):
    y = mu + sigma * x
    lp = torch.log(torch.as_tensor(sigma, dtype=y.dtype, device=y.device)).expand(y.shape)
    return y, sum_event(lp, batch_ndims)


def offset_multiplier_free(y, mu, sigma):
    return (y - mu) / sigma


# --- positive: y = exp(x) (ref: positive_constrain.hpp) ---------------------


def positive_constrain(x):
    return torch.exp(x)


def positive_constrain_lp(x, *, batch_ndims=0):
    return torch.exp(x), sum_event(x, batch_ndims)


def positive_free(y):
    return torch.log(y)


# --- probability: y = sigmoid(x) (ref: prob_constrain.hpp) ------------------


def prob_constrain(x):
    return torch.sigmoid(x)


def prob_constrain_lp(x, *, batch_ndims=0):
    return torch.sigmoid(x), sum_event(-log1p_exp(-x) - log1p_exp(x), batch_ndims)


def prob_free(y):
    return torch.log(y) - torch.log1p(-y)


# --- correlation in (-1,1): y = tanh(x) (ref: corr_constrain.hpp) -----------


def corr_constrain(x):
    return torch.tanh(x)


def corr_constrain_lp(x, *, batch_ndims=0):
    y = torch.tanh(x)
    return y, sum_event(log1m(torch.square(y)), batch_ndims)


def corr_free(y):
    return torch.atanh(y)
