"""Vector-valued constraint transforms (ordered, positive ordered).

Counterpart: ``math_tpu/transforms/vector.py:13-45`` (reference:
``prim/mat/fun/{ordered,positive_ordered}_constrain.hpp``).  The event axis is
the last one; the ``_lp`` variants return the log absolute Jacobian
determinant summed over every axis after the first ``batch_ndims`` (0: the
scalar the JAX function returns; 1: one value per chain).
"""

from __future__ import annotations

import torch

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
