"""Scalar (elementwise) constraint transforms.

Counterpart: ``math_tpu/transforms/scalar.py`` (reference:
``prim/scal/fun/*_constrain.hpp`` / ``*_free.hpp``).  All functions broadcast
elementwise; the ``_lp`` variants return the log absolute Jacobian determinant
summed over every axis after the first ``batch_ndims`` (0: the scalar the JAX
function returns; 1: one value per chain).
"""

from __future__ import annotations

import torch

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
