"""The chain-batched convention in one place: a density or a log-Jacobian sums
over every axis after the first ``batch_ndims`` (the chain axes); a solver's
lanes are the first axis of its state and parameters."""

from __future__ import annotations

import torch
from torch._C._functorch import get_unwrapped, is_functorch_wrapped_tensor


def sum_event(x, batch_ndims=0):
    """Sum over every axis after the first ``batch_ndims``; a tensor that has
    only batch axes (one scalar per chain) is returned as it is."""
    if x.ndim <= batch_ndims:
        return x
    return x.flatten(batch_ndims).sum(-1)


def where_lanes(mask, new, old):
    """``new`` on the lanes where ``mask (C,)`` holds, ``old`` on the others
    (the lanes are the first axis)."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)), new, old)


def as_lanes(x0, theta):
    """``(x0 (C, n), theta (C, p), squeeze)`` for a solver: a single ``(n,)``
    problem with a ``(p,)`` theta gets a lane axis of one (``squeeze``: take
    it off the result); a shared ``(n,)`` x0 or ``(p,)`` theta is expanded
    over the lanes of the other."""
    x0 = torch.as_tensor(x0)
    theta = torch.as_tensor(theta, dtype=x0.dtype, device=x0.device)
    squeeze = x0.ndim == 1 and theta.ndim == 1
    if x0.ndim == 1:
        x0 = x0.expand(1 if squeeze else theta.shape[0], -1)
    if theta.ndim == 1:
        theta = theta.expand(x0.shape[0], -1)
    if x0.ndim != 2 or theta.ndim != 2 or theta.shape[0] != x0.shape[0]:
        raise ValueError(f"expected x0 (C, n) and theta (C, p); got {tuple(x0.shape)} and {tuple(theta.shape)}")
    return x0, theta, squeeze


def plain_tensor(t):
    """``t`` without the wrappers a ``torch.func`` transform puts on a tensor
    made inside it: a factory's result belongs to the transform's level, and a
    module-level cache that kept it would hand a later call a tensor that has
    escaped its transform.  Every cache of constants stores this."""
    while is_functorch_wrapped_tensor(t):
        t = get_unwrapped(t)
    return t
