"""Shared machinery for the distribution modules.

Counterpart: ``math_tpu/dists/_util.py``.  Pattern: broadcast -> prune via
``include_summand`` -> vectorized elementwise log-prob -> sum over every axis
after the first ``batch_ndims`` (the chain axes).

Error-handling contract (as in the JAX package): invalid parameters and
off-support outcomes both yield ``-inf`` log-prob, with input sanitization so
gradients stay nan-free at valid points.
"""

from __future__ import annotations

import numpy as np
import torch

from math_tpu_torch.utils.batch import sum_event

__all__ = ["fdtype", "bcast", "finish", "safe", "ok_pos"]


def _like(*args):
    """(dtype, device) the arguments agree on: the promoted dtype of the
    floating tensors (they decide, like JAX's strongly-typed arrays), else of
    the numpy/Python values; the device of the first tensor, else the CPU."""
    dt = None
    device = torch.device("cpu")
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if tensors:
        device = tensors[0].device
    for a in tensors:
        if a.is_floating_point():
            dt = a.dtype if dt is None else torch.promote_types(dt, a.dtype)
    if dt is None:
        host = [np.asarray(a).dtype for a in args if not isinstance(a, torch.Tensor)]
        np_dt = np.result_type(*host, np.float32)
        dt = torch.float64 if np_dt == np.float64 else torch.float32
    return dt, device


def fdtype(*args):
    """Floating result dtype for a set of (possibly int / numpy) arguments."""
    return _like(*args)[0]


def bcast(*args):
    """Broadcast all args to a common shape as float tensors on one device."""
    dt, device = _like(*args)
    arrs = [torch.as_tensor(a, dtype=dt, device=device) for a in args]
    return torch.broadcast_tensors(*arrs) if len(arrs) > 1 else arrs


def safe(x, ok, fill=1.0):
    """Replace invalid entries so math on them cannot produce nan.

    The "double-where" trick: downstream ``where(ok, lp, -inf)`` discards
    these lanes, and sanitizing first keeps reverse-mode gradients finite.
    """
    return torch.where(ok, x, torch.as_tensor(fill, dtype=x.dtype, device=x.device))


def finish(lp, ok, batch_ndims=0):
    """Sum elementwise log-prob, sending invalid lanes to -inf."""
    neg_inf = torch.as_tensor(-float("inf"), dtype=lp.dtype, device=lp.device)
    return sum_event(torch.where(ok, lp, neg_inf), batch_ndims)


def ok_pos(x):
    return torch.isfinite(x) & (x > 0)
