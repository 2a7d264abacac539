"""Shared machinery for the distribution modules.

Counterpart: ``math_tpu/dists/_util.py``.  Pattern: broadcast -> prune via
``include_summand`` -> vectorized elementwise log-prob -> sum over every axis
after the first ``batch_ndims`` (the chain axes).

Error-handling contract (as in the JAX package): invalid parameters and
off-support outcomes both yield ``-inf`` log-prob, with input sanitization so
gradients stay nan-free at valid points.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from math_tpu_torch.utils.batch import plain_tensor, sum_event

__all__ = [
    "fdtype", "bcast", "as_tensors", "finish", "finish_prod", "safe", "ok_pos", "ok_prob", "ok_simplex", "ok_ordered",
    "all_event", "rng_params", "rng_shape",
]


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


# Host constants up to this many elements are copied to a device once and the
# copy is kept (a density inside a sampler meets the same few constants at every
# gradient call); a larger array is data and should be passed as a tensor.
_CONST_CACHE_MAX_ELEMS = 4096


@functools.lru_cache(maxsize=256)
def _const_tensor(raw, np_dtype, shape, dt, device):
    """The tensor of a host constant, keyed by its bytes: a numpy array that
    was changed in place gives a new key, so the copy is never stale.  Kept
    plain, so a copy first made under a transform serves every later call."""
    return plain_tensor(torch.as_tensor(np.frombuffer(raw, dtype=np_dtype).reshape(shape).copy(), dtype=dt, device=device))


def _as_constant(a, dt, device):
    arr = np.asarray(a)
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)  # torch refuses negative strides
    if arr.size > _CONST_CACHE_MAX_ELEMS or arr.dtype == object:
        return torch.as_tensor(arr, dtype=dt, device=device)
    return _const_tensor(arr.tobytes(), arr.dtype.str, arr.shape, dt, device)


def as_tensors(*args):
    """All args as float tensors of one dtype on one device; Python numbers
    and numpy arrays become read-only constants (do not write into them)."""
    dt, device = _like(*args)
    return [a.to(dtype=dt, device=device) if isinstance(a, torch.Tensor) else _as_constant(a, dt, device) for a in args]


def bcast(*args):
    """Broadcast all args to a common shape as float tensors on one device.
    The results are read-only views: do not write into them."""
    arrs = as_tensors(*args)
    return torch.broadcast_tensors(*arrs) if len(arrs) > 1 else arrs


def safe(x, ok, fill=1.0):
    """Replace invalid entries so math on them cannot produce nan.

    The "double-where" trick: downstream ``where(ok, lp, -inf)`` discards
    these lanes, and sanitizing first keeps reverse-mode gradients finite.
    """
    return torch.where(ok, x, fill)


def finish(lp, ok, batch_ndims=0):
    """Sum elementwise log-prob, sending invalid lanes to -inf."""
    return sum_event(torch.where(ok, lp, -float("inf")), batch_ndims)


def finish_prod(p, ok, batch_ndims=0):
    """Product form for plain cdfs (Stan's vectorized cdf semantics): the
    product over every axis after the first ``batch_ndims``, NaN where an
    argument is invalid (as in the JAX package), in that chain alone."""
    p = torch.where(ok, p, math.nan)
    if p.ndim <= batch_ndims:
        return p
    return p.flatten(batch_ndims).prod(-1)


def rng_params(generator, *params):
    """The parameters of an ``_rng`` as float tensors of one dtype on the
    generator's device (the draws are made there)."""
    dt = _like(*params)[0]
    device = generator.device
    return [p.to(device=device, dtype=dt) if isinstance(p, torch.Tensor)
            else torch.as_tensor(np.asarray(p), dtype=dt, device=device) for p in params]


def rng_shape(shape, *params):
    """The shape of the draws: ``shape``, else the parameters' broadcast shape."""
    if shape is not None:
        return tuple(shape)
    return tuple(torch.broadcast_shapes(*(p.shape for p in params)))


def ok_pos(x):
    return torch.isfinite(x) & (x > 0)


def ok_prob(x):
    return torch.isfinite(x) & (x >= 0) & (x <= 1)


def ok_simplex(x, axis=-1):
    """Valid simplex along ``axis`` (ref: ``check_simplex.hpp``).

    Tolerance scales with dtype epsilon and length so float32 simplexes
    produced by the stick-breaking transform pass (the reference's fixed
    CONSTRAINT_TOLERANCE=1e-8 assumes double).
    """
    k = x.shape[axis]
    tol = max(1e-8, 16.0 * k * torch.finfo(x.dtype).eps)
    fin = torch.all(ok_prob(x), dim=axis)
    return fin & (torch.abs(torch.sum(x, dim=axis) - 1.0) <= tol)


def all_event(mask, batch_ndims=0):
    """``mask`` reduced by ``all`` over every axis after the first
    ``batch_ndims``: one verdict per chain (the JAX package's ``jnp.all``
    over everything, one chain at a time under ``vmap``)."""
    if mask.ndim <= batch_ndims:
        return mask
    return mask.flatten(batch_ndims).all(-1)


def ok_ordered(x, axis=-1):
    """Finite and strictly increasing along ``axis`` (ref: ``check_ordered.hpp``)."""
    fin = torch.all(torch.isfinite(x), dim=axis)
    inc = torch.all(torch.diff(x, dim=axis) > 0, dim=axis)
    return fin & inc
