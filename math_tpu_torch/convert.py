"""Data and sampler state shared between ``math_tpu`` and this package.

The system has no weights; what both packages must be able to share is the
data of a model and the state of a sampler.  Everything crosses as numpy
arrays, so neither package imports the other: the JAX side calls
``np.asarray`` on its ``IntegratorState`` / ``DualAveragingState`` /
``WelfordState`` fields and hands them to the functions here.
"""

from __future__ import annotations

import numpy as np
import torch

from math_tpu_torch.config import get_config
from math_tpu_torch.infer.adapt import DualAveragingState, WelfordState
from math_tpu_torch.infer.nuts import IntegratorState
from math_tpu_torch.models.glm_logistic import synthetic_data  # noqa: F401  (same X, y for both)
from math_tpu_torch.models.gp_regression import synthetic_data as gp_synthetic_data  # noqa: F401  (same x, y)


def _place(device, dtype):
    cfg = get_config()
    return (
        torch.device(cfg.device if device is None else device),
        cfg.default_dtype if dtype is None else dtype,
    )


def _t(a, device, dtype):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def data_from_numpy(*arrays, device=None, dtype=None):
    """A model's data (``x, y`` of the GP; ``X, y`` of the GLM) as tensors on
    ``device``, to be passed through the samplers' ``args=``."""
    device, dtype = _place(device, dtype)
    return tuple(_t(a, device, dtype) for a in arrays)


def positions_from_numpy(z, *, device=None, dtype=None):
    """A batch of unconstrained positions ``(C, dim)`` (or of constrained
    hyperparameter draws ``(M, 3)``) from the JAX package, on ``device``: both
    packages then evaluate the same points."""
    if np.ndim(z) != 2:
        raise ValueError("positions_from_numpy: expected a (C, dim) batch")
    device, dtype = _place(device, dtype)
    return _t(z, device, dtype)


def from_numpy_state(z, r, logp, grad, step_size, inv_mass, *, device=None, dtype=None):
    """``(IntegratorState, step_size, inv_mass)`` on ``device`` from the JAX
    package's chain-batched sampler state: ``z, r, grad (C, dim)``,
    ``logp (C,)``, a scalar ``step_size``, ``inv_mass (dim,)`` or
    ``(dim, dim)``."""
    device, dtype = _place(device, dtype)
    state = IntegratorState(
        _t(z, device, dtype), _t(r, device, dtype), _t(logp, device, dtype), _t(grad, device, dtype)
    )
    if state.z.ndim != 2 or state.logp.shape != state.z.shape[:1]:
        raise ValueError("from_numpy_state: expected z (C, dim) and logp (C,)")
    return state, _t(step_size, device, dtype), _t(inv_mass, device, dtype)


def dual_averaging_from_numpy(log_eps, log_eps_bar, h_bar, mu, count, *, device=None, dtype=None):
    device, dtype = _place(device, dtype)
    return DualAveragingState(
        _t(log_eps, device, dtype),
        _t(log_eps_bar, device, dtype),
        _t(h_bar, device, dtype),
        _t(mu, device, dtype),
        torch.as_tensor(np.asarray(count), dtype=torch.int32, device=device),
    )


def welford_from_numpy(count, mean, m2, *, device=None, dtype=None):
    device, dtype = _place(device, dtype)
    return WelfordState(_t(count, device, dtype), _t(mean, device, dtype), _t(m2, device, dtype))
