"""Log-density program layer (counterpart: ``math_tpu/model.py``).

Declare named parameter blocks with constraint transforms, supply
``log_prob`` on constrained values, and get back a flat unconstrained
log-density

    lp(theta) = log_prob(constrain(theta)) + sum log|det J|

that the samplers consume.  Chain-batched: ``theta`` is ``(C, dim)``, every
block handed to ``log_prob_fn`` carries the leading chain axis, ``log_prob_fn``
returns ``(C,)`` and so does ``logp``.  A single ``(dim,)`` point is accepted
too and gives a scalar.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from math_tpu_torch.config import get_config
from math_tpu_torch.transforms import Transform


def _size(shape: Tuple[int, ...]) -> int:
    return int(np.prod(shape)) if shape else 1


@dataclasses.dataclass(frozen=True)
class LogDensity:
    """Flat unconstrained log-density with parameter packing metadata."""

    param_specs: Tuple[Tuple[str, Transform], ...]
    log_prob_fn: Callable[..., torch.Tensor]
    dim: int

    def unravel(self, theta):
        """Split flat unconstrained theta (..., dim) into named blocks."""
        out = {}
        pos = 0
        for name, tr in self.param_specs:
            n = _size(tr.unconstrained_shape)
            block = theta[..., pos : pos + n]
            out[name] = block.reshape(theta.shape[:-1] + tuple(tr.unconstrained_shape))
            pos += n
        return out

    def ravel_constrained(self, values: Dict[str, torch.Tensor]):
        """Inverse for one point: free each constrained value and concatenate."""
        parts = [
            tr.free(torch.as_tensor(values[name])).reshape(-1)
            for name, tr in self.param_specs
        ]
        return torch.cat(parts) if parts else torch.zeros((0,))

    def constrain(self, theta):
        """Named constrained values (no Jacobian)."""
        blocks = self.unravel(theta)
        return {name: tr.constrain(blocks[name]) for name, tr in self.param_specs}

    def constrain_lp(self, theta):
        """(values, log|det J|); the log-Jacobian has theta's leading shape."""
        blocks = self.unravel(theta)
        b = theta.ndim - 1
        lp = torch.zeros(theta.shape[:-1], dtype=theta.dtype, device=theta.device)
        out = {}
        for name, tr in self.param_specs:
            y, lj = tr.constrain_lp(blocks[name], batch_ndims=b)
            out[name] = y
            lp = lp + lj
        return out, lp

    def _batched(self, theta, fn):
        if theta.ndim == 1:
            return fn(theta[None])[0]
        return fn(theta)

    def logp(self, theta, *data):
        """Log density (C, dim) -> (C,); extra ``*data`` args are forwarded to
        ``log_prob_fn`` (pass large datasets this way, already on the device,
        and through the samplers' ``args=``)."""

        def fn(th):
            values, lp_jac = self.constrain_lp(th)
            return self.log_prob_fn(values, *data) + lp_jac

        return self._batched(theta, fn)

    def logp_unadjusted(self, theta, *data):
        """Log density WITHOUT the change-of-variables adjustment (the
        objective of Stan's ``optimize`` method, jacobian=false)."""
        return self._batched(theta, lambda th: self.log_prob_fn(self.constrain(th), *data))

    def logp_and_grad(self, theta, *data):
        """(logp (C,), grad (C, dim)); chains are independent, so the
        gradient of the sum is the per-chain gradient."""
        z = theta.detach().requires_grad_(True)
        with torch.enable_grad():
            lp = self.logp(z, *data)
            (grad,) = torch.autograd.grad(lp.sum(), z)
        return lp.detach(), grad

    def transform_draws(self, positions):
        """Constrain a batch of draws: (..., dim) -> dict of (..., *shape)."""
        positions = torch.as_tensor(positions)
        flat = positions.reshape(-1, self.dim)
        cons = self.constrain(flat)
        lead = tuple(positions.shape[:-1])
        return {name: v.reshape(lead + tuple(v.shape[1:])) for name, v in cons.items()}

    def generate_quantities(self, gq_fn, positions, *data, key=None):
        """Standalone generated quantities over saved draws (the Stan
        ``standalone_gqs`` service: re-run a generated-quantities block
        against an existing posterior sample without re-sampling).

        ``gq_fn(params, *data)`` — or, when ``key=`` (a ``torch.Generator``)
        is given, ``gq_fn(params, generator, *data)`` for ``*_rng``
        quantities such as posterior-predictive replicates — is chain-batched
        like ``log_prob_fn``: ``params`` holds every draw along a leading
        axis, and it returns a tensor, or a dict / tuple / list of them, with
        that axis first.  ``positions`` is any (..., dim) batch of
        unconstrained draws; every draw goes through one call (the JAX
        package vmaps a per-draw function), and the draw axes are restored.
        The same generator state gives the same output.
        """
        pos = torch.as_tensor(positions)
        lead = tuple(pos.shape[:-1])
        params = self.constrain(pos.reshape(-1, self.dim))
        with torch.no_grad():
            out = gq_fn(params, *data) if key is None else gq_fn(params, key, *data)
        return _tree_map(lambda v: v.reshape(lead + tuple(v.shape[1:])), out)

    def initial_positions(self, generator, num_chains, init_radius=2.0, *,
                          device=None, dtype=None):
        """Stan-style uniform(-2, 2) unconstrained inits, drawn on ``device``
        from ``generator`` (a ``torch.Generator`` of that device)."""
        cfg = get_config()
        device = torch.device(cfg.device if device is None else device)
        dtype = cfg.default_dtype if dtype is None else dtype
        u = torch.rand((num_chains, self.dim), generator=generator, device=device, dtype=dtype)
        return (2.0 * u - 1.0) * init_radius


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def make_log_density(
    params: Dict[str, Transform],
    log_prob_fn: Callable[..., torch.Tensor],
) -> LogDensity:
    specs = tuple(params.items())
    dim = sum(_size(tr.unconstrained_shape) for _, tr in specs)
    return LogDensity(param_specs=specs, log_prob_fn=log_prob_fn, dim=dim)
