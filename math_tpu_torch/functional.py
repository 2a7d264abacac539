"""Higher-order AD entry points and parallel-map functionals.

Counterpart: ``math_tpu/functional.py``.  Reference:
``rev/mat/functor/{gradient,jacobian}.hpp``,
``mix/mat/functor/{hessian,grad_hessian,hessian_times_vector,...}.hpp``,
``prim/mat/functor/map_rect*.hpp``, ``rev/mat/functor/adj_jac_apply.hpp``,
``prim/mat/functor/finite_diff_gradient_auto.hpp``.

These collapse onto ``torch.func`` transforms; the value of this module is
the Stan-shaped API (names, composition, return conventions):

  reference                          here
  -----------------------------------------------------------------
  gradient(f, x, fx, grad)           fx, grad = gradient(f, x)
  jacobian(f, x, fx, J)              fx, J    = jacobian(f, x)
  hessian(f, x, fx, grad, H)         fx, g, H = hessian(f, x)
  grad_hessian (fvar<fvar<var>>)     grad_hessian(f, x) (3rd order)
  hessian_times_vector               hessian_times_vector(f, x, v) (HVP
                                     via fwd-over-rev; no Hessian formed)
  map_rect<cid, F>                   map_rect(f, shared, job_params, ...)
  adj_jac_apply<F>                   adj_jac_apply(f, mjac)(args...)

Through the port's hand-written kernels every transform here reaches the
kernels' own rules (``ops/glm_fused.py``, ``ops/chol_blocked.py``: a
``jvp`` from the forward launch's partials, a ``vmap`` into its lanes).  A
forward pass over another forward pass through such a rule cannot carry the
outer tangent (``torch.func`` hands the inner rule tensors without it), so
``grad_hessian`` takes its third order as forward over the reverse-over-
reverse Hessian.  ``f`` takes a tensor; an ``x`` that is not one becomes a
float64 tensor on the device of a tensor argument, else on
``get_config().device`` (the card unless configured otherwise).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch.func import grad, grad_and_value, jacfwd, jacrev, jvp, vmap

from math_tpu_torch.config import get_config
from math_tpu_torch.testing import finite_diff_gradient  # noqa: F401  (re-export: the ground truth)


def _x(x, *like):
    """``x`` as it is if it is a tensor; else float64 on the device of the
    first tensor in ``like``, or on ``get_config().device``."""
    if isinstance(x, torch.Tensor):
        return x
    device = next((t.device for t in like if isinstance(t, torch.Tensor)), None) or get_config().device
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)


def gradient(f: Callable, x):
    """(f(x), grad f(x)) — one reverse sweep (ref: gradient.hpp:42-57)."""
    g, fx = grad_and_value(f)(_x(x))
    return fx, g


def jacobian(f: Callable, x, mode: str = "rev"):
    """(f(x), J) with J_ij = df_i/dx_j (ref: jacobian.hpp both modes)."""
    x = _x(x)
    jac = jacrev(f)(x) if mode == "rev" else jacfwd(f)(x)
    return f(x), jac


def hessian(f: Callable, x):
    """(f, grad, H) via forward-over-reverse (ref: mix hessian.hpp:42-66), in
    one evaluation of ``f``: the value and gradient ride out of the forward
    pass as its auxiliary outputs."""

    def grad_aux(xx):
        g, fx = grad_and_value(f)(xx)
        return g, (fx, g)

    H, (fx, g) = jacfwd(grad_aux, has_aux=True)(_x(x))
    return fx, g, H


def grad_hessian(f: Callable, x):
    """(f, H, grad-of-H) third-order (ref: mix grad_hessian.hpp), ``gH[i, j,
    k] = d H_ij / d x_k``: forward over the reverse-over-reverse Hessian (a
    forward pass over a forward rule drops the outer tangent; see the module
    docstring)."""
    x = _x(x)
    H = jacfwd(grad(f))(x)
    gH = jacfwd(jacrev(grad(f)))(x)
    return f(x), H, gH


def hessian_times_vector(f: Callable, x, v):
    """H v without materializing H (ref: mix hessian_times_vector.hpp)."""
    x = _x(x, v)
    return jvp(grad(f), (x,), (_x(v, x).to(x.dtype),))[1]


def grad_tr_mat_times_hessian(f: Callable, x, m):
    """grad of tr(M H(x)) (ref: mix grad_tr_mat_times_hessian.hpp)."""
    x = _x(x, m)
    m = _x(m, x).to(x.dtype)
    return grad(lambda xx: torch.sum(m * jacfwd(grad(f))(xx)))(x)


def derivative(f: Callable, x):
    """(f(x), f'(x)) for scalar x (ref: mix derivative.hpp)."""
    x = _x(x)
    return f(x), grad(f)(x)


def partial_derivative(f: Callable, x, i: int):
    """(f(x), df/dx_i) (ref: mix partial_derivative.hpp)."""
    x = _x(x)
    return f(x), grad(f)(x)[i]


def finite_diff_hessian(f: Callable, x, h=1e-4):
    """Finite-difference Hessian (ref: finite_diff_hessian.hpp), a numpy
    array; ``f`` is evaluated where ``_x`` puts ``x``."""
    x = _x(x)
    n = x.numel()
    H = np.zeros((n, n))
    for i in range(n):
        def gi(xx, i=i):
            return finite_diff_gradient(f, xx)[i]

        H[i] = finite_diff_gradient(gi, x, h=h)
    return 0.5 * (H + H.T)


def finite_diff_grad_hessian(f: Callable, x, h=1e-3):
    """Finite-difference gradient-of-Hessian, shape (n, n, n)
    (ref: finite_diff_grad_hessian.hpp; the _auto variant's exact-Hessian
    core here is ``hessian``, differenced over each coordinate)."""
    x = _x(x)
    n = x.numel()
    out = np.zeros((n, n, n))
    for i in range(n):
        e = torch.zeros_like(x)
        e[i] = h
        hp = hessian(f, x + e)[2].detach().cpu().numpy()
        hm = hessian(f, x - e)[2].detach().cpu().numpy()
        out[i] = (hp - hm) / (2.0 * h)
    return out


def map_rect(f: Callable, shared_params, job_params, x_r=None, x_i=None, *, axis_name: Optional[str] = None):
    """Map-reduce over independent jobs (ref: map_rect.hpp:123).

    ``f(shared, job_param, x_r_j, x_i_j) -> vector``; the jobs ride
    ``torch.func.vmap`` and concatenate, exactly like the reference's per-job
    output stacking (``map_rect_combine.hpp:65-91``).  Jobs across devices:
    every rank calls this on its own jobs and passes ``axis_name``, which
    changes nothing here, as in the reference (functional.py:125-152): the
    outputs stay the rank's, since a log-density consumer reduces them across
    the ranks anyway (``parallel.sharded_data_logdensity``)."""
    job_params = _x(job_params, shared_params)
    n_jobs = job_params.shape[0]
    if x_r is None:
        x_r = torch.zeros((n_jobs, 0), dtype=job_params.dtype, device=job_params.device)
    if x_i is None:
        x_i = torch.zeros((n_jobs, 0), dtype=torch.int32, device=job_params.device)
    outs = vmap(f, in_dims=(None, 0, 0, 0))(
        _x(shared_params, job_params), job_params, _x(x_r, job_params), torch.as_tensor(x_i, device=job_params.device)
    )
    return outs.reshape(-1)


def adj_jac_apply(f: Callable, multiply_adjoint_jacobian: Callable):
    """Custom-VJP builder (ref: adj_jac_apply.hpp:618): an
    ``autograd.Function`` (``setup_context`` style, so ``torch.func``
    transforms take it) whose backward is the hand-written adjoint.

    ``f(*args) -> out``; ``multiply_adjoint_jacobian(args, adj) -> tuple of
    cotangents``, with ``args`` the primal arguments (the reference's operand
    storage on the vari).  ``vmap`` is generated from ``f`` and the adjoint."""

    class _AdjJac(torch.autograd.Function):
        generate_vmap_rule = True

        @staticmethod
        def forward(*args):
            return f(*args)

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.tensor_slots = [isinstance(a, torch.Tensor) for a in inputs]
            ctx.others = [None if t else a for a, t in zip(inputs, ctx.tensor_slots)]
            ctx.save_for_backward(*[a for a, t in zip(inputs, ctx.tensor_slots) if t])

        @staticmethod
        def backward(ctx, adj):
            saved = iter(ctx.saved_tensors)
            args = tuple(next(saved) if t else o for t, o in zip(ctx.tensor_slots, ctx.others))
            return tuple(multiply_adjoint_jacobian(args, adj))

    def wrapped(*args):
        return _AdjJac.apply(*args)

    return wrapped
