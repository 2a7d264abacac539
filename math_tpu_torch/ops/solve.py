"""Algebraic equation solvers with implicit-function-theorem gradients,
chain-batched.

Counterpart: ``math_tpu/ops/solve.py`` (reference: ``algebra_solver_newton``
/ ``algebra_solver_fp``, KINSOL, ``rev/mat/functor/algebra_solver_newton.hpp:59-72``,
and ``algebra_solver_powell``, Eigen dogleg).  Gradients come from the
implicit function theorem (``algebra_system.hpp``):

    f(x*, theta) = 0   =>   thetabar = -(df/dtheta)^T (df/dx)^-T xbar

The reference gets them from ``lax.custom_root``; here a
``torch.autograd.Function`` whose backward solves with the ``(C, n, n)``
Jacobian at the root (``torch.linalg.solve``) and takes one vjp in theta.
First order only.

Chain-batched: ``f(x, theta)`` maps ``x (C, n)`` and ``theta (C, p)`` to
``(C, n)``.  The iterations run per lane with masks, as ``vmap`` of the
reference's ``while_loop`` does: a lane stops at its own tolerance or
iteration budget and keeps its value while the others go on.  Jacobians take
one reverse pass over ``n`` copies of the lanes (``jacobian``): the lanes
are independent, so ``f`` must act lane by lane, with its per-lane data in
``theta``, as under the reference's ``vmap``.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.autograd.function import once_differentiable

from math_tpu_torch.utils.batch import as_lanes, where_lanes

__all__ = ["algebra_solver_newton", "algebra_solver_powell", "algebra_solver", "algebra_solver_fp", "jacobian"]


def jacobian(fn, x, *args):
    """``(C, n, n)``: the Jacobian of a square system ``fn(x, *args)``, ``x
    (C, n) -> (C, n)``, at ``x`` for every lane, by one reverse pass over
    ``n`` copies of the lanes: copy ``i`` gives row ``i``.  ``fn`` must act
    lane by lane, its per-lane data in ``args`` (tensors with the lane axis
    first, copied with ``x``; anything else is passed as it is)."""
    c, n = x.shape
    with torch.enable_grad():
        xr = x.detach().repeat(n, 1).requires_grad_(True)
        ar = [a.repeat((n,) + (1,) * (a.ndim - 1)) if isinstance(a, torch.Tensor) and a.ndim and a.shape[0] == c else a
              for a in args]
        y = fn(xr, *ar).reshape(n, c, n)
        (g,) = torch.autograd.grad(torch.diagonal(y, dim1=0, dim2=2).sum(), xr, allow_unused=True)
    if g is None:
        return x.new_zeros((c, n, n))
    return g.reshape(n, c, n).transpose(0, 1)


def _solve(a, b):
    """``a^-1 b`` for ``a (C, n, n)``, ``b (C, n)``; a singular lane gives
    non-finite values instead of raising, as the reference's solve does."""
    return torch.linalg.solve_ex(a, b[..., None])[0][..., 0]


def _norm(x):
    return torch.linalg.vector_norm(x, dim=-1)


def _newton_solve(f, x0, theta, max_iter, tol):
    """Damped Newton per lane with 3-try backtracking (ref: solve.py:24-53)."""

    def fx(x):
        return f(x, theta)

    x = x0
    rn = _norm(fx(x0))
    it = torch.zeros_like(rn, dtype=torch.int32)
    while True:
        live = (it < max_iter) & (rn > tol)
        if not bool(live.any()):
            return x
        r = fx(x)
        step = _solve(jacobian(f, x, theta), r)
        r0 = _norm(r)
        x1, x2, x3 = x - step, x - 0.5 * step, x - 0.25 * step
        n1, n2, n3 = _norm(fx(x1)), _norm(fx(x2)), _norm(fx(x3))
        pick2 = (n1 > r0) & (n2 <= n1)
        pick3 = (n1 > r0) & (n2 > n1)
        xn = where_lanes(pick3, x3, where_lanes(pick2, x2, x1))
        rnn = torch.where(pick3, n3, torch.where(pick2, n2, n1))
        x = where_lanes(live, xn, x)
        rn = torch.where(live, rnn, rn)
        it = it + live.to(torch.int32)


def _dogleg_solve(f, x0, theta, max_iter, tol):
    """Powell hybrid: trust-region dogleg between the Cauchy and Newton steps
    on 1/2 |f|^2, per lane (ref: solve.py:83-144)."""

    def fx(x):
        return f(x, theta)

    def dot(a, b):
        return torch.sum(a * b, dim=-1)

    def mv(m, v):
        return (m @ v[..., None])[..., 0]

    x = x0
    res = _norm(fx(x0))
    delta = torch.clamp_min(_norm(x0), 1.0)
    it = torch.zeros_like(res, dtype=torch.int32)
    while True:
        live = (it < max_iter) & (res > tol)
        if not bool(live.any()):
            return x
        r = fx(x)
        J = jacobian(f, x, theta)
        g = mv(J.mT, r)  # gradient of 1/2|f|^2
        p_newton = -_solve(J, r)
        Jg = mv(J, g)
        alpha = dot(g, g) / torch.clamp_min(dot(Jg, Jg), 1e-300)
        p_cauchy = -alpha[:, None] * g
        npn, npc = _norm(p_newton), _norm(p_cauchy)
        # dogleg blend: tau solves |p_c + tau (p_n - p_c)| = delta
        d = p_newton - p_cauchy
        a = dot(d, d)
        b = 2.0 * dot(p_cauchy, d)
        c = dot(p_cauchy, p_cauchy) - delta * delta
        disc = torch.clamp_min(b * b - 4 * a * c, 0.0)
        tau = (-b + torch.sqrt(disc)) / torch.clamp_min(2.0 * a, 1e-300)
        p_blend = p_cauchy + torch.clamp(tau, 0.0, 1.0)[:, None] * d
        p_short = where_lanes(npc >= delta, (delta / torch.clamp_min(npc, 1e-300))[:, None] * p_cauchy, p_blend)
        p = where_lanes(npn <= delta, p_newton, p_short)
        # actual against predicted reduction of 1/2|f|^2
        xn = x + p
        rn = fx(xn)
        ared = 0.5 * (dot(r, r) - dot(rn, rn))
        Jp = mv(J, p)
        pred = -dot(r, Jp) - 0.5 * dot(Jp, Jp)
        rho = ared / torch.where(torch.abs(pred) < 1e-300, torch.full_like(pred, 1e-300), pred)
        accept = rho > 1e-4
        delta_next = torch.where(rho < 0.25, 0.25 * delta,
                                 torch.where(rho > 0.75, torch.maximum(delta, 2.0 * _norm(p)), delta))
        res_next = torch.where(accept, _norm(rn), _norm(r))
        x = where_lanes(live & accept, xn, x)
        delta = torch.where(live, torch.clamp_min(delta_next, 1e-12), delta)
        res = torch.where(live, res_next, res)
        it = it + live.to(torch.int32)


def _fixed_point_solve(residual, x0, theta, max_iter, tol):
    """``x <- x - residual(x)`` per lane while ``|residual(x)| > tol`` (ref: solve.py:197-206)."""
    x = x0
    it = torch.zeros(x0.shape[0], dtype=torch.int32, device=x0.device)
    while True:
        live = (it < max_iter) & (_norm(residual(x, theta)) > tol)
        if not bool(live.any()):
            return x
        x = where_lanes(live, x - residual(x, theta), x)
        it = it + live.to(torch.int32)


class _ImplicitRoot(torch.autograd.Function):
    """``x* = solve(x0, theta)`` with ``residual(x*, theta) = 0``; backward
    ``thetabar = -(dres/dtheta)^T (dres/dx)^-T xbar`` (``lax.custom_root``'s
    vjp).  ``x0`` gets no gradient."""

    @staticmethod
    def forward(ctx, residual, solve, x0, theta):
        x = solve(residual, x0, theta)
        ctx.residual = residual
        ctx.save_for_backward(x, theta)
        return x

    @staticmethod
    @once_differentiable
    def backward(ctx, xbar):
        x, theta = ctx.saved_tensors
        J = jacobian(ctx.residual, x, theta)
        w = _solve(J.mT, xbar)
        with torch.enable_grad():
            th = theta.detach().requires_grad_(True)
            (tbar,) = torch.autograd.grad(ctx.residual(x, th), th, grad_outputs=w, allow_unused=True)
        return None, None, None, (torch.zeros_like(theta) if tbar is None else -tbar)


def _root(residual, solve, x0, theta):
    x0, theta, squeeze = as_lanes(x0, theta)
    x = _ImplicitRoot.apply(residual, solve, x0, theta)
    return x[0] if squeeze else x


def algebra_solver_newton(f: Callable, x0, theta, *, max_iter: int = 100, tol: float = 1e-10):
    """Solve ``f(x, theta) = 0`` from ``x0`` for every lane; IFT gradients in
    ``theta`` (ref: algebra_solver_newton.hpp)."""
    return _root(f, lambda res, x, th: _newton_solve(res, x, th, max_iter, tol), x0, theta)


def algebra_solver_powell(f: Callable, x0, theta, *, max_iter: int = 200, tol: float = 1e-10):
    """Powell dogleg root solve with IFT gradients (ref:
    ``algebra_solver_powell.hpp``); more robust than plain Newton far from
    the root, the same gradients."""
    return _root(f, lambda res, x, th: _dogleg_solve(res, x, th, max_iter, tol), x0, theta)


# Stan's bare `algebra_solver` is the Powell variant (algebra_solver.hpp)
algebra_solver = algebra_solver_powell


def algebra_solver_fp(f: Callable, x0, theta, *, max_iter: int = 500, tol: float = 1e-10):
    """Fixed-point solve ``x = f(x, theta)`` (ref: algebra_solver_fp.hpp /
    KINSOL KIN_FP), with IFT gradients on ``x - f(x)``."""
    return _root(lambda x, th: x - f(x, th), lambda res, x, th: _fixed_point_solve(res, x, th, max_iter, tol), x0, theta)
