"""Implicit (stiff) ODE integration: adaptive TR-BDF2 with Newton stages,
chain-batched.

Counterpart: ``math_tpu/ops/ode_stiff.py`` (reference capability: CVODES BDF,
``cvodes_integrator.hpp`` CV_BDF).  TR-BDF2 (Bank et al.), the one-step
L-stable composite of a trapezoidal stage to ``t + gamma h`` and a BDF2
stage to ``t + h``, ``gamma = 2 - sqrt(2)``, with an embedded second-order
error estimate and adaptive ``h``.  Each stage is a fixed 8 iterations of
damped Newton with a dense Jacobian (``ops/solve.py::jacobian``: one reverse
pass over ``n`` copies of the lanes, so ``f`` acts lane by lane).
Gradients: the continuous adjoint of ``ops/ode.py`` with this solver for
the backward integration, ``h`` starting at 0.01 (first order only).

Chain-batched as ``ops/ode.py``: ``f(t, y, theta)`` maps ``(C, n), (C, p)``
to ``(C, n)`` with ``t`` a ``(C, 1)`` tensor; the step loop runs per lane
with masks.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from math_tpu_torch.ops import ode
from math_tpu_torch.ops.solve import _norm, _solve, jacobian
from math_tpu_torch.utils.batch import where_lanes

__all__ = ["odeint_stiff_adjoint", "integrate_ode_trbdf2"]

_GAMMA = 2.0 - math.sqrt(2.0)
_D = _GAMMA / 2.0


def _newton(residual, x0, args, iters=8):
    """Fixed-iteration damped Newton with a dense Jacobian (ref:
    ode_stiff.py:38-52); ``residual(x, *args)`` with per-lane ``args``."""
    x = x0
    for _ in range(iters):
        r = residual(x, *args)
        step = _solve(jacobian(residual, x, *args), r)
        x1, x2 = x - step, x - 0.5 * step
        better = _norm(residual(x1, *args)) <= _norm(r)
        x = where_lanes(better, x1, x2)
    return x


def _trbdf2_step(f, t, y, h, theta, fn):
    """One TR-BDF2 step for every lane (``t``, ``h`` are ``(C,)``); returns
    ``(y1, err_estimate, f(t+h, y1), yg, fg)`` (ref: ode_stiff.py:55-87)."""
    g, d = _GAMMA, _D
    hc, tc = h[:, None], t[:, None]
    t_g, t_1 = tc + g * hc, tc + hc

    def stage(x, ts, dh, rhs, th):
        return x - dh * f(ts, x, th) - rhs

    # TR stage to t + g h
    dh = d * hc
    yg = _newton(stage, y + g * hc * fn, (t_g, dh, y + dh * fn, theta))
    fg = f(t_g, yg, theta)

    # BDF2 stage to t + h: y1 - d h f(t+h, y1) = a1 yg - a2 y
    a1 = 1.0 / (g * (2.0 - g))
    a2 = (1.0 - g) ** 2 / (g * (2.0 - g))
    y1 = _newton(stage, yg + (yg - y) * (1.0 - g) / g, (t_1, dh, a1 * yg - a2 * y, theta))
    f1 = f(t_1, y1, theta)

    # error estimate: difference to the full-step trapezoidal solution
    y_tr_full = y + 0.5 * hc * (fn + f1)
    return y1, y1 - y_tr_full, f1, yg, fg


def _integrate_segment_stiff(f, y0, t0, t1, theta, rtol, atol, h0, max_steps):
    """Adaptive TR-BDF2 from ``t0`` to ``t1`` per lane; ``(y(t1), h_last)``,
    NaN for a lane that reaches ``max_steps`` (ref: ode_stiff.py:96-125)."""
    t, h, thr = ode._segment_bounds(y0, t0, t1, h0)
    t1f = float(ode.np_dtype(y0.dtype)(t1))
    y = y0
    fn = f(t[:, None], y0, theta)
    steps = torch.zeros_like(t, dtype=torch.int32)
    while True:
        live = (t < thr) & (steps < max_steps)
        if not bool(live.any()):
            break
        h_eff = torch.minimum(h, t1f - t)
        y_new, err, f1, _, _ = _trbdf2_step(f, t, y, h_eff, theta, fn)
        enorm = ode._nan_to_inf(ode._error_norm(err, y, y_new, rtol, atol))
        accept = live & (enorm <= 1.0)
        factor = torch.clamp(0.9 * torch.pow(torch.clamp_min(enorm, 1e-10), -1.0 / 3.0), 0.2, 4.0)
        h_next = torch.clamp_min(h_eff * factor, 1e-12)
        t = torch.where(accept, t + h_eff, t)
        y = where_lanes(accept, y_new, y)
        fn = where_lanes(accept, f1, fn)
        h = torch.where(live, h_next, h)
        steps = steps + live.to(torch.int32)
    return where_lanes(steps >= max_steps, torch.full_like(y, float("nan")), y), h


ode._SEGMENT_FNS["trbdf2"] = (_integrate_segment_stiff, 0.01)


def odeint_stiff_adjoint(f, y0, t0, ts, theta, rtol=1e-6, atol=1e-9, max_steps=100_000):
    """Stiff solve with adjoint gradients (the backward pass TR-BDF2 too,
    ``h`` starting at 0.01 both ways; ref: ode_stiff.py:128-185)."""
    return ode.odeint_adjoint(f, y0, t0, ts, theta, rtol, atol, max_steps, method="trbdf2")


def integrate_ode_trbdf2(f: Callable, y0, t0, ts, theta, rtol=1e-6, atol=1e-9, max_num_steps=100_000):
    """Stan-facing stiff integrator (the integrate_ode_bdf workhorse)."""
    return odeint_stiff_adjoint(f, y0, t0, ts, theta, rtol, atol, max_num_steps)
