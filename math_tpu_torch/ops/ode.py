"""ODE integration with sensitivities, chain-batched.

Counterpart: ``math_tpu/ops/ode.py`` (reference: ``integrate_ode_rk45``,
Boost odeint dopri5, ``prim/arr/functor/integrate_ode_rk45.hpp``, and the
CVODES ``integrate_ode_bdf/adams`` path).  The same solvers: adaptive
Dormand-Prince 5(4), Adams-Bashforth-Moulton PECE(4), fixed-grid RK4, and the
*continuous adjoint* for gradients: the backward pass integrates

    d/dt [y, lambda, mu] = [f, -lambda^T df/dy, -lambda^T df/dtheta]

between observation times, reversed in time, with the same segment solver.

Chain-batched (the JAX package gets its chain axis from ``jax.vmap``):
``f(t, y, theta)`` maps ``y (C, n)`` and ``theta (C, p)`` to ``(C, n)``; ``t``
broadcasts against ``y``: a ``(C, 1)`` tensor in the adaptive solvers (each
lane has its own time) and a Python float in ``ode_rk4_fixed`` (all lanes
share the grid).  ``ts`` is shared by all lanes and lives on the host (numpy
or a CPU tensor); outputs are ``(C, T, n)``.

The adaptive loops run per lane with masks, which is exactly what ``vmap`` of
the reference's ``while_loop`` does: the body runs on every lane while any
lane is live, and a lane that is done keeps its carry.  So each lane takes the
reference's step sequence, and a lane solved inside a batch equals that lane
solved alone.  One host ``any()`` a step decides whether to go on.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from math_tpu_torch.utils.batch import as_lanes, where_lanes

__all__ = [
    "odeint_adjoint", "integrate_ode_rk45", "integrate_ode_adams", "integrate_ode_bdf", "integrate_dae",
    "ode_rk4_fixed",
]

# Dormand-Prince 5(4) tableau (ref: ode.py:36-47)
_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
_A = np.zeros((7, 7))
_A[1, 0] = 1 / 5
_A[2, :2] = [3 / 40, 9 / 40]
_A[3, :3] = [44 / 45, -56 / 15, 32 / 9]
_A[4, :4] = [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729]
_A[5, :5] = [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656]
_A[6, :6] = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84]
_B5 = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0])
_B4 = np.array([5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40])


def np_dtype(dtype):
    """The numpy twin of a floating torch dtype: host-side times and step
    sizes are computed in the working precision, as the reference computes
    them in ``y0.dtype``."""
    return {torch.float64: np.float64, torch.float32: np.float32}[dtype]


def _combo(coeffs, ks):
    """``sum(c_j * k_j)`` in the reference's order (zero coefficients kept:
    a non-finite stage propagates as it does there)."""
    return sum(float(c) * k for c, k in zip(coeffs, ks))


def _dopri_step(f, t, y, h, theta, k0):
    """One DP5(4) step for every lane; ``t``, ``h`` are ``(C,)``.  FSAL:
    ``k0 = f(t, y)`` from the previous step (ref: ode.py:50)."""
    hc = h[:, None]
    tc = t[:, None]
    ks = [k0]
    for i in range(1, 7):
        yi = y + hc * _combo(_A[i, :i], ks)
        ks.append(f(tc + float(_C[i]) * hc, yi, theta))
    y5 = y + hc * _combo(_B5, ks)
    y4 = y + hc * _combo(_B4, ks)
    return y5, y5 - y4, ks[6]  # ks[6] = f(t+h, y5) (FSAL)


def _error_norm(err, y, y_new, rtol, atol):
    """RMS of the scaled error over the state axis, one value a lane (ref: ode.py:63)."""
    scale = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y_new))
    return torch.sqrt(torch.mean(torch.square(err / scale), dim=-1))


def _nan_to_inf(enorm):
    return torch.where(torch.isnan(enorm), torch.full_like(enorm, float("inf")), enorm)


def _step_factor(enorm):
    return torch.clamp(0.9 * torch.pow(torch.clamp_min(enorm, 1e-10), -0.2), 0.2, 5.0)


def _segment_bounds(y0, t0, t1, h0):
    """``(t (C,), h (C,), threshold)`` at the start of a segment: the loop
    runs while ``t < t1 - 1e-12 |t1|``, and ``h`` starts at ``min(h0,
    max(t1 - t0, 1e-12))``; both computed in the working dtype."""
    nd = np_dtype(y0.dtype)
    t0n, t1n = nd(t0), nd(t1)
    thr = float(t1n - nd(1e-12) * abs(t1n))
    span = float(max(t1n - t0n, nd(1e-12)))
    t = torch.full((y0.shape[0],), float(t0n), dtype=y0.dtype, device=y0.device)
    return t, torch.clamp_max(h0, span), thr


def _integrate_segment(f, y0, t0, t1, theta, rtol, atol, h0, max_steps):
    """Adaptively integrate every lane from ``t0`` to ``t1``; returns
    ``(y(t1) (C, n), h_last (C,))``.  A lane that reaches ``max_steps`` gives
    NaN (ref: ode.py:68-98)."""
    t, h, thr = _segment_bounds(y0, t0, t1, h0)
    t1f = float(np_dtype(y0.dtype)(t1))
    y = y0
    k = f(t[:, None], y0, theta)
    steps = torch.zeros_like(t, dtype=torch.int32)
    while True:
        live = (t < thr) & (steps < max_steps)
        if not bool(live.any()):
            break
        h_eff = torch.minimum(h, t1f - t)
        y_new, err, k_new = _dopri_step(f, t, y, h_eff, theta, k)
        enorm = _nan_to_inf(_error_norm(err, y, y_new, rtol, atol))
        accept = live & (enorm <= 1.0)
        h_next = torch.clamp_min(h_eff * _step_factor(enorm), 1e-12)
        t = torch.where(accept, t + h_eff, t)
        y = where_lanes(accept, y_new, y)
        k = where_lanes(accept, k_new, k)
        h = torch.where(live, h_next, h)
        steps = steps + live.to(torch.int32)
    return where_lanes(steps >= max_steps, torch.full_like(y, float("nan")), y), h


def _rk4_step(f, t, y, h, theta):
    """One classic RK4 step for every lane; ``t``, ``h`` are ``(C,)`` (ref: ode.py:101)."""
    hc = h[:, None]
    tc = t[:, None]
    k1 = f(tc, y, theta)
    k2 = f(tc + 0.5 * hc, y + 0.5 * hc * k1, theta)
    k3 = f(tc + 0.5 * hc, y + 0.5 * hc * k2, theta)
    k4 = f(tc + hc, y + hc * k3, theta)
    return y + (hc / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def _adams_abm(f, theta, rtol, atol, t, y, h, hist, have, steps):
    """The predictor-corrector branch (ref: ode.py:129-149); ``hist (C, 4, n)`` oldest..newest."""
    f0, f1, f2, f3 = hist.unbind(1)
    hc = h[:, None]
    pred = y + (hc / 24.0) * (55.0 * f3 - 59.0 * f2 + 37.0 * f1 - 9.0 * f0)
    fp = f((t + h)[:, None], pred, theta)
    corr = y + (hc / 24.0) * (9.0 * fp + 19.0 * f3 - 5.0 * f2 + f1)
    enorm = _nan_to_inf(_error_norm((19.0 / 270.0) * (corr - pred), y, corr, rtol, atol))
    accept = enorm <= 1.0
    fc = f((t + h)[:, None], corr, theta)  # PECE final evaluation
    t_new = torch.where(accept, t + h, t)
    y_new = where_lanes(accept, corr, y)
    hist_new = where_lanes(accept, torch.stack([f1, f2, f3, fc], 1), hist)
    # quantized step control: grow/shrink kills the uniform history
    shrink = enorm > 1.0
    grow = accept & (enorm < 0.02)
    h_new = torch.where(shrink, 0.5 * h, torch.where(grow, 2.0 * h, h))
    have_new = have & ~(shrink | grow)
    return t_new, y_new, h_new, hist_new, have_new, steps + 1


def _adams_build(f, theta, rtol, atol, t, y, h, hist, have, steps):
    """(Re)build the uniform 4-point history with 3 RK4 substeps, the first
    checked by step doubling (ref: ode.py:151-176)."""
    y1_full = _rk4_step(f, t, y, h, theta)
    y_half = _rk4_step(f, t, y, 0.5 * h, theta)
    y1 = _rk4_step(f, t + 0.5 * h, y_half, 0.5 * h, theta)
    enorm = _nan_to_inf(_error_norm((y1 - y1_full) / 15.0, y, y1, rtol, atol))
    ok = enorm <= 1.0
    f0 = f(t[:, None], y, theta)
    f1 = f((t + h)[:, None], y1, theta)
    y2 = _rk4_step(f, t + h, y1, h, theta)
    f2 = f((t + 2 * h)[:, None], y2, theta)
    y3 = _rk4_step(f, t + 2 * h, y2, h, theta)
    f3 = f((t + 3 * h)[:, None], y3, theta)
    hist_new = where_lanes(ok, torch.stack([f0, f1, f2, f3], 1), hist)
    t_new = torch.where(ok, t + 3 * h, t)
    y_new = where_lanes(ok, y3, y)
    h_new = torch.where(ok, h, 0.5 * h)
    return t_new, y_new, h_new, hist_new, ok, steps + 3


def _adams_finish(f, theta, rtol, atol, t1f, t, y, h, hist, have, steps):
    """Near ``t1``: one adaptive DP5 step clamped to ``t1`` (ref: ode.py:178-194)."""
    h_eff = torch.minimum(h, t1f - t)
    k0 = f(t[:, None], y, theta)
    y_new, err, _ = _dopri_step(f, t, y, h_eff, theta, k0)
    enorm = _nan_to_inf(_error_norm(err, y, y_new, rtol, atol))
    accept = enorm <= 1.0
    t_new = torch.where(accept, t + h_eff, t)
    y_new = where_lanes(accept, y_new, y)
    return t_new, y_new, h_eff * _step_factor(enorm), hist, torch.zeros_like(have), steps + 1


def _integrate_segment_adams(f, y0, t0, t1, theta, rtol, atol, h0, max_steps):
    """Adams-Bashforth-Moulton PECE(4) with restart-on-step-change (ref:
    ode.py:109-214, the CVODES CV_ADAMS path of ``cvodes_integrator.hpp``).

    The reference's ``lax.switch`` over three branches becomes, per lane, the
    branch its index picks: each branch that some live lane takes is computed
    for all lanes and selected per lane, which is what ``vmap`` of a switch
    with a batched index does (a branch no live lane takes is skipped: its
    lanes would be discarded)."""
    t, h, thr = _segment_bounds(y0, t0, t1, h0)
    t1f = float(np_dtype(y0.dtype)(t1))
    carry = (t, y0, h, torch.zeros((y0.shape[0], 4, y0.shape[1]), dtype=y0.dtype, device=y0.device),
             torch.zeros_like(t, dtype=torch.bool), torch.zeros_like(t, dtype=torch.int32))
    while True:
        t, y, h, hist, have, steps = carry
        live = (t < thr) & (steps < max_steps)
        room = t + 4.0 * h < t1f
        idx = torch.where(room & have, 0, torch.where(room, 1, 2))
        taken = torch.stack([live.any()] + [(live & (idx == b)).any() for b in range(3)]).tolist()
        if not taken[0]:
            break
        branches = (
            lambda: _adams_abm(f, theta, rtol, atol, *carry),
            lambda: _adams_build(f, theta, rtol, atol, *carry),
            lambda: _adams_finish(f, theta, rtol, atol, t1f, *carry),
        )
        new = list(carry)
        for b in range(3):
            if taken[1 + b]:
                sel = live & (idx == b)
                new = [where_lanes(sel, o, n) for o, n in zip(branches[b](), new)]
        carry = tuple(new)
    t, y, h, _, _, steps = carry
    return where_lanes(steps >= max_steps, torch.full_like(y, float("nan")), y), h


# method -> (segment loop, the step ``h`` starts at); ``ops/ode_stiff.py``
# adds "trbdf2" when it is imported (``_segment_method`` imports it)
_SEGMENT_FNS = {"dopri": (_integrate_segment, 0.1), "adams": (_integrate_segment_adams, 0.1)}


def _segment_method(method):
    if method == "trbdf2":
        from math_tpu_torch.ops import ode_stiff  # noqa: F401
    return _SEGMENT_FNS[method]


def _host_times(ts, t0, dtype):
    """``(t0, ts)`` as numpy values of the working dtype (``ts`` may be
    numpy, a list or a CPU tensor)."""
    if isinstance(ts, torch.Tensor):
        if ts.device.type != "cpu":
            raise ValueError("ts lives on the host: pass numpy or a CPU tensor")
        ts = ts.detach().numpy()
    nd = np_dtype(dtype)
    return nd(t0), np.asarray(ts, dtype=nd).reshape(-1)


def _forward(f, y0, t0, ts, theta, rtol, atol, max_steps, method="dopri"):
    """``ys[:, i] = y(ts[i])``, sequential over the output grid; ``h`` starts
    at the method's (0.1; TR-BDF2 0.01) and is carried across segments (ref:
    ode.py:217, ode_stiff.py:128-141)."""
    segment, h0 = _segment_method(method)
    t, tsn = _host_times(ts, t0, y0.dtype)
    y = y0
    h = torch.full((y0.shape[0],), h0, dtype=y0.dtype, device=y0.device)
    ys = []
    for t_next in tsn:
        y, h = segment(f, y, t, t_next, theta, rtol, atol, h, max_steps)
        ys.append(y)
        t = t_next
    return torch.stack(ys, 1)


def _vjp_rhs(f, t, y, theta, lam):
    """``(f(t, y, theta), lam^T df/dy, lam^T df/dtheta)`` by one reverse pass;
    chains are independent, so the batched vjp is each lane's.  Where ``y``
    carries a graph (the stiff solver's Newton Jacobian of the augmented
    system) the results are differentiable in ``y`` and ``lam``, as
    ``jax.vjp`` is."""
    graph = torch.is_grad_enabled() and y.requires_grad
    with torch.enable_grad():
        yy = y if graph else y.detach().requires_grad_(True)
        th = theta.detach().requires_grad_(True)
        fy = f(t, yy, th)
        dlam, dmu = torch.autograd.grad(fy, (yy, th), grad_outputs=lam, allow_unused=True, create_graph=graph)
    dlam = torch.zeros_like(y) if dlam is None else dlam
    dmu = torch.zeros_like(theta) if dmu is None else dmu
    return (fy if graph else fy.detach()), dlam, dmu


def _adjoint_sweep(f, ys, g, t0, ts, theta, rtol, atol, max_steps, segment, h_start):
    """``(lambda(t0), mu(t0))``: the augmented system integrated backward over
    every interval with ``segment`` (time reversed, ``s = -t``), ``lambda``
    picking up ``g[:, k]`` at each output time (ref: ode.py:255-302)."""
    dim = ys.shape[-1]
    t0n, tsn = _host_times(ts, t0, ys.dtype)
    t_prev = np.concatenate([[t0n], tsn[:-1]]).astype(tsn.dtype)

    def aug_f_rev(s, z, th):
        fy, dlam, dmu = _vjp_rhs(f, -s, z[:, :dim], th, z[:, dim:2 * dim])
        return -torch.cat([fy, -dlam, -dmu], -1)

    lam = torch.zeros_like(ys[:, 0])
    mu = torch.zeros_like(theta)
    h = torch.full((ys.shape[0],), h_start, dtype=ys.dtype, device=ys.device)
    for k in reversed(range(len(tsn))):
        lam = lam + g[:, k]
        z0 = torch.cat([ys[:, k], lam, mu], -1)
        z1, h = segment(aug_f_rev, z0, -tsn[k], -t_prev[k], theta, rtol, atol, h, max_steps)
        lam, mu = z1[:, dim:2 * dim], z1[:, 2 * dim:]
    return lam, mu


class _OdeintAdjoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f, y0, t0, ts, theta, rtol, atol, max_steps, method):
        ys = _forward(f, y0, t0, ts, theta, rtol, atol, max_steps, method)
        ctx.f, ctx.t0, ctx.ts, ctx.opts = f, t0, ts, (rtol, atol, max_steps, method)
        ctx.save_for_backward(theta, ys)
        return ys

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        theta, ys = ctx.saved_tensors
        rtol, atol, max_steps, method = ctx.opts
        lam, mu = _adjoint_sweep(ctx.f, ys, g.contiguous(), ctx.t0, ctx.ts, theta, rtol, atol, max_steps,
                                 *_segment_method(method))
        # cotangents of t0 and ts are zero, as the reference returns them
        t0_bar = torch.zeros_like(ctx.t0) if ctx.needs_input_grad[2] else None
        ts_bar = torch.zeros_like(ctx.ts) if ctx.needs_input_grad[3] else None
        return None, lam, t0_bar, ts_bar, mu, None, None, None, None


def odeint_adjoint(f, y0, t0, ts, theta, rtol=1e-6, atol=1e-8, max_steps=10_000, method="dopri"):
    """Solve ``y' = f(t, y, theta)`` at times ``ts`` for every lane, with
    continuous-adjoint gradients in ``y0`` and ``theta`` (zero in ``t0`` and
    ``ts``); the backward pass integrates with the same ``method`` ("dopri",
    "adams" or the stiff "trbdf2").  First order only: the backward pass is
    not differentiable."""
    y0, theta, squeeze = as_lanes(y0, theta)
    ys = _OdeintAdjoint.apply(f, y0, t0, ts, theta, rtol, atol, max_steps, method)
    return ys[0] if squeeze else ys


def integrate_ode_rk45(
    f: Callable,
    y0,
    t0,
    ts,
    theta,
    rtol: float = 1e-6,
    atol: float = 1e-8,
    max_num_steps: int = 10_000,
):
    """Stan-named wrapper (ref: integrate_ode_rk45.hpp:80-140)."""
    return odeint_adjoint(f, y0, t0, ts, theta, rtol, atol, max_num_steps)


def integrate_ode_adams(f, y0, t0, ts, theta, rtol=1e-8, atol=1e-10, max_num_steps=100_000):
    """Non-stiff CVODES-Adams equivalent (ref: cvodes_integrator.hpp
    CV_ADAMS): Adams-Bashforth-Moulton PECE(4) multistep with Milne-device
    step control; the continuous adjoint integrates backward with the
    same method."""
    return odeint_adjoint(f, y0, t0, ts, theta, rtol, atol, max_num_steps, method="adams")


def integrate_ode_bdf(f, y0, t0, ts, theta, rtol=1e-6, atol=1e-9, max_num_steps=100_000):
    """Stiff-path API (ref: cvodes_integrator.hpp CV_BDF).

    Backed by the implicit L-stable TR-BDF2 solver with Newton stages and
    a TR-BDF2 adjoint backward pass (``ops.ode_stiff``)."""
    from math_tpu_torch.ops.ode_stiff import integrate_ode_trbdf2

    return integrate_ode_trbdf2(f, y0, t0, ts, theta, rtol, atol, max_num_steps)


def integrate_dae(
    f: Callable,
    g: Callable,
    y0,
    z0,
    t0,
    ts,
    theta,
    rtol: float = 1e-6,
    atol: float = 1e-8,
    max_num_steps: int = 10_000,
    newton_iters: int = 20,
):
    """Semi-explicit index-1 DAE (ref: ``integrate_dae`` / IDAS):

        y' = f(t, y, z, theta),    0 = g(t, y, z, theta)

    The algebraic variables are eliminated inside the right-hand side by a
    damped-Newton solve with implicit-function-theorem gradients
    (``ops.solve.algebra_solver_newton``, started from ``z0`` at every
    evaluation), turning the DAE into an ODE in ``y`` that the adjoint DP5
    core integrates.  Valid when dg/dz is nonsingular along the trajectory
    (the index-1 condition IDAS also requires).  ``t`` reaches ``f`` and
    ``g`` as a ``(C, 1)`` tensor.

    Returns ``(ys (C, T, ny), zs (C, T, nz))`` at the requested times.
    """
    from math_tpu_torch.ops.solve import algebra_solver_newton

    y0, theta, squeeze = as_lanes(y0, theta)
    z0 = torch.as_tensor(z0, dtype=y0.dtype, device=y0.device)
    if z0.ndim == 1:
        z0 = z0.expand(y0.shape[0], -1)
    ny = y0.shape[-1]

    def solve_z(t, y, th, z_guess):
        # (t, y, theta) packed into the solver's parameter, one row a lane
        packed = torch.cat([torch.as_tensor(t, dtype=y.dtype, device=y.device).expand(y.shape[0], 1), y, th], -1)

        def resid(z, q):
            return g(q[:, :1], q[:, 1:1 + ny], z, q[:, 1 + ny:])

        return algebra_solver_newton(resid, z_guess, packed, max_iter=newton_iters, tol=10 * atol)

    def rhs(t, y, th):
        return f(t, y, solve_z(t, y, th, z0), th)

    ys = odeint_adjoint(rhs, y0, t0, ts, theta, rtol, atol, max_num_steps)
    c, nt = ys.shape[:2]
    _, tsn = _host_times(ts, t0, ys.dtype)
    t_col = torch.as_tensor(tsn, device=ys.device).repeat(c)[:, None]
    zs = solve_z(t_col, ys.reshape(c * nt, ny), theta.repeat_interleave(nt, 0), z0.repeat_interleave(nt, 0))
    zs = zs.reshape(c, nt, -1)
    return (ys[0], zs[0]) if squeeze else (ys, zs)


def ode_rk4_fixed(f: Callable, y0, t0, ts, theta, steps_per_interval: int = 16):
    """Fixed-grid RK4, differentiable by autograd (ref: ode.py:408-433): the
    cross-check oracle for the adjoint path.  ``h = (t_next - t) / steps`` is
    computed once an interval in the working dtype, and each interval starts
    at its ``t_next``, not at an accumulated time.  A Python loop: on the
    card the Lotka-Volterra model takes the kernel of ``ops/lv_rk4.py``
    instead."""
    y0, theta, squeeze = as_lanes(y0, theta)
    t, tsn = _host_times(ts, t0, y0.dtype)
    nd = tsn.dtype.type
    y = y0
    ys = []
    for t_next in tsn:
        h = (t_next - t) / nd(steps_per_interval)
        hf, hh, h6 = float(h), float(nd(0.5) * h), float(h / nd(6.0))
        tt = t
        for _ in range(steps_per_interval):
            k1 = f(float(tt), y, theta)
            k2 = f(float(tt + nd(0.5) * h), y + hh * k1, theta)
            k3 = f(float(tt + nd(0.5) * h), y + hh * k2, theta)
            k4 = f(float(tt + h), y + hf * k3, theta)
            y = y + h6 * (k1 + 2 * k2 + 2 * k3 + k4)
            tt = tt + h
        ys.append(y)
        t = t_next
    out = torch.stack(ys, 1)
    return out[0] if squeeze else out
