"""MAP optimization (L-BFGS) and Laplace-approximation sampling.

Counterpart: ``math_tpu/infer/optimize.py`` (the downstream-Stan service
methods ``optimize`` and ``laplace``: stan-dev/stan
``services/optimize/bfgs.hpp``, ``services/laplace_sample.hpp``).

Stan semantics mirrored:

* ``map_estimate(..., jacobian=False)`` (Stan's ``optimize`` default)
  maximizes the CONSTRAINED-space density — the change-of-variables
  adjustment is dropped, so the returned point is the constrained MAP;
  ``jacobian=True`` maximizes the unconstrained-space posterior density
  (the mode the ``laplace`` method expands around).
* ``laplace_sample`` draws theta ~ N(mode, (-H)^-1) in the unconstrained
  space and reports per-draw ``log_q`` (approximation) and ``log_p``
  (target), enabling the same importance-resampling diagnostics Stan's
  laplace_sample feeds to PSIS.

The optimizer is ``lbfgs``, a chain-batched L-BFGS written here (the JAX
package runs ``optax.lbfgs``, a JAX library): ``(C, dim)`` lanes, each with
its own memory, step and line-search state, computing what ``optax.lbfgs``
computes with the reference's arguments — ``scale_by_lbfgs`` (the two-loop
recursion, the scaled identity ``s'y / y'y`` and, on the first step, the
capped reciprocal gradient norm) and ``scale_by_zoom_linesearch`` (strong
Wolfe conditions with the approximate-Wolfe relaxation, initial step 1, at
most 20 steps, cubic / quadratic / bisection zoom, the safe-step fallback).
Log densities are chain-batched as everywhere in the port, so one call
evaluates every lane.  Lanes that converge (``max |g| <= tol``) or stall
(a non-finite step, a line search that failed without decreasing the
objective, or five iterations in a row that did not decrease it by more than
its rounding: float32 at its noise floor, where ``tol`` is out of reach) are
masked, not branched; they keep their last point and report its gradient
norm.  Loop counters are Python
ints.  The host reads one pair of flags a line search where its first trial
step is accepted (the usual case), and then one every second step: whether
any lane still searches, and whether any lane is still active (the outer
loop's stop test rides on the same read).

``laplace_sample``'s Hessian is one double backward: the mode replicated
into ``dim`` lanes, one ``create_graph`` gradient ``g``, and the gradient of
``sum_c g[c, c]`` holds row c of H in lane c.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from math_tpu_torch.config import get_config

__all__ = ["OptimizeResult", "LaplaceResult", "LbfgsResult", "map_estimate", "laplace_sample", "lbfgs", "hessian"]

_LS_MAX_STEPS = 20
# A lane whose objective has not decreased by more than its rounding for this
# many iterations in a row stalls (float32 at its noise floor, where the
# approximate-Wolfe steps are accepted without progress).
_STALL_ITERS = 5
_SLOPE_RTOL, _CURV_RTOL, _APPROX_DEC_RTOL, _INTERVAL_THRESHOLD, _INCREASE = 1e-4, 0.9, 1e-6, 1e-5, 2.0


class OptimizeResult(NamedTuple):
    theta: torch.Tensor  # (dim,) unconstrained optimum
    value: torch.Tensor  # objective log density at the optimum
    grad_norm: torch.Tensor  # inf-norm of the gradient at the optimum
    iterations: int
    converged: bool
    num_grad_calls: int = 0  # value-and-gradient evaluations (line search included)


class LaplaceResult(NamedTuple):
    draws: torch.Tensor  # (num_samples, dim) unconstrained draws
    mode: torch.Tensor  # (dim,)
    log_p: torch.Tensor  # (num_samples,) target log density (jacobian=True)
    log_q: torch.Tensor  # (num_samples,) Gaussian approximation log density
    hessian: torch.Tensor  # (dim, dim) of the expanded log density at mode
    opt: OptimizeResult


class LbfgsResult(NamedTuple):
    z: torch.Tensor  # (C, dim) last point of each lane
    value: torch.Tensor  # (C,) objective (minimized) there
    grad: torch.Tensor  # (C, dim) its gradient
    iterations: torch.Tensor  # (C,) iterations each lane took
    converged: torch.Tensor  # (C,) max |grad| <= tol
    stalled: torch.Tensor  # (C,) stopped on a non-finite step or a failed line search
    num_evals: int  # chain-batched value-and-gradient calls
    path: list  # with record=True: (z, grad, recorded (C,)) at the start and after each iteration


def _where(mask, a, b):
    return torch.where(mask[:, None] if a.ndim == 2 else mask, a, b)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Minimizer of the cubic through (a, fa, fpa), (b, fb), (c, fc)
    (optax's ``_cubicmin``, per lane)."""
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    r0, r1 = fb - fa - C * db, fc - fa - C * dc
    A = (dc ** 2 * r0 - db ** 2 * r1) / denom
    B = (-(dc ** 3) * r0 + db ** 3 * r1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    err = value - value_init - _SLOPE_RTOL * stepsize * slope_init
    approx = torch.maximum(slope - (2 * _SLOPE_RTOL - 1.0) * slope_init,
                           value - value_init - _APPROX_DEC_RTOL * value_init.abs())
    err = torch.clamp_min(torch.minimum(approx, err), 0.0)
    return torch.where(torch.isnan(err), math.inf, err)


def _curvature_error(slope, slope_init):
    err = torch.clamp_min(slope.abs() - _CURV_RTOL * slope_init.abs(), 0.0)
    return torch.where(torch.isnan(err), math.inf, err)


def _zoom_linesearch(fun, z, d, v0, g0, lane_active):
    """optax's ``zoom_linesearch`` (initial guess 1, no maximal step, tol 0)
    for every lane at once; ``(stepsize, value, grad, failed, evals,
    any_lane_active)``.  ``fun`` is evaluated once a step for every lane; the
    lanes whose search has ended keep their state.  The first step is taken
    unread (where no lane is active it is the run's one wasted evaluation)."""
    slope0 = (d * g0).sum(-1)
    zero = torch.zeros_like(v0)
    false = torch.zeros_like(lane_active)
    st = dict(stepsize=zero, value=v0, grad=g0, slope=slope0, interval_found=false, done=false, failed=false,
              low=zero, value_low=v0, slope_low=slope0, high=zero, value_high=v0, slope_high=slope0,
              cubic_ref=zero, value_cubic_ref=v0, safe_stepsize=zero, safe_value=v0, safe_grad=g0)
    evals = 0
    any_active = True
    for count in range(_LS_MAX_STEPS):
        live = lane_active & ~st["done"] & ~st["failed"]
        if count == 1:  # after the first trial step: one read of both flags
            live_any, any_active = torch.stack([live.any(), lane_active.any()]).tolist()
            if not (live_any and any_active):
                break
        elif count > 1 and count % 2 == 1 and not bool(live.any()):
            break
        low, high = st["low"], st["high"]
        # the trial step: the interval search doubles, the zoom interpolates
        search_step = torch.ones_like(v0) if count == 0 else _INCREASE * st["stepsize"]
        delta = (high - low).abs()
        left, right = torch.minimum(high, low), torch.maximum(high, low)
        cubic = _cubicmin(low, st["value_low"], st["slope_low"], high, st["value_high"], st["cubic_ref"],
                          st["value_cubic_ref"])
        use_cubic = (cubic > left + 0.2 * delta) & (cubic < right - 0.2 * delta)
        quad = _quadmin(low, st["value_low"], st["slope_low"], high, st["value_high"])
        use_quad = ~use_cubic & (quad > left + 0.1 * delta) & (quad < right - 0.1 * delta)
        middle = torch.where(use_cubic, cubic, st["cubic_ref"])
        middle = torch.where(use_quad, quad, middle)
        middle = torch.where(~use_cubic & ~use_quad, (low + high) / 2.0, middle)
        zoom = st["interval_found"]
        trial = torch.where(zoom, middle, search_step)
        value, grad = fun(z + trial[:, None] * d)
        evals += 1
        slope = (grad * d).sum(-1)
        dec = _decrease_error(trial, value, slope, v0, slope0)
        err = torch.maximum(dec, _curvature_error(slope, slope0))
        done = err <= 0.0
        safe_decrease = dec <= 0.0
        new = dict(stepsize=trial, value=value, grad=grad, slope=slope, done=done)
        # the interval search (optax's _search_interval)
        high_new = (dec > 0.0) | ((value >= st["value"]) & (count > 0))
        low_new = (slope >= 0.0) & ~high_new
        s_low = torch.where(low_new, trial, st["stepsize"])
        s_vlow = torch.where(low_new, value, st["value"])
        s_slow = torch.where(low_new, slope, st["slope"])
        s_high = torch.where(low_new, st["stepsize"], trial)
        s_vhigh = torch.where(low_new, st["value"], value)
        s_shigh = torch.where(low_new, st["slope"], slope)
        s_safe = safe_decrease
        s_failed = ~done if count + 1 >= _LS_MAX_STEPS else false
        # the zoom (optax's _zoom_into_interval)
        z_safe = safe_decrease & (value < st["safe_value"])
        high_mid = (dec > 0.0) | (value >= st["value_low"])
        high_low = (slope * (high - low) >= 0.0) & ~high_mid
        low_mid = ~high_mid
        z_high = torch.where(high_low, low, torch.where(high_mid, trial, high))
        z_vhigh = torch.where(high_low, st["value_low"], torch.where(high_mid, value, st["value_high"]))
        z_shigh = torch.where(high_low, st["slope_low"], torch.where(high_mid, slope, st["slope_high"]))
        z_low = torch.where(low_mid, trial, low)
        z_vlow = torch.where(low_mid, value, st["value_low"])
        z_slow = torch.where(low_mid, slope, st["slope_low"])
        moved_high = high_mid | high_low
        z_cref = torch.where(moved_high, high, low)
        z_vcref = torch.where(moved_high, st["value_high"], st["value_low"])
        take_safe = torch.where(zoom, z_safe, s_safe)
        safe_stepsize = torch.where(take_safe, trial, st["safe_stepsize"])
        z_failed = (~done) & ((count + 1 >= _LS_MAX_STEPS) | ((delta <= _INTERVAL_THRESHOLD) & (safe_stepsize > 0.0)))
        new.update(
            interval_found=torch.where(zoom, st["interval_found"], high_new | low_new | done),
            failed=torch.where(zoom, z_failed, s_failed),
            low=torch.where(zoom, z_low, s_low), value_low=torch.where(zoom, z_vlow, s_vlow),
            slope_low=torch.where(zoom, z_slow, s_slow), high=torch.where(zoom, z_high, s_high),
            value_high=torch.where(zoom, z_vhigh, s_vhigh), slope_high=torch.where(zoom, z_shigh, s_shigh),
            cubic_ref=torch.where(zoom, z_cref, s_low), value_cubic_ref=torch.where(zoom, z_vcref, s_vlow),
            safe_stepsize=safe_stepsize, safe_value=torch.where(take_safe, value, st["safe_value"]),
            safe_grad=_where(take_safe, grad, st["safe_grad"]),
        )
        # optax's _try_safe_step on the lanes that failed
        use_safe = new["failed"] & ((new["safe_stepsize"] > 0.0) | torch.isinf(dec))
        new["stepsize"] = torch.where(use_safe, new["safe_stepsize"], new["stepsize"])
        new["value"] = torch.where(use_safe, new["safe_value"], new["value"])
        new["grad"] = _where(use_safe, new["safe_grad"], new["grad"])
        st = {k: _where(live, new[k], v) for k, v in st.items()}
    return st["stepsize"], st["value"], st["grad"], st["failed"], evals, any_active


def _precondition(g, S, Y, rho, gamma, mem_idx):
    """optax's ``_precondition_by_lbfgs``: the two-loop recursion over the
    memory, oldest slot at ``mem_idx``."""
    m = S.shape[0]
    order = [(mem_idx + i) % m for i in range(m)]
    vec = g
    alphas = {}
    for i in reversed(order):
        alphas[i] = rho[i] * (S[i] * vec).sum(-1)
        vec = vec - alphas[i][:, None] * Y[i]
    vec = gamma[:, None] * vec
    for i in order:
        beta = rho[i] * (Y[i] * vec).sum(-1)
        vec = vec + (alphas[i] - beta)[:, None] * S[i]
    return vec


def lbfgs(fun: Callable, z0, *, memory_size: int = 10, max_iters: int = 1000, tol: float = 1e-8,
          record: bool = False) -> LbfgsResult:
    """Minimize ``fun`` over every lane of ``z0 (C, dim)`` at once, as
    ``optax.lbfgs(memory_size)`` with the JAX package's loop around it
    (``math_tpu/infer/optimize.py:85-103``): iterate while ``max |g| > tol``
    and fewer than ``max_iters`` iterations, reject a non-finite step.
    ``fun(z (C, dim)) -> (value (C,), grad (C, dim))``.  With ``record``,
    ``path`` holds the starting points and each iteration's points and
    gradients, and which lanes recorded them (those still iterating, with
    finite values)."""
    z = z0.detach().clone()
    C, D = z.shape
    v, g = fun(z)
    evals = 1
    eps = torch.finfo(z.dtype).eps
    S = torch.zeros((memory_size, C, D), dtype=z.dtype, device=z.device)
    Y = torch.zeros_like(S)
    rho = torch.zeros((memory_size, C), dtype=z.dtype, device=z.device)
    prev_z, prev_g = torch.zeros_like(z), torch.zeros_like(g)
    active = torch.isfinite(v) & (g.abs().amax(-1) > tol)
    iterations = torch.zeros(C, dtype=torch.long, device=z.device)
    stalled = torch.zeros_like(active)
    flat = torch.zeros(C, dtype=torch.long, device=z.device)
    path = [(z, g, torch.isfinite(v))] if record else []
    for it in range(max_iters):
        mem_idx, prev_idx = it % memory_size, (it - 1) % memory_size
        if it > 0:
            dp, du = z - prev_z, g - prev_g
            sy = (du * dp).sum(-1)
            yy = (du * du).sum(-1)
            S[prev_idx], Y[prev_idx] = dp, du
            rho[prev_idx] = torch.where(sy == 0.0, 0.0, 1.0 / torch.where(sy == 0.0, 1.0, sy))
            gamma = torch.where(yy > 0.0, sy / torch.where(yy > 0.0, yy, 1.0), 1.0)
        else:
            gamma = torch.clamp_max(1.0 / torch.linalg.vector_norm(g, dim=-1), 1.0)
        d = -_precondition(g, S, Y, rho, gamma, mem_idx)
        step, v_new, g_new, ls_failed, n, any_active = _zoom_linesearch(fun, z, d, v, g, active)
        evals += n
        if not any_active:
            break
        z_new = z + step[:, None] * d
        ok = torch.isfinite(v_new) & torch.isfinite(z_new).all(-1) & torch.isfinite(g_new).all(-1)
        decreased = (v - v_new) > 4.0 * eps * v.abs()
        flat = torch.where(decreased, 0, flat + 1)
        lane_stalls = active & (~ok | (ls_failed & ~decreased) | (flat >= _STALL_ITERS))
        move = active & ok
        prev_z, prev_g = z, g
        z, v, g = _where(move, z_new, z), torch.where(move, v_new, v), _where(move, g_new, g)
        iterations = iterations + active.long()
        stalled = stalled | lane_stalls
        if record:
            path.append((z, g, move))
        active = active & ~lane_stalls & (g.abs().amax(-1) > tol)
    converged = g.abs().amax(-1) <= tol
    return LbfgsResult(z, v, g, iterations, converged, stalled, evals, path)


def _value_and_grad(logdensity_fn, args):
    """``z -> (-logdensity (C,), its gradient (C, dim))``: the objective L-BFGS
    minimizes."""

    def fun(z):
        z = z.detach().requires_grad_(True)
        with torch.enable_grad():
            lp = -logdensity_fn(z, *args)
            (grad,) = torch.autograd.grad(lp.sum(), z)
        return lp.detach(), grad

    return fun


def _device_dtype(init, device, dtype):
    cfg = get_config()
    if init is not None and isinstance(init, torch.Tensor):
        device = init.device if device is None else device
        dtype = init.dtype if dtype is None else dtype
    return torch.device(cfg.device if device is None else device), (cfg.default_dtype if dtype is None else dtype)


def map_estimate(
    logdensity_fn: Callable,
    dim: int,
    *,
    args=(),
    init: Optional[torch.Tensor] = None,
    jacobian: bool = False,
    unadjusted_fn: Optional[Callable] = None,
    max_iters: int = 1000,
    tol: float = 1e-8,
    memory_size: int = 10,
    dtype=None,
    device=None,
) -> OptimizeResult:
    """L-BFGS maximization of the log density (Stan's ``optimize``).

    ``logdensity_fn(theta (C, dim), *args) -> (C,)`` must be the
    JACOBIAN-ADJUSTED unconstrained density (what the samplers consume).
    With ``jacobian=False`` (Stan's default) pass ``unadjusted_fn`` — e.g.
    ``LogDensity.logp_unadjusted`` — so the constrained-space MAP is found;
    when omitted, ``logdensity_fn`` itself is maximized.  Runs on ``device``
    (default: ``init``'s, else ``get_config().device``) in ``dtype``
    (default: ``init``'s, else ``get_config().default_dtype``): pass the
    dtype of the model's data (float32 for the GLM kernels on the card).
    ``converged`` is False for a lane that stalled (float32 at its noise
    floor); ``grad_norm`` is then the gradient's inf-norm where it stopped.
    """
    target = unadjusted_fn if (not jacobian and unadjusted_fn is not None) else logdensity_fn
    device, dtype = _device_dtype(init, device, dtype)
    z0 = torch.zeros((1, dim), dtype=dtype, device=device) if init is None else \
        torch.as_tensor(init, dtype=dtype, device=device).reshape(1, dim)
    res = lbfgs(_value_and_grad(target, tuple(args)), z0, memory_size=memory_size, max_iters=max_iters, tol=tol)
    grad_norm = res.grad.abs().amax(-1)[0]
    return OptimizeResult(
        theta=res.z[0], value=-res.value[0], grad_norm=grad_norm, iterations=int(res.iterations[0]),
        converged=bool(res.converged[0]) and not bool(res.stalled[0]), num_grad_calls=res.num_evals,
    )


def hessian(logdensity_fn: Callable, theta, args=()):
    """Hessian of ``logdensity_fn`` at ``theta (dim,)`` by one double
    backward: ``theta`` replicated into ``dim`` lanes (a chain-batched
    density evaluates them in one call), one ``create_graph`` gradient ``g``,
    and the gradient of ``sum_c g[c, c]``, whose lane c is row c of H."""
    dim = theta.shape[-1]
    z = theta.detach().reshape(1, dim).expand(dim, dim).clone().requires_grad_(True)
    with torch.enable_grad():
        lp = logdensity_fn(z, *args)
        (g,) = torch.autograd.grad(lp.sum(), z, create_graph=True)
        (h,) = torch.autograd.grad(torch.diagonal(g).sum(), z)
    return h


def _gaussian_draws(mode, h, z, jitter=0.0):
    """``(draws, log_q, h_sym)`` of N(mode, (-H + jitter I)^-1) from the
    standard normals ``z (n, dim)`` (the reference's ``expand``)."""
    from math_tpu_torch.ops.cholesky import cholesky_decompose

    dim = mode.shape[-1]
    h = 0.5 * (h + h.mT)
    prec = -h + jitter * torch.eye(dim, dtype=h.dtype, device=h.device)
    L = cholesky_decompose(prec)
    # -H = L L^T  =>  cov = L^-T L^-1; draws = mode + L^-T z
    delta = torch.linalg.solve_triangular(L.mT, z.mT, upper=True).mT
    draws = mode[None, :] + delta
    half_logdet_prec = torch.log(torch.diagonal(L)).sum()
    log_q = -0.5 * (z * z).sum(-1) + half_logdet_prec - 0.5 * dim * math.log(2.0 * math.pi)
    return draws, log_q, h


def laplace_sample(
    logdensity_fn: Callable,
    key: torch.Generator,
    dim: int,
    num_samples: int = 1000,
    *,
    args=(),
    init: Optional[torch.Tensor] = None,
    max_iters: int = 1000,
    tol: float = 1e-8,
    jitter: float = 0.0,
    dtype=None,
    device=None,
) -> LaplaceResult:
    """Draws from the Laplace approximation at the posterior mode
    (Stan's ``laplace`` method): find the mode of the jacobian-adjusted
    unconstrained density, expand with the exact Hessian (second-order
    autograd; through a GLM kernel its differentiable plain version, as the
    JAX package's level-1 rule), and sample theta ~ N(mode, (-H + jitter
    I)^-1) with standard normals from ``key`` (a ``torch.Generator`` of
    ``device``).  Returns per-draw ``log_p`` (target) and ``log_q``
    (approximation) for importance diagnostics (Stan feeds these to PSIS).
    """
    opt = map_estimate(logdensity_fn, dim, args=args, init=init, jacobian=True, max_iters=max_iters, tol=tol,
                       dtype=dtype, device=device)
    mode = opt.theta
    h = hessian(logdensity_fn, mode, tuple(args))
    z = torch.randn((num_samples, dim), generator=key, dtype=mode.dtype, device=mode.device)
    draws, log_q, h = _gaussian_draws(mode, h, z, jitter)
    with torch.no_grad():
        log_p = logdensity_fn(draws, *args)
    return LaplaceResult(draws=draws, mode=mode, log_p=log_p, log_q=log_q, hessian=h, opt=opt)
