"""ADVI: automatic differentiation variational inference.

Counterpart: ``math_tpu/infer/advi.py`` (Stan ships ADVI in stan-dev/stan,
``stan/variational/advi.hpp``): mean-field and full-rank Gaussian families in
the unconstrained space, reparameterized ELBO gradients, and Stan's
optimization protocol:

* step-size schedule: ``eta * k^(-1/2+eps) / (tau + sqrt(s_k))`` with the
  windowed adagrad accumulator ``s_k = alpha g^2 + (1-alpha) s_{k-1}``
  (alpha=0.1, tau=1.0 — advi.hpp's stochastic_gradient_ascent);
* eta adaptation: trial runs over candidates, best ELBO wins
  (advi.hpp::adapt_eta);
* termination: every ``eval_elbo`` steps the ELBO is re-estimated and the
  relative change enters a circular buffer; the fit stops when the mean or
  median of the buffer drops below ``tol_rel_obj``.

    ELBO = E_{z~q}[ logp(mu + sigma o z) ] + H[q]
    H[meanfield] = sum(omega) + D/2 log(2 pi e)
    H[fullrank]  = sum(log diag L) + D/2 log(2 pi e)

The ``num_mc`` draws of q are the chain axis of the port's log density
``(C, dim) -> (C,)``, so one call evaluates them all.  Noise: ``key`` is a
``torch.Generator``; the fit draws four generators from it, one for the eta
trials, one for the trials' ELBO, one for the optimization and one for the
ELBO evaluations, so that evaluating never shifts the optimization's stream.
Every eta candidate starts from the same state of the trial generators, so
each sees the same noise (the JAX package reuses one trial key).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from math_tpu_torch.config import get_config

_SGA_ALPHA, _SGA_TAU, _SGA_EPS_POW = 0.1, 1.0, 1e-16


class ADVIResult(NamedTuple):
    mu: torch.Tensor  # (dim,)
    omega: torch.Tensor  # (dim,) log-sd (meanfield), log |diag L| (fullrank)
    L: torch.Tensor  # (dim, dim) scale factor (fullrank) or diag(exp(omega))
    elbo_trace: torch.Tensor  # (num_evals,) ELBO at each eval point
    final_elbo: torch.Tensor
    converged: bool = False  # hit the tol_rel_obj rule (vs max steps)
    num_steps_run: int = 0
    learning_rate: Optional[float] = None  # the eta used (chosen by the trials where none was given)
    eta_trial_elbos: tuple = ()  # (eta, trial ELBO) of each candidate tried


def _entropy_meanfield(omega):
    d = omega.shape[-1]
    return torch.sum(omega, -1) + 0.5 * d * (1.0 + math.log(2.0 * math.pi))


def _entropy_fullrank(L):
    d = L.shape[-1]
    return torch.sum(torch.log(torch.abs(torch.diagonal(L, dim1=-2, dim2=-1))), -1) + 0.5 * d * (
        1.0 + math.log(2.0 * math.pi)
    )


def _sample_q(gen, mu, scale_fn, num_mc, dim, dtype):
    z = torch.randn((num_mc, dim), generator=gen, device=mu.device, dtype=dtype)
    return mu + scale_fn(z)


def _child(gen):
    """A new generator on ``gen``'s device, seeded from ``gen``."""
    seed = int(torch.randint(0, 2**62, (1,), generator=gen, device=gen.device))
    return torch.Generator(device=gen.device).manual_seed(seed)


def _sga_update(eta, params, grads, s, t):
    """One step of Stan's stochastic gradient ascent on the negative ELBO
    (advi.hpp; ref: advi.py:138-157): ``t`` is the step's count (1 on the
    first step, which seeds the accumulator with ``g^2``).  Returns
    ``(params, s)``."""
    if t <= 1.0:
        s = [torch.square(g) for g in grads]
    else:
        s = [_SGA_ALPHA * torch.square(g) + (1.0 - _SGA_ALPHA) * sv for g, sv in zip(grads, s)]
    lr = eta * t ** (-0.5 + _SGA_EPS_POW)
    params = [p - lr * g / (_SGA_TAU + torch.sqrt(sv)) for p, g, sv in zip(params, grads, s)]
    return params, s


def advi(
    logdensity_fn: Callable,
    key,
    dim: int,
    *,
    args=(),
    method: str = "meanfield",
    num_steps: int = 10000,
    num_mc: int = 8,
    learning_rate: Optional[float] = None,
    eta_candidates=(100.0, 10.0, 1.0, 0.1, 0.01),
    eta_trial_steps: int = 50,
    num_elbo_mc: int = 100,
    eval_elbo: int = 100,
    tol_rel_obj: Optional[float] = 0.01,
    dtype=None,
    device=None,
) -> ADVIResult:
    """Fit q to exp(logdensity) and return variational parameters.

    ``logdensity_fn(z, *args)`` maps ``(C, dim) -> (C,)``; ``key`` is a
    ``torch.Generator`` of ``device`` (default ``get_config().device``, the
    GPU); ``dtype`` defaults to ``get_config().default_dtype``.

    ``method``: "meanfield" (diagonal) or "fullrank" (dense Cholesky scale).
    When ``learning_rate`` is None, runs Stan-style trial optimizations over
    ``eta_candidates`` and keeps the best-ELBO eta.  ``num_steps`` is the
    maximum; with ``tol_rel_obj`` set (Stan default 0.01) the fit stops at
    the Stan convergence rule (mean or median of the relative-ELBO-change
    circular buffer below tol).  ``tol_rel_obj=None`` runs exactly
    ``num_steps`` steps.
    """
    if method not in ("meanfield", "fullrank"):
        raise ValueError(f"unknown ADVI method {method!r}")
    fullrank = method == "fullrank"
    cfg = get_config()
    device = torch.device(cfg.device if device is None else device)
    dtype = cfg.default_dtype if dtype is None else dtype
    args = tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in args)
    rows, cols = torch.tril_indices(dim, dim, device=device)
    diag_pos = torch.nonzero(rows == cols)[:, 0]

    def unpack_fullrank(lflat):
        # the diagonal kept positive through exp (only diagonal entries are exp'd)
        vals = lflat.index_put((diag_pos,), torch.exp(lflat[diag_pos]))
        return torch.zeros((dim, dim), dtype=dtype, device=device).index_put((rows, cols), vals)

    def neg_elbo(params, gen, n_mc):
        if fullrank:
            mu, L = params[0], unpack_fullrank(params[1])
            scale = lambda z: z @ L.T  # noqa: E731
            ent = _entropy_fullrank(L)
        else:
            mu, omega = params
            scale = lambda z: torch.exp(omega) * z  # noqa: E731
            ent = _entropy_meanfield(omega)
        zs = _sample_q(gen, mu, scale, n_mc, dim, dtype)
        return -(torch.mean(logdensity_fn(zs, *args)) + ent)

    def init_params():
        second = dim * (dim + 1) // 2 if fullrank else dim
        return [torch.zeros((dim,), dtype=dtype, device=device), torch.zeros((second,), dtype=dtype, device=device)]

    def sga_segment(eta, params, opt_state, gen, steps):
        """``steps`` iterations of Stan's stochastic gradient ascent."""
        s, t = opt_state
        for _ in range(steps):
            t += 1.0
            leaves = [p.detach().requires_grad_(True) for p in params]
            with torch.enable_grad():
                loss = neg_elbo(leaves, gen, num_mc)
                grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                params, s = _sga_update(eta, [p.detach() for p in params], grads, s, t)
        return params, (s, t)

    def elbo(params, gen):
        with torch.no_grad():
            return -neg_elbo(params, gen, num_elbo_mc)

    trials = []
    if learning_rate is None:
        k_trial, k_trial_eval = _child(key), _child(key)
        trial_state, trial_eval_state = k_trial.get_state(), k_trial_eval.get_state()
        best, best_lr = -np.inf, eta_candidates[0]
        for lr in eta_candidates:
            k_trial.set_state(trial_state)  # every candidate on the same noise
            p, _ = sga_segment(lr, init_params(), (None, 0.0), k_trial, eta_trial_steps)
            k_trial_eval.set_state(trial_eval_state)
            e = float(elbo(p, k_trial_eval))
            trials.append((lr, e))
            if np.isfinite(e) and e > best:
                best, best_lr = e, lr
        learning_rate = best_lr

    k_opt, k_eval = _child(key), _child(key)
    params = init_params()
    opt_state = (None, 0.0)

    # Stan's convergence machinery: relative ELBO change circular buffer
    cb_size = max(int(round(max(0.1 * num_steps / eval_elbo, 2.0))), 2)
    rel_changes: list = []
    elbo_prev = None
    elbo_trace = []
    converged = False
    steps_run = 0
    while steps_run < num_steps:
        n = min(eval_elbo, num_steps - steps_run)
        params, opt_state = sga_segment(learning_rate, params, opt_state, k_opt, n)
        steps_run += n
        e = float(elbo(params, k_eval))
        elbo_trace.append(e)
        if tol_rel_obj is None:
            continue
        if elbo_prev is not None:
            denom = abs(elbo_prev) if elbo_prev != 0 else 1.0
            rel_changes.append(abs(e - elbo_prev) / denom)
            if len(rel_changes) > cb_size:
                rel_changes.pop(0)
            if len(rel_changes) >= cb_size:
                m = float(np.mean(rel_changes))
                med = float(np.median(rel_changes))
                if min(m, med) < tol_rel_obj:
                    converged = True
                    break
        elbo_prev = e

    with torch.no_grad():
        if fullrank:
            mu, L = params[0], unpack_fullrank(params[1])
            omega = torch.log(torch.abs(torch.diagonal(L)))
        else:
            mu, omega = params
            L = torch.diag(torch.exp(omega))
    final = elbo(params, k_eval)
    return ADVIResult(
        mu=mu, omega=omega, L=L,
        elbo_trace=torch.tensor(elbo_trace, dtype=dtype, device=device),
        final_elbo=final, converged=converged, num_steps_run=steps_run,
        learning_rate=float(learning_rate), eta_trial_elbos=tuple(trials),
    )


def advi_sample(key, result: ADVIResult, num_samples: int):
    """Draw from the fitted q; ``key`` is a ``torch.Generator`` of the
    result's device."""
    dim = result.mu.shape[-1]
    z = torch.randn((num_samples, dim), generator=key, device=result.mu.device, dtype=result.mu.dtype)
    return result.mu + z @ result.L.T
