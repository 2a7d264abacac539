"""Warmup adaptation: dual-averaging step size + windowed Welford metric.

Counterpart: ``math_tpu/infer/adapt.py``.  Reference behavior: Stan's
stepsize_adaptation (Nesterov dual averaging, gamma=0.05, t0=10, kappa=0.75,
delta=0.8) and windowed covariance adaptation (init buffer 75, doubling slow
windows from 25, terminal buffer 50), with the Welford accumulator from
``prim/mat/fun/welford_var_estimator.hpp`` and the same
``(n/(n+5)) var + 1e-3 (5/(n+5))`` regularization.

The dual-averaging and Welford states are tensors on the sampler's device (no
host round trip per step); the schedule helpers are numpy, as in the JAX
package.  Each state holds one accumulator, or one per chain: dual averaging
takes a ``(C,)`` step size, and ``welford_init`` / ``welford_cov_init`` take
``chains=C`` for ``(C, D)`` means and ``(C, D)`` / ``(C, D, D)`` moments,
updated by ``(C, D)`` draws.  All chains of a batch update together, so the
count is shared.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from math_tpu_torch.infer.nuts import (
    IntegratorState,
    kinetic_energy,
    leapfrog,
    sample_momentum,
)


class DualAveragingState(NamedTuple):
    log_eps: torch.Tensor
    log_eps_bar: torch.Tensor
    h_bar: torch.Tensor
    mu: torch.Tensor
    count: torch.Tensor


def da_init(eps0, dtype=torch.float32, device=None):
    if isinstance(eps0, torch.Tensor) and device is None:
        device = eps0.device
    eps0 = torch.as_tensor(eps0, dtype=dtype, device=device)
    return DualAveragingState(
        log_eps=torch.log(eps0),
        log_eps_bar=torch.zeros_like(eps0),
        h_bar=torch.zeros_like(eps0),
        mu=torch.log(10.0 * eps0),
        count=torch.zeros(eps0.shape, dtype=torch.int32, device=eps0.device),
    )


def da_update(s: DualAveragingState, accept_prob, target=0.8,
              gamma=0.05, t0=10.0, kappa=0.75):
    count = s.count + 1
    t = count.to(s.log_eps.dtype)
    eta = 1.0 / (t + t0)
    h_bar = (1.0 - eta) * s.h_bar + eta * (target - accept_prob)
    log_eps = s.mu - torch.sqrt(t) / gamma * h_bar
    w = torch.pow(t, -kappa)
    log_eps_bar = w * log_eps + (1.0 - w) * s.log_eps_bar
    return DualAveragingState(log_eps, log_eps_bar, h_bar, s.mu, count)


class WelfordState(NamedTuple):
    count: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor


def _lead(chains):
    return () if chains is None else (chains,)


def welford_init(dim, dtype=torch.float32, device=None, chains=None):
    """An empty accumulator of ``dim`` coordinates, one per chain where
    ``chains`` is given."""
    return WelfordState(
        count=torch.zeros((), dtype=dtype, device=device),
        mean=torch.zeros(_lead(chains) + (dim,), dtype=dtype, device=device),
        m2=torch.zeros(_lead(chains) + (dim,), dtype=dtype, device=device),
    )


def welford_update(s: WelfordState, x):
    """Ref: welford_var_estimator.hpp:19-27; ``x`` is ``(D,)``, or ``(C, D)``
    for per-chain accumulators (elementwise, so the same formula)."""
    count = s.count + 1.0
    delta = x - s.mean
    mean = s.mean + delta / count
    m2 = s.m2 + delta * (x - mean)
    return WelfordState(count, mean, m2)


def welford_variance_regularized(s: WelfordState):
    """Stan's shrunk sample variance (downstream var_adaptation)."""
    n = torch.clamp(s.count, min=2.0)
    var = s.m2 / (n - 1.0)
    return (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))


class WelfordCovState(NamedTuple):
    count: torch.Tensor
    mean: torch.Tensor  # (dim,)
    m2: torch.Tensor  # (dim, dim)


def welford_cov_init(dim, dtype=torch.float32, device=None, chains=None):
    """Dense-metric accumulator (ref: welford_covar_estimator.hpp), one per
    chain where ``chains`` is given."""
    return WelfordCovState(
        count=torch.zeros((), dtype=dtype, device=device),
        mean=torch.zeros(_lead(chains) + (dim,), dtype=dtype, device=device),
        m2=torch.zeros(_lead(chains) + (dim, dim), dtype=dtype, device=device),
    )


def welford_cov_update(s: WelfordCovState, x):
    """``x`` is ``(D,)``, or ``(C, D)``: the outer product is taken per chain."""
    count = s.count + 1.0
    delta = x - s.mean
    mean = s.mean + delta / count
    m2 = s.m2 + delta[..., :, None] * (x - mean)[..., None, :]
    return WelfordCovState(count, mean, m2)


def welford_cov_regularized(s: WelfordCovState):
    """Stan's shrunk covariance (downstream covar_adaptation):
    (n/(n+5)) Sigma + 1e-3 (5/(n+5)) I."""
    n = torch.clamp(s.count, min=2.0)
    cov = s.m2 / (n - 1.0)
    cov = 0.5 * (cov + cov.mT)
    dim = cov.shape[-1]
    eye = torch.eye(dim, dtype=cov.dtype, device=cov.device)
    return (n / (n + 5.0)) * cov + 1e-3 * (5.0 / (n + 5.0)) * eye


def warmup_schedule(num_warmup, init_buffer=75, term_buffer=50, base_window=25):
    """Static schedule arrays: in_slow[t], window_end[t] (numpy).

    Follows Stan's windowed adaptation: fast(75) | 25,50,100,... | fast(50),
    with proportional shrinking when num_warmup is small and the final slow
    window extended to abut the terminal buffer.
    """
    in_slow = np.zeros(num_warmup, dtype=bool)
    window_end = np.zeros(num_warmup, dtype=bool)
    if num_warmup < 20:
        return in_slow, window_end
    if init_buffer + term_buffer + base_window > num_warmup:
        init_buffer = int(0.15 * num_warmup)
        term_buffer = int(0.10 * num_warmup)
        base_window = num_warmup - init_buffer - term_buffer
    slow_end = num_warmup - term_buffer
    in_slow[init_buffer:slow_end] = True
    start, size = init_buffer, base_window
    while start < slow_end:
        end = start + size
        if end + 2 * size > slow_end:
            end = slow_end
        window_end[end - 1] = True
        start, size = end, size * 2
    return in_slow, window_end


def choose_depth_cap(depths, user_cap, margin=2, sat_tol=0.05):
    """Auto-size the NUTS tree-depth cap from observed tree depths.

    The transition's cost scales with the program's ``max_depth`` (the
    checkpoint stacks and the worst lane's tree budget), not the adapted
    depth, while a cap at or below the adapted depth truncates real
    trajectories.  Rule: the cap must clear the adapted mean depth by
    ~``margin`` AND keep the expected saturation rate at or under
    ``sat_tol``, so

        cap = min(user_cap,
                  max(round(mean + margin),
                      smallest c with P(depth >= c) <= sat_tol))

    ``P(depth >= c)`` estimated from the observed distribution IS the
    expected cap-hit rate at cap ``c``, so the chosen cap is self-consistent
    with ``warn_on_treedepth_saturation``'s default threshold (a cap chosen
    here never warns on the data that chose it).

    ``depths``: any array of observed tree depths (host numpy ok).
    Returns an int in [2, user_cap].
    """
    d = np.asarray(depths).reshape(-1)
    if d.size == 0:
        return int(user_cap)
    mean = float(d.mean())
    # smallest c with P(d >= c) <= sat_tol; observed depths are themselves
    # truncated at the cap they ran under, so a heavy lump AT the current
    # cap pushes c past it (the caller's ratchet then re-observes)
    dmax = int(d.max())
    tail = dmax + 1
    for c in range(2, dmax + 2):
        if float(np.mean(d >= c)) <= sat_tol:
            tail = c
            break
    cap = max(int(np.floor(mean + margin + 0.5)), tail)
    return int(np.clip(cap, 2, user_cap))


def depth_probe_window(window_end, num_warmup, override=None, tail=50):
    """(probe_end, tail_len) for auto depth sizing.

    The probe runs at the ``max_depth`` ceiling until ~``tail`` steps past
    the FIRST metric-window close, and the cap is read from those last
    ``tail`` steps only: before the first metric update the depth
    distribution reflects the IDENTITY metric and reads too deep.
    ``override`` forces a fixed probe length (cap read from its second half).
    """
    if override is not None:
        probe = max(1, min(int(override), num_warmup))
        return probe, max(1, probe // 2)
    we = np.nonzero(np.asarray(window_end))[0]
    first_close = int(we[0]) + 1 if len(we) else num_warmup
    probe = min(first_close + tail, num_warmup)
    tail_len = probe - first_close
    if tail_len < 1:
        tail_len = max(1, probe // 2)
    return probe, tail_len


def treedepth_saturation(tree_depth, cap):
    """Fraction of transitions whose tree hit the depth cap (the Stan
    max-treedepth-warning analog; report it whenever a cap is set)."""
    return float(np.mean(np.asarray(tree_depth) >= cap))


def warn_on_treedepth_saturation(tree_depth, cap, threshold=0.05):
    """Warn when the sampling-phase saturation rate exceeds ``threshold``
    (trajectories are being truncated — raise the cap or re-run with a larger
    ``max_depth`` ceiling)."""
    return warn_on_saturation_rate(treedepth_saturation(tree_depth, cap), cap, threshold, stacklevel=3)


def warn_on_saturation_rate(rate, cap, threshold=0.05, stacklevel=2):
    """The warning of ``warn_on_treedepth_saturation`` for a hit rate counted
    by the caller (the chunked sampler counts each chunk against the cap it
    ran at); returns ``rate``."""
    import warnings

    if rate > threshold:
        warnings.warn(
            f"NUTS tree-depth cap {cap} was hit on {100.0 * rate:.1f}% of "
            f"transitions (> {100.0 * threshold:.0f}%); trajectories are "
            "being truncated — raise max_depth (or the auto_depth ceiling)",
            stacklevel=stacklevel,
        )
    return rate


def find_reasonable_step_size(noise, logp_grad_fn, state: IntegratorState,
                              inv_mass, eps0=1.0, max_iter=100):
    """Stan/NUTS-paper init heuristic, per chain: double/halve eps until the
    one-step acceptance probability crosses 1/2.  Returns ``(C,)`` step
    sizes.  A lane that has crossed is frozen while the others go on."""
    n_chains, dim = state.z.shape
    dt, dev = state.z.dtype, state.z.device
    r0 = sample_momentum(noise, inv_mass, (n_chains, dim), site="step_size_momentum")
    start = IntegratorState(state.z, r0, state.logp, state.grad)
    h0 = -start.logp + kinetic_energy(inv_mass, r0)
    inf = torch.as_tensor(float("inf"), dtype=dt, device=dev)
    log_half = math.log(0.5)

    def accept_log_prob(eps):
        s = leapfrog(logp_grad_fn, start, eps, inv_mass)
        h = -s.logp + kinetic_energy(inv_mass, s.r)
        h = torch.where(torch.isnan(h), inf, h)
        return h0 - h  # log accept prob

    eps = torch.full((n_chains,), float(eps0), dtype=dt, device=dev)
    up = accept_log_prob(eps) > log_half
    factor = torch.where(up, 2.0, 0.5).to(dt)

    live = torch.ones((n_chains,), dtype=torch.bool, device=dev)
    it = 0
    while it < max_iter:
        a = accept_log_prob(eps)
        crossed = torch.where(up, a <= log_half, a > log_half)
        live = live & ~crossed
        if not bool(live.any()):
            break
        eps = torch.where(live, eps * factor, eps)
        it += 1
    # step back once on the shrinking side so we end on the acceptable side
    eps = torch.where(up, eps * 0.5, eps)
    return torch.clamp(eps, 1e-8, 1e3)
