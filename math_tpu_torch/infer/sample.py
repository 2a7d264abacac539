"""The sampling entry point: Stan-window warmup per chain, then sampling,
all chains in one batch.

Counterpart: ``math_tpu/infer/sample.py``.  The JAX package writes one chain
(``_warmup_chain_factory``, ``_sample_chain_factory``) and ``vmap``s it; here
the chains are the leading axis of every tensor, as in the rest of the port:
each chain adapts its own step size (dual averaging on its own acceptance)
and its own metric (Welford windows over its own draws), so the step sizes are
``(C,)`` and the metrics ``(C, D)`` or ``(C, D, D)``, carried as a
``nuts.Metric``.  All chains run one NUTS transition together, so a lane whose
step size is small makes the whole batch wait for its deeper tree.

Where it differs from the reference on purpose:

- the initial-position probe runs on the sampling device, through the model's
  own kernels (the reference moves it to the host CPU with the Pallas
  thresholds raised, an answer to its TPU worker);
- the default ``dtype`` is ``get_config().default_dtype`` (float32: the
  reference's float64 default is float32 under its own ``x64=False``, and the
  GLM kernels take float32);
- ``key`` is a ``torch.Generator`` of the device (or an object with
  ``ChainNoise``'s methods), and all noise goes through ``ChainNoise``;
- ``ChainResult`` also carries ``n_grad_calls`` (every chain-batched gradient
  evaluation of the call, the initial probes included) and
  ``warmup_tree_depth``, the depths ``auto_depth`` sizes the cap from.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from math_tpu_torch.config import get_config
from math_tpu_torch.infer import adapt
from math_tpu_torch.infer.nuts import ChainNoise, IntegratorState, LogpGrad, Metric, NutsStats, make_metric, nuts_kernel


def _bad_mask(logp_grad, init):
    """``(bad, logp)`` as numpy: per chain, whether ``init`` has a non-finite
    log density or gradient.  ``logp_grad`` is a ``LogpGrad``; the probe runs
    where ``init`` lies."""
    lp, grad = logp_grad(init)
    bad = ~torch.isfinite(lp) | ~torch.isfinite(grad).all(-1)
    return bad.cpu().numpy(), lp.cpu().numpy()


def _init_bad_mask(logdensity_fn, init, args=()):
    """Per-chain bool mask: chain starts at non-finite logp or gradient
    (numpy), and the log densities.  ``logdensity_fn(z, *args)`` maps
    ``(C, dim) -> (C,)``; the probe runs on ``init``'s device, through the
    model's kernels there (the reference's probe on the host CPU answers its
    TPU worker and would run the kernels' plain versions here)."""
    return _bad_mask(LogpGrad(logdensity_fn, args), init)


def _raise_on_bad(bad, lp):
    if bad.any():
        idx = np.nonzero(bad)[0].tolist()
        raise ValueError(
            f"non-finite initial log density or gradient for chains {idx} "
            f"(logp={lp[bad]}); fix the init (init=/init_radius=) or the "
            "model's support before sampling"
        )


def check_init_logdensity(logdensity_fn, init, args=()):
    """Raise if any chain starts at a non-finite logp or gradient (Stan's
    services throw on a non-finite initial log density, util::initialize),
    before any transition runs."""
    _raise_on_bad(*_init_bad_mask(logdensity_fn, init, args))


def _uniform_init(noise, num_chains, dim, init_radius, site):
    return (2.0 * noise.uniform((num_chains, dim), site=site) - 1.0) * init_radius


def _draw_init(noise, logp_grad, num_chains, dim, init_radius, max_retries):
    init = _uniform_init(noise, num_chains, dim, init_radius, ("init", 0))
    bad, _ = _bad_mask(logp_grad, init)
    tries = 0
    while bad.any() and tries < max_retries:
        tries += 1
        redraw = _uniform_init(noise, num_chains, dim, init_radius, ("init", tries))
        init = torch.where(torch.as_tensor(bad, device=init.device)[:, None], redraw, init)
        bad, _ = _bad_mask(logp_grad, init)
    return init


def _noise(key, device, dtype):
    return key if hasattr(key, "normal") else ChainNoise(key, device, dtype)


def draw_init_positions(
    logdensity_fn, key, num_chains, dim, *, args=(), init_radius=2.0,
    dtype=None, max_retries=100, device=None,
):
    """Uniform(-r, r) inits on ``device``, re-drawing non-finite chains like
    Stan does (util::initialize re-draws a failing random init up to 100
    times; user-supplied inits never retry, they go to
    ``check_init_logdensity``).  ``key``: a ``torch.Generator`` of ``device``
    or a ``ChainNoise``."""
    cfg = get_config()
    device = torch.device(cfg.device if device is None else device)
    dtype = cfg.default_dtype if dtype is None else dtype
    noise = _noise(key, device, dtype)
    return _draw_init(noise, LogpGrad(logdensity_fn, args), num_chains, dim, init_radius, max_retries)


class ChainResult(NamedTuple):
    position: torch.Tensor  # (chains, num_samples, dim)
    stats: NutsStats  # fields shaped (chains, num_samples)
    step_size: torch.Tensor  # (chains,)
    inv_mass: torch.Tensor  # (chains, dim) or (chains, dim, dim)
    warmup_accept: torch.Tensor  # (chains,) mean accept during warmup
    max_depth: int = 10  # sampling-phase tree-depth cap actually used
    n_grad_calls: int = 0  # chain-batched gradient evaluations of the whole call
    warmup_tree_depth: Optional[torch.Tensor] = None  # (chains, num_warmup): what auto_depth reads


class WarmupCarry(NamedTuple):
    """What warmup carries from one step (or one segment of steps) to the
    next: the integrator state, dual averaging, the Welford accumulator, the
    current metric and the running sum of acceptance probabilities."""

    state: IntegratorState
    da: adapt.DualAveragingState
    wf: tuple
    metric: Metric
    acc_sum: torch.Tensor


def _welford_fns(c, dim, dt, dev, dense_mass):
    """``(init, update, final)`` of the per-chain accumulator of the metric's kind."""
    if dense_mass:
        return (lambda: adapt.welford_cov_init(dim, dt, dev, chains=c), adapt.welford_cov_update,
                adapt.welford_cov_regularized)
    return lambda: adapt.welford_init(dim, dt, dev, chains=c), adapt.welford_update, adapt.welford_variance_regularized


def _warmup_init(noise, logp_grad, z0, dense_mass=False):
    """The carry warmup starts from (ref: resume.py:83 ``_warmup_init``): the
    state at ``z0``, a unit metric, each chain's initial step-size heuristic
    in a fresh dual-averaging state, an empty accumulator."""
    c, dim = z0.shape
    dt, dev = z0.dtype, z0.device
    wf_init, _, _ = _welford_fns(c, dim, dt, dev, dense_mass)
    if dense_mass:
        inv_mass = torch.eye(dim, dtype=dt, device=dev).expand(c, dim, dim).contiguous()
    else:
        inv_mass = torch.ones((c, dim), dtype=dt, device=dev)
    metric = make_metric(inv_mass, dense_mass)
    logp0, grad0 = logp_grad(z0)
    state = IntegratorState(z0, torch.zeros_like(z0), logp0, grad0)
    da = adapt.da_init(adapt.find_reasonable_step_size(noise, logp_grad, state, metric), dt)
    return WarmupCarry(state, da, wf_init(), metric, torch.zeros((c,), dtype=dt, device=dev))


def _warmup_segment(noise, logp_grad, carry, in_slow, window_end, max_depth, target_accept):
    """The warmup steps of one slice ``(in_slow, window_end)`` of the Stan
    schedule, from ``carry`` (ref: resume.py:100 ``_warmup_segment``).
    Returns ``(carry, depths (C, steps))``; a run split into segments draws
    the same numbers as one segment over the whole schedule."""
    state, da, wf, metric, acc_sum = carry
    c, dim = state.z.shape
    dt, dev = state.z.dtype, state.z.device
    wf_init, wf_update, wf_final = _welford_fns(c, dim, dt, dev, metric.dense)
    depths = []
    for slow, win_end in zip(in_slow, window_end):
        state, stats = nuts_kernel(noise, state, logp_grad, torch.exp(da.log_eps), metric, max_depth=max_depth)
        da = adapt.da_update(da, stats.accept_prob, target=target_accept)
        if slow:
            wf = wf_update(wf, state.z)
        if win_end:
            metric = make_metric(wf_final(wf), metric.dense)
            wf = wf_init()
            # the metric just changed, so the averaged iterates are stale
            da = adapt.da_init(torch.exp(da.log_eps), dt)
        acc_sum = acc_sum + stats.accept_prob
        depths.append(stats.tree_depth)
    depths = torch.stack(depths, 1) if depths else torch.zeros((c, 0), dtype=torch.int32, device=dev)
    return WarmupCarry(state, da, wf, metric, acc_sum), depths


def _warmup_step_size(da, num_warmup):
    """The sampling step size warmup hands on: the averaged iterate."""
    return torch.exp(da.log_eps_bar) if num_warmup > 0 else torch.exp(da.log_eps)


def _warmup_chains(noise, logp_grad, z0, num_warmup, max_depth, target_accept, dense_mass=False):
    """Every chain's Stan-window warmup, chain-batched (ref:
    ``_warmup_chain_factory``, sample.py:130): per-chain step size (the
    initial heuristic, then dual averaging on the chain's own acceptance) and
    per-chain metric (Welford windows over the chain's own draws, the dual
    averaging re-centred when a window closes).  Returns ``(state, eps_final
    (C,), metric, warmup_accept (C,), depths (C, num_warmup))``; the depths
    feed ``adapt.choose_depth_cap``."""
    carry = _warmup_init(noise, logp_grad, z0, dense_mass)
    in_slow, window_end = adapt.warmup_schedule(num_warmup)
    carry, depths = _warmup_segment(noise, logp_grad, carry, in_slow, window_end, max_depth, target_accept)
    eps_final = _warmup_step_size(carry.da, num_warmup)
    return carry.state, eps_final, carry.metric, carry.acc_sum / max(num_warmup, 1), depths


def _sample_chains(noise, logp_grad, state, eps, metric, num_samples, max_depth, thin=1):
    """Every chain's sampling phase from its warmed-up state (ref:
    ``_sample_chain_factory``, sample.py:209): ``thin`` transitions a kept
    draw, the statistics of the last.  Returns ``(state, zs (C, num_samples,
    D), stats with fields (C, num_samples))``."""
    c, dim = state.z.shape
    zs = torch.empty((c, num_samples, dim), dtype=state.z.dtype, device=state.z.device)
    kept = []
    for i in range(num_samples):
        for _ in range(thin):
            state, stats = nuts_kernel(noise, state, logp_grad, eps, metric, max_depth=max_depth)
        zs[:, i] = state.z
        kept.append(stats)
    if kept:
        return state, zs, NutsStats(*(torch.stack(f, 1) for f in zip(*kept)))
    empty = torch.zeros((c, 0), device=state.z.device)
    return state, zs, NutsStats(*([empty] * len(NutsStats._fields)))


def sample_nuts(
    logdensity_fn: Callable,
    key,
    dim: Optional[int] = None,
    *,
    args=(),
    num_warmup: int = 1000,
    num_samples: int = 1000,
    num_chains: int = 4,
    init: Optional[torch.Tensor] = None,
    max_depth: int = 10,
    target_accept: float = 0.8,
    init_radius: float = 2.0,
    thin: int = 1,
    dense_mass: bool = False,
    dtype=None,
    auto_depth: bool = False,
    depth_margin: int = 2,
    treedepth_warn_threshold: float = 0.05,
    device=None,
) -> ChainResult:
    """Run NUTS with Stan-style windowed warmup on every chain, all chains as
    one batch.

    ``logdensity_fn(z, *args)`` maps unconstrained ``(C, dim)`` to ``(C,)``
    (a ``LogDensity``'s ``logp``); pass large data through ``args``.  ``key``
    is a ``torch.Generator`` of ``device``.  Runs on ``device`` (default:
    ``get_config().device``, the GPU) in ``dtype`` (default:
    ``get_config().default_dtype``); ``init`` and the tensors in ``args`` are
    moved there.  Without ``init``, ``dim`` chains' inits are drawn
    uniform(-``init_radius``, ``init_radius``) and re-drawn where the log
    density is not finite; every init is then checked
    (``check_init_logdensity``).  Returns positions of shape
    ``(chains, num_samples, dim)``.

    ``dense_mass=True`` adapts a dense metric per chain (Stan's dense_e).
    ``auto_depth=True``: warmup runs at the ``max_depth`` ceiling; the
    sampling phase runs at a cap chosen from the tree depths of the second half
    of warmup (``adapt.choose_depth_cap`` with ``depth_margin``), and a
    warning fires if sampling hits that cap on more than
    ``treedepth_warn_threshold`` of its transitions.
    """
    cfg = get_config()
    device = torch.device(cfg.device if device is None else device)
    dtype = cfg.default_dtype if dtype is None else dtype
    args = tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in args)
    noise = _noise(key, device, dtype)
    logp_grad = LogpGrad(logdensity_fn, args)

    with torch.no_grad():
        if init is None:
            if dim is None:
                raise ValueError("pass dim= or init=")
            init = _draw_init(noise, logp_grad, num_chains, dim, init_radius, max_retries=100)
        init = torch.as_tensor(init).to(device=device, dtype=dtype)
        _raise_on_bad(*_bad_mask(logp_grad, init))

        state, eps, metric, warmup_accept, depths = _warmup_chains(
            noise, logp_grad, init, num_warmup, max_depth, target_accept, dense_mass
        )
        cap = max_depth
        if auto_depth:
            cap = adapt.choose_depth_cap(depths[:, num_warmup // 2 :].cpu().numpy(), max_depth, depth_margin)
        _, zs, stats = _sample_chains(noise, logp_grad, state, eps, metric, num_samples, cap, thin)
    if auto_depth:
        adapt.warn_on_treedepth_saturation(stats.tree_depth.cpu().numpy(), cap, treedepth_warn_threshold)
    return ChainResult(
        position=zs,
        stats=stats,
        step_size=eps,
        inv_mass=metric.inv_mass,
        warmup_accept=warmup_accept,
        max_depth=cap,
        n_grad_calls=logp_grad.calls,
        warmup_tree_depth=depths,
    )
