"""SMC with adaptive likelihood tempering and systematic resampling.

Counterpart: ``math_tpu/infer/smc.py`` (BASELINE.md config 5 names SMC
tempering).  Design:

- particles live in the unconstrained space; the tempered target is
      pi_t(z) ∝ p0(z) * exp(t * (logp(z) - p0(z)))     t: 0 -> 1
  with p0 a normal reference N(0, init_scale^2 I) (importance init);
- the next temperature is chosen by bisection so the incremental weights'
  relative ESS hits a target (adaptive tempering);
- resampling is systematic (cumsum + stratified uniform);
- mutation is ``mutation_steps`` NUTS transitions at the new tempered density,
  one step size for all particles (tuned from the previous stage's
  acceptance) and a diagonal metric from the population's variance.

The particles are the chain axis of the port's batched ``nuts_kernel``: one
transition moves them all.  ``particle_batch`` chunks the log-density calls,
not the tree: every value and gradient is taken ``particle_batch`` rows at a
time (bounding memory where each particle's density holds a large
intermediate, an (n, n) kernel matrix on the GP), while the sampler and its
noise stay those of the unbatched run.  ``smc_tempered`` and
``smc_tempered_stagewise`` are host loops over the one shared stage
function, so they agree particle for particle.

On one device all noise comes from one ``torch.Generator`` (resampling and
mutation in a fixed order).  Across devices (``smc_tempered(axis_name=...)``,
one process a device, ``parallel.chain_mesh``): each rank holds
``num_particles`` particles; the log-likelihoods are all-gathered (one scalar
a particle), so every rank chooses the same temperature and, from the shared
generator, the same global resampling indices; ancestors travel by block
rotations only where some rank needs one (``ancestor_exchange``), never by an
all-gather of particles; the mutation's metric and acceptance are pooled over
the ranks.  Two streams, as the reference's (smc.py:246-256): the caller's
generator, the same on every rank, drives the ladder's resampling; a
generator derived from it and the rank drives initialisation and mutation.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from math_tpu_torch.config import get_config
from math_tpu_torch.infer.nuts import ChainNoise, IntegratorState, nuts_kernel
from math_tpu_torch.infer.sample import _noise
from math_tpu_torch.utils import _collectives as coll


class SMCResult(NamedTuple):
    particles: torch.Tensor  # (n, dim) final (unweighted after resample)
    log_evidence: torch.Tensor  # log Z estimate
    num_stages: int
    final_step_size: torch.Tensor
    temperatures: tuple = ()  # the ladder: t after each stage


def systematic_resample(key, log_weights):
    """Systematic resampling indices for normalized log weights; ``key`` is
    a ``torch.Generator`` of the weights' device or a ``ChainNoise``."""
    n = log_weights.shape[0]
    w = torch.exp(log_weights - torch.logsumexp(log_weights, 0))
    cum = torch.cumsum(w, 0)
    u0 = _noise(key, w.device, w.dtype).uniform((), site="resample")
    pts = (u0 + torch.arange(n, dtype=w.dtype, device=w.device)) / n
    idx = torch.searchsorted(cum, pts, side="left")
    # a float cumsum can top out below 1.0, letting searchsorted return n for
    # the last stratified points; clamp so every id is a valid particle
    return torch.clamp(idx, max=n - 1)


def ancestor_exchange(z, idx, axis_name):
    """Fetch global ancestor particles into local slots without an all-gather
    (ref: smc.py:59-94).

    ``z`` is this rank's ``(n, dim)`` block; ``idx`` the global ancestor ids
    (in ``[0, n * R)``) this rank must receive.  Rotating the blocks by an
    offset ``d`` delivers rank ``(r + d) % R``'s block to rank ``r``; a
    rotation runs only where some rank needs an ancestor at that offset (one
    all-reduce MAX of every rank's demand for every offset, so every rank
    takes the same rotations and the collectives stay in step).

    Transfer bound: bytes moved = (#distinct needed offsets) x block size,
    against an all-gather's (R - 1) x block size; systematic-resample ids are
    sorted, so the needed offsets are a contiguous band around 0.
    """
    n = z.shape[0]
    size, rank = coll.axis_size(axis_name), coll.axis_index(axis_name)
    src_shard, src_pos = idx // n, idx % n
    # offset 0: ancestors already resident.  Slots whose ancestor lives
    # elsewhere also start from a valid local particle, not zeros.
    out = z[src_pos]
    if size == 1:
        return out
    offsets = torch.arange(1, size, device=idx.device)
    demand = (src_shard[None, :] == (rank + offsets[:, None]) % size).any(1).to(torch.int64)
    need = coll.pmax(demand, axis_name).tolist()
    for d, needed in zip(range(1, size), need):
        if needed:
            zr = coll.rotate(z, d, axis_name)
            sel = src_shard == (rank + d) % size
            out = torch.where(sel[:, None], zr[src_pos], out)
    return out


def _rel_ess(log_w):
    lw = log_w - torch.logsumexp(log_w, 0)
    return torch.exp(-torch.logsumexp(2.0 * lw, 0)) / log_w.shape[0]


def _next_temperature(t, log_like, target_ess, max_bisect=30):
    """Bisect dt so rel-ESS of exp(dt * log_like) hits target_ess (on the
    device: no host round trip)."""
    t = torch.as_tensor(t, dtype=log_like.dtype, device=log_like.device)
    hi_ok = _rel_ess((1.0 - t) * log_like) >= target_ess
    lo, hi = torch.zeros_like(t), 1.0 - t
    for _ in range(max_bisect):
        mid = 0.5 * (lo + hi)
        ok = _rel_ess(mid * log_like) >= target_ess
        lo = torch.where(ok, mid, lo)
        hi = torch.where(ok, hi, mid)
    dt = torch.where(hi_ok, 1.0 - t, lo)
    return torch.clamp(t + dt, max=1.0)


def _pbatch_map(fn, z, batch):
    """``fn`` over leading-axis sub-batches of ``z`` of ``batch`` rows,
    outputs concatenated; ``batch=None`` is ``fn(z)``.  Bounds peak memory:
    only ``batch`` particles' intermediates live at once."""
    if batch is None:
        return fn(z)
    n = z.shape[0]
    if n % batch:
        raise ValueError(f"num_particles={n} not divisible by particle_batch={batch}")
    outs = [fn(part) for part in z.split(batch)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


class _SharedAndRankNoise:
    """The two streams of sharded SMC behind ``ChainNoise``'s methods:
    resampling (``site="resample"``) draws from the shared stream, the same on
    every rank; every other site from this rank's."""

    def __init__(self, shared, rank):
        self.shared, self.rank = shared, rank

    def _stream(self, site):
        return self.shared if site == "resample" else self.rank

    def normal(self, shape, site=None):
        return self._stream(site).normal(shape, site)

    def uniform(self, shape, site=None):
        return self._stream(site).uniform(shape, site)

    def bernoulli(self, shape, site=None):
        return self._stream(site).bernoulli(shape, site)


def _sharded_noise(key, rank, device, dtype):
    """The streams of rank ``rank`` from the caller's generator ``key``:
    ``key`` itself (shared) and ``_collectives.rank_generator(key, rank)``."""
    if not isinstance(key, torch.Generator):
        raise TypeError("smc_tempered(axis_name=...): key must be a torch.Generator, the same seed on every rank")
    return _SharedAndRankNoise(ChainNoise(key, device, dtype), ChainNoise(coll.rank_generator(key, rank, device), device, dtype))


class _StageState(NamedTuple):
    z: torch.Tensor
    t: torch.Tensor
    logz: torch.Tensor
    stage_idx: int
    eps: torch.Tensor


def _make_smc_stage(
    logdensity_fn, dim, args, num_particles, mutation_steps, max_depth,
    target_rel_ess, init_scale, axis_name, particle_batch,
):
    """The per-stage transition shared by both entry points (one body, so
    the entry point cannot change the stream).  ``stage(noise, carry) ->
    carry``; with ``axis_name`` each rank's ``carry`` holds its
    ``num_particles`` particles and ``noise`` is ``_SharedAndRankNoise``."""
    log_scale = dim * math.log(init_scale)

    def ref_lp(z):
        return -0.5 * torch.sum(torch.square(z / init_scale), -1) - log_scale

    def log_like_fn(z):
        return logdensity_fn(z, *args) - ref_lp(z)

    def tempered_value_and_grad(t):
        def one(z):
            z = z.detach().requires_grad_(True)
            with torch.enable_grad():
                r = ref_lp(z)
                lp = r + t * (logdensity_fn(z, *args) - r)
                (g,) = torch.autograd.grad(lp.sum(), z)
            return lp.detach(), g

        return lambda z: _pbatch_map(one, z, particle_batch)

    def pmean(x):
        return x if axis_name is None else coll.pmean(x, axis_name)

    def stage(noise, carry: _StageState) -> _StageState:
        z, t, logz, stage_idx, eps = carry
        with torch.no_grad():
            log_like = _pbatch_map(log_like_fn, z, particle_batch)
        log_like = torch.where(torch.isnan(log_like), -torch.inf, log_like)
        if axis_name is not None:  # every rank's: one scalar a particle
            log_like = coll.all_gather(log_like, axis_name)
        t_new = _next_temperature(t, log_like, target_rel_ess)
        log_w = (t_new - t) * log_like
        logz = logz + torch.logsumexp(log_w, 0) - math.log(log_w.shape[0])
        idx = systematic_resample(noise, log_w)
        if axis_name is None:
            z = z[idx]
        else:
            rank = coll.axis_index(axis_name)
            z = ancestor_exchange(z, idx[rank * num_particles:(rank + 1) * num_particles], axis_name)

        # mutation: NUTS at the new tempered target, one step size for all
        # particles and a metric from the population's variance (every
        # rank's, ref: smc.py:205-230)
        lg = tempered_value_and_grad(t_new)
        lp0, g0 = lg(z)
        states = IntegratorState(z, torch.zeros_like(z), lp0, g0)
        mean = pmean(torch.mean(z, 0))
        inv_mass = torch.clamp(pmean(torch.mean(torch.square(z - mean), 0)), min=1e-6)
        acc = None
        for _ in range(mutation_steps):
            states, stats = nuts_kernel(noise, states, lg, eps, inv_mass, max_depth=max_depth)
            acc = pmean(torch.mean(stats.accept_prob))
        # crude Robbins-Monro step-size tune toward 0.65 acceptance
        eps = eps * torch.exp(1.0 * (acc - 0.65))
        return _StageState(states.z, t_new, logz, stage_idx + 1, eps)

    return stage


def _smc_init(noise, dim, num_particles, init_scale, dtype, device):
    """Initial carry of the stage machine: particles from N(0, init_scale^2 I)."""
    z = init_scale * noise.normal((num_particles, dim), site="smc_init")
    zero = torch.zeros((), dtype=dtype, device=device)
    return _StageState(z, zero, zero, 0, torch.full((), 0.2, dtype=dtype, device=device))


def _run_stages(
    logdensity_fn, key, dim, args, num_particles, mutation_steps, max_depth, target_rel_ess, max_stages,
    init_scale, dtype, device, axis_name, particle_batch, progress_fn,
):
    cfg = get_config()
    device = torch.device(cfg.device if device is None else device)
    dtype = cfg.default_dtype if dtype is None else dtype
    args = tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in args)
    stage = _make_smc_stage(
        logdensity_fn, dim, args, num_particles, mutation_steps, max_depth,
        target_rel_ess, init_scale, axis_name, particle_batch,
    )
    if axis_name is None:
        noise = _noise(key, device, dtype)
    else:
        noise = _sharded_noise(key, coll.axis_index(axis_name), device, dtype)
    with torch.no_grad():
        carry = _smc_init(noise, dim, num_particles, init_scale, dtype, device)
        ladder = []
        t = 0.0
        while t < 1.0 and carry.stage_idx < max_stages:
            carry = stage(noise, carry)
            t = float(carry.t)  # scalar host sync: drives the ladder
            ladder.append(t)
            if progress_fn is not None:
                progress_fn(carry.stage_idx, t, float(carry.logz))
        if axis_name is not None:
            # replicated by construction (gathered weights, pooled
            # acceptance); made explicit as the reference does (smc.py:318-323)
            carry = carry._replace(logz=coll.pmean(carry.logz, axis_name), eps=coll.pmean(carry.eps, axis_name),
                                   stage_idx=coll.pmax_int(carry.stage_idx, axis_name, device))
    return SMCResult(
        particles=carry.z, log_evidence=carry.logz, num_stages=carry.stage_idx,
        final_step_size=carry.eps, temperatures=tuple(ladder),
    )


def smc_tempered(
    logdensity_fn: Callable,
    key,
    dim: int,
    *,
    args=(),
    num_particles: int = 1024,
    mutation_steps: int = 3,
    max_depth: int = 6,
    target_rel_ess: float = 0.5,
    max_stages: int = 100,
    init_scale: float = 1.0,
    dtype=None,
    axis_name: Optional[str] = None,
    particle_batch: Optional[int] = None,
    device=None,
) -> SMCResult:
    """Adaptive tempered SMC from N(0, init_scale^2 I) to the posterior.

    ``logdensity_fn(z, *args)`` maps ``(n, dim) -> (n,)``; ``key`` is a
    ``torch.Generator`` of ``device`` (default ``get_config().device``, the
    GPU); ``dtype`` defaults to ``get_config().default_dtype``.

    ``particle_batch``: evaluate the log density in sub-batches of that many
    particles to bound peak memory (needed when each particle's log density
    holds large intermediates, e.g. an (n, n) GP kernel matrix); must divide
    ``num_particles``.

    ``axis_name`` (a mesh axis, ``parallel.chain_mesh``): every rank of the
    axis calls this with the same arguments and the same ``key`` (a
    ``torch.Generator``); ``num_particles`` is then the rank's count and
    ``particles`` the rank's block of the global population (ref:
    smc.py:276-323).  Temperature and resampling read the gathered weights,
    ancestors move by ``ancestor_exchange``; ``log_evidence``,
    ``final_step_size`` and ``num_stages`` are the same on every rank.

    A host loop over stages with one scalar synchronisation a stage, as
    ``smc_tempered_stagewise``; the two return the same particles.
    """
    return _run_stages(
        logdensity_fn, key, dim, args, num_particles, mutation_steps, max_depth, target_rel_ess, max_stages,
        init_scale, dtype, device, axis_name, particle_batch, None,
    )


def smc_tempered_stagewise(
    logdensity_fn: Callable,
    key,
    dim: int,
    *,
    args=(),
    num_particles: int = 1024,
    mutation_steps: int = 3,
    max_depth: int = 6,
    target_rel_ess: float = 0.5,
    max_stages: int = 100,
    init_scale: float = 1.0,
    dtype=None,
    particle_batch: Optional[int] = None,
    progress_fn: Optional[Callable] = None,
    device=None,
) -> SMCResult:
    """``smc_tempered`` with a progress callback: the host drives the
    temperature ladder one stage at a time.  Same stage function and noise
    order as ``smc_tempered``, so the particle stream is bit-identical.
    Single device.

    ``progress_fn(stage_idx, t, logz)`` if given is called after each stage
    (e.g. for logging the temperature ladder).
    """
    return _run_stages(
        logdensity_fn, key, dim, args, num_particles, mutation_steps, max_depth, target_rel_ess, max_stages,
        init_scale, dtype, device, None, particle_batch, progress_fn,
    )
