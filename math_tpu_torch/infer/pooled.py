"""Chain-batched NUTS with cross-chain pooled warmup.

Counterpart: ``math_tpu/infer/pooled.py``.  All chains advance in lock-step
as one ``(C, dim)`` batch; warmup statistics (mean acceptance for dual
averaging, Welford moments for the metric) are pooled across every chain, so
step size and metric are shared.  Pooling has no analog in Stan (which adapts
per chain); sharing the metric across chains is statistically more efficient
when running hundreds of chains.

The module is mesh-agnostic, as the reference's: with ``axis_name`` (the
name of a mesh axis, ``parallel.chain_mesh``) each rank advances its own
chains and the statistics are pooled across the ranks by the collectives of
``utils/_collectives.py``; with ``axis_name=None`` they pool over the local
batch only and no collective runs.  ``run_pooled_chains_chunked(mesh=...)``
takes the global chains and returns the global result.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from math_tpu_torch.config import get_config
from math_tpu_torch.infer import adapt
from math_tpu_torch.infer.nuts import ChainNoise, IntegratorState, LogpGrad, NutsStats, nuts_kernel
from math_tpu_torch.utils import _collectives as coll


class PooledResult(NamedTuple):
    position: torch.Tensor  # (chains, num_samples, dim)
    accept_prob: torch.Tensor
    diverging: torch.Tensor
    tree_depth: torch.Tensor
    n_leapfrog: torch.Tensor
    energy: torch.Tensor
    step_size: torch.Tensor  # scalar (shared)
    inv_mass: torch.Tensor  # (dim,) shared
    max_depth: int = 10  # sampling-phase cap actually used
    n_grad_calls: int = 0  # chain-batched gradient evaluations of the whole run
    final_state: Optional[IntegratorState] = None
    chunk_caps: tuple = ()  # run_pooled_chains_chunked: the cap each warmup, then sampling, chunk ran at
    chunk_seconds: tuple = ()  # run_pooled_chains_chunked: host wall of each of those chunks


def _pmean(x, axis_name):
    x = x.mean(0)
    return x if axis_name is None else coll.pmean(x, axis_name)


def _psum(x, axis_name):
    x = x.sum(0)
    return x if axis_name is None else coll.psum(x, axis_name)


def _welford_merge_batch(wf: adapt.WelfordState, zs, axis_name=None):
    """Chan-style parallel merge of a cross-chain batch into the accumulator
    (ref: pooled.py:55-67); with ``axis_name`` the batch is every rank's."""
    cg = zs.shape[0] if axis_name is None else coll.psum_int(zs.shape[0], axis_name, zs.device)
    mb = _pmean(zs, axis_name)
    m2b = _psum(torch.square(zs - mb), axis_name)
    n = wf.count
    n_new = n + cg
    delta = mb - wf.mean
    mean_new = wf.mean + delta * (cg / n_new)
    m2_new = wf.m2 + m2b + torch.square(delta) * (n * cg / n_new)
    return adapt.WelfordState(n_new, mean_new, m2_new)


def init_pooled(noise, z0s, logp_grad, axis_name=None):
    """(states, da, wf, inv_mass): initial integrator states, the shared
    initial step size (geometric mean of the per-chain heuristics, over every
    rank's chains with ``axis_name``) in a fresh dual-averaging state, an
    empty Welford accumulator, a unit metric."""
    dim = z0s.shape[1]
    dt, dev = z0s.dtype, z0s.device
    logp0, grad0 = logp_grad(z0s)
    states = IntegratorState(z0s, torch.zeros_like(z0s), logp0, grad0)
    inv_mass = torch.ones((dim,), dtype=dt, device=dev)
    single = adapt.find_reasonable_step_size(noise, logp_grad, states, inv_mass)
    eps0 = torch.exp(_pmean(torch.log(single), axis_name))
    return states, adapt.da_init(eps0, dt), adapt.welford_init(dim, dt, dev), inv_mass


def warmup_pooled(noise, states, da, wf, inv_mass, logp_grad, in_slow, window_end, *,
                  max_depth, target_accept, depths=None, axis_name=None):
    """Pooled warmup over the steps of the (numpy) schedule; each step's tree
    depths ``(C,)`` (this rank's) are appended to the list ``depths`` where
    one is given.  With ``axis_name`` the acceptance and the Welford moments
    pool over every rank's chains."""
    dim = states.z.shape[1]
    dt, dev = states.z.dtype, states.z.device
    for slow, win_end in zip(in_slow, window_end):
        eps = torch.exp(da.log_eps)
        states, stats = nuts_kernel(noise, states, logp_grad, eps, inv_mass, max_depth=max_depth)
        da = adapt.da_update(da, _pmean(stats.accept_prob, axis_name), target=target_accept)
        if depths is not None:
            depths.append(stats.tree_depth)
        if slow:
            wf = _welford_merge_batch(wf, states.z, axis_name)
        if win_end:
            inv_mass = adapt.welford_variance_regularized(wf)
            da = adapt.da_init(torch.exp(da.log_eps), dt)
            wf = adapt.welford_init(dim, dt, dev)
    return states, da, wf, inv_mass


def sample_pooled(noise, states, logp_grad, eps, inv_mass, num_samples, *, max_depth):
    """``num_samples`` transitions at a fixed step size and metric.  Returns
    ``(states, zs (n, C, dim), stats with leading (n, C))``."""
    n_chains, dim = states.z.shape
    zs = torch.empty((num_samples, n_chains, dim), dtype=states.z.dtype, device=states.z.device)
    all_stats = []
    for i in range(num_samples):
        states, stats = nuts_kernel(noise, states, logp_grad, eps, inv_mass, max_depth=max_depth)
        zs[i] = states.z
        all_stats.append(stats)
    if all_stats:
        stats = NutsStats(*(torch.stack(f) for f in zip(*all_stats)))
    else:
        empty = torch.empty((0, n_chains), device=states.z.device)
        stats = NutsStats(*([empty] * len(NutsStats._fields)))
    return states, zs, stats


def _pooled_result(zs, stats, eps_final, inv_mass, max_depth, n_grad_calls, final_state, chunk_caps=(), chunk_seconds=()):
    # (num_samples, chains, ...) -> (chains, num_samples, ...)
    stats = NutsStats(*(f.swapaxes(0, 1) for f in stats))
    return PooledResult(
        position=zs.swapaxes(0, 1),
        accept_prob=stats.accept_prob,
        diverging=stats.diverging,
        tree_depth=stats.tree_depth,
        n_leapfrog=stats.n_leapfrog,
        energy=stats.energy,
        step_size=eps_final,
        inv_mass=inv_mass,
        max_depth=max_depth,
        n_grad_calls=n_grad_calls,
        final_state=final_state,
        chunk_caps=tuple(chunk_caps),
        chunk_seconds=tuple(chunk_seconds),
    )


def gather_pooled(res: PooledResult, axis_name) -> PooledResult:
    """The global result from each rank's: draws, statistics and final states
    all-gathered along the chain axis in rank order (the reference's
    ``out_specs=P(axis)``); the shared ``step_size``, ``inv_mass`` and caps
    are already the same on every rank; ``n_grad_calls`` and
    ``chunk_seconds`` stay this rank's."""
    def g(t):
        return coll.all_gather(t, axis_name)

    fields = ("position", "accept_prob", "diverging", "tree_depth", "n_leapfrog", "energy")
    state = res.final_state
    return res._replace(
        **{f: g(getattr(res, f)) for f in fields},
        final_state=None if state is None else IntegratorState(*(g(t) for t in state)),
    )


def _pooled_depths(depths, max_depth, axis_name):
    """Tree depths as the cap decisions read them (numpy): this rank's, or
    with ``axis_name`` every rank's, from the all-reduced histogram (one
    all-reduce of ``max_depth + 1`` counts), so that every rank decides the
    same cap (ref: pooled.py:158-166)."""
    d = torch.stack(depths) if isinstance(depths, list) else depths
    if axis_name is None:
        return d.cpu().numpy()
    hist = coll.psum(torch.bincount(d.reshape(-1).long(), minlength=max_depth + 1), axis_name)
    return np.repeat(np.arange(max_depth + 1), hist.cpu().numpy())


def run_pooled_chains(
    rng,
    z0s,
    logdensity_fn: Callable,
    *,
    args=(),
    num_warmup: int,
    num_samples: int,
    max_depth: int = 10,
    target_accept: float = 0.8,
    axis_name: Optional[str] = None,
    device=None,
) -> PooledResult:
    """Advance a batch of chains with shared (pooled) step size and metric.

    ``rng`` is a ``torch.Generator`` of ``device`` (or any object with
    ``ChainNoise``'s three methods); ``z0s`` is ``(chains, dim)``;
    ``logdensity_fn(z, *args)`` maps ``(chains, dim) -> (chains,)``.  Runs on
    ``device`` (default: ``get_config().device``, the GPU): ``z0s`` and the
    tensors in ``args`` are moved there if they are elsewhere.

    With ``axis_name`` (a mesh axis, ``parallel.chain_mesh``) every rank of
    the axis calls this on its own chains and generator: the initial step
    size, the acceptance and the metric's moments pool over every rank's
    chains (all-reduces), so every rank adapts the same step size and metric;
    the draws are this rank's (``parallel.sample_nuts_sharded`` gathers
    them).  An all-reduce over one rank is the identity, so at world size 1
    the run equals the run without ``axis_name`` bit for bit.
    """
    device = torch.device(get_config().device if device is None else device)
    z0s = z0s.to(device)
    args = tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in args)
    noise = rng if hasattr(rng, "normal") else ChainNoise(rng, device, z0s.dtype)
    logp_grad = LogpGrad(logdensity_fn, args)

    with torch.no_grad():
        states, da, wf, inv_mass = init_pooled(noise, z0s, logp_grad, axis_name)
        in_slow, window_end = adapt.warmup_schedule(num_warmup)
        states, da, wf, inv_mass = warmup_pooled(
            noise, states, da, wf, inv_mass, logp_grad, in_slow, window_end,
            max_depth=max_depth, target_accept=target_accept, axis_name=axis_name,
        )
        eps_final = torch.exp(da.log_eps_bar) if num_warmup > 0 else torch.exp(da.log_eps)
        states, zs, stats = sample_pooled(
            noise, states, logp_grad, eps_final, inv_mass, num_samples, max_depth=max_depth
        )
    return _pooled_result(zs, stats, eps_final, inv_mass, max_depth, logp_grad.calls, states)


def run_pooled_chains_chunked(
    rng,
    z0s,
    logdensity_fn: Callable,
    *,
    args=(),
    num_warmup: int,
    num_samples: int,
    max_depth: int = 10,
    target_accept: float = 0.8,
    warmup_chunk: int = 100,
    sample_chunk: int = 100,
    mesh=None,
    axis: str = "chain",
    auto_depth: bool = False,
    depth_probe: Optional[int] = None,
    depth_margin: int = 2,
    warmup_start_cap: int = 6,
    treedepth_warn_threshold: float = 0.05,
    device=None,
) -> PooledResult:
    """``run_pooled_chains`` as a host loop over warmup and sampling chunks,
    with the tree-depth cap re-chosen between chunks (ref:
    pooled.py:346-547).

    At a fixed cap (``auto_depth=False``) the draws equal
    ``run_pooled_chains``'s from the same generator, bit for bit: the chunks
    run the same operations in the same order and the one generator is
    carried across them, never re-seeded.

    ``auto_depth=True``: warmup starts at ``min(max_depth,
    warmup_start_cap)``; after each warmup chunk but the last the cap is
    re-chosen, up or down within ``max_depth``, from the tree depths of that
    chunk's last 50 steps (``adapt.choose_depth_cap``); ``depth_probe``
    splits a chunk at that step, so that a re-size reads it.  The sampling
    phase then re-sizes from a pilot of the first 100 draws (as many as the
    chunk that ends there holds): where the pilot hit its own cap on more than
    ``treedepth_warn_threshold`` of its transitions, the cap goes up by at
    least one and another pilot of 100 draws re-checks (the draws are kept).
    The reference takes each warmup decision one chunk later (it reads a
    chunk's depths only after the next chunk is dispatched, to hide its
    relay's round trip); with no such lag here the port re-sizes one chunk
    earlier.  The saturation warning counts each sampling chunk against the
    cap that chunk ran at (as ``infer/resume.py`` does), where the reference
    counts every draw against the final cap, so that the truncation an
    escalation detected still warns.  ``PooledResult.max_depth`` is the final
    cap, ``chunk_caps`` the cap of every chunk, ``chunk_seconds`` its host
    wall (the sampler synchronises with the device at every leaf, so this is
    the chunk's time to within one leaf).

    ``mesh=`` (a ``DeviceMesh``, ``parallel.chain_mesh``; chains sharded over
    its dimension ``axis``): every rank calls this with the global ``z0s``
    (chains divisible by the mesh size) and its own generator ``rng`` (for
    example from ``parallel.mesh.sharded_inits``), keeps its contiguous block
    of chains, pools the warmup statistics across the ranks as
    ``run_pooled_chains(axis_name=axis)`` does, and returns the global result
    (``gather_pooled``).  Every cap decision reads the depths of every rank
    (``_pooled_depths``), so all ranks run the same caps; the draws equal the
    monolithic sharded run's, bit for bit, at a fixed cap.  ``device``
    defaults to the mesh's.
    """
    axis_name = None
    if mesh is not None:
        coll.bind_mesh(mesh)
        axis_name, size, rank = axis, mesh.size(), mesh.get_local_rank(axis)
        if z0s.shape[0] % size:
            raise ValueError(f"{z0s.shape[0]} chains not divisible by mesh size {size}")
        z0s = z0s.chunk(size)[rank]
        device = coll.mesh_device(mesh) if device is None else device
    device = torch.device(get_config().device if device is None else device)
    z0s = z0s.to(device)
    args = tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in args)
    noise = rng if hasattr(rng, "normal") else ChainNoise(rng, device, z0s.dtype)
    logp_grad = LogpGrad(logdensity_fn, args)
    in_slow, window_end = adapt.warmup_schedule(num_warmup)
    cap = max(2, warmup_start_cap) if auto_depth and warmup_start_cap < max_depth else max_depth
    probe = min(depth_probe, num_warmup) if auto_depth and depth_probe is not None else 0
    caps, seconds = [], []

    with torch.no_grad():
        states, da, wf, inv_mass = init_pooled(noise, z0s, logp_grad, axis_name)
        s = 0
        while s < num_warmup:
            t0 = time.perf_counter()
            e = min(s + warmup_chunk, num_warmup)
            if auto_depth and s < probe < e:
                e = probe
            depths = []
            states, da, wf, inv_mass = warmup_pooled(
                noise, states, da, wf, inv_mass, logp_grad, in_slow[s:e], window_end[s:e],
                max_depth=cap, target_accept=target_accept, depths=depths, axis_name=axis_name,
            )
            caps.append(cap)
            s = e
            if auto_depth and s < num_warmup:  # from the chunk's last 50 steps
                cap = adapt.choose_depth_cap(_pooled_depths(depths[-50:], max_depth, axis_name), max_depth, depth_margin)
            seconds.append(time.perf_counter() - t0)
        eps_final = torch.exp(da.log_eps_bar) if num_warmup > 0 else torch.exp(da.log_eps)

        zs_parts, stats_parts = [], []
        hits = total = done = 0
        pilot_end = min(100, num_samples) if auto_depth else 0
        piloting = auto_depth
        while done < num_samples:
            t0 = time.perf_counter()
            n = min(sample_chunk, num_samples - done)
            if piloting and done < pilot_end:
                n = min(n, pilot_end - done)
            states, zs, stats = sample_pooled(noise, states, logp_grad, eps_final, inv_mass, n, max_depth=cap)
            zs_parts.append(zs)
            stats_parts.append(stats)
            caps.append(cap)
            done += n
            if auto_depth:
                depth = _pooled_depths(stats.tree_depth, max_depth, axis_name)
                hits += int((depth >= cap).sum())
                total += depth.size
            if piloting and done == pilot_end and done < num_samples:
                new_cap = adapt.choose_depth_cap(depth, max_depth, depth_margin)
                if float(np.mean(depth >= cap)) > treedepth_warn_threshold and cap < max_depth:
                    new_cap = max(new_cap, cap + 1)
                    pilot_end = min(done + 100, num_samples)  # re-pilot
                else:
                    piloting = False
                cap = new_cap
            seconds.append(time.perf_counter() - t0)
        if not zs_parts:  # num_samples == 0
            _, zs, stats = sample_pooled(noise, states, logp_grad, eps_final, inv_mass, 0, max_depth=cap)
            zs_parts, stats_parts = [zs], [stats]
    zs = torch.cat(zs_parts, 0)
    stats = NutsStats(*(torch.cat(f, 0) for f in zip(*stats_parts)))
    if auto_depth and total:
        adapt.warn_on_saturation_rate(hits / total, cap, treedepth_warn_threshold)
    res = _pooled_result(zs, stats, eps_final, inv_mass, cap, logp_grad.calls, states, caps, seconds)
    return res if axis_name is None else gather_pooled(res, axis_name)
