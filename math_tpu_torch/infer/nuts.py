"""NUTS with multinomial tree doubling, chain-batched.

Counterpart: ``math_tpu/infer/nuts.py``.  The same iterative formulation of
multinomial NUTS (Hoffman & Gelman 2011; Betancourt's multinomial variant as
in Stan; iterative U-turn checkpointing):

- tree doubling up to ``max_depth``
- each subtree built leaf by leaf, with early exit on turning/divergence
- sub-U-turn checks via a checkpoint stack indexed by the bit pattern of the
  leaf index (store at even leaves, check at odd leaves)
- biased-progressive sampling across doublings, multinomial within subtrees

The JAX package writes one chain and gets the chain axis from ``vmap``, which
runs a ``while_loop`` body for all lanes while any lane is live and freezes
the whole carry of a finished lane by select.  Here that is written out: every
carried tensor has a leading chain axis ``(C, ...)``, the loops are Python
``while`` loops that run while any lane is live, and every update is masked
with the lane's liveness, so a lane that has turned or diverged never changes
again.  Because all live lanes started the loop together, they share the loop
counters: the doubling ``depth`` and the ``leaf`` index within a subtree are
Python integers, and only liveness differs between lanes.  (Each ``any()`` is
one host synchronisation per leaf.)

All randomness comes through a ``ChainNoise`` object, so a test can replace it
with a replay of numbers made elsewhere.

The inverse metric is shared by all chains (``(D,)`` diagonal, ``(D, D)``
dense: the pooled sampler's) or one per chain (``sample_nuts``'s per-chain
adaptation): a ``Metric`` says which, since a ``(C, D)`` per-chain diagonal
and a ``(D, D)`` shared dense metric are both 2-D.  A bare tensor is read as a
shared metric.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class IntegratorState(NamedTuple):
    z: torch.Tensor  # (C, D)
    r: torch.Tensor  # (C, D)
    logp: torch.Tensor  # (C,)
    grad: torch.Tensor  # (C, D)


class Tree(NamedTuple):
    z_left: torch.Tensor
    r_left: torch.Tensor
    grad_left: torch.Tensor
    logp_left: torch.Tensor
    z_right: torch.Tensor
    r_right: torch.Tensor
    grad_right: torch.Tensor
    logp_right: torch.Tensor
    z_prop: torch.Tensor
    logp_prop: torch.Tensor
    grad_prop: torch.Tensor
    energy_prop: torch.Tensor
    log_sum_w: torch.Tensor
    rho: torch.Tensor
    turning: torch.Tensor
    diverging: torch.Tensor
    sum_accept: torch.Tensor
    n_leaves: torch.Tensor
    depth: torch.Tensor


class NutsStats(NamedTuple):
    accept_prob: torch.Tensor
    step_size: torch.Tensor
    tree_depth: torch.Tensor
    n_leapfrog: torch.Tensor
    diverging: torch.Tensor
    energy: torch.Tensor


class ChainNoise:
    """The sampler's only source of randomness: draws on ``device`` from one
    ``torch.Generator``.  ``site`` names the place that asks (for example
    ``("leaf", depth, leaf)``); this class ignores it, a replay in a test keys
    on it."""

    def __init__(self, generator, device, dtype):
        self.generator = generator
        self.device = torch.device(device)
        self.dtype = dtype

    def normal(self, shape, site=None):
        return torch.randn(shape, generator=self.generator, device=self.device, dtype=self.dtype)

    def uniform(self, shape, site=None):
        return torch.rand(shape, generator=self.generator, device=self.device, dtype=self.dtype)

    def bernoulli(self, shape, site=None):
        return self.uniform(shape, site) < 0.5


class LogpGrad:
    """Value and gradient of a chain-batched log density ``(C, D) -> (C,)``.

    Chains are independent, so the gradient of ``logp.sum()`` is the per-chain
    gradient.  Each call makes a fresh leaf and returns detached tensors, so
    no graph outlives the call.  ``calls`` counts the chain-batched gradient
    evaluations (one call serves every chain)."""

    def __init__(self, logdensity_fn: Callable, args=()):
        self.fn = logdensity_fn
        self.args = tuple(args)
        self.calls = 0

    def __call__(self, z):
        self.calls += 1
        z = z.detach().requires_grad_(True)
        with torch.enable_grad():
            logp = self.fn(z, *self.args)
            (grad,) = torch.autograd.grad(logp.sum(), z)
        return logp.detach(), grad


class Metric(NamedTuple):
    """An inverse metric M^-1 with its kind explicit: ``inv_mass`` is ``(D,)``
    or, one per chain, ``(C, D)`` where ``dense`` is False (Stan's diag_e);
    ``(D, D)`` or, one per chain, ``(C, D, D)`` where it is True (dense_e).
    ``chol`` is the lower Cholesky factor of a dense ``inv_mass``, made once
    by ``make_metric`` (None for a diagonal one)."""

    inv_mass: torch.Tensor
    dense: bool
    chol: Optional[torch.Tensor] = None


def make_metric(inv_mass, dense):
    """A ``Metric`` for ``inv_mass`` of the given kind, a dense one factored
    here, once (the sampler makes one when a warmup window ends)."""
    return Metric(inv_mass, bool(dense), torch.linalg.cholesky(inv_mass) if dense else None)


def as_metric(inv_mass):
    """A ``Metric`` as it is, or a bare tensor read as a shared metric:
    ``(D,)`` diagonal, ``(D, D)`` dense."""
    if isinstance(inv_mass, Metric):
        return inv_mass
    return Metric(inv_mass, inv_mass.ndim == 2)


def _per_chain(t, r):
    """A per-chain ``(C, D)`` factor shaped against momenta ``(C, ..., D)``."""
    return t.reshape(t.shape[:1] + (1,) * (r.ndim - 2) + t.shape[1:])


def velocity(inv_mass, r):
    """M^-1 r for momenta ``(..., D)`` (``(C, ..., D)`` under a per-chain
    metric); ``inv_mass`` is a ``Metric`` or a bare shared tensor, (D,)
    diagonal or (D, D) dense (Stan's diag_e / dense_e metrics)."""
    m = as_metric(inv_mass)
    im = m.inv_mass
    if m.dense:
        if im.ndim == 2:
            return r @ im.mT
        c, d = r.shape[0], r.shape[-1]
        return torch.bmm(r.reshape(c, -1, d), im.mT).reshape(r.shape)
    if im.ndim == 2:
        return _per_chain(im, r) * r
    return im * r


velocity_batch = velocity


def kinetic_energy(inv_mass, r):
    return 0.5 * torch.sum(r * velocity(inv_mass, r), dim=-1)


def sample_momentum(noise, inv_mass, shape, site="momentum"):
    """r ~ N(0, M) with M = inv_mass^-1: diag -> z/sqrt(im); dense -> L^-T z
    with L = chol(inv_mass) (so cov(r) = L^-T L^-1 = M), the factor taken
    from the ``Metric`` where it carries one.  ``shape`` is ``(C, D)``."""
    z = noise.normal(tuple(shape), site=site)
    m = as_metric(inv_mass)
    if m.dense:
        chol = m.chol if m.chol is not None else torch.linalg.cholesky(m.inv_mass)
        if chol.ndim == 2:
            return torch.linalg.solve_triangular(chol.mT, z.mT, upper=True).mT
        return torch.linalg.solve_triangular(chol.mT, z[..., None], upper=True)[..., 0]
    return z / torch.sqrt(m.inv_mass)


def _col(eps):
    """A step size as a column against (C, D): scalars stay scalars."""
    if isinstance(eps, torch.Tensor) and eps.ndim == 1:
        return eps[:, None]
    return eps


def leapfrog(logp_grad_fn: Callable, state: IntegratorState, eps, inv_mass):
    """One velocity-Verlet step for every chain; ``eps`` is a scalar or a
    per-chain ``(C,)`` (signed) step size."""
    e = _col(eps)
    r_half = state.r + 0.5 * e * state.grad
    z_new = state.z + e * velocity(inv_mass, r_half)
    logp, grad = logp_grad_fn(z_new)
    r_new = r_half + 0.5 * e * grad
    return IntegratorState(z_new, r_new, logp, grad)


def _is_turning(inv_mass, r_left, r_right, rho):
    """Generalized-NUTS termination criterion (Stan's compute_criterion)."""
    v_left = velocity(inv_mass, r_left)
    v_right = velocity(inv_mass, r_right)
    return (torch.sum(v_left * rho, -1) <= 0) | (torch.sum(v_right * rho, -1) <= 0)


def _popcount(x):
    if isinstance(x, torch.Tensor):
        x = x.to(torch.int64)
        x = x - ((x >> 1) & 0x55555555)
        x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
        x = (x + (x >> 4)) & 0x0F0F0F0F
        return ((x * 0x01010101) & 0xFFFFFFFF) >> 24
    return bin(int(x)).count("1")


def _leaf_ckpt_idx(leaf):
    """Checkpoint bookkeeping for iterative sub-U-turn checks.

    For leaf index l (0-based within the subtree): store at
    ``idx_max = popcount(l >> 1)`` when l is even; when l is odd, check the
    spans ending at l, whose checkpoints live at idx_min..idx_max with
    ``idx_min = idx_max - trailing_ones(l) + 1``.  ``leaf`` is a Python int
    (the sampler's case: live lanes share the leaf index) or an integer
    tensor.
    """
    idx_max = _popcount(leaf >> 1)
    trailing_ones = _popcount(leaf ^ (leaf + 1)) - 1
    idx_min = idx_max - trailing_ones + 1
    return idx_min, idx_max


def _iterative_turning(inv_mass, r_new, rho_cum, r_ckpts, rho_ckpts, idx_min, idx_max):
    """Check U-turn of every subtree span ending at the current (odd) leaf.

    ``r_new``, ``rho_cum`` are ``(C, D)``, the checkpoint stacks
    ``(C, max_depth, D)``; ``idx_min``/``idx_max`` are ints or ``(C,)``
    tensors.  All slots are checked in one masked pass.
    """
    k = r_ckpts.shape[-2]
    slots = torch.arange(k, device=r_ckpts.device)
    if isinstance(idx_min, torch.Tensor):
        idx_min = idx_min[..., None]
    if isinstance(idx_max, torch.Tensor):
        idx_max = idx_max[..., None]
    mask = (slots >= idx_min) & (slots <= idx_max)
    rho_span = rho_cum[..., None, :] - rho_ckpts + r_ckpts  # (C, K, D)
    turn_left = torch.sum(velocity(inv_mass, r_ckpts) * rho_span, -1) <= 0
    turn_right = torch.sum(velocity(inv_mass, r_new)[..., None, :] * rho_span, -1) <= 0
    return torch.any(mask & (turn_left | turn_right), dim=-1)


def _build_subtree(
    noise,
    logp_grad_fn,
    edge: IntegratorState,
    direction,
    depth: int,
    eps,
    inv_mass,
    energy0,
    max_depth: int,
    max_delta_energy: float,
    active,
):
    """Build, for every lane in ``active``, a balanced subtree of 2^depth
    leaves from ``edge`` going in ``direction`` (C,), leaf by leaf, with early
    exit of a lane on turning/divergence.  Lanes outside ``active`` come back
    with an empty subtree (no leaves, ``log_sum_w = -inf``)."""
    n_chains, dim = edge.z.shape
    dt, dev = edge.z.dtype, edge.z.device
    num_leaves = 1 << depth
    signed_eps = direction * eps

    r_ckpts = torch.zeros((n_chains, max_depth, dim), dtype=dt, device=dev)
    rho_ckpts = torch.zeros((n_chains, max_depth, dim), dtype=dt, device=dev)

    false = torch.zeros((n_chains,), dtype=torch.bool, device=dev)
    tree = Tree(
        z_left=edge.z,
        r_left=edge.r,
        grad_left=edge.grad,
        logp_left=edge.logp,
        z_right=edge.z,
        r_right=edge.r,
        grad_right=edge.grad,
        logp_right=edge.logp,
        z_prop=edge.z,
        logp_prop=edge.logp,
        grad_prop=edge.grad,
        energy_prop=energy0,
        log_sum_w=torch.full((n_chains,), -float("inf"), dtype=dt, device=dev),
        rho=torch.zeros((n_chains, dim), dtype=dt, device=dev),
        turning=false,
        diverging=false,
        sum_accept=torch.zeros((n_chains,), dtype=dt, device=dev),
        n_leaves=torch.zeros((n_chains,), dtype=torch.int32, device=dev),
        depth=torch.full((n_chains,), depth, dtype=torch.int32, device=dev),
    )
    inf = torch.as_tensor(float("inf"), dtype=dt, device=dev)

    live = active
    leaf = 0
    # (the caller has checked that some lane of ``active`` is live)
    while leaf < num_leaves and (leaf == 0 or bool(live.any())):
        # the integrator state of a lane is its tree's right edge (the newest
        # leaf); finished lanes integrate too and are masked out below
        state = IntegratorState(tree.z_right, tree.r_right, tree.logp_right, tree.grad_right)
        state = leapfrog(logp_grad_fn, state, signed_eps, inv_mass)
        energy = -state.logp + kinetic_energy(inv_mass, state.r)
        energy = torch.where(torch.isnan(energy), inf, energy)
        delta = energy - energy0
        diverging = delta > max_delta_energy
        log_w = -delta
        accept_prob = torch.clamp(torch.exp(-delta), max=1.0)

        # progressive multinomial proposal within the subtree
        new_lsw = torch.logaddexp(tree.log_sum_w, log_w)
        u = noise.uniform((n_chains,), site=("leaf", depth, leaf))
        take = live & (torch.log(u) < (log_w - new_lsw))
        take_c = take[:, None]
        live_c = live[:, None]

        rho = tree.rho + state.r

        # checkpoint store (even leaves) / check (odd leaves)
        idx_min, idx_max = _leaf_ckpt_idx(leaf)
        if leaf % 2 == 0:
            r_ckpts[:, idx_max] = torch.where(live_c, state.r, r_ckpts[:, idx_max])
            rho_ckpts[:, idx_max] = torch.where(live_c, rho, rho_ckpts[:, idx_max])
            turning = false
        else:
            # (a 1-leaf "span" cannot u-turn: depth 0 has no odd leaf)
            turning = _iterative_turning(
                inv_mass, state.r, rho, r_ckpts, rho_ckpts, idx_min, idx_max
            )

        first = leaf == 0
        tree = Tree(
            z_left=torch.where(live_c, state.z, tree.z_left) if first else tree.z_left,
            r_left=torch.where(live_c, state.r, tree.r_left) if first else tree.r_left,
            grad_left=torch.where(live_c, state.grad, tree.grad_left) if first else tree.grad_left,
            logp_left=torch.where(live, state.logp, tree.logp_left) if first else tree.logp_left,
            z_right=torch.where(live_c, state.z, tree.z_right),
            r_right=torch.where(live_c, state.r, tree.r_right),
            grad_right=torch.where(live_c, state.grad, tree.grad_right),
            logp_right=torch.where(live, state.logp, tree.logp_right),
            z_prop=torch.where(take_c, state.z, tree.z_prop),
            logp_prop=torch.where(take, state.logp, tree.logp_prop),
            grad_prop=torch.where(take_c, state.grad, tree.grad_prop),
            energy_prop=torch.where(take, energy, tree.energy_prop),
            log_sum_w=torch.where(live, new_lsw, tree.log_sum_w),
            rho=torch.where(live_c, rho, tree.rho),
            turning=torch.where(live, turning, tree.turning),
            diverging=torch.where(live, diverging, tree.diverging),
            sum_accept=tree.sum_accept + torch.where(live, accept_prob, torch.zeros_like(accept_prob)),
            n_leaves=tree.n_leaves + live.to(torch.int32),
            depth=tree.depth,
        )
        live = live & ~tree.turning & ~tree.diverging
        leaf += 1
    return tree


def nuts_kernel(
    noise,
    state: IntegratorState,
    logp_grad_fn: Callable,
    eps,
    inv_mass,
    max_depth: int = 10,
    max_delta_energy: float = 1000.0,
):
    """One NUTS transition for every chain.  Returns (new IntegratorState,
    NutsStats), all with the leading chain axis."""
    n_chains, dim = state.z.shape
    dt, dev = state.z.dtype, state.z.device

    r0 = sample_momentum(noise, inv_mass, (n_chains, dim))
    start = IntegratorState(state.z, r0, state.logp, state.grad)
    energy0 = -start.logp + kinetic_energy(inv_mass, r0)

    false = torch.zeros((n_chains,), dtype=torch.bool, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    tree = Tree(
        z_left=start.z,
        r_left=r0,
        grad_left=start.grad,
        logp_left=start.logp,
        z_right=start.z,
        r_right=r0,
        grad_right=start.grad,
        logp_right=start.logp,
        z_prop=start.z,
        logp_prop=start.logp,
        grad_prop=start.grad,
        energy_prop=energy0,
        log_sum_w=torch.zeros((n_chains,), dtype=dt, device=dev),
        rho=r0,
        turning=false,
        diverging=false,
        sum_accept=torch.zeros((n_chains,), dtype=dt, device=dev),
        n_leaves=torch.zeros((n_chains,), dtype=torch.int32, device=dev),
        depth=torch.zeros((n_chains,), dtype=torch.int32, device=dev),
    )

    active = ~false
    depth = 0
    while depth < max_depth and bool(active.any()):
        direction = torch.where(noise.bernoulli((n_chains,), site=("direction", depth)), one, -one)
        fwd = direction > 0
        fwd_c = fwd[:, None]
        edge = IntegratorState(
            torch.where(fwd_c, tree.z_right, tree.z_left),
            torch.where(fwd_c, tree.r_right, tree.r_left),
            torch.where(fwd, tree.logp_right, tree.logp_left),
            torch.where(fwd_c, tree.grad_right, tree.grad_left),
        )
        sub = _build_subtree(
            noise,
            logp_grad_fn,
            edge,
            direction,
            depth,
            eps,
            inv_mass,
            energy0,
            max_depth,
            max_delta_energy,
            active,
        )
        sub_invalid = sub.turning | sub.diverging

        # biased progressive sampling across the doubling
        u = noise.uniform((n_chains,), site=("select", depth))
        take_new = active & ~sub_invalid & (torch.log(u) < (sub.log_sum_w - tree.log_sum_w))
        take_c = take_new[:, None]

        # an invalid subtree leaves the tree state frozen, its stats counted;
        # a finished lane (not in ``active``) is frozen altogether
        grow = active & ~sub_invalid
        grow_l = (grow & ~fwd)[:, None]
        grow_r = (grow & fwd)[:, None]
        r_left = torch.where(grow_l, sub.r_right, tree.r_left)
        r_right = torch.where(grow_r, sub.r_right, tree.r_right)
        rho = torch.where(grow[:, None], tree.rho + sub.rho, tree.rho)
        full_turning = _is_turning(inv_mass, r_left, r_right, rho)
        tree = Tree(
            z_left=torch.where(grow_l, sub.z_right, tree.z_left),
            r_left=r_left,
            grad_left=torch.where(grow_l, sub.grad_right, tree.grad_left),
            logp_left=torch.where(grow_l[:, 0], sub.logp_right, tree.logp_left),
            z_right=torch.where(grow_r, sub.z_right, tree.z_right),
            r_right=r_right,
            grad_right=torch.where(grow_r, sub.grad_right, tree.grad_right),
            logp_right=torch.where(grow_r[:, 0], sub.logp_right, tree.logp_right),
            z_prop=torch.where(take_c, sub.z_prop, tree.z_prop),
            logp_prop=torch.where(take_new, sub.logp_prop, tree.logp_prop),
            grad_prop=torch.where(take_c, sub.grad_prop, tree.grad_prop),
            energy_prop=torch.where(take_new, sub.energy_prop, tree.energy_prop),
            log_sum_w=torch.where(
                grow, torch.logaddexp(tree.log_sum_w, sub.log_sum_w), tree.log_sum_w
            ),
            rho=rho,
            turning=torch.where(active, sub_invalid | full_turning, tree.turning),
            diverging=tree.diverging | (active & sub.diverging),
            sum_accept=tree.sum_accept + sub.sum_accept,
            n_leaves=tree.n_leaves + sub.n_leaves,
            depth=tree.depth + active.to(torch.int32),
        )
        active = active & ~tree.turning & ~tree.diverging
        depth += 1

    new_state = IntegratorState(tree.z_prop, r0, tree.logp_prop, tree.grad_prop)
    n = torch.clamp(tree.n_leaves, min=1)
    eps_t = torch.as_tensor(eps, dtype=dt, device=dev)
    stats = NutsStats(
        accept_prob=tree.sum_accept / n.to(dt),
        step_size=eps_t.expand(n_chains) if eps_t.ndim == 0 else eps_t,
        tree_depth=tree.depth,
        n_leapfrog=tree.n_leaves,
        diverging=tree.diverging,
        energy=tree.energy_prop,
    )
    return new_state, stats
