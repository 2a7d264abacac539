"""PyTorch port: chain-batched NUTS pieces against ``math_tpu`` (CPU, float64).

Deterministic pieces are held at ``rtol=1e-12`` (same arithmetic, float64 on
both sides).  One whole transition is held with REPLAYED randomness: the test
reproduces ``nuts_kernel``'s key splitting with ``jax.random``, records every
number the JAX transition can draw, and feeds the same numbers to the port
through a replay noise object; positions and energies then agree to
``rtol=1e-9`` (sums in another order over a few dozen leapfrogs), tree depths
and leapfrog counts exactly.  That is the test that shows the port's
masked-lane loops equal ``vmap`` of ``while_loop``.
"""

from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from math_tpu.infer import adapt as jadapt
from math_tpu.infer import nuts as jnuts
from math_tpu.infer import pooled as jpooled
from math_tpu.models import eight_schools as jes

from math_tpu_torch.infer import adapt as tadapt
from math_tpu_torch.infer import nuts as tnuts
from math_tpu_torch.infer import pooled as tpooled
from math_tpu_torch.models import eight_schools as tes
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)

RTOL = 1e-12
C, D = 4, 10
JMODEL = jes.make()
TMODEL = tes.make()
J_LOGP_GRAD = jax.value_and_grad(JMODEL.logp)


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _inv_mass(kind, rng):
    if kind == "diag":
        return 0.5 + rng.uniform(size=D)
    a = rng.normal(size=(D, D)) * 0.2
    return a @ a.T + np.diag(0.5 + rng.uniform(size=D))


def _state(rng, scale=1.0):
    z = rng.normal(size=(C, D)) * scale
    r = rng.normal(size=(C, D))
    logp, grad = jax.vmap(J_LOGP_GRAD)(jnp.asarray(z))
    return z, r, np.asarray(logp), np.asarray(grad)


class ReplayNoise:
    """Hands the sampler numbers made elsewhere, keyed by the asking site."""

    def __init__(self, table):
        self.table = table
        self.asked = []

    def _get(self, shape, site):
        self.asked.append(site)
        out = torch.as_tensor(self.table[site])
        assert tuple(out.shape) == tuple(shape), (site, out.shape, shape)
        return out

    normal = uniform = bernoulli = _get


@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_velocity_kinetic_energy(kind):
    rng = np.random.default_rng(1)
    im, r = _inv_mass(kind, rng), rng.normal(size=(C, D))
    close(tnuts.velocity(t64(im), t64(r)), jax.vmap(lambda x: jnuts.velocity(jnp.asarray(im), x))(jnp.asarray(r)))
    close(
        tnuts.kinetic_energy(t64(im), t64(r)),
        jax.vmap(lambda x: jnuts.kinetic_energy(jnp.asarray(im), x))(jnp.asarray(r)),
    )
    rb = rng.normal(size=(C, 5, D))
    close(
        tnuts.velocity_batch(t64(im), t64(rb)),
        jax.vmap(lambda x: jnuts.velocity_batch(jnp.asarray(im), x))(jnp.asarray(rb)),
    )


@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_leapfrog(kind):
    rng = np.random.default_rng(2)
    im = _inv_mass(kind, rng)
    z, r, logp, grad = _state(rng)
    eps = np.array([0.1, -0.2, 0.05, 0.3])
    want = jax.vmap(
        lambda s, e: jnuts.leapfrog(J_LOGP_GRAD, s, e, jnp.asarray(im))
    )(jnuts.IntegratorState(*map(jnp.asarray, (z, r, logp, grad))), jnp.asarray(eps))
    fn = tnuts.LogpGrad(TMODEL.logp)
    got = tnuts.leapfrog(fn, tnuts.IntegratorState(t64(z), t64(r), t64(logp), t64(grad)), t64(eps), t64(im))
    for g, w in zip(got, want):
        close(g, w)
    assert fn.calls == 1 and not got.grad.requires_grad and not got.logp.requires_grad


@pytest.mark.parametrize("leaf", range(64))
def test_leaf_ckpt_idx(leaf):
    want = tuple(int(v) for v in jnuts._leaf_ckpt_idx(jnp.asarray(leaf, jnp.int32)))
    assert tnuts._leaf_ckpt_idx(leaf) == want
    got_t = tnuts._leaf_ckpt_idx(torch.tensor([leaf, leaf]))
    assert tuple(int(v[1]) for v in got_t) == want


@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_turning_checks(kind):
    rng = np.random.default_rng(3)
    im = _inv_mass(kind, rng)
    jim = jnp.asarray(im)
    n, k = 24, 6
    r_new, rho = rng.normal(size=(n, D)), rng.normal(size=(n, D))
    r_ck, rho_ck = rng.normal(size=(n, k, D)), rng.normal(size=(n, k, D)) * 2.0
    lo = rng.integers(0, k, size=n)
    hi = np.minimum(lo + rng.integers(0, 3, size=n), k - 1)
    want = jax.vmap(partial(jnuts._iterative_turning, jim))(
        *map(jnp.asarray, (r_new, rho, r_ck, rho_ck)), jnp.asarray(lo, jnp.int32), jnp.asarray(hi, jnp.int32)
    )
    got = tnuts._iterative_turning(
        t64(im), t64(r_new), t64(rho), t64(r_ck), t64(rho_ck), torch.tensor(lo), torch.tensor(hi)
    )
    assert np.array_equal(got.numpy(), np.asarray(want)) and 0 < int(got.sum()) < n
    # the sampler's case: one Python (idx_min, idx_max) for every lane
    got_i = tnuts._iterative_turning(t64(im), t64(r_new), t64(rho), t64(r_ck), t64(rho_ck), 1, 3)
    want_i = jax.vmap(lambda a, b, c, d: jnuts._iterative_turning(jim, a, b, c, d, 1, 3))(
        *map(jnp.asarray, (r_new, rho, r_ck, rho_ck))
    )
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    r_l, r_r = rng.normal(size=(n, D)), rng.normal(size=(n, D))
    want_t = jax.vmap(partial(jnuts._is_turning, jim))(*map(jnp.asarray, (r_l, r_r, rho)))
    got_t = tnuts._is_turning(t64(im), t64(r_l), t64(r_r), t64(rho))
    assert np.array_equal(got_t.numpy(), np.asarray(want_t)) and 0 < int(got_t.sum()) < n


def test_dual_averaging_50_steps():
    rng = np.random.default_rng(4)
    acc = rng.uniform(size=50)
    js = jadapt.da_init(0.37, jnp.float64)
    ts = tadapt.da_init(0.37, torch.float64)
    for a in acc:
        js = jadapt.da_update(js, jnp.asarray(a), target=0.8)
        ts = tadapt.da_update(ts, t64(a), target=0.8)
        for g, w in zip(ts, js):
            close(g, w)
    assert int(ts.count) == 50


def test_welford_accumulators():
    rng = np.random.default_rng(5)
    xs = rng.normal(size=(20, D)) * rng.uniform(0.5, 3.0, size=D)
    jw, tw = jadapt.welford_init(D, jnp.float64), tadapt.welford_init(D, torch.float64)
    jc, tc = jadapt.welford_cov_init(D, jnp.float64), tadapt.welford_cov_init(D, torch.float64)
    for x in xs:
        jw, tw = jadapt.welford_update(jw, jnp.asarray(x)), tadapt.welford_update(tw, t64(x))
        jc, tc = jadapt.welford_cov_update(jc, jnp.asarray(x)), tadapt.welford_cov_update(tc, t64(x))
    for g, w in list(zip(tw, jw)) + list(zip(tc, jc)):
        close(g, w)
    close(tadapt.welford_variance_regularized(tw), jadapt.welford_variance_regularized(jw))
    close(tadapt.welford_cov_regularized(tc), jadapt.welford_cov_regularized(jc))
    # empty accumulator: the n >= 2 clamp
    close(
        tadapt.welford_variance_regularized(tadapt.welford_init(D, torch.float64)),
        jadapt.welford_variance_regularized(jadapt.welford_init(D, jnp.float64)),
    )


def test_welford_merge_batch():
    rng = np.random.default_rng(6)
    jw, tw = jadapt.welford_init(D, jnp.float64), tadapt.welford_init(D, torch.float64)
    for _ in range(3):
        zs = rng.normal(size=(16, D)) + 2.0
        jw = jpooled._welford_merge_batch(jw, jnp.asarray(zs), None)
        tw = tpooled._welford_merge_batch(tw, t64(zs))
        for g, w in zip(tw, jw):
            close(g, w)
    assert float(tw.count) == 48.0


@pytest.mark.parametrize("num_warmup", [0, 10, 20, 100, 150, 500, 1000])
def test_warmup_schedule(num_warmup):
    for g, w in zip(tadapt.warmup_schedule(num_warmup), jadapt.warmup_schedule(num_warmup)):
        assert g.dtype == bool and np.array_equal(g, w)
    we = tadapt.warmup_schedule(num_warmup)[1]
    assert tadapt.depth_probe_window(we, num_warmup) == jadapt.depth_probe_window(we, num_warmup)
    assert tadapt.depth_probe_window(we, num_warmup, override=30) == jadapt.depth_probe_window(we, num_warmup, override=30)


@pytest.mark.parametrize("seed", range(6))
def test_choose_depth_cap(seed):
    rng = np.random.default_rng(seed)
    depths = np.clip(rng.poisson(2.0 + seed, size=400), 1, 10)
    for cap in (4, 6, 10):
        assert tadapt.choose_depth_cap(depths, cap) == jadapt.choose_depth_cap(depths, cap)
        assert tadapt.treedepth_saturation(depths, cap) == jadapt.treedepth_saturation(depths, cap)
    assert tadapt.choose_depth_cap(np.array([]), 7) == 7


def test_find_reasonable_step_size_momentum_replayed():
    rng = np.random.default_rng(7)
    im = _inv_mass("diag", rng)
    z, _, logp, grad = _state(rng, scale=np.array([0.2, 1.0, 3.0, 6.0])[:, None])
    keys = jax.random.split(jax.random.PRNGKey(11), C)
    jstate = jnuts.IntegratorState(*map(jnp.asarray, (z, np.zeros_like(z), logp, grad)))
    want = jax.jit(jax.vmap(lambda k, s: jadapt.find_reasonable_step_size(k, J_LOGP_GRAD, s, jnp.asarray(im))))(keys, jstate)
    noise = ReplayNoise(
        {"step_size_momentum": np.stack([np.asarray(jax.random.normal(k, (D,), jnp.float64)) for k in keys])}
    )
    tstate = tnuts.IntegratorState(t64(z), t64(np.zeros_like(z)), t64(logp), t64(grad))
    got = tadapt.find_reasonable_step_size(noise, tnuts.LogpGrad(TMODEL.logp), tstate, t64(im))
    close(got, want)
    assert len(set(np.asarray(want).tolist())) > 1  # lanes stop at different step sizes


def _jax_noise_table(keys, max_depth):
    """Everything ``nuts_kernel`` can draw, per chain, from its key-splitting
    scheme (``nuts.py``: split for momentum/loop, 4-way split per doubling,
    one split per leaf)."""
    table = {}
    per_chain = []
    for key in keys:
        t = {}
        key_mom, key = jax.random.split(key)
        t["momentum"] = np.asarray(jax.random.normal(key_mom, (D,), jnp.float64))
        for depth in range(max_depth):
            key, key_dir, key_sub, key_sel = jax.random.split(key, 4)
            t[("direction", depth)] = bool(jax.random.bernoulli(key_dir))
            t[("select", depth)] = float(jax.random.uniform(key_sel, dtype=jnp.float64))
            k = key_sub
            for leaf in range(1 << depth):
                k, sub = jax.random.split(k)
                t[("leaf", depth, leaf)] = float(jax.random.uniform(sub, dtype=jnp.float64))
        per_chain.append(t)
    for site in per_chain[0]:
        table[site] = np.stack([np.asarray(t[site]) for t in per_chain])
    return table


@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_whole_transition_replayed_randomness(kind):
    max_depth = 5
    rng = np.random.default_rng(8)
    im = _inv_mass(kind, rng)
    z, _, logp, grad = _state(rng, scale=np.array([1.0, 1.0, 1.0, 6.0])[:, None])
    eps = 0.8  # lanes stop at different depths; the far-out lane diverges
    keys = jax.random.split(jax.random.PRNGKey(5), C)
    jstate = jnuts.IntegratorState(*map(jnp.asarray, (z, np.zeros_like(z), logp, grad)))
    jkernel = jax.jit(
        jax.vmap(
            lambda k, s: jnuts.nuts_kernel(k, s, J_LOGP_GRAD, jnp.asarray(eps), jnp.asarray(im), max_depth=max_depth)
        )
    )
    want_state, want_stats = jkernel(keys, jstate)

    noise = ReplayNoise(_jax_noise_table(keys, max_depth))
    tstate = tnuts.IntegratorState(t64(z), t64(np.zeros_like(z)), t64(logp), t64(grad))
    fn = tnuts.LogpGrad(TMODEL.logp)
    with torch.no_grad():
        got_state, got_stats = tnuts.nuts_kernel(noise, tstate, fn, t64(eps), t64(im), max_depth=max_depth)

    assert np.array_equal(got_stats.tree_depth.numpy(), np.asarray(want_stats.tree_depth))
    assert np.array_equal(got_stats.n_leapfrog.numpy(), np.asarray(want_stats.n_leapfrog))
    assert np.array_equal(got_stats.diverging.numpy(), np.asarray(want_stats.diverging))
    # the lanes must differ, or the masks were not exercised
    assert len(set(np.asarray(want_stats.n_leapfrog).tolist())) > 1
    close(got_stats.accept_prob, want_stats.accept_prob, rtol=1e-9)
    close(got_stats.energy, want_stats.energy, rtol=1e-9)
    close(got_stats.step_size, want_stats.step_size)
    for g, w in zip(got_state, want_state):
        close(g, w, rtol=1e-9, atol=1e-12)
    # one chain-batched gradient call per leaf of the deepest live lane
    assert fn.calls <= int(np.asarray(want_stats.n_leapfrog).sum())
    assert fn.calls >= int(np.asarray(want_stats.n_leapfrog).max())
