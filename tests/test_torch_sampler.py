"""PyTorch port: the sampling slice as a whole against ``math_tpu`` (CPU, float64).

Draws cannot agree bit for bit between the frameworks (Threefry and Philox), so
whole runs are held statistically: posterior means of the port's run against a
``math_tpu.infer.pooled.run_pooled_chains`` run of the same model agree within
4 Monte-Carlo standard errors (the errors of both runs added in quadrature,
each from the port's own ESS estimator), and the divergence rate stays low.
Sizes are small on purpose: the whole file is a few tens of seconds.
"""

import numpy as np

import jax
import jax.numpy as jnp
import torch

from math_tpu.diagnostics import convergence as jconv
from math_tpu.infer import pooled as jpooled
from math_tpu.models import eight_schools as jes
from math_tpu.models import glm_logistic as jglm

from math_tpu_torch import convert
from math_tpu_torch.diagnostics import convergence as tconv
from math_tpu_torch.infer import pooled as tpooled
from math_tpu_torch.infer.nuts import ChainNoise, LogpGrad
from math_tpu_torch.models import eight_schools as tes
from math_tpu_torch.models import glm_logistic as tglm
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)


def _mcse(draws):
    """Monte-Carlo standard error of the mean per coordinate of (chains, n, dim)."""
    draws = np.asarray(draws, np.float64)
    return draws.reshape(-1, draws.shape[-1]).std(0) / np.sqrt(tconv.ess(draws))


def _means_agree(got, want, n_se=4.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.abs(got.mean((0, 1)) - want.mean((0, 1)))
    se = np.sqrt(_mcse(got) ** 2 + _mcse(want) ** 2)
    assert np.all(diff < n_se * se), (diff, se)


def _jax_run(model, chains, dim, num_warmup, num_samples, max_depth, args=(), seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), chains)
    z0 = jax.random.uniform(jax.random.PRNGKey(seed + 1), (chains, dim), jnp.float64, -2.0, 2.0)
    run = jax.jit(
        lambda k, z, *a: jpooled.run_pooled_chains(
            k, z, model.logp, args=a, num_warmup=num_warmup, num_samples=num_samples, max_depth=max_depth
        )
    )
    return run(keys, z0, *args)


def test_eight_schools_posterior_matches_jax_run():
    chains, nw, ns, depth = 16, 150, 150, 6
    tm = tes.make()
    g = torch.Generator().manual_seed(0)
    z0 = tm.initial_positions(g, chains, device="cpu", dtype=torch.float64)
    res = tpooled.run_pooled_chains(g, z0, tm.logp, num_warmup=nw, num_samples=ns, max_depth=depth, device="cpu")
    assert res.position.shape == (chains, ns, tm.dim) and res.tree_depth.shape == (chains, ns)
    assert bool(torch.isfinite(res.position).all())
    assert float(res.diverging.double().mean()) < 0.02
    assert int(res.tree_depth.max()) <= depth and res.max_depth == depth
    assert res.n_grad_calls >= int(res.n_leapfrog.max(0).values.sum())
    want = _jax_run(jes.make(), chains, tm.dim, nw, ns, depth)
    assert float(np.mean(np.asarray(want.diverging))) < 0.02
    # mu and log tau (unconstrained coordinates 0 and 1)
    _means_agree(res.position[..., :2].numpy(), np.asarray(want.position)[..., :2])
    # shared step size and metric adapt to the same posterior
    assert 0.5 < float(res.step_size) / float(want.step_size) < 2.0


def test_glm_logistic_posterior_matches_jax_run():
    n, k, chains, nw, ns, depth = 2000, 5, 8, 100, 100, 6
    X, y, beta_true, _ = tglm.synthetic_data(n, k, seed=0, dtype=np.float64)
    tm = tglm.make(k)
    g = torch.Generator().manual_seed(1)
    z0 = tm.initial_positions(g, chains, device="cpu", dtype=torch.float64)
    res = tpooled.run_pooled_chains(
        g, z0, tm.logp, args=(torch.tensor(X), torch.tensor(y)), num_warmup=nw, num_samples=ns, max_depth=depth, device="cpu"
    )
    assert float(res.diverging.double().mean()) < 0.02
    want = _jax_run(jglm.make(k), chains, tm.dim, nw, ns, depth, args=(jnp.asarray(X), y))
    _means_agree(res.position.numpy(), np.asarray(want.position))
    assert np.max(np.abs(res.position[..., 1:].mean((0, 1)).numpy() - beta_true)) < 0.3


def test_warmed_jax_state_carried_into_the_port():
    """A JAX run's adapted step size, metric and last positions go through
    ``convert.from_numpy_state``; 100 sampling steps in the port then target
    the same posterior."""
    chains, depth = 16, 6
    jm, tm = jes.make(), tes.make()
    want = _jax_run(jm, chains, tm.dim, 150, 150, depth, seed=2)
    z_last = np.asarray(want.position)[:, -1, :]
    logp, grad = jax.vmap(jax.value_and_grad(jm.logp))(jnp.asarray(z_last))
    state, eps, inv_mass = convert.from_numpy_state(
        z_last, np.zeros_like(z_last), np.asarray(logp), np.asarray(grad),
        np.asarray(want.step_size), np.asarray(want.inv_mass), device="cpu", dtype=torch.float64,
    )
    assert state.z.dtype == torch.float64 and eps.ndim == 0 and inv_mass.shape == (tm.dim,)
    # the carried state is consistent with the port's own density
    got_logp, got_grad = tm.logp_and_grad(state.z)
    np.testing.assert_allclose(got_logp.numpy(), state.logp.numpy(), rtol=1e-10)
    np.testing.assert_allclose(got_grad.numpy(), state.grad.numpy(), rtol=1e-10, atol=1e-12)
    noise = ChainNoise(torch.Generator().manual_seed(3), "cpu", torch.float64)
    with torch.no_grad():
        _, zs, stats = tpooled.sample_pooled(noise, state, LogpGrad(tm.logp), eps, inv_mass, 100, max_depth=depth)
    assert float(stats.diverging.double().mean()) < 0.02
    assert 0.6 < float(stats.accept_prob.mean()) < 0.98
    _means_agree(zs.swapaxes(0, 1)[..., :2].numpy(), np.asarray(want.position)[..., :2])


def test_adaptation_state_converters():
    da = convert.dual_averaging_from_numpy(np.log(0.3), 0.1, -0.2, np.log(3.0), 7, device="cpu", dtype=torch.float64)
    assert int(da.count) == 7 and da.count.dtype == torch.int32 and float(da.mu) == np.log(3.0)
    wf = convert.welford_from_numpy(5.0, np.arange(3.0), np.ones(3), device="cpu", dtype=torch.float32)
    assert wf.mean.dtype == torch.float32 and float(wf.count) == 5.0 and wf.m2.shape == (3,)


def test_diagnostics_equal_the_jax_package():
    rng = np.random.default_rng(0)
    # AR(1) chains, so the autocorrelation sum does real work
    x = np.zeros((6, 200, 3))
    e = rng.normal(size=x.shape)
    for t in range(1, x.shape[1]):
        x[:, t] = 0.7 * x[:, t - 1] + e[:, t]
    x[..., 2] += np.arange(6)[:, None] * 0.5  # chains that disagree
    for name in ("ess", "ess_bulk", "ess_tail", "rhat", "split_rhat"):
        np.testing.assert_allclose(getattr(tconv, name)(x), getattr(jconv, name)(x), rtol=1e-12)
        np.testing.assert_allclose(getattr(tconv, name)(x[..., 0]), getattr(jconv, name)(x[..., 0]), rtol=1e-12)
    got, want = tconv.summary(x), jconv.summary(x)
    assert [r["name"] for r in got] == [r["name"] for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose([g[k] for k in g if k != "name"], [w[k] for k in w if k != "name"], rtol=1e-12)
