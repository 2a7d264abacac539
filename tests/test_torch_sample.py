"""PyTorch port: ``infer/sample.py`` (``sample_nuts``) and its per-chain
pieces against ``math_tpu`` (CPU, float64).

Deterministic pieces are held at ``rtol=1e-10``: the chain-batched Welford
and covariance accumulators and dual averaging against the reference's
per-chain ones on the same draws, the initial-density check (it must name the
same chains), and the three metric forms at ``C == D``, where a per-chain
diagonal ``(C, D)`` metric and a shared dense ``(D, D)`` one have the same
shape.  Whole runs are held statistically, as in ``test_torch_sampler.py``:
posterior means and standard deviations of the port's ``sample_nuts`` against
a ``math_tpu.infer.sample_nuts`` run of the same model within 4 Monte-Carlo
standard errors, and the dense metric against the true covariance within the
reference tests' bounds (``tests/test_dense_mass.py``).  Sizes are small: the
whole file is a few tens of seconds.
"""

import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from math_tpu.infer import adapt as jadapt
from math_tpu.infer import nuts as jnuts
from math_tpu.infer import sample as jsample
from math_tpu.models import eight_schools as jes

from math_tpu_torch import dists, transforms
from math_tpu_torch.diagnostics import convergence as tconv
from math_tpu_torch.diagnostics import summary
from math_tpu_torch.infer import ChainResult, sample_nuts
from math_tpu_torch.infer import adapt as tadapt
from math_tpu_torch.infer import nuts as tnuts
from math_tpu_torch.infer import sample as tsample
from math_tpu_torch.model import make_log_density
from math_tpu_torch.models import eight_schools as tes
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)

RTOL = 1e-10
C, D, T = 5, 5, 40  # chains == dimensions: the per-chain diagonal and shared dense forms share a shape


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _draws(seed=0):
    return np.random.default_rng(seed).normal(size=(T, C, D)) * np.linspace(0.5, 2.0, D)


# --- the chain-batched accumulators -----------------------------------------


@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_welford_per_chain_matches_reference_per_chain(kind):
    """One chain-batched accumulator over (C, D) draws against C reference
    accumulators, each over its own chain's draws."""
    xs = _draws()
    init, update, final = {
        "diag": (tadapt.welford_init, tadapt.welford_update, tadapt.welford_variance_regularized),
        "dense": (tadapt.welford_cov_init, tadapt.welford_cov_update, tadapt.welford_cov_regularized),
    }[kind]
    jinit, jupdate, jfinal = {
        "diag": (jadapt.welford_init, jadapt.welford_update, jadapt.welford_variance_regularized),
        "dense": (jadapt.welford_cov_init, jadapt.welford_cov_update, jadapt.welford_cov_regularized),
    }[kind]
    s = init(D, torch.float64, "cpu", chains=C)
    for x in xs:
        s = update(s, t64(x))
    for c in range(C):
        js = jinit(D, jnp.float64)
        for x in xs:
            js = jupdate(js, jnp.asarray(x[c]))
        close(s.mean[c], js.mean)
        close(s.m2[c], js.m2)
        close(final(s)[c], jfinal(js))
    assert final(s).shape == ((C, D) if kind == "diag" else (C, D, D))


def test_welford_shared_form_is_unchanged():
    """Without ``chains`` the accumulators hold one (D,) / (D, D) state, as before."""
    assert tadapt.welford_init(D).mean.shape == (D,)
    s = tadapt.welford_cov_init(D, torch.float64)
    for x in _draws()[:, 0]:
        s = tadapt.welford_cov_update(s, t64(x))
    js = jadapt.welford_cov_init(D, jnp.float64)
    for x in _draws()[:, 0]:
        js = jadapt.welford_cov_update(js, jnp.asarray(x))
    close(tadapt.welford_cov_regularized(s), jadapt.welford_cov_regularized(js))


def test_dual_averaging_takes_per_chain_step_sizes():
    rng = np.random.default_rng(1)
    eps0 = 0.1 + rng.uniform(size=C)
    accepts = rng.uniform(size=(T, C))
    s = tadapt.da_init(t64(eps0), torch.float64)
    for a in accepts:
        s = tadapt.da_update(s, t64(a), target=0.8)
    for c in range(C):
        js = jadapt.da_init(jnp.asarray(eps0[c]), jnp.float64)
        for a in accepts:
            js = jadapt.da_update(js, jnp.asarray(a[c]), target=0.8)
        close(s.log_eps[c], js.log_eps)
        close(s.log_eps_bar[c], js.log_eps_bar)
        close(s.h_bar[c], js.h_bar)
    assert s.count.shape == (C,)


# --- the metric forms at C == D ----------------------------------------------


def _metrics(rng):
    diag = 0.5 + rng.uniform(size=(C, D))
    a = rng.normal(size=(C, D, D)) * 0.3
    dense = a @ np.swapaxes(a, -1, -2) + np.eye(D) * (0.5 + rng.uniform(size=(C, 1, 1)))
    return diag, dense


@pytest.mark.parametrize("form", ["per_chain_diag", "shared_dense", "per_chain_dense"])
def test_metric_forms_at_c_equal_d(form):
    """velocity, kinetic energy and the momentum draw of each metric form
    against the reference's single-chain functions, chain by chain.  A bare
    2-D tensor is read as the shared dense metric; the per-chain diagonal one
    must say so (``Metric``), or a (C, D) metric with C == D would be taken
    for a dense one."""
    rng = np.random.default_rng(2)
    diag, dense = _metrics(rng)
    r = rng.normal(size=(C, D))
    z = rng.normal(size=(C, D))
    rk = rng.normal(size=(C, 3, D))  # a checkpoint stack (C, K, D)
    if form == "per_chain_diag":
        metric, per_chain = tnuts.make_metric(t64(diag), dense=False), list(diag)
    elif form == "shared_dense":
        metric, per_chain = t64(dense[0]), [dense[0]] * C
    else:
        metric, per_chain = tnuts.make_metric(t64(dense), dense=True), list(dense)

    class Replay:
        def normal(self, shape, site=None):
            return t64(z)

    v = tnuts.velocity(metric, t64(r))
    ke = tnuts.kinetic_energy(metric, t64(r))
    mom = tnuts.sample_momentum(Replay(), metric, (C, D))
    vk = tnuts.velocity(metric, t64(rk))
    for c in range(C):
        im = jnp.asarray(per_chain[c])
        close(v[c], jnuts.velocity(im, jnp.asarray(r[c])))
        close(ke[c], jnuts.kinetic_energy(im, jnp.asarray(r[c])))
        close(vk[c], jnuts.velocity_batch(im, jnp.asarray(rk[c])))
        if im.ndim == 2:
            want = jax.scipy.linalg.solve_triangular(jnp.linalg.cholesky(im).T, jnp.asarray(z[c]), lower=False)
        else:
            want = z[c] / np.sqrt(per_chain[c])
        close(mom[c], want)
    if form == "per_chain_diag":
        # the same tensor read bare is the shared dense metric: another answer
        assert not np.allclose(tnuts.velocity(t64(diag), t64(r)).numpy(), v.numpy())


# --- the initial-density check -----------------------------------------------


def test_check_init_names_the_same_chains_as_the_reference():
    init = np.random.default_rng(3).uniform(-2, 1, size=(6, 3))
    init[[1, 4], 0] = 1.9  # outside the support of the two models below

    def jlogp(z):
        return jnp.where(z[0] > 1.5, -jnp.inf, -0.5 * jnp.sum(z * z))

    def tlogp(z):
        return torch.where(z[:, 0] > 1.5, -torch.inf, -0.5 * (z * z).sum(-1))

    def chains_named(fn, *a):
        with pytest.raises(ValueError, match="non-finite initial log density") as err:
            fn(*a)
        return re.search(r"chains (\[[^\]]*\])", str(err.value)).group(1)

    got = chains_named(tsample.check_init_logdensity, tlogp, t64(init))
    assert got == chains_named(jsample.check_init_logdensity, jlogp, jnp.asarray(init)) == "[1, 4]"
    bad, _ = tsample._init_bad_mask(tlogp, t64(init))
    jbad, _ = jsample._init_bad_mask(jlogp, jnp.asarray(init))
    assert np.array_equal(bad, jbad)
    tsample.check_init_logdensity(tlogp, t64(np.delete(init, [1, 4], axis=0)))  # all finite: no error


def test_draw_init_positions_redraws_bad_chains():
    def tlogp(z):
        return torch.where(z[:, 0] > 0.0, -torch.inf, -0.5 * (z * z).sum(-1))

    init = tsample.draw_init_positions(tlogp, torch.Generator().manual_seed(4), 16, 3, device="cpu",
                                       dtype=torch.float64)
    assert init.shape == (16, 3) and bool((init[:, 0] <= 0.0).all()) and float(init.abs().max()) <= 2.0


# --- whole runs, held statistically -----------------------------------------


def _mcse(draws):
    draws = np.asarray(draws, np.float64)
    return draws.reshape(-1, draws.shape[-1]).std(0) / np.sqrt(tconv.ess(draws))


def _agree(got, want, n_se=4.0):
    """Means and sds of (chains, n, dim) draws within ``n_se`` Monte-Carlo
    standard errors (the sd's taken as sd / sqrt(2 ESS))."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    se = np.sqrt(_mcse(got) ** 2 + _mcse(want) ** 2)
    diff = np.abs(got.mean((0, 1)) - want.mean((0, 1)))
    assert np.all(diff < n_se * se), ("mean", diff, se)
    sd_g, sd_w = got.reshape(-1, got.shape[-1]).std(0), want.reshape(-1, want.shape[-1]).std(0)
    se_sd = np.sqrt(sd_g**2 / (2 * tconv.ess(got)) + sd_w**2 / (2 * tconv.ess(want)))
    assert np.all(np.abs(sd_g - sd_w) < n_se * se_sd), ("sd", sd_g, sd_w, se_sd)


def test_sample_nuts_eight_schools_matches_jax_run():
    tm = tes.make()
    res = sample_nuts(tm.logp, torch.Generator().manual_seed(0), tm.dim, num_warmup=100, num_samples=80,
                      num_chains=6, max_depth=6, device="cpu", dtype=torch.float64)
    assert isinstance(res, ChainResult)
    assert res.position.shape == (6, 80, tm.dim) and res.stats.tree_depth.shape == (6, 80)
    assert res.step_size.shape == (6,) and res.inv_mass.shape == (6, tm.dim) and res.warmup_accept.shape == (6,)
    assert len(set(res.step_size.tolist())) == 6  # each chain adapts its own step size
    assert res.n_grad_calls >= int(res.stats.n_leapfrog.max(0).values.sum())
    assert float(res.stats.diverging.double().mean()) < 0.03
    want = jsample.sample_nuts(jes.make().logp, jax.random.PRNGKey(0), tm.dim, num_warmup=100, num_samples=80,
                               num_chains=6, max_depth=6)
    # mu and log tau (unconstrained coordinates 0 and 1)
    _agree(res.position[..., :2].numpy(), np.asarray(want.position)[..., :2])


RHO = 0.95
COV = np.array([[1.0, RHO * 2.0], [RHO * 2.0, 4.0 + 0.2]])
PREC = np.linalg.inv(COV)


def test_dense_metric_learns_the_covariance():
    """Twin of tests/test_dense_mass.py: the per-chain dense metric against the
    true covariance (0.35), the draws' covariance (0.15), shallow trees, and
    the draws against a ``math_tpu`` run; the reference test's sizes."""
    prec = t64(PREC)
    res = sample_nuts(lambda z: -0.5 * ((z @ prec) * z).sum(-1), torch.Generator().manual_seed(0), 2,
                      num_warmup=600, num_samples=800, num_chains=4, dense_mass=True, device="cpu",
                      dtype=torch.float64)
    assert res.inv_mass.shape == (4, 2, 2)
    im = res.inv_mass.mean(0).numpy()
    assert np.abs(im - COV).max() / np.abs(COV).max() < 0.35, im
    got = np.cov(res.position.reshape(-1, 2).numpy().T)
    assert np.abs(got - COV).max() / np.abs(COV).max() < 0.15
    assert float(res.stats.tree_depth[:, 100:].double().mean()) < 4.0
    want = jsample.sample_nuts(lambda z: -0.5 * z @ PREC @ z, jax.random.PRNGKey(0), dim=2, num_warmup=600,
                               num_samples=800, num_chains=4, dense_mass=True)
    _agree(res.position.numpy(), np.asarray(want.position))


# --- the README's quick start, as the port writes it ------------------------


def test_readme_quick_start_twin_runs_on_the_cpu():
    y = np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
    sigma = np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])

    def log_prob(p):  # every block has a leading chain axis
        mu, tau, tt = p["mu"], p["tau"], p["theta_tilde"]
        lp = dists.normal_lpdf(mu, 0.0, 5.0, propto=True, batch_ndims=1)
        lp = lp + dists.cauchy_lpdf(tau, 0.0, 5.0, propto=True, batch_ndims=1)
        lp = lp + dists.std_normal_lpdf(tt, propto=True, batch_ndims=1)
        lp = lp + dists.normal_lpdf(y, mu[:, None] + tau[:, None] * tt, sigma, propto=True, batch_ndims=1)
        return lp

    model = make_log_density({
        "mu": transforms.Identity(shape=()),
        "tau": transforms.LowerBound(shape=(), lb=0.0),
        "theta_tilde": transforms.Identity(shape=(8,)),
    }, log_prob)
    res = sample_nuts(model.logp, torch.Generator(device="cpu").manual_seed(0), dim=model.dim,
                      num_chains=4, num_warmup=60, num_samples=40, device="cpu")
    rows = summary(res.position[:, :, :2].cpu().numpy(), names=["mu", "log_tau"])
    assert [r["name"] for r in rows] == ["mu", "log_tau"]
    assert res.position.dtype == torch.float32  # the configured default dtype
    assert abs(rows[0]["mean"] - 4.4) < 5.0 and all(np.isfinite(r["rhat"]) for r in rows)
