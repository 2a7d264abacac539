"""PyTorch port: the GP slice against ``math_tpu`` (CPU, float64).

Same inputs, made from a seed with numpy, go through the JAX function and its
counterpart: the six covariance functions with chain-batched hyperparameters
(against ``jax.vmap`` of the JAX ones), ``inv_gamma_lpdf``, the multi-normal
pair, the marginal and the latent GP model at positions carried across by
``math_tpu_torch.convert`` (``logp`` and gradient ``rtol=1e-8``), exact latent
recovery against the analytic conditional, and the slice as a whole: a short
chain-batched NUTS run on the marginal GP held statistically against a
``math_tpu`` run.  The port's blocked Cholesky runs with blocks of 16 here, so
the small matrices still span several blocks.  Densities agree to
``rtol=1e-12``, covariances to ``1e-12``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from math_tpu import dists as jd
from math_tpu.infer import pooled as jpooled
from math_tpu.models import gp_regression as jgp
from math_tpu.ops import gp as jgp_ops

from math_tpu_torch import convert, get_config, update_config
from math_tpu_torch import dists as td
from math_tpu_torch.diagnostics import convergence as tconv
from math_tpu_torch.dists import _util
from math_tpu_torch.infer import pooled as tpooled
from math_tpu_torch.models import gp_regression as tgp
from math_tpu_torch.ops import chol_blocked
from math_tpu_torch.ops import gp as tgp_ops
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)

C = 4


def t64(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float64, requires_grad=grad)


def close(got, want, rtol=1e-12, atol=1e-13):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture
def small_blocks():
    old = get_config().cholesky_block_size
    update_config(cholesky_block_size=16)
    yield
    update_config(cholesky_block_size=old)


# --- covariance functions ------------------------------------------------------

COVS = {
    "gp_exp_quad_cov": 2, "gp_exponential_cov": 2, "gp_matern32_cov": 2, "gp_matern52_cov": 2,
    "gp_periodic_cov": 3, "gp_dot_prod_cov": 1,
}


@pytest.mark.parametrize("two_d", [False, True])
@pytest.mark.parametrize("name", sorted(COVS))
def test_covariances_with_chain_batched_hyperparameters(name, two_d):
    rng = np.random.default_rng(1)
    x = rng.uniform(-2, 2, (12, 2)) if two_d else np.sort(rng.uniform(-3, 3, 12))
    y = rng.uniform(-2, 2, (7, 2)) if two_d else None
    hyper = [0.5 + rng.uniform(size=C) for _ in range(COVS[name])]
    jf = lambda *h: getattr(jgp_ops, name)(jnp.asarray(x), *h, **({} if y is None else {"y": jnp.asarray(y)}))  # noqa: E731
    want = jax.vmap(jf)(*map(jnp.asarray, hyper))
    th = [t64(h, grad=True) for h in hyper]
    got = getattr(tgp_ops, name)(t64(x), *th, **({} if y is None else {"y": t64(y)}))
    assert got.shape == (C, 12, 12 if y is None else 7)
    close(got, want, atol=1e-12)
    # one chain with Python floats gives the unbatched matrix
    close(getattr(tgp_ops, name)(t64(x), *[float(h[0]) for h in hyper], **({} if y is None else {"y": t64(y)})), want[0], atol=1e-12)
    # gradients of a weighted sum, per chain
    wts = rng.normal(size=got.shape)
    want_g = jax.grad(lambda *h: jnp.sum(jax.vmap(jf)(*h) * wts), argnums=tuple(range(len(hyper))))(*map(jnp.asarray, hyper))
    for g, w in zip(torch.autograd.grad((got * t64(wts)).sum(), th), want_g):
        close(g, w, rtol=1e-10, atol=1e-12)


def test_sq_dists_and_add_diag():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(9, 3))
    close(tgp_ops.sq_dists(t64(x)), jgp_ops.sq_dists(jnp.asarray(x)))
    assert float(tgp_ops.sq_dists(t64(x)).min()) >= 0.0
    k = rng.normal(size=(C, 9, 9))
    jit = 0.1 + rng.uniform(size=C)
    close(tgp_ops.add_diag(t64(k), t64(jit)), k + jit[:, None, None] * np.eye(9))
    close(tgp_ops.add_diag(t64(k[0]), 1e-3), jgp_ops.add_diag(jnp.asarray(k[0]), 1e-3))


# --- densities -----------------------------------------------------------------


@pytest.mark.parametrize("propto", [False, True])
def test_inv_gamma_lpdf(propto):
    rng = np.random.default_rng(3)
    args = (0.2 + rng.uniform(size=10) * 3, 1.0 + rng.uniform(size=10) * 4, 0.5 + rng.uniform(size=10) * 4)
    jf = lambda *a: jd.inv_gamma_lpdf(*a, propto=propto)  # noqa: E731
    targs = [t64(a, grad=True) for a in args]
    got = td.inv_gamma_lpdf(*targs, propto=propto)
    close(got, jf(*map(jnp.asarray, args)))
    for g, w in zip(torch.autograd.grad(got, targs), jax.grad(jf, (0, 1, 2))(*map(jnp.asarray, args))):
        close(g, w)
    # constants as host numbers: propto drops their terms, as in the JAX package
    close(td.inv_gamma_lpdf(targs[0], 5.0, 5.0, propto=propto), jd.inv_gamma_lpdf(jnp.asarray(args[0]), 5.0, 5.0, propto=propto))
    # one value per chain equals a loop over the chains; off-support gives -inf
    ys = t64(0.2 + rng.uniform(size=(C, 3)))
    per_chain = td.inv_gamma_lpdf(ys, 5.0, 5.0, propto=propto, batch_ndims=1)
    close(per_chain, [float(td.inv_gamma_lpdf(ys[c], 5.0, 5.0, propto=propto)) for c in range(C)])
    assert float(td.inv_gamma_lpdf(t64([-1.0]), 5.0, 5.0)) == -np.inf


@pytest.mark.parametrize("propto", [False, True])
@pytest.mark.parametrize("rows", [(), (3,)])
def test_multi_normal_lpdf(rows, propto, small_blocks):
    rng = np.random.default_rng(5)
    k = 40
    a = rng.normal(size=(k, k))
    sigma, mu, y = a @ a.T + k * np.eye(k), rng.normal(size=k), rng.normal(size=rows + (k,))
    jf = lambda yy, mm, ss: jd.multi_normal_lpdf(yy, mm, 0.5 * (ss + ss.T), propto=propto)  # noqa: E731
    want = jf(*map(jnp.asarray, (y, mu, sigma)))
    want_g = jax.grad(jf, (0, 1, 2))(*map(jnp.asarray, (y, mu, sigma)))
    ty, tmu, ts = (t64(v, grad=True) for v in (y, mu, sigma))
    got = td.multi_normal_lpdf(ty, tmu, 0.5 * (ts + ts.mT), propto=propto)
    assert got.ndim == 0
    close(got, want, rtol=1e-10)
    for g, w in zip(torch.autograd.grad(got, (ty, tmu, ts)), want_g):
        close(g, w, rtol=1e-8, atol=1e-10)
    # the Cholesky-parameterized form, and data as numpy under propto
    L = np.linalg.cholesky(sigma)
    close(td.multi_normal_cholesky_lpdf(ty, tmu, t64(L), propto=propto),
          jd.multi_normal_cholesky_lpdf(jnp.asarray(y), jnp.asarray(mu), jnp.asarray(L), propto=propto), rtol=1e-10)
    close(td.multi_normal_lpdf(y, mu, ts, propto=propto), jd.multi_normal_lpdf(y, mu, jnp.asarray(sigma), propto=propto), rtol=1e-10)


def test_multi_normal_lpdf_per_chain(small_blocks):
    rng = np.random.default_rng(6)
    k = 20
    a = rng.normal(size=(C, k, k))
    sigma, mu, y = a @ np.swapaxes(a, -1, -2) + k * np.eye(k), rng.normal(size=(C, k)), rng.normal(size=k)
    got = td.multi_normal_lpdf(y, t64(mu), t64(sigma), batch_ndims=1)
    want = [float(jd.multi_normal_lpdf(jnp.asarray(y), jnp.asarray(mu[c]), jnp.asarray(sigma[c]))) for c in range(C)]
    close(got, want, rtol=1e-10)
    got = td.multi_normal_cholesky_lpdf(t64(np.stack([y] * C)), t64(mu[0]), t64(np.linalg.cholesky(sigma)), batch_ndims=1)
    want = [float(jd.multi_normal_lpdf(jnp.asarray(y), jnp.asarray(mu[0]), jnp.asarray(sigma[c]))) for c in range(C)]
    close(got, want, rtol=1e-10)


def test_host_constants_are_copied_to_the_device_once():
    """``bcast`` keeps the tensor of a Python number or a small numpy array
    (keyed by its bytes) instead of converting it at every call; values and
    gradients of the densities are what they were, and an array changed in
    place is not served stale."""
    rng = np.random.default_rng(7)
    y, mu, sig = rng.normal(size=8), rng.normal(size=8), 0.5 + rng.uniform(size=8)
    x = t64(rng.normal(size=8), grad=True)
    xj = jnp.asarray(x.detach().numpy())
    got = td.normal_lpdf(y, x, sig, propto=True)
    jf = lambda m: jd.normal_lpdf(y, m, sig, propto=True)  # noqa: E731
    close(got, jf(xj))
    close(torch.autograd.grad(got, x)[0], jax.grad(jf)(xj))
    pos = t64(0.3 + rng.uniform(size=8), grad=True)
    for name, args in (("normal_lpdf", (y, x, sig)), ("cauchy_lpdf", (y, x, sig)), ("inv_gamma_lpdf", (pos, 5.0, sig))):
        # host constants against the same values as tensors (propto=False keeps every term in both)
        got = getattr(td, name)(*args)
        want = getattr(td, name)(*[a if isinstance(a, torch.Tensor) else t64(a) for a in args])
        close(got, want.detach())
        leaf = x if name != "inv_gamma_lpdf" else pos
        close(torch.autograd.grad(got, leaf)[0], torch.autograd.grad(want, leaf)[0])
    # the same constant is the same tensor the second time
    first = _util.bcast(x, 5.0, sig)
    second = _util.bcast(x, 5.0, sig)
    assert first[1].data_ptr() == second[1].data_ptr() and first[2].data_ptr() == second[2].data_ptr()
    assert first[1].dtype == torch.float64 and not first[1].requires_grad
    # changed in place: a new value, not the kept copy
    before = float(td.normal_lpdf(y, x.detach(), sig))
    sig[0] *= 3.0
    after = float(td.normal_lpdf(y, x.detach(), sig))
    assert before != after
    close(after, jd.normal_lpdf(y, xj, sig))
    # a large array is data: converted as before, not kept
    big = rng.normal(size=_util._CONST_CACHE_MAX_ELEMS + 1)
    kept = _util._const_tensor.cache_info().currsize
    close(td.normal_lpdf(big, x[0].detach(), 5.0), jd.normal_lpdf(big, float(x[0].detach()), 5.0))
    assert _util._const_tensor.cache_info().currsize == kept


# --- the models ----------------------------------------------------------------


def test_synthetic_data_is_the_same_in_both_packages():
    for n, seed in ((50, 0), (64, 3)):
        for got, want in zip(tgp.synthetic_data(n, seed=seed), jgp.synthetic_data(n, seed=seed)):
            np.testing.assert_array_equal(got, want)
    assert convert.gp_synthetic_data is tgp.synthetic_data


@pytest.mark.parametrize("name,jitter", [("make_marginal", 1e-3), ("make", 1e-3)])
def test_gp_models_logp_and_gradient(name, jitter, small_blocks):
    """``logp`` and its gradient for 4 chains at n = 60 against ``jax.vmap`` of
    the JAX model at the same positions, carried across by ``convert``."""
    n = 60
    x, y = jgp.synthetic_data(n, seed=2)
    jm, tm = getattr(jgp, name)(n, jitter=jitter), getattr(tgp, name)(n, jitter=jitter)
    assert tm.dim == jm.dim == (3 if name == "make_marginal" else 3 + n)
    z = np.random.default_rng(0).normal(size=(C, jm.dim)) * 0.5
    jlogp = lambda t: jm.logp(t, jnp.asarray(x), jnp.asarray(y))  # noqa: E731
    want, want_g = jax.jit(jax.vmap(jax.value_and_grad(jlogp)))(jnp.asarray(z))
    xt, yt = convert.data_from_numpy(x, y, device="cpu", dtype=torch.float64)
    zt = convert.positions_from_numpy(z, device="cpu", dtype=torch.float64)
    chol_blocked.reset_counts()
    lp, g = tm.logp_and_grad(zt, xt, yt)
    assert chol_blocked.PLAIN_CALLS["chol_inv_block"] == 4  # ceil(60 / 16) blocks, one pass, all chains at once
    close(lp, want, rtol=1e-8)
    close(g, want_g, rtol=1e-8, atol=1e-8)
    close(tm.logp(zt[0], xt, yt), want[0], rtol=1e-8)  # a single point gives a scalar
    with pytest.raises(ValueError, match="batch"):
        convert.positions_from_numpy(z[0])


def test_matheron_matches_analytic_conditional(small_blocks):
    """Twin of tests/test_gp_recovery.py:29 at a smaller size."""
    n, m, jitter = 48, 2000, 1e-8
    x, y = tgp.synthetic_data(n, seed=3)
    rho, alpha, sigma = 0.8, 1.2, 0.4
    d2 = (x[:, None] - x[None, :]) ** 2
    k = alpha**2 * np.exp(-0.5 * d2 / rho**2) + jitter * np.eye(n)
    a = k + sigma**2 * np.eye(n)
    mean, cov = k @ np.linalg.solve(a, y), k - k @ np.linalg.solve(a, k)

    ths = convert.positions_from_numpy(np.tile([rho, alpha, sigma], (m, 1)), device="cpu", dtype=torch.float64)
    gen = torch.Generator().manual_seed(0)
    fs = tgp.sample_latent_conditional(gen, ths, x, y, jitter=jitter, batch=500, device="cpu", dtype=torch.float64).numpy()
    assert fs.shape == (m, n) and np.isfinite(fs).all()
    sd = np.sqrt(np.diag(cov))
    # MC error on the mean is sd/sqrt(m); allow 5 sigma
    assert np.all(np.abs(fs.mean(0) - mean) < 5.0 * sd / np.sqrt(m) + 1e-12)
    # per-coordinate variance within 20% (chi^2 MC error at m=2000 ~ 3.2%)
    ratio = fs.var(0) / np.diag(cov)
    assert np.all(ratio > 0.8) and np.all(ratio < 1.2)
    # off-diagonal structure: correlation of two nearby coords
    c_ref = cov[10, 11] / np.sqrt(cov[10, 10] * cov[11, 11])
    assert abs(np.corrcoef(fs[:, 10], fs[:, 11])[0, 1] - c_ref) < 0.1


def test_marginal_gp_posterior_matches_jax_run():
    """The slice as a whole: 16-chain NUTS with pooled warmup on the marginal GP
    at n = 30 (three blocks of 10), at the main path's ``max_depth=3`` and
    ``target_accept=0.75``; posterior means of the unconstrained hyperparameters agree with
    a ``math_tpu`` run within 4 Monte-Carlo standard errors (the errors of both
    runs added in quadrature), and both adapt to a like step size."""
    n, chains, nw, ns, depth = 30, 16, 30, 30, 3  # chains are nearly free in a chain-batched sampler; transitions are not
    x, y = tgp.synthetic_data(n, seed=1)
    tm, jm = tgp.make_marginal(n), jgp.make_marginal(n)
    gen = torch.Generator().manual_seed(0)
    z0 = tm.initial_positions(gen, chains, init_radius=0.5, device="cpu", dtype=torch.float64)
    old = get_config().cholesky_block_size
    update_config(cholesky_block_size=10)
    try:
        res = tpooled.run_pooled_chains(
            gen, z0, tm.logp, args=convert.data_from_numpy(x, y, device="cpu", dtype=torch.float64),
            num_warmup=nw, num_samples=ns, max_depth=depth, target_accept=0.75, device="cpu",
        )
    finally:
        update_config(cholesky_block_size=old)
    assert res.position.shape == (chains, ns, 3) and bool(torch.isfinite(res.position).all())
    assert float(res.diverging.double().mean()) < 0.05
    assert chol_blocked.LAUNCHES["chol_inv_block"] == 0
    keys = jax.random.split(jax.random.PRNGKey(0), chains)
    want = jax.jit(lambda kk, zz, *a: jpooled.run_pooled_chains(
        kk, zz, jm.logp, args=a, num_warmup=nw, num_samples=ns, max_depth=depth, target_accept=0.75,
    ))(keys, jnp.asarray(z0.numpy()), jnp.asarray(x), jnp.asarray(y))
    got_z, want_z = res.position.numpy(), np.asarray(want.position)

    def mcse(draws):
        return draws.reshape(-1, 3).std(0) / np.sqrt(tconv.ess(draws))

    diff = np.abs(got_z.mean((0, 1)) - want_z.mean((0, 1)))
    se = np.sqrt(mcse(got_z) ** 2 + mcse(want_z) ** 2)
    assert np.all(diff < 4.0 * se), (diff, se)
    assert 0.5 < float(res.step_size) / float(want.step_size) < 2.0
    sigma = tm.transform_draws(res.position)["sigma"]
    assert abs(float(sigma.mean()) - 0.3) < 0.15  # the data's noise level, at n = 30
