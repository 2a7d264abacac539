"""PyTorch port: densities against ``math_tpu.dists`` (CPU, float64).

Same inputs, made from a seed with numpy, go through the JAX density and its
counterpart.  With ``batch_ndims=0`` the port returns the scalar the JAX
function returns; values and gradients agree to ``rtol=1e-12`` (the same
float64 arithmetic, up to the order of one sum).  With ``batch_ndims=1`` the
result equals a Python loop over the chains.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from math_tpu import dists as jd
from math_tpu_torch import dists as td
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)

RTOL = 1e-12
RNG = np.random.default_rng(0)
N, K, C = 40, 3, 4


def t64(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float64, requires_grad=grad)


def close(got, want, rtol=RTOL, atol=1e-13):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


CONTINUOUS = {
    "normal_lpdf": (RNG.normal(size=N), RNG.normal(size=N), 0.5 + RNG.uniform(size=N)),
    "cauchy_lpdf": (RNG.normal(size=N), RNG.normal(size=N), 0.5 + RNG.uniform(size=N)),
    "std_normal_lpdf": (RNG.normal(size=N),),
}
X = RNG.normal(size=(N, K))
GLM = {
    "bernoulli_logit_glm_lpmf": (RNG.integers(0, 2, N).astype(np.float64), (0.3, RNG.normal(size=K) * 0.5)),
    "poisson_log_glm_lpmf": (RNG.poisson(2.0, N).astype(np.float64), (0.1, RNG.normal(size=K) * 0.3)),
    "normal_id_glm_lpdf": (RNG.normal(size=N), (0.2, RNG.normal(size=K), 1.3)),
}


@pytest.mark.parametrize("propto", [False, True])
@pytest.mark.parametrize("name", sorted(CONTINUOUS))
def test_continuous_value_and_grad(name, propto):
    args = CONTINUOUS[name]
    jf = lambda *a: getattr(jd, name)(*a, propto=propto)  # noqa: E731
    want = jf(*map(jnp.asarray, args))
    want_g = jax.grad(jf, tuple(range(len(args))))(*map(jnp.asarray, args))
    targs = [t64(a, grad=True) for a in args]
    got = getattr(td, name)(*targs, propto=propto)
    assert got.ndim == 0
    close(got.detach(), want)
    for g, w in zip(torch.autograd.grad(got, targs), want_g):
        close(g, w)


@pytest.mark.parametrize("name", sorted(CONTINUOUS))
def test_continuous_propto_prunes_numpy_constants(name):
    """numpy arguments are constants: with propto their terms are dropped, as
    in the JAX package (y numpy and sigma numpy drop log sigma and the rest)."""
    args = CONTINUOUS[name]
    if len(args) == 1:
        want = getattr(jd, name)(jnp.asarray(args[0]), propto=True)
        got = getattr(td, name)(t64(args[0]), propto=True)
    else:
        y, mu, sigma = args
        want = getattr(jd, name)(y, jnp.asarray(mu), sigma, propto=True)
        got = getattr(td, name)(y, t64(mu), sigma, propto=True)
        assert abs(float(got) - float(getattr(td, name)(y, t64(mu), t64(sigma), propto=True))) > 1e-3
    close(got, want)


@pytest.mark.parametrize("name", ["normal_lpdf", "cauchy_lpdf"])
def test_invalid_parameter_gives_neg_inf_with_finite_grads(name):
    y, mu, sigma = (a.copy() for a in CONTINUOUS[name])
    sigma[3] = -1.0
    targs = [t64(y, grad=True), t64(mu, grad=True), t64(sigma, grad=True)]
    got = getattr(td, name)(*targs)
    want = getattr(jd, name)(*map(jnp.asarray, (y, mu, sigma)))
    assert float(got.detach()) == float(want) == -np.inf
    want_g = jax.grad(getattr(jd, name), (0, 1, 2))(*map(jnp.asarray, (y, mu, sigma)))
    for g, w in zip(torch.autograd.grad(got, targs), want_g):
        assert torch.isfinite(g).all()
        close(g, w)
    nan_y = CONTINUOUS["std_normal_lpdf"][0].copy()
    nan_y[0] = np.nan
    assert float(td.std_normal_lpdf(t64(nan_y))) == float(jd.std_normal_lpdf(jnp.asarray(nan_y))) == -np.inf


@pytest.mark.parametrize("name", sorted(CONTINUOUS))
def test_continuous_batch_ndims_1_is_a_loop_over_chains(name):
    args = CONTINUOUS[name]
    batched = [t64(RNG.normal(size=(C,) + a.shape) * 0.1 + a) for a in args]
    if len(args) == 3:
        batched[2] = batched[2].abs() + 0.1
    got = getattr(td, name)(*batched, propto=True, batch_ndims=1)
    want = torch.stack([getattr(td, name)(*[b[c] for b in batched], propto=True) for c in range(C)])
    assert got.shape == (C,)
    close(got, want)
    # a per-chain scalar block (C,) sums over nothing
    assert td.std_normal_lpdf(t64(np.arange(C) * 0.1), batch_ndims=1).shape == (C,)


@pytest.mark.parametrize("propto", [False, True])
@pytest.mark.parametrize("name", sorted(GLM))
def test_glm_value_and_grad(name, propto):
    y, params = GLM[name]
    jf = lambda *p: getattr(jd, name)(y, X, *p, propto=propto)  # noqa: E731
    jparams = tuple(jnp.asarray(p) for p in params)
    want = jf(*jparams)
    want_g = jax.grad(jf, tuple(range(len(params))))(*jparams)
    tparams = [t64(p, grad=True) for p in params]
    got = getattr(td, name)(y, X, *tparams, propto=propto)
    assert got.ndim == 0 and got.dtype == torch.float64
    close(got.detach(), want)
    for g, w in zip(torch.autograd.grad(got, tparams), want_g):
        close(g, w)


@pytest.mark.parametrize("name", sorted(GLM))
def test_glm_batch_ndims_1_is_a_loop_over_chains(name):
    y, params = GLM[name]
    batched = [t64(np.asarray(p) + 0.1 * RNG.normal(size=(C,) + np.shape(p))) for p in params]
    if len(params) == 3:
        batched[2] = batched[2].abs() + 0.1
    got = getattr(td, name)(y, X, *batched, propto=True, batch_ndims=1)
    want = torch.stack([getattr(td, name)(y, X, *[b[c] for b in batched], propto=True) for c in range(C)])
    assert got.shape == (C,)
    close(got, want)


def test_bernoulli_glm_rejects_y_outside_0_1():
    y, params = GLM["bernoulli_logit_glm_lpmf"]
    bad = y.copy()
    bad[5] = 2.0
    tparams = [t64(p) for p in params]
    assert float(td.bernoulli_logit_glm_lpmf(bad, X, *tparams)) == -np.inf
    assert float(jd.bernoulli_logit_glm_lpmf(bad, X, *map(jnp.asarray, params))) == -np.inf
