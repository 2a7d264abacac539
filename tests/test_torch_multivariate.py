"""PyTorch port: ``dists/multivariate.py`` against ``math_tpu.dists`` (CPU, float64).

- Every density, with ``propto`` off and on: ``C`` chains at once with
  ``batch_ndims=1`` against ``jax.vmap`` of the JAX density (one value a
  chain), the gradients in every tensor argument, and each chain alone with
  ``batch_ndims=0`` (a loop over the chains) against the same numbers.
  Parameters are tensors (JAX arrays on the JAX side), data numpy arrays, so
  ``propto`` drops the same terms in both packages.  Tolerance ``1e-10``
  relative, an absolute floor of ``1e-10`` (float64; a solve against an
  explicit block inverse and LAPACK's solve differ in the last digits).
- One invalid chain (a matrix that is not positive definite, a theta off the
  simplex) gives ``-inf`` in that chain alone, with finite gradients in the
  others.
- Each ``_rng``: moments against closed forms, and the same draws again from
  a generator with the same seed.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import math_tpu.dists as jd
from math_tpu_torch import dists as td
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)

RTOL, ATOL = 1e-10, 1e-10
C, K = 3, 3
RNG = np.random.default_rng(17)


def spd(c, k, scale=1.0):
    a = RNG.normal(size=(c, k, k))
    return scale * (a @ np.swapaxes(a, -1, -2) + k * np.eye(k))


def corr_chol(c, k):
    a = spd(c, k)
    d = np.sqrt(np.einsum("cii->ci", a))
    return np.linalg.cholesky(a / d[:, :, None] / d[:, None, :])


def simplex(c, k):
    g = RNG.gamma(2.0, size=(c, k))
    return g / g.sum(-1, keepdims=True)


MU = RNG.normal(size=(C, K))
Y = RNG.normal(size=(C, 2, K)) + MU[:, None, :]
SIGMA = spd(C, K)
L_SIGMA = np.linalg.cholesky(SIGMA)
OMEGA = np.linalg.inv(SIGMA)
NU = np.array([4.5, 7.0, 12.0])
ETA = np.array([0.8, 1.5, 3.0])
LCORR = corr_chol(C, K)
S_DATA = spd(1, K)[0]
W = spd(C, K, 0.7)

# name -> (parameters with a chain axis, data (numpy, shared by the chains))
CASES = {
    "multi_normal_lpdf": ((Y, MU, SIGMA), ()),
    "multi_normal_cholesky_lpdf": ((Y, MU, L_SIGMA), ()),
    "multi_normal_prec_lpdf": ((Y, MU, OMEGA), ()),
    "multi_student_t_lpdf": ((Y, NU, MU, SIGMA), ()),
    "dirichlet_lpdf": ((simplex(C, K), np.exp(RNG.normal(size=(C, K)))), ()),
    "multinomial_lpmf": ((simplex(C, K),), (np.array([2.0, 3.0, 5.0]),)),
    "lkj_corr_cholesky_lpdf": ((LCORR, ETA), ()),
    "lkj_corr_lpdf": ((LCORR @ np.swapaxes(LCORR, -1, -2), ETA), ()),
    "wishart_lpdf": ((W, NU), (S_DATA,)),
    "inv_wishart_lpdf": ((W, NU), (S_DATA,)),
}
DATA_FIRST = {"multinomial_lpmf"}  # its data (y) comes before the parameter
# symmetric matrix parameters: the gradients are compared on symmetric
# directions, sym(G) = (G + G^T) / 2.  ``jnp.linalg.cholesky`` symmetrizes its
# input, the blocked factorization reads one triangle, so the raw cotangents
# differ in their antisymmetric part, which no symmetric matrix can feel.
SYMMETRIC = {"multi_normal_lpdf": {2}, "multi_normal_prec_lpdf": {2}, "multi_student_t_lpdf": {3}, "wishart_lpdf": {0},
             "inv_wishart_lpdf": {0}, "lkj_corr_lpdf": {0}}


def sym(g):
    return 0.5 * (g + np.swapaxes(g, -1, -2))


def call(mod, name, params, data, **kw):
    args = (*data, *params) if name in DATA_FIRST else (*params, *data)
    return getattr(mod, name)(*args, **kw)


def close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64), rtol=RTOL, atol=ATOL,
                               err_msg=what)


@pytest.mark.parametrize("propto", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_density_against_jax(name, propto):
    params, data = CASES[name]
    n = len(params)

    def jf(*p):
        return call(jd, name, p, data, propto=propto)

    want, want_g = jax.jit(jax.vmap(lambda *p: (jf(*p), jax.grad(jf, tuple(range(n)))(*p))))(*map(jnp.asarray, params))
    tp = [torch.tensor(p, dtype=torch.float64, requires_grad=True) for p in params]
    got = call(td, name, tp, data, propto=propto, batch_ndims=1)
    assert got.shape == (C,)
    close(got.detach(), want, f"{name} value")
    for i, g in enumerate(torch.autograd.grad(got.sum(), tp)):
        g, w = g.numpy(), np.asarray(want_g[i])
        if i in SYMMETRIC.get(name, ()):
            g, w = sym(g), sym(w)
        close(g, w, f"{name} gradient {i}")
    for c in range(C):  # batch_ndims=0, one chain at a time
        one = call(td, name, [t[c].detach() for t in tp], data, propto=propto)
        assert one.ndim == 0
        close(one, want[c], f"{name} chain {c}")


def test_every_function_is_ported():
    import math_tpu.dists.multivariate as jm
    from math_tpu_torch.dists import multivariate as tm
    names = [n for n, v in vars(jm).items() if callable(v) and not n.startswith("_") and getattr(v, "__module__", "") == jm.__name__]
    assert sorted(n for n in names if not hasattr(tm, n)) == []
    assert set(tm.__all__) == set(names)


def test_do_lkj_constant():
    for eta in (0.7, 1.0, 2.5):
        for k in (2, 3, 6):
            close(td.do_lkj_constant(eta, k), jd.do_lkj_constant(eta, k), "do_lkj_constant")
    close(td.do_lkj_constant(torch.tensor(ETA), 4), jax.vmap(lambda e: jd.do_lkj_constant(e, 4))(ETA), "per chain")


def test_shared_data_and_rows():
    """``y (C, n, k)`` against a shared ``mu (k,)`` and ``sigma (k, k)``, and
    shared ``y`` against per-chain matrices: the same as a loop over chains."""
    got = td.multi_normal_lpdf(torch.tensor(Y), torch.tensor(MU[0]), torch.tensor(SIGMA[0]), batch_ndims=1)
    close(got, [jd.multi_normal_lpdf(Y[c], MU[0], SIGMA[0]) for c in range(C)], "shared mu, sigma")
    got = td.multi_normal_lpdf(torch.tensor(Y[0, 0]), torch.tensor(MU[0]), torch.tensor(SIGMA), batch_ndims=1)
    close(got, [jd.multi_normal_lpdf(Y[0, 0], MU[0], SIGMA[c]) for c in range(C)], "shared y, mu")


def test_invalid_chain_alone():
    """A matrix that is not positive definite or off the unit diagonal, a
    theta off the simplex: -inf in that chain, the others as before with
    finite gradients (the double ``where`` around ``slogdet`` included)."""
    bad_corr = LCORR @ np.swapaxes(LCORR, -1, -2)
    bad_corr[1] = np.array([[1.0, 0.9, -0.9], [0.9, 1.0, 0.9], [-0.9, 0.9, 1.0]])  # unit diagonal, not PD
    cases = [
        ("lkj_corr_lpdf", (bad_corr, ETA), ()),
        ("dirichlet_lpdf", (np.stack([simplex(1, K)[0], np.array([0.5, 0.6, -0.1]), simplex(1, K)[0]]), np.ones((C, K)) * 2), ()),
        ("multinomial_lpmf", (np.stack([simplex(1, K)[0], np.array([0.5, 0.6, 0.1]), simplex(1, K)[0]]),), (np.array([1.0, 2.0, 0.0]),)),
    ]
    for name, params, data in cases:
        tp = [torch.tensor(p, dtype=torch.float64, requires_grad=True) for p in params]
        got = call(td, name, tp, data, batch_ndims=1)
        assert torch.isneginf(got[1]) and torch.isfinite(got[[0, 2]]).all(), (name, got)
        want = [float(call(jd, name, [p[c] for p in params], data)) for c in range(C)]
        close(got.detach(), want, name)
        g = torch.autograd.grad(got[[0, 2]].sum(), tp)
        assert all(torch.isfinite(gi).all() for gi in g), name


def test_wishart_not_positive_definite_is_nan_in_its_chain():
    w = W.copy()
    w[2] = -np.eye(K)
    got = td.wishart_lpdf(torch.tensor(w), torch.tensor(NU), S_DATA, batch_ndims=1)
    assert torch.isnan(got[2]) and torch.isfinite(got[:2]).all()
    assert np.isnan(float(jd.wishart_lpdf(w[2], NU[2], S_DATA)))


def gen(seed=5):
    return torch.Generator().manual_seed(seed)


def test_rng_moments_and_seeds():
    n = 40_000
    mu, sigma = torch.tensor(MU[0]), torch.tensor(SIGMA[0])
    draws = {
        "multi_normal_rng": lambda g: td.multi_normal_rng(g, mu, sigma, shape=(n,)),
        "multi_normal_cholesky_rng": lambda g: td.multi_normal_cholesky_rng(g, mu, torch.linalg.cholesky(sigma), shape=(n,)),
        "multi_normal_prec_rng": lambda g: td.multi_normal_prec_rng(g, mu, torch.linalg.inv(sigma), shape=(n,)),
        "multi_student_t_rng": lambda g: td.multi_student_t_rng(g, 7.0, mu, sigma, shape=(n,)),
    }
    for name, f in draws.items():
        x = f(gen()).numpy()
        assert np.array_equal(x, f(gen()).numpy()), name
        scale = 7.0 / 5.0 if name == "multi_student_t_rng" else 1.0
        se = np.sqrt(np.diag(SIGMA[0]) * scale / n)
        assert np.all(np.abs(x.mean(0) - MU[0]) < 5 * se), name
        assert np.abs(np.cov(x.T) - scale * SIGMA[0]).max() < 0.06 * np.abs(SIGMA[0]).max() * scale, name
    al = np.array([1.5, 2.0, 3.0])
    x = td.dirichlet_rng(gen(), torch.tensor(al), shape=(n,)).numpy()
    a0 = al.sum()
    np.testing.assert_allclose(x.mean(0), al / a0, atol=5 * np.sqrt(al * (a0 - al) / (a0**2 * (a0 + 1)) / n).max())
    assert np.array_equal(x, td.dirichlet_rng(gen(), torch.tensor(al), shape=(n,)).numpy())
    th = np.array([0.2, 0.3, 0.5])
    y = td.multinomial_rng(gen(), torch.tensor(th), 10, shape=(n,)).numpy()
    assert (y.sum(-1) == 10).all() and y.dtype == np.int32
    np.testing.assert_allclose(y.mean(0), 10 * th, atol=5 * np.sqrt(10 * th * (1 - th) / n).max())
    assert np.array_equal(y, td.multinomial_rng(gen(), torch.tensor(th), 10, shape=(n,)).numpy())


@pytest.mark.parametrize("k,eta", [(3, 2.0), (5, 1.5)])
def test_lkj_rng_moments(k, eta):
    """Off-diagonal r of an LKJ(eta) correlation matrix: (r + 1) / 2 ~
    Beta(b, b), b = eta - 1 + k / 2, so E r = 0 and E r^2 = 1 / (2 b + 1)."""
    n = 20_000
    L = td.lkj_corr_cholesky_rng(gen(), k, eta, shape=(n,))
    assert torch.equal(L, td.lkj_corr_cholesky_rng(gen(), k, eta, shape=(n,)))
    y = td.lkj_corr_rng(gen(), k, eta, shape=(n,)).numpy()
    assert np.array_equal(y, td.lkj_corr_rng(gen(), k, eta, shape=(n,)).numpy())
    np.testing.assert_allclose(np.einsum("nii->ni", y), 1.0, atol=1e-12)
    r = y[:, np.tril_indices(k, -1)[0], np.tril_indices(k, -1)[1]]
    b = eta - 1 + k / 2
    var = 1.0 / (2 * b + 1)
    assert np.abs(r.mean(0)).max() < 5 * np.sqrt(var / n)
    assert np.abs((r**2).mean(0) - var).max() < 5 * np.sqrt(2 * var**2 / n) * 2


def test_wishart_rngs():
    n, nu = 20_000, 7.0
    w = td.wishart_rng(gen(), nu, torch.tensor(SIGMA[0]), shape=(n,)).numpy()
    assert np.array_equal(w, td.wishart_rng(gen(), nu, torch.tensor(SIGMA[0]), shape=(n,)).numpy())
    sd = np.sqrt(nu * (SIGMA[0] ** 2 + np.outer(np.diag(SIGMA[0]), np.diag(SIGMA[0]))) / n)
    assert np.all(np.abs(w.mean(0) - nu * SIGMA[0]) < 5 * sd)
    nu = 12.0
    iw = td.inv_wishart_rng(gen(), nu, torch.tensor(SIGMA[0]), shape=(n,)).numpy()
    assert np.array_equal(iw, td.inv_wishart_rng(gen(), nu, torch.tensor(SIGMA[0]), shape=(n,)).numpy())
    want = SIGMA[0] / (nu - K - 1)
    np.testing.assert_allclose(iw.mean(0), want, atol=0.05 * np.abs(want).max())
