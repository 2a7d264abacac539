"""PyTorch port: every function of ``dists/more.py`` and the deprecated
aliases of ``dists/deprecated.py`` against ``math_tpu`` (CPU, float64).

The points are those of ``tests/test_dists_more.py`` and the sweep's
(``tests/dist_fixtures.py`` ``FAMS`` / ``CDFS``).  Tolerances (float64):
values ``1e-11`` relative (the Kalman filter and the matrix densities:
factorizations by the blocked Cholesky against XLA's, ``1e-10``); gradients
``1e-9``.  With ``batch_ndims=1`` each density equals a loop over the chains,
and a chain with an invalid argument is ``-inf`` alone.  The ``_rng``
functions are held in ``tests/test_torch_univariate_rng.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from math_tpu import dists as jd
from math_tpu.dists import more as jmore
from math_tpu_torch import dists as td
from math_tpu_torch.dists import more as tmore

from dist_fixtures import CDFS, FAMS
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)

RTOL, MAT_RTOL, GRAD_RTOL = 1e-11, 1e-10, 1e-9
C = 3
FAM = {f.name: f for f in FAMS}
MORE = ["wiener", "gaussian_dlm_obs", "multi_gp", "multi_gp_cholesky", "matrix_normal_prec", "lkj_cov"]
rng = np.random.default_rng(2)
_A = rng.normal(size=(5, 5))
GP_SIGMA = _A @ _A.T + 5 * np.eye(5)
GP_W = np.array([0.5, 1.0, 2.0])
GP_Y = rng.normal(size=(3, 5))


def t64(a, grad=False):
    return torch.tensor(np.asarray(a, dtype=np.float64), dtype=torch.float64, requires_grad=grad)


def close(got, want, rtol, atol=1e-300, msg=""):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


def test_every_function_is_ported_and_the_aliases_match():
    assert sorted(tmore.__all__) == sorted(jmore.__all__)
    import math_tpu.dists.deprecated as jdep
    import math_tpu_torch.dists.deprecated as tdep

    assert sorted(tdep.__all__) == sorted(jdep.__all__)
    for alias in jdep.__all__:
        assert getattr(td, alias) is getattr(tdep, alias)
        target = getattr(jdep, alias).__name__
        assert getattr(td, alias).__name__ == target, alias


@pytest.mark.parametrize("name", MORE)
def test_sweep_values_and_invalid_rows(name):
    fam = FAM[name]
    rtol = RTOL if name == "wiener" else MAT_RTOL
    for args in [fam.args] + fam.rows:
        got = getattr(td, name + "_lpdf")(*args)
        assert got.ndim == 0 and got.dtype == torch.float64
        close(got, getattr(jd, name + "_lpdf")(*args), rtol, msg=name)
        close(got, fam.oracle(*args), fam.val_tol)
    for args in fam.invalid:
        got = float(getattr(td, name + "_lpdf")(*args))
        want = float(getattr(jd, name + "_lpdf")(*args))
        assert got == want or (np.isnan(got) and np.isnan(want)), (name, got, want)


def test_wiener_grads_and_the_series_points():
    pts = np.array([(0.8, 1.5, 0.3, 0.5, 0.5), (1.2, 2.0, 0.2, 0.4, -0.8), (2.5, 1.0, 0.1, 0.6, 1.0), (0.45, 1.2, 0.4, 0.3, 0.0),
                    (0.31, 1.5, 0.3, 0.5, 0.5)])
    want, want_g = jax.jit(jax.vmap(jax.value_and_grad(jd.wiener_lpdf, tuple(range(5)))))(*jnp.asarray(pts.T))
    for row, w, *wg in zip(pts, want, *want_g):
        tp = [t64(a, grad=True) for a in row]
        got = td.wiener_lpdf(*tp)
        close(got.detach(), w, RTOL)
        for g, gw in zip(torch.autograd.grad(got, tp), wg):
            close(g, gw, GRAD_RTOL, atol=1e-12)


def _dlm():
    r = np.random.default_rng(1)
    n, rr, T = 3, 2, 8
    F = r.normal(size=(n, rr))
    G = 0.8 * np.eye(n) + 0.05 * r.normal(size=(n, n))
    V, W = np.eye(rr) * 0.4, np.eye(n) * 0.3
    y = r.normal(size=(rr, T))
    return y, F, G, V, W, np.zeros(n), np.eye(n)


def test_gaussian_dlm_obs_multivariate_grad_and_diagonal_V():
    y, F, G, V, W, m0, C0 = _dlm()
    want, want_g = jax.value_and_grad(lambda g: jd.gaussian_dlm_obs_lpdf(y, F, g, V, W, m0, C0))(jnp.asarray(G))
    g = t64(G, grad=True)
    got = td.gaussian_dlm_obs_lpdf(y, F, g, V, W, m0, C0)
    close(got.detach(), want, MAT_RTOL)
    (gg,) = torch.autograd.grad(got, g)
    close(gg, want_g, GRAD_RTOL, atol=1e-12)
    close(td.gaussian_dlm_obs_lpdf(y, F, G, np.diag(V), W, m0, C0), want, MAT_RTOL)


def test_gaussian_dlm_obs_batch_ndims_1():
    y, F, G, V, W, m0, C0 = _dlm()
    ys = np.stack([y, 1.1 * y, y - 0.2])
    Gs = np.stack([G, 0.9 * G, G])
    got = td.gaussian_dlm_obs_lpdf(ys, F, Gs, V, W, m0, C0, batch_ndims=1)
    close(got, [float(jd.gaussian_dlm_obs_lpdf(ys[c], F, Gs[c], V, W, m0, C0)) for c in range(C)], MAT_RTOL)


@pytest.mark.parametrize("propto", [False, True])
def test_multi_gp_pair_value_and_grad(propto):
    L = np.linalg.cholesky(GP_SIGMA)
    for jf, tf, scale in ((jd.multi_gp_lpdf, td.multi_gp_lpdf, GP_SIGMA), (jd.multi_gp_cholesky_lpdf, td.multi_gp_cholesky_lpdf, L)):
        want, want_g = jax.value_and_grad(lambda y, s, w: jf(y, s, w, propto=propto), (0, 1, 2))(
            jnp.asarray(GP_Y), jnp.asarray(scale), jnp.asarray(GP_W))
        tp = [t64(a, grad=True) for a in (GP_Y, scale, GP_W)]
        got = tf(*tp, propto=propto)
        close(got.detach(), want, MAT_RTOL)
        grads = torch.autograd.grad(got, tp)
        close(grads[0], want_g[0], GRAD_RTOL, atol=1e-12)
        close(grads[2], want_g[2], GRAD_RTOL, atol=1e-12)
        # the blocked factorization reads one triangle: compare on symmetric directions
        sym = lambda m: 0.5 * (np.asarray(m) + np.asarray(m).T) if jf is jd.multi_gp_lpdf else np.tril(np.asarray(m))  # noqa: E731
        close(sym(grads[1].numpy()), sym(want_g[1]), GRAD_RTOL, atol=1e-12)


def test_multi_gp_batch_ndims_1_and_an_invalid_chain():
    ys = np.stack([GP_Y, 0.5 * GP_Y, GP_Y + 0.1])
    ws = np.stack([GP_W, 2 * GP_W, GP_W])
    got = td.multi_gp_lpdf(ys, GP_SIGMA, ws, batch_ndims=1)
    close(got, [float(jd.multi_gp_lpdf(ys[c], GP_SIGMA, ws[c])) for c in range(C)], MAT_RTOL)
    L = np.linalg.cholesky(GP_SIGMA)
    got_c = td.multi_gp_cholesky_lpdf(ys, np.stack([L] * C), ws, batch_ndims=1)
    close(got_c, got, MAT_RTOL)
    bad = np.stack([GP_SIGMA, -GP_SIGMA, GP_SIGMA])
    out = td.multi_gp_lpdf(ys, bad, ws, batch_ndims=1)
    close(out[[0, 2]], got[[0, 2]], 1e-12)
    assert not bool(torch.isfinite(out[1]))


def _mn():
    r = np.random.default_rng(3)
    n, p = 3, 2
    A = r.normal(size=(n, n))
    B = r.normal(size=(p, p))
    return r.normal(size=(n, p)), r.normal(size=(n, p)), A @ A.T + n * np.eye(n), B @ B.T + p * np.eye(p)


def test_matrix_normal_prec_value_grad_and_batch():
    y, mu, s, dd = _mn()
    want, want_g = jax.value_and_grad(jd.matrix_normal_prec_lpdf, (0, 1))(*[jnp.asarray(a) for a in (y, mu, s, dd)])
    ty, tmu = t64(y, grad=True), t64(mu, grad=True)
    got = td.matrix_normal_prec_lpdf(ty, tmu, s, dd)
    close(got.detach(), want, MAT_RTOL)
    for g, w in zip(torch.autograd.grad(got, (ty, tmu)), want_g):
        close(g, w, GRAD_RTOL, atol=1e-12)
    ys = np.stack([y, y + 0.3, 2 * y])
    got_b = td.matrix_normal_prec_lpdf(ys, mu, s, dd, batch_ndims=1)
    close(got_b, [float(jd.matrix_normal_prec_lpdf(ys[c], mu, s, dd)) for c in range(C)], MAT_RTOL)


def test_lkj_cov_value_grad_and_batch():
    fam = FAM["lkj_cov"]
    y, mu, sigma, eta = fam.args
    want, want_g = jax.value_and_grad(lambda e: jd.lkj_cov_lpdf(y, mu, sigma, e))(jnp.asarray(eta))
    te = t64(eta, grad=True)
    got = td.lkj_cov_lpdf(y, mu, sigma, te)
    close(got.detach(), want, MAT_RTOL)
    close(torch.autograd.grad(got, te)[0], want_g, GRAD_RTOL)
    ys = np.stack([y, 1.2 * y, y])
    etas = np.array([eta, 2.0, 0.7])
    got_b = td.lkj_cov_lpdf(ys, mu, sigma, t64(etas), batch_ndims=1)
    close(got_b, [float(jd.lkj_cov_lpdf(ys[c], mu, sigma, etas[c])) for c in range(C)], MAT_RTOL)


def test_dirichlet_lpmf_forwards():
    theta, alpha = np.array([0.2, 0.3, 0.5]), np.array([1.5, 2.0, 3.0])
    close(td.dirichlet_lpmf(theta, alpha), jd.dirichlet_lpmf(theta, alpha), RTOL)
    thetas = np.stack([theta, [0.1, 0.1, 0.8], theta])
    close(td.dirichlet_lpmf(thetas, alpha, batch_ndims=1), [float(jd.dirichlet_lpmf(t, alpha)) for t in thetas], RTOL)


CDF_CASES = [("beta_binomial", k) for k in ("cdf", "lcdf", "lccdf")] + [("neg_binomial", k) for k in ("lcdf", "lccdf")]


@pytest.mark.parametrize("name,kind", CDF_CASES)
def test_cdfs_value_grad_and_batch(name, kind):
    c = next(c for c in CDFS if c.name == name)
    y, *params = c.args
    floats = [i for i, p in enumerate(params) if isinstance(p, float)]
    jf, tf = getattr(jd, f"{name}_{kind}"), getattr(td, f"{name}_{kind}")

    def jfun(*fp):
        full = list(params)
        for i, v in zip(floats, fp):
            full[i] = v
        return jf(y, *full)

    want, want_g = jax.value_and_grad(jfun, tuple(range(len(floats))))(*[jnp.asarray(params[i], jnp.float64) for i in floats])
    tp = [t64(params[i], grad=True) for i in floats]
    full = list(params)
    for i, v in zip(floats, tp):
        full[i] = v
    got = tf(y, *full)
    close(got.detach(), want, 1e-10)
    probs = np.asarray(c.probs(*c.args))
    oracle = {"cdf": np.prod(probs), "lcdf": np.sum(np.log(probs)), "lccdf": np.sum(np.log1p(-probs))}[kind]
    close(got.detach(), oracle, 1e-7)
    for g, w in zip(torch.autograd.grad(got, tp), want_g):
        close(g, w, GRAD_RTOL, atol=1e-12)
    cp = [t64(np.array([p, 1.1 * p, -1.0]))[:, None] if isinstance(p, float) else p for p in params]
    out = tf(y, *cp, batch_ndims=1)
    alone = [tf(y, *[q[k] if isinstance(q, torch.Tensor) else q for q in cp]) for k in range(2)]
    close(out[:2], alone, 1e-13)
    assert bool(torch.isnan(out[2])) if kind == "cdf" else float(out[2]) == -np.inf
