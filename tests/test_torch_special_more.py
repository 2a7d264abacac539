"""PyTorch port: ``gamma_p`` / ``gamma_q``, ``special/hyper.py``,
``special/owens_t.py`` and ``special/bessel.py`` against ``math_tpu.special``
(CPU, float64), at the points of ``tests/test_special.py`` and
``tests/test_special_bessel.py``.

Tolerances:

- ``gamma_p`` / ``gamma_q`` values ``2e-9`` relative: they are PyTorch's
  ``gammainc`` / ``gammaincc``, which are off by up to 1.6e-9 relative where
  ``a`` is 20-60 and ``z`` near ``a`` (its uniform asymptotic expansion;
  scipy's and XLA's are good to 1e-14 there: ROADMAP C2), and exact to
  1e-14 elsewhere on the grid (``test_gamma_values_off_the_band``);
- their partials ``1e-8`` relative with an absolute floor of ``1e-15`` (the
  shape partial is the same Gautschi series and asymptotic expansion as
  JAX's; where the asymptotic branch runs, its ``gamma_q`` factor carries
  the value's error); second derivatives ``1e-8`` of the largest entry,
  absolute ``1e-12``;
- ``F32`` and the ``grad_*`` functions of ``hyper.py`` ``1e-12`` (the same
  series term for term), the gamma ones ``1e-8``;
- ``owens_t`` ``1e-13``, its gradient ``1e-12``;
- the Bessel functions ``1e-11`` relative on the grid of
  ``tests/test_special_bessel.py`` (the same quadratures, summed in another
  order: I_n is 1.5e-12 apart at one point), their derivative in ``z``
  ``1e-10``.
"""

import importlib

import numpy as np
import pytest
import scipy.special as sp

import jax
import jax.numpy as jnp
import torch

import math_tpu.special as js
import math_tpu_torch.special as ts

AS = np.array([0.3, 0.5, 1.0, 2.5, 5.0, 11.0, 20.0, 50.0])
ZS = np.array([1e-3, 0.1, 1.0, 5.0, 10.0, 25.0, 40.0, 80.0])
GA, GZ = (g.ravel() for g in np.meshgrid(AS, ZS, indexing="ij"))
NS = np.array([0, 1, 2, 3, 5, 8, 10, 15])
XS = np.array([1e-3, 0.1, 0.5, 1.0, 3.0, 10.0, 30.0, 80.0, 200.0, 600.0, 2000.0])
BN, BX = (g.ravel() for g in np.meshgrid(NS, XS, indexing="ij"))
BESSEL = ["bessel_first_kind", "bessel_second_kind", "modified_bessel_first_kind", "modified_bessel_second_kind"]


def t64(a, grad=False):
    return torch.tensor(np.asarray(a, dtype=np.float64), dtype=torch.float64, requires_grad=grad)


def close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["gamma_p", "gamma_q"])
def test_gamma_values_and_partials(name):
    jf = getattr(js, name)
    want = np.asarray(jax.jit(jf)(GA, GZ))
    want_g = [np.asarray(g) for g in jax.jit(jax.vmap(jax.grad(jf, (0, 1))))(GA, GZ)]
    a, z = t64(GA, grad=True), t64(GZ, grad=True)
    got = getattr(ts, name)(a, z)
    close(got.detach(), want, 2e-9, atol=1e-300)
    for g, w in zip(torch.autograd.grad(got.sum(), (a, z)), want_g):
        close(g, w, 1e-8, atol=1e-15)


@pytest.mark.parametrize("name", ["gamma_p", "gamma_q"])
def test_gamma_values_off_the_band(name):
    """Away from PyTorch's asymptotic band (a in 20-60 with z near a) the
    values agree with JAX and scipy to 1e-13."""
    keep = ~((GA >= 20) & (np.abs(GZ - GA) < 0.5 * GA))
    got = getattr(ts, name)(t64(GA[keep]), t64(GZ[keep])).numpy()
    close(got, getattr(js, name)(GA[keep], GZ[keep]), 1e-13, atol=1e-300)
    close(got, getattr(sp, {"gamma_p": "gammainc", "gamma_q": "gammaincc"}[name])(GA[keep], GZ[keep]), 1e-13, atol=1e-300)


HESSIAN_POINTS = [(2.0, 3.0), (0.5, 4.0), (10.0, 9.0), (3.0, 40.0), (50.0, 45.0)]


@pytest.fixture(scope="module")
def jax_hessians():
    pts = jnp.asarray(HESSIAN_POINTS)
    return {name: np.asarray(jax.jit(jax.vmap(jax.hessian(lambda v, f=getattr(js, name): f(v[0], v[1]))))(pts))
            for name in ("gamma_p", "gamma_q")}


@pytest.mark.parametrize("name", ["gamma_p", "gamma_q"])
@pytest.mark.parametrize("i", range(len(HESSIAN_POINTS)), ids=[str(p) for p in HESSIAN_POINTS])
def test_gamma_second_order(name, i, jax_hessians):
    want = jax_hessians[name][i]
    got = torch.autograd.functional.hessian(lambda v: getattr(ts, name)(v[0], v[1]), t64(HESSIAN_POINTS[i])).numpy()
    close(got, want, 0.0, atol=max(1e-8 * np.max(np.abs(want)), 1e-12))


def test_grad_reg_inc_gamma_pair_on_the_reference_grid():
    """``tests/test_special_bessel.py``'s grid, z = 0 included; with no graph
    the 256-term series is summed in chunks of rows."""
    a = np.repeat(AS, 9)
    z = np.tile(np.array([0.0, 1e-3, 0.1, 1.0, 5.0, 10.0, 25.0, 40.0, 80.0]), len(AS))
    for name in ("grad_reg_inc_gamma", "grad_reg_lower_inc_gamma"):
        with torch.no_grad():
            got = getattr(ts, name)(t64(a), t64(z))
        close(got, getattr(js, name)(a, z), 1e-8, atol=1e-15)
    assert bool(torch.isnan(ts.grad_reg_inc_gamma(-1.0, 2.0)))


def test_F32_and_the_beta_gradients():
    for z in (0.1, 0.5, 0.9):
        close(ts.F32(1.0, 1.0, 1.0, 2.0, 2.0, z), js.F32(1.0, 1.0, 1.0, 2.0, 2.0, z), 1e-12)
    close(ts.F32(1.5, 0.7, 2.0, 3.0, 1.2, np.array([0.3, -0.4])), js.F32(1.5, 0.7, 2.0, 3.0, 1.2, np.array([0.3, -0.4])), 1e-12)
    for a, b, z in [(0.5, 0.7, 0.3), (2.0, 3.0, 0.6), (5.0, 1.5, 0.9)]:
        for name in ("grad_inc_beta", "grad_reg_inc_beta"):
            for g, w in zip(getattr(ts, name)(a, b, z), getattr(js, name)(a, b, z)):
                close(g, w, 1e-10)


def test_owens_t_values_and_gradient():
    hs = np.array([0.0, 0.5, 1.3, -1.3, 2.0, 4.0, 0.8, 1.5])
    as_ = np.array([0.1, 0.5, 0.7, 0.7, 1.0, 3.0, 0.6, 2.5])
    got = ts.owens_t(t64(hs), t64(as_))
    close(got, js.owens_t(hs, as_), 1e-13, atol=1e-300)
    close(got, sp.owens_t(hs, as_), 1e-10)
    close(ts.owens_t(1.3, -0.7), sp.owens_t(1.3, -0.7), 1e-10)
    h, a = t64(hs, grad=True), t64(as_, grad=True)
    grads = torch.autograd.grad(ts.owens_t(h, a).sum(), (h, a))
    want = jax.jit(jax.vmap(jax.grad(js.owens_t, (0, 1))))(jnp.asarray(hs), jnp.asarray(as_))
    for g, w in zip(grads, want):
        close(g, w, 1e-12, atol=1e-15)


@pytest.mark.parametrize("name", BESSEL)
def test_bessel_grid_and_derivative(name):
    jf, tf = getattr(js, name), getattr(ts, name)
    want = np.asarray(jax.jit(jf)(BN.astype(np.float64), BX))
    got = tf(t64(BN), t64(BX)).numpy()
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    close(got[fin], want[fin], 1e-11, atol=1e-300)
    pts = [(0, 2.5), (3, 0.7), (5, 40.0), (2, 600.0)]
    n = np.array([p[0] for p in pts], dtype=np.float64)
    x = np.array([p[1] for p in pts])
    jg = np.asarray(jax.jit(jax.vmap(jax.grad(jf, 1)))(jnp.asarray(n), jnp.asarray(x)))
    tx = t64(x, grad=True)
    (g,) = torch.autograd.grad(tf(t64(n), tx).sum(), tx)
    close(g, jg, 1e-10, atol=1e-15)


def test_bessel_reflections_and_domain():
    close(ts.bessel_first_kind(2, -5.0), sp.jv(2, -5.0), 1e-10)
    close(ts.bessel_first_kind(-3, 5.0), sp.jv(-3, 5.0), 1e-10)
    close(ts.bessel_second_kind(-2, 3.0), sp.yv(-2, 3.0), 1e-10)
    close(ts.modified_bessel_first_kind(3, -7.0), sp.iv(3, -7.0), 1e-10)
    assert float(ts.bessel_first_kind(0, 0.0)) == 1.0 and float(ts.bessel_first_kind(2, 0.0)) == 0.0
    assert bool(torch.isnan(ts.bessel_second_kind(1, -1.0))) and bool(torch.isnan(ts.modified_bessel_second_kind(1, 0.0)))


def test_every_special_name_resolves():
    """Every public name of ``math_tpu.special`` (and of its modules
    ``incbeta``, ``hyper``, ``bessel``, ``owens_t``) resolves in the port."""
    missing = [n for n in dir(js) if not n.startswith("_") and callable(getattr(js, n)) and not hasattr(ts, n)]
    assert missing == []
    for sub in ("bessel", "hyper", "incbeta", "owens_t"):
        mod = importlib.import_module("math_tpu.special." + sub)
        port = importlib.import_module("math_tpu_torch.special." + sub)
        names = [n for n in dir(mod) if not n.startswith("_") and callable(getattr(mod, n))
                 and getattr(getattr(mod, n), "__module__", "") == mod.__name__]
        assert [n for n in names if not hasattr(port, n)] == [], mod.__name__


@pytest.mark.parametrize("name", ["bessel_second_kind", "modified_bessel_second_kind"])
def test_float32_bessel_derivative_is_finite(name):
    """In float32 the far exp-sinh nodes (t > ~89) are dropped: x sinh t would
    be inf and its derivative in z NaN; the derivative stays finite and near
    float64's."""
    n = torch.tensor([0.0, 1.0, 3.0])
    out = {}
    for dt in (torch.float32, torch.float64):
        z = torch.tensor([0.5, 3.0, 20.0], dtype=dt, requires_grad=True)
        (g,) = torch.autograd.grad(getattr(ts, name)(n.to(dt), z).sum(), z)
        out[dt] = g.double()
    assert bool(torch.isfinite(out[torch.float32]).all())
    close(out[torch.float32], out[torch.float64], 1e-4)
