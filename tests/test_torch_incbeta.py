"""PyTorch port: ``special/incbeta.py`` against ``math_tpu.special`` (CPU,
float64).

``inc_beta`` on a grid (``a``, ``b`` in {0.1, 0.5, 1, 2.5, 10, 80}, ``x``
from 1e-8 to 1 - 1e-8) and at the edge cases of XLA's ``betainc`` (``a`` or
``b`` 0 or infinite, ``x`` 0 or 1, out of range, NaN).  Tolerances:

- values ``1e-13`` relative to ``max(I, 1 - I)``: where the continued
  fraction runs on the swapped arguments the result is ``1 - q``, and both
  packages' ``lgamma`` (exact to an ulp of ~270 at b = 80) set q's error
  (``I_0.99(80, 0.1)``: JAX 3.9e-13 and the port 2.1e-12 from mpmath,
  relative to I = 0.034, both ~8e-14 of q = 0.966);
- first partials ``1e-10`` relative with an absolute floor of ``1e-12``
  (partials that cancel to ~1e-13 are noise in both);
- second derivatives (``jax.hessian``, forward over the custom rule, against
  reverse over the port's backward) ``1e-8`` of the largest entry;
- the chunked (no graph) and the unchunked partials agree to ``1e-13``.

``log_inc_beta`` (the port's own, under ``neg_binomial_2_lccdf``) against
``log`` of JAX's ``inc_beta`` where I is not small (values ``1e-13``
relative to ``max(1, |log I|)``, partials ``1e-10``), against mpmath in the
far lower tail (``1e-12``), and finite in float32 where I underflows.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import math_tpu.special as js
from math_tpu.special import incbeta as jib
from math_tpu_torch.special import incbeta as tib
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)

VALS = [0.1, 0.5, 1.0, 2.5, 10.0, 80.0]
XS = [1e-8, 0.01, 0.3, 0.5, 0.7, 0.99, 1.0 - 1e-8]
A, B, X = (g.ravel() for g in np.meshgrid(VALS, VALS, XS, indexing="ij"))
EDGES = [  # (a, b, x)
    (2.0, 3.0, 0.0), (2.0, 3.0, 1.0), (0.0, 3.0, 0.4), (2.0, 0.0, 0.4), (0.0, 3.0, 0.0), (2.0, 0.0, 1.0),
    (math.inf, 3.0, 0.4), (2.0, math.inf, 0.4), (0.0, 0.0, 0.5), (-1.0, 3.0, 0.4), (2.0, 3.0, -0.1), (2.0, 3.0, 1.1),
    (math.nan, 3.0, 0.4), (2.0, 3.0, math.nan), (1e-310, 3.0, 0.4),
]
HESSIAN_POINTS = [  # beta cdf rows, student_t (a = nu / 2, b = 1/2), binomial and neg_binomial_2 cdf rows
    (2.0, 3.0, 0.1), (2.0, 3.0, 0.9), (0.5, 0.5, 0.9), (2.0, 0.5, 0.5), (15.0, 0.5, 0.99), (6.0, 3.0, 0.7),
    (3.0, 6.0, 3.0 / 5.5), (4.0, 0.5, 0.3), (10.0, 2.5, 0.95), (0.1, 80.0, 1e-8),
]


def t64(a, grad=False):
    return torch.tensor(np.asarray(a, dtype=np.float64), dtype=torch.float64, requires_grad=grad)


@pytest.fixture(scope="module")
def jax_grid():
    f = lambda a, b, x: jib.inc_beta(a, b, x)  # noqa: E731
    val = jax.jit(f)(A, B, X)
    grads = jax.jit(jax.vmap(jax.grad(f, (0, 1, 2))))(A, B, X)
    return np.asarray(val), [np.asarray(g) for g in grads]


def test_values_on_the_grid(jax_grid):
    want, _ = jax_grid
    got = tib.inc_beta(t64(A), t64(B), t64(X)).numpy()
    scale = np.maximum(want, 1.0 - want)
    assert np.max(np.abs(got - want) / scale) < 1e-13


@pytest.mark.parametrize("i", [0, 1, 2], ids=["a", "b", "x"])
def test_partials_on_the_grid(jax_grid, i):
    _, want = jax_grid
    args = [t64(v, grad=True) for v in (A, B, X)]
    (g,) = torch.autograd.grad(tib.inc_beta(*args).sum(), args[i])
    np.testing.assert_allclose(g.numpy(), want[i], rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("edge", EDGES, ids=str)
def test_edge_cases(edge):
    got = float(tib.inc_beta(*[t64(v) for v in edge]))
    want = float(jib.inc_beta(*[jnp.float64(v) for v in edge]))
    assert got == want or (math.isnan(got) and math.isnan(want)), (edge, got, want)


@pytest.mark.parametrize("point", HESSIAN_POINTS, ids=str)
def test_second_derivatives(point):
    want = np.asarray(jax.hessian(lambda v: jib.inc_beta(v[0], v[1], v[2]))(jnp.asarray(point)))
    got = torch.autograd.functional.hessian(lambda v: tib.inc_beta(v[0], v[1], v[2]), t64(point)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-8 * np.max(np.abs(want)))


def test_chunked_partials_equal_the_unchunked(monkeypatch):
    """The no-graph backward sums the quadrature a chunk of rows at a time;
    with a chunk of ~2,500 rows the partials of 20,000 elements agree with
    the one-pass (graph) form to 1e-13."""
    rng = np.random.default_rng(0)
    a, b, x = (t64(v) for v in (rng.uniform(0.2, 20, 20_000), rng.uniform(0.2, 20, 20_000), rng.uniform(0, 1, 20_000)))
    with torch.no_grad():
        p = tib._betainc(a, b, x)
        whole = tib._partials(a, b, x, p, (True, True, True), chunked=False)
        monkeypatch.setattr(tib, "_CHUNK_NODE_EVALS", 1 << 20)
        parts = tib._partials(a, b, x, p, (True, True, True), chunked=True)
    for w, c in zip(whole, parts):
        np.testing.assert_allclose(c.numpy(), w.numpy(), rtol=1e-13, atol=1e-300)
    # and through autograd, the backward path itself
    args = [t64(v.numpy(), grad=True) for v in (a, b, x)]
    grads = torch.autograd.grad(tib.inc_beta(*args).sum(), args)
    for g, w in zip(grads, whole):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-13, atol=1e-300)


def test_dead_partials_are_skipped(monkeypatch):
    """With ``b`` data only the a-quadrature runs; with only ``x`` live none."""
    seen = []
    real = tib._beta_integrals
    monkeypatch.setattr(tib, "_beta_integrals", lambda *args: seen.append(args[4:]) or real(*args))
    a, x = t64([2.0, 3.0], grad=True), t64([0.3, 0.6], grad=True)
    torch.autograd.grad(tib.inc_beta(a, 5.0, x).sum(), a)
    assert seen == [(True, False)]
    seen.clear()
    torch.autograd.grad(tib.inc_beta(2.0, 5.0, x).sum(), x)
    assert seen == []


def test_lentz_iterations_are_counted():
    tib.reset_counts()
    tib.inc_beta(t64([2.0, 30.0]), t64([3.0, 20.0]), t64([0.4, 0.5]))
    assert tib.LENTZ["calls"] == 1
    assert 8 <= tib.LENTZ["iterations"] <= 599 and tib.LENTZ["iterations"] % 8 == 0


def test_float32_partials_stay_finite():
    """Nodes near 0 underflow ``t = x S`` in float32; the log-space integrand
    keeps the partials finite and near the float64 ones (a < 1 included)."""
    pts = np.array([[0.3, 4.0, 0.2], [2.0, 0.4, 0.9], [5.0, 20.0, 0.3], [0.8, 0.8, 0.5]])
    out = {}
    for dt in (torch.float32, torch.float64):
        args = [torch.tensor(pts[:, i], dtype=dt, requires_grad=True) for i in range(3)]
        out[dt] = [g.double().numpy() for g in torch.autograd.grad(tib.inc_beta(*args).sum(), args)]
    for g32, g64 in zip(out[torch.float32], out[torch.float64]):
        assert np.isfinite(g32).all()
        np.testing.assert_allclose(g32, g64, rtol=2e-4, atol=1e-5)


def test_inc_beta_dd_and_hypergeometric_gradients():
    a, b, x = np.array([2.0, 0.5, 7.0]), np.array([3.0, 1.5, 2.0]), np.array([0.4, 0.2, 0.8])
    for name in ("inc_beta_dda", "inc_beta_ddb", "inc_beta_ddz"):
        np.testing.assert_allclose(getattr(tib, name)(a, b, x).numpy(), getattr(js, name)(a, b, x), rtol=1e-10)
    args2 = (np.array([1.0, 0.5]), np.array([1.5, 2.0]), np.array([2.5, 3.0]), np.array([0.4, -0.3]))
    for g, w in zip(tib.grad_2F1(*args2), js.grad_2F1(*args2)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-13)
    args3 = (1.0, 1.5, 0.7, 2.0, 2.5, np.array([0.4, 0.9]))
    for g, w in zip(tib.grad_F32(*args3), js.grad_F32(*args3)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12)
    # differentiable again: d/da of dI/dx against JAX's mixed second derivative
    ta = t64(2.0, grad=True)
    (h,) = torch.autograd.grad(tib.inc_beta_ddz(ta, 3.0, 0.4), ta)
    want = jax.grad(lambda u: js.inc_beta_ddz(u, 3.0, 0.4))(2.0)
    np.testing.assert_allclose(float(h), float(want), rtol=1e-8)


def test_basic_inc_beta_is_the_differentiable_one():
    from math_tpu_torch.special import basic

    a = t64(2.0, grad=True)
    (g,) = torch.autograd.grad(basic.inc_beta(a, 3.0, 0.4), a)
    np.testing.assert_allclose(float(g), float(js.inc_beta_dda(2.0, 3.0, 0.4)), rtol=1e-10)


LOG_POINTS = [(16.0, 5.0, 0.3), (16.0, 0.7, 0.05), (2.0, 3.0, 0.4), (0.5, 0.5, 0.9), (10.0, 2.5, 0.95), (3.0, 6.0, 0.7)]


def test_log_inc_beta_against_jax():
    pts = np.array(LOG_POINTS)
    f = lambda a, b, x: jnp.log(jib.inc_beta(a, b, x))  # noqa: E731
    want = np.asarray(jax.vmap(f)(*pts.T))
    want_g = [np.asarray(g) for g in jax.vmap(jax.grad(f, (0, 1, 2)))(*pts.T)]
    args = [t64(c, grad=True) for c in pts.T]
    got = tib.log_inc_beta(*args)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-13 * np.maximum(1.0, np.abs(want)).max() / np.abs(want).min())
    for g, w in zip(torch.autograd.grad(got.sum(), args), want_g):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10, atol=1e-12)
    h = torch.autograd.functional.hessian(lambda v: tib.log_inc_beta(v[0], v[1], v[2]), t64(LOG_POINTS[0])).numpy()
    hw = np.asarray(jax.hessian(lambda v: f(v[0], v[1], v[2]))(jnp.asarray(LOG_POINTS[0])))
    np.testing.assert_allclose(h, hw, rtol=0, atol=1e-8 * np.abs(hw).max())


def test_log_inc_beta_far_tail():
    """I_x(16, 1) at x = 1.6e-4 is ~1e-61: float64 against mpmath, float32
    finite (I itself underflows there) and within 1e-5; the partials in b
    and x against the float64 ones."""
    import mpmath as mp

    mp.mp.dps = 40
    pts = [(16.0, 1.0, 1.6e-4), (16.0, 5.0, 1e-3), (30.0, 2.0, 0.01)]
    for a, b, x in pts:
        want = float(mp.log(mp.betainc(a, b, 0, x, regularized=True)))
        np.testing.assert_allclose(float(tib.log_inc_beta(a, b, x)), want, rtol=1e-12)
    out = {}
    for dt in (torch.float32, torch.float64):
        args = [torch.tensor([p[i] for p in pts], dtype=dt, requires_grad=i > 0) for i in range(3)]
        v = tib.log_inc_beta(*args)
        out[dt] = [v.detach().double().numpy()] + [g.double().numpy() for g in torch.autograd.grad(v.sum(), args[1:])]
    for got, want in zip(out[torch.float32], out[torch.float64]):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-4)
    assert float(tib.inc_beta(torch.tensor(16.0), torch.tensor(1.0), torch.tensor(1.6e-4))) == 0.0
