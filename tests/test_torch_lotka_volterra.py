"""PyTorch port: ``models/lotka_volterra.py`` and ``dists.lognormal_lpdf``
against ``math_tpu`` (CPU, float64).

``synthetic_data`` equals the reference's arrays; ``logp`` and its gradient
at 16 seeded unconstrained points equal
``math_tpu.models.lotka_volterra.make(ts, solver=...)``'s under
``jax.value_and_grad``, with ``y_obs`` passed as an array to both: for the
fixed-grid RK4 solver (on the CPU the kernel's plain version) at 1e-10, for
adaptive DP5 with the continuous adjoint at 1e-9 (the lanes take the
reference's steps; step sizes move by an ulp, see ``tests/test_torch_ode.py``).
``lognormal_lpdf`` equals the reference elementwise over a grid with y <= 0,
non-finite values and bad sigma, values and gradients at 1e-12.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from math_tpu import dists as jdists
from math_tpu.models import lotka_volterra as jlv

from math_tpu_torch import dists as tdists
from math_tpu_torch.models import lotka_volterra as tlv
from math_tpu_torch.ops import lv_rk4
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)

N_POINTS = 16
TOL = {"rk4": 1e-10, "rk45": 1e-9}


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("n_times", [20, 7])
def test_synthetic_data_matches_reference(seed, n_times):
    for dtype in (np.float64, np.float32):
        got = tlv.synthetic_data(n_times, seed=seed, dtype=dtype)
        want = jlv.synthetic_data(n_times, seed=seed, dtype=dtype)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def _points():
    """Unconstrained points around the generating values, as a sampler's chains sit."""
    _, _, theta, z0 = tlv.synthetic_data(20)
    rng = np.random.default_rng(5)
    z = np.concatenate([np.log(theta), np.log(z0), np.log([0.25, 0.25])])
    return z + 0.15 * rng.normal(size=(N_POINTS, 8))


@pytest.fixture(scope="module", params=["rk4", "rk45"])
def logp_pair(request):
    solver = request.param
    ts, y, _, _ = tlv.synthetic_data(20)
    z = _points()
    jm = jlv.make(ts, solver=solver)
    jl, jg = jax.jit(jax.vmap(jax.value_and_grad(lambda q: jm.logp(q, jnp.asarray(y)))))(jnp.asarray(z))
    tm = tlv.make(ts, solver=solver)
    plain = lv_rk4.PLAIN_CALLS["lv_rk4_plain"]
    tl, tg = tm.logp_and_grad(torch.tensor(z), torch.tensor(y))
    assert lv_rk4.PLAIN_CALLS["lv_rk4_plain"] == plain + (solver == "rk4")
    return solver, {"logp": (tl.numpy(), np.asarray(jl)), "grad": (tg.numpy(), np.asarray(jg))}


@pytest.mark.parametrize("part", ["logp", "grad"])
def test_logp_and_grad_match_reference(logp_pair, part):
    solver, parts = logp_pair
    got, want = parts[part]
    assert got.shape == want.shape == ((N_POINTS,) if part == "logp" else (N_POINTS, 8))
    tol = TOL[solver]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


def test_model_layout_and_solver_names():
    ts = tlv.synthetic_data(20)[0]
    m = tlv.make(ts, solver="rk4")
    assert m.dim == 8 and [name for name, _ in m.param_specs] == ["theta", "z0", "sigma"]
    with pytest.raises(ValueError, match="solver"):
        tlv.make(ts, solver="bdf")


def _lognormal_grid():
    ys = [-1.0, 0.0, 1e-3, 0.5, 2.0, 40.0, np.inf, np.nan]
    mus = [-1.0, 0.0, 2.3, np.inf]
    sigmas = [0.25, 1.0, 0.0, -1.0, np.inf]
    g = np.array(np.meshgrid(ys, mus, sigmas, indexing="ij")).reshape(3, -1)
    return g[0], g[1], g[2]


@pytest.mark.parametrize("propto", [False, True])
def test_lognormal_lpdf_matches_reference(propto):
    y, mu, sigma = _lognormal_grid()
    want = np.asarray(jax.vmap(lambda a, b, c: jdists.lognormal_lpdf(a, b, c, propto=propto))(y, mu, sigma))
    got = tdists.lognormal_lpdf(torch.tensor(y), torch.tensor(mu), torch.tensor(sigma), propto=propto, batch_ndims=1)
    assert np.isneginf(want).any() and np.isfinite(want).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


@pytest.mark.parametrize("propto", [False, True])
def test_lognormal_lpdf_gradients_match_reference(propto):
    y, mu, sigma = _lognormal_grid()
    jg = jax.vmap(jax.grad(lambda a, b, c: jdists.lognormal_lpdf(a, b, c, propto=propto), (0, 1, 2)))(y, mu, sigma)
    args = [torch.tensor(a, requires_grad=True) for a in (y, mu, sigma)]
    lp = tdists.lognormal_lpdf(*args, propto=propto, batch_ndims=1)
    tg = torch.autograd.grad(lp.sum(), args)
    for g, w in zip(tg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-12)


def test_lognormal_lpdf_sums_after_the_batch_axes():
    rng = np.random.default_rng(0)
    y, mu = np.exp(rng.normal(size=(3, 5, 2))), rng.normal(size=(3, 5, 2))
    got = tdists.lognormal_lpdf(torch.tensor(y), torch.tensor(mu), 0.5, batch_ndims=1)
    for c in range(3):
        want = float(jdists.lognormal_lpdf(jnp.asarray(y[c]), jnp.asarray(mu[c]), 0.5))
        np.testing.assert_allclose(float(got[c]), want, rtol=1e-12)


# --- the kernel pair's Function on every derivative order (ROADMAP C4) ------
#
# ``_LvRk4`` on CPU tensors, with the kernels' stand-ins: the forward launch is
# ``ode_rk4_fixed`` (what the forward kernel computes), the adjoint launch
# ``lv_rk4_adjoint_reference`` (the adjoint kernel's sweep in its order).  The
# model is routed through the Function, as it is on the card.  ``jvp``,
# ``jacfwd`` and ``functional.hessian`` of the port's RK4 model at two points
# against ``jax.jvp`` / ``jax.jacfwd`` / ``jax.hessian`` of the JAX package's,
# float64, 1e-9 relative.


@pytest.fixture
def through_function(monkeypatch):
    """Route ``lv_rk4`` through ``_LvRk4`` on the CPU; count the stand-ins' calls."""
    calls = {"forward": 0, "adjoint": 0}

    def forward(z0, t0, ts, theta, steps, stamps=None):
        calls["forward"] += 1
        return lv_rk4.ode.ode_rk4_fixed(lv_rk4.lv_rhs, z0, t0, ts, theta, steps)

    def adjoint(z0, t0, ts, theta, steps, ys, gbar, stamps=None):
        calls["adjoint"] += 1
        return lv_rk4.lv_rk4_adjoint_reference(z0, t0, ts, theta, steps, ys, gbar)

    monkeypatch.setattr(lv_rk4, "lv_rk4_forward", forward)
    monkeypatch.setattr(lv_rk4, "lv_rk4_adjoint", adjoint)
    monkeypatch.setattr(lv_rk4, "lv_rk4", lambda z0, t0, ts, theta, s: lv_rk4._LvRk4.apply(z0, theta, t0, ts, int(s)))
    lv_rk4.reset_counts()
    return calls


@pytest.fixture(scope="module")
def second_order_reference():
    """JAX's jvp, gradient (jacfwd) and Hessian at two points, one jit."""
    ts, y, _, _ = tlv.synthetic_data(20)
    z = _points()[:2]
    v = np.random.default_rng(9).normal(size=z.shape)
    jm = jlv.make(ts, solver="rk4")

    def one(q, t):
        f = lambda p: jm.logp(p, jnp.asarray(y))  # noqa: E731
        return jax.jvp(f, (q,), (t,))[1], jax.jacfwd(f)(q), jax.hessian(f)(q)

    refs = jax.jit(jax.vmap(one))(jnp.asarray(z), jnp.asarray(v))
    return ts, y, z, v, [np.asarray(r) for r in refs]


def _close(got, want):
    got = got.detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * np.abs(want).max())


@pytest.mark.parametrize("order", ["jvp", "jacfwd", "hessian"])
def test_kernel_function_takes_every_order(through_function, second_order_reference, order):
    from math_tpu_torch import functional

    ts, y, z, v, (jvp_want, grad_want, hess_want) = second_order_reference
    tm = tlv.make(ts, solver="rk4")
    yt = torch.tensor(y)
    f = lambda q: tm.logp(q[None], yt)[0]  # noqa: E731
    # the two points under vmap: the Function's vmap rule folds them into
    # the lanes of one forward launch
    zt, vt = torch.tensor(z), torch.tensor(v)
    if order == "jvp":
        _close(torch.func.vmap(lambda q, t: torch.func.jvp(f, (q,), (t,))[1])(zt, vt), jvp_want)
    elif order == "jacfwd":
        _close(torch.func.vmap(torch.func.jacfwd(f))(zt), grad_want)
    else:
        _, g, h = torch.func.vmap(lambda q: functional.hessian(f, q))(zt)
        _close(g, grad_want)
        _close(h, hess_want)
    # forward mode and the second order run through the plain version; the
    # primal is always the forward launch's
    assert lv_rk4.PLAIN_CALLS["lv_rk4_plain"] > 0
    assert through_function["forward"] == 1 and through_function["adjoint"] == 0


def test_first_order_is_the_kernel_pair_alone(through_function):
    """A sampler's gradient and ``torch.func.grad``: one forward and one
    adjoint launch each, no plain call; a ``create_graph`` gradient (the
    Laplace Hessian's first pass) takes the plain version for its adjoint."""
    ts, y, _, _ = tlv.synthetic_data(20)
    tm = tlv.make(ts, solver="rk4")
    z, yt = torch.tensor(_points()[:3]), torch.tensor(y)
    _, g_autograd = tm.logp_and_grad(z, yt)
    g_func = torch.func.grad(lambda q: tm.logp(q, yt).sum())(z)
    assert through_function == {"forward": 2, "adjoint": 2}
    assert lv_rk4.PLAIN_CALLS["lv_rk4_plain"] == 0
    assert torch.equal(g_autograd, g_func)
    zz = z.clone().requires_grad_(True)
    (g2,) = torch.autograd.grad(tm.logp(zz, yt).sum(), zz, create_graph=True)
    assert through_function["adjoint"] == 2 and lv_rk4.PLAIN_CALLS["lv_rk4_plain"] == 1 and g2.requires_grad
    np.testing.assert_allclose(g2.detach().numpy(), g_autograd.numpy(), rtol=1e-10, atol=1e-10 * float(g_autograd.abs().max()))


def test_vmap_folds_into_the_lanes(through_function):
    """``vmap`` over a batch of chain blocks: one forward launch for the
    batch, equal to each block's own call."""
    ts, y, _, _ = tlv.synthetic_data(20)
    tm = tlv.make(ts, solver="rk4")
    z, yt = torch.tensor(_points()[:6]).reshape(3, 2, 8), torch.tensor(y)
    got = torch.func.vmap(lambda q: tm.logp(q, yt))(z)
    assert through_function["forward"] == 1
    want = torch.stack([tm.logp(q, yt) for q in z])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-13)
