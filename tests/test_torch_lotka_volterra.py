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


# --- the kernels' Functions on every derivative order (ROADMAP C4, B8) -----
#
# ``_LvRk4`` and the Functions under it on CPU tensors, with the kernels'
# stand-ins: the forward launch is ``lv_rk4_states_reference`` (what the
# forward kernel computes, its states kept), the adjoint launch
# ``lv_rk4_adjoint_states_reference`` (the adjoint kernel's sweep over the
# stored states, in its order), the dual forward and the dual adjoint their
# arithmetic in dual numbers (``lv_rk4_dual_states_reference``,
# ``lv_rk4_dual_adjoint_reference``; held against ``torch.func.jvp`` of
# ``ode_rk4_fixed`` and of the adjoint sweep below).  The model is
# routed through the Functions, as it is on the card.  ``jvp``, ``jacfwd``,
# ``functional.hessian``, the double-backward Hessian and a third order of the
# port's RK4 model at two points against ``jax.jvp`` / ``jax.jacfwd`` /
# ``jax.hessian`` of the JAX package's, float64, 1e-9 relative.


@pytest.fixture
def through_function(monkeypatch):
    """Route ``lv_rk4`` through ``_LvRk4`` on the CPU; count the stand-ins' calls."""
    calls = {"forward": 0, "adjoint": 0, "dual_forward": 0, "dual_adjoint": 0}

    def forward(z0, t0, ts, theta, steps, stamps=None):
        calls["forward"] += 1
        return lv_rk4.lv_rk4_states_reference(z0, t0, ts, theta, steps)

    def adjoint(t0, ts, theta, steps, states, gbar, stamps=None):
        calls["adjoint"] += 1
        assert states.shape == (len(ts) * steps, theta.shape[0], 2)
        return lv_rk4.lv_rk4_adjoint_states_reference(t0, ts, theta, steps, states, gbar)

    def dual_forward(z0, t0, ts, theta, steps, tz0, ttheta, stamps=None, keep_states=False):
        calls["dual_forward"] += 1
        ys, tys, states = lv_rk4.lv_rk4_dual_states_reference(z0, t0, ts, theta, steps, tz0, ttheta)
        return (ys, tys, states) if keep_states else (ys, tys)

    def dual_adjoint(t0, ts, theta, steps, ttheta, states, gbar, tgbar, stamps=None):
        calls["dual_adjoint"] += 1
        return lv_rk4.lv_rk4_dual_adjoint_reference(t0, ts, theta, steps, ttheta, states, gbar, tgbar)

    monkeypatch.setattr(lv_rk4, "lv_rk4_forward", forward)
    monkeypatch.setattr(lv_rk4, "lv_rk4_adjoint", adjoint)
    monkeypatch.setattr(lv_rk4, "lv_rk4_dual_forward", dual_forward)
    monkeypatch.setattr(lv_rk4, "lv_rk4_dual_adjoint", dual_adjoint)
    monkeypatch.setattr(lv_rk4, "lv_rk4", lv_rk4._kernel_route)
    lv_rk4.reset_counts()
    return calls


SHORT_TIMES = 5  # the third-order cases solve the first 5 intervals (the plain route is slow on the CPU)


@pytest.fixture(scope="module")
def second_order_reference():
    """JAX's jvp, gradient (jacfwd) and Hessian at two points; on the model of
    the first ``SHORT_TIMES`` intervals at the first point, the Hessian-vector
    product with ``v`` and its derivative along ``w`` (a third derivative);
    one jit."""
    ts, y, _, _ = tlv.synthetic_data(20)
    z = _points()[:2]
    rng = np.random.default_rng(9)
    v, w = rng.normal(size=z.shape), rng.normal(size=z.shape)
    jm, jm_short = jlv.make(ts, solver="rk4"), jlv.make(ts[:SHORT_TIMES], solver="rk4")

    def one(q, t):
        f = lambda p: jm.logp(p, jnp.asarray(y))  # noqa: E731
        return jax.jvp(f, (q,), (t,))[1], jax.jacfwd(f)(q), jax.hessian(f)(q)

    def third(q, t, s):
        f = lambda p: jm_short.logp(p, jnp.asarray(y[:SHORT_TIMES]))  # noqa: E731
        return jax.jvp(lambda p: jax.jvp(jax.grad(f), (p,), (t,))[1], (q,), (s,))

    refs = jax.jit(lambda a, b, c: (jax.vmap(one)(a, b), third(a[0], b[0], c[0])))(jnp.asarray(z), jnp.asarray(v), jnp.asarray(w))
    return ts, y, z, v, w, [np.asarray(r) for r in refs[0] + refs[1]]


def _close(got, want):
    got = got.detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * np.abs(want).max())


# the kernel launches of each order at two points vmapped into one batch
ORDER_CALLS = {
    "jvp": {"forward": 1, "adjoint": 0, "dual_forward": 1, "dual_adjoint": 0},
    "jacfwd": {"forward": 1, "adjoint": 0, "dual_forward": 1, "dual_adjoint": 0},
    # jacfwd over grad: the primal, its tangents (dual forward), the adjoint as
    # _LvRk4Adjoint and its jvp (one dual forward + one dual adjoint)
    "hessian": {"forward": 1, "adjoint": 1, "dual_forward": 2, "dual_adjoint": 1},
}


@pytest.mark.parametrize("order", ["jvp", "jacfwd", "hessian"])
def test_kernel_function_takes_every_order(through_function, second_order_reference, order):
    from math_tpu_torch import functional

    ts, y, z, v, _, (jvp_want, grad_want, hess_want, _, _) = second_order_reference
    tm = tlv.make(ts, solver="rk4")
    yt = torch.tensor(y)
    f = lambda q: tm.logp(q[None], yt)[0]  # noqa: E731
    # the two points under vmap: each Function's vmap rule folds them (and
    # jacfwd's basis tangents) into the lanes of one launch
    zt, vt = torch.tensor(z), torch.tensor(v)
    if order == "jvp":
        _close(torch.func.vmap(lambda q, t: torch.func.jvp(f, (q,), (t,))[1])(zt, vt), jvp_want)
    elif order == "jacfwd":
        _close(torch.func.vmap(torch.func.jacfwd(f))(zt), grad_want)
    else:
        _, g, h = torch.func.vmap(lambda q: functional.hessian(f, q))(zt)
        _close(g, grad_want)
        _close(h, hess_want)
    # forward mode and the second order run on the kernels alone
    assert lv_rk4.PLAIN_CALLS["lv_rk4_plain"] == 0
    assert through_function == ORDER_CALLS[order]


def test_double_backward_hessian_is_the_kernels_alone(through_function, second_order_reference):
    """``infer.optimize.hessian`` (Laplace's double backward) against
    ``jax.hessian``: the create_graph gradient runs the adjoint as
    ``_LvRk4Adjoint``, whose backward is one dual forward + dual adjoint; the
    likelihood's cotangent of ``gbar`` reaches the first-order adjoint once
    more.  No plain call."""
    from math_tpu_torch.infer.optimize import hessian

    ts, y, z, _, _, (_, _, hess_want, _, _) = second_order_reference
    tm = tlv.make(ts, solver="rk4")
    _close(hessian(tm.logp, torch.tensor(z[1]), (torch.tensor(y),)), hess_want[1])
    assert lv_rk4.PLAIN_CALLS["lv_rk4_plain"] == 0
    assert through_function == {"forward": 1, "adjoint": 2, "dual_forward": 1, "dual_adjoint": 1}


def test_adjoint_backward_is_hvp_and_jvp(through_function):
    """``_LvRk4Adjoint.backward`` for a cotangent ``u`` of ``(z0bar,
    thetabar)``: ``H u`` for ``(z0, theta)`` (H the Hessian of ``<gbar,
    ys>``) and ``J u`` for ``gbar``, against autograd through the plain
    version (float64, 1e-10)."""
    ts = tlv.synthetic_data(4)[0]
    rng = np.random.default_rng(12)
    c, steps = 3, 5
    z0 = torch.tensor(np.array([33.0, 6.0]) * np.exp(0.2 * rng.normal(size=(c, 2))), requires_grad=True)
    th = torch.tensor(np.array([0.55, 0.028, 0.80, 0.024]) * np.exp(0.2 * rng.normal(size=(c, 4))), requires_grad=True)
    gbar = torch.tensor(rng.normal(size=(c, 4, 2)), requires_grad=True)
    uz, uth = torch.tensor(rng.normal(size=(c, 2))), torch.tensor(rng.normal(size=(c, 4)))
    _, states = lv_rk4.lv_rk4_states_reference(z0.detach(), 0.0, ts, th.detach(), steps)
    zb, tb = lv_rk4._LvRk4Adjoint.apply(z0, th, gbar, states, 0.0, ts, steps)
    got = torch.autograd.grad((zb * uz).sum() + (tb * uth).sum(), (z0, th, gbar))
    assert through_function == {"forward": 0, "adjoint": 1, "dual_forward": 1, "dual_adjoint": 1}
    ys = lv_rk4.ode.ode_rk4_fixed(lv_rk4.lv_rhs, z0, 0.0, ts, th, steps)
    zb2, tb2 = torch.autograd.grad(ys, (z0, th), gbar, create_graph=True)
    want = torch.autograd.grad((zb2 * uz).sum() + (tb2 * uth).sum(), (z0, th, gbar))
    ju = torch.func.jvp(lambda a, b: lv_rk4.ode.ode_rk4_fixed(lv_rk4.lv_rhs, a, 0.0, ts, b, steps), (z0.detach(), th.detach()),
                        (uz, uth))[1]
    for g, w in zip(got + (got[2],), want + (ju,)):
        np.testing.assert_allclose(g.numpy(), w.detach().numpy(), rtol=1e-10, atol=1e-10 * float(w.abs().max()))


def _short_model(y):
    """The model of the first ``SHORT_TIMES`` intervals, as a function of one point."""
    ts = tlv.synthetic_data(20)[0][:SHORT_TIMES]
    tm, yt = tlv.make(ts, solver="rk4"), torch.tensor(y[:SHORT_TIMES])
    return lambda q: tm.logp(q[None], yt)[0]


@pytest.mark.parametrize("route", ["reverse_over_reverse", "forward_over_forward"])
def test_third_order_takes_the_plain_version(through_function, second_order_reference, route):
    """A directional third derivative (the derivative along ``w`` of the
    Hessian-vector product with ``v``) against JAX's.  Reverse over reverse
    (as ``functional.grad_hessian``): the adjoint's backward is differentiated
    again, so that rule takes the plain version, one call.  Forward over
    forward over reverse takes the plain version from the start (one call):
    ``torch.func`` drops the outer tangent of a Function's ``jvp`` rule."""
    _, y, z, v, w, (_, _, _, _, third_want) = second_order_reference
    f = _short_model(y)
    q, vt, wt = torch.tensor(z[0]), torch.tensor(v[0]), torch.tensor(w[0])
    if route == "reverse_over_reverse":
        hvp = lambda p: torch.func.grad(lambda r: (torch.func.grad(f)(r) * vt).sum())(p)  # noqa: E731
    else:
        hvp = lambda p: torch.func.jvp(torch.func.grad(f), (p,), (vt,))[1]  # noqa: E731
    _close(torch.func.jvp(hvp, (q,), (wt,))[1], third_want)
    assert lv_rk4.PLAIN_CALLS["lv_rk4_plain"] == 1


def test_reverse_over_forward_is_the_dual_pair(through_function, second_order_reference):
    """``grad`` of a ``jvp`` (the gradient of a directional derivative, ``H
    v``): the backward of ``_LvRk4Dual`` is one dual forward + dual adjoint; no
    plain call."""
    _, y, z, v, _, (_, _, _, hv_want, _) = second_order_reference
    f = _short_model(y)
    got = torch.func.grad(lambda q: torch.func.jvp(f, (q,), (torch.tensor(v[0]),))[1])(torch.tensor(z[0]))
    _close(got, hv_want)
    assert lv_rk4.PLAIN_CALLS["lv_rk4_plain"] == 0
    assert through_function == {"forward": 1, "adjoint": 1, "dual_forward": 2, "dual_adjoint": 1}


def test_first_order_is_the_kernel_pair_alone(through_function):
    """A sampler's gradient and ``torch.func.grad``: one forward and one
    adjoint launch each, no plain call; a ``create_graph`` gradient (the
    Laplace Hessian's first pass) runs the adjoint as ``_LvRk4Adjoint``, whose
    primal is the adjoint launch: no plain call either."""
    ts, y, _, _ = tlv.synthetic_data(20)
    tm = tlv.make(ts, solver="rk4")
    z, yt = torch.tensor(_points()[:3]), torch.tensor(y)
    _, g_autograd = tm.logp_and_grad(z, yt)
    g_func = torch.func.grad(lambda q: tm.logp(q, yt).sum())(z)
    assert through_function == {"forward": 2, "adjoint": 2, "dual_forward": 0, "dual_adjoint": 0}
    assert lv_rk4.PLAIN_CALLS["lv_rk4_plain"] == 0
    assert torch.equal(g_autograd, g_func)
    zz = z.clone().requires_grad_(True)
    (g2,) = torch.autograd.grad(tm.logp(zz, yt).sum(), zz, create_graph=True)
    assert through_function["adjoint"] == 3 and lv_rk4.PLAIN_CALLS["lv_rk4_plain"] == 0 and g2.requires_grad
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


@pytest.mark.parametrize("c,nt,steps", [(4, 20, 24), (3, 3, 7), (5, 2, 1)])
def test_stored_states_and_their_adjoint_match_the_recompute(c, nt, steps):
    """The stored-state forward's ``ys`` equals ``ode_rk4_fixed``'s bit for
    bit and its states start each interval at ``ys`` (the layout the adjoint
    kernel reads); the adjoint sweep over the stored states equals the one
    that recomputes each interval from ``ys`` (1e-13), and so does the
    adjoint kernel's order, 32 segments joined by a scan (1e-12: the joins
    round in another order)."""
    rng = np.random.default_rng(c + nt + steps)
    ts = np.arange(1, nt + 1, dtype=np.float64)
    z0 = torch.tensor(np.array([33.0, 6.0]) * np.exp(0.2 * rng.normal(size=(c, 2))))
    th = torch.tensor(np.array([0.55, 0.028, 0.80, 0.024]) * np.exp(0.2 * rng.normal(size=(c, 4))))
    g = torch.tensor(rng.normal(size=(c, nt, 2)))
    ys, states = lv_rk4.lv_rk4_states_reference(z0, 0.0, ts, th, steps)
    assert torch.equal(ys, lv_rk4.ode.ode_rk4_fixed(lv_rk4.lv_rhs, z0, 0.0, ts, th, steps))
    assert states.shape == (nt * steps, c, 2) and torch.equal(states[0], z0)
    assert torch.equal(states[steps::steps], ys[:, :-1].transpose(0, 1))
    new = lv_rk4.lv_rk4_adjoint_states_reference(0.0, ts, th, steps, states, g)
    old = lv_rk4.lv_rk4_adjoint_reference(z0, 0.0, ts, th, steps, ys, g)
    scan = lv_rk4.lv_rk4_adjoint_scan_reference(0.0, ts, th, steps, states, g)
    for a, s, b in zip(new, scan, old):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-13, atol=1e-13 * float(b.abs().max()))
        np.testing.assert_allclose(s.numpy(), b.numpy(), rtol=1e-12, atol=1e-12 * float(b.abs().max()))


def test_dual_references_are_the_jvp_of_the_primal_ones():
    """The dual stand-ins against ``torch.func.jvp``: the dual forward's
    ``(ys, ys')`` against the jvp of ``ode_rk4_fixed`` and its dual states
    against the jvp of the states reference; the dual adjoint against the jvp
    of the adjoint sweep (1e-13)."""
    rng = np.random.default_rng(21)
    c, nt, steps = 3, 3, 7
    ts = np.arange(1, nt + 1, dtype=np.float64)
    z0 = torch.tensor(np.array([33.0, 6.0]) * np.exp(0.2 * rng.normal(size=(c, 2))))
    th = torch.tensor(np.array([0.55, 0.028, 0.80, 0.024]) * np.exp(0.2 * rng.normal(size=(c, 4))))
    tz, tth, g, tg = (torch.tensor(rng.normal(size=s)) for s in ((c, 2), (c, 4), (c, nt, 2), (c, nt, 2)))
    ys, tys, dstates = lv_rk4.lv_rk4_dual_states_reference(z0, 0.0, ts, th, steps, tz, tth)
    want = torch.func.jvp(lambda a, b: lv_rk4.ode.ode_rk4_fixed(lv_rk4.lv_rhs, a, 0.0, ts, b, steps), (z0, th), (tz, tth))
    (_, st), (_, tst) = torch.func.jvp(lambda a, b: lv_rk4.lv_rk4_states_reference(a, 0.0, ts, b, steps), (z0, th), (tz, tth))
    got = lv_rk4.lv_rk4_dual_adjoint_reference(0.0, ts, th, steps, tth, dstates, g, tg)
    (zb, tb), (tzb, ttb) = torch.func.jvp(lambda a, s, gg: lv_rk4.lv_rk4_adjoint_states_reference(0.0, ts, a, steps, s, gg),
                                          (th, st, g), (tth, tst, tg))
    for a, b in zip((ys, tys, dstates[..., 0], dstates[..., 1]) + got, want + (st, tst, zb, tb, tzb, ttb)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-13, atol=1e-13 * float(b.abs().max()))
