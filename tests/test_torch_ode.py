"""PyTorch port: ``ops/ode.py`` and the LV kernel's adjoint algorithm against
``math_tpu.ops.ode`` (CPU, float64).

The same numpy inputs go through both packages; the JAX functions are
``vmap``ped over the lanes, the port's are chain-batched.  Tolerances:
``ode_rk4_fixed`` values and gradients 1e-12 (the same operations in the
same order); ``integrate_ode_rk45`` / ``integrate_ode_adams`` values and
continuous-adjoint gradients 1e-9 (each lane takes the reference's step
sequence; ``pow`` and the sums of the error norm round differently, which
moves the step sizes by an ulp).  The test system is Lotka-Volterra with a
time-dependent forcing term, so the per-lane time argument is exercised.
``lv_rk4_adjoint_reference`` (the CUDA adjoint kernel's sweep written in
PyTorch) is held against autograd through ``ode_rk4_fixed`` and against
``jax.vjp`` of the reference at 1e-12.
"""

import math
import os

import numpy as np
import pytest
from scipy.integrate import solve_ivp

import jax
import jax.numpy as jnp
import torch

from math_tpu.ops import ode as jode

from math_tpu_torch.ops import lv_rk4
from math_tpu_torch.ops import ode as tode

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The solvers run thousands of tiny operations; on the CPU a batched
    ``torch.linalg.solve`` of a few 2 x 2 systems takes ~8 ms with a pool of
    threads and ~0.04 ms with one.  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
TS = np.linspace(0.5, 10.0, 12)
THETA = np.array([1.1, 0.4, 0.4, 0.1])
Y0 = np.array([10.0, 5.0])
C = 3
PARTS = ("values", "grad_y0", "grad_theta")


def jax_forced(t, y, th):
    return jnp.stack([th[0] * y[0] - th[1] * y[0] * y[1] + 0.1 * jnp.sin(t), -th[2] * y[1] + th[3] * y[0] * y[1]])


def torch_forced(t, y, th):
    u, v = y.unbind(-1)
    a, b, g, d = th.unbind(-1)
    s = 0.1 * (torch.sin(t)[:, 0] if isinstance(t, torch.Tensor) else math.sin(t))
    return torch.stack([a * u - b * u * v + s, -g * v + d * u * v], -1)


def _lanes(seed=0):
    rng = np.random.default_rng(seed)
    return Y0 * np.exp(0.1 * rng.normal(size=(C, 2))), THETA * np.exp(0.1 * rng.normal(size=(C, 4)))


def _jax_values_and_grads(jax_solve, y0, th, ys=lambda out: out):
    """The JAX side once: ``vmap`` of the solve's values and of the gradient
    of ``sum(ys**2)``, in one ``jax.jit`` (one trace and compile for both;
    eager, the two traces took half again as long)."""
    def loss(a, b):
        out = jax_solve(a, b)
        return jnp.sum(jnp.square(ys(out))), out

    (_, out), jg = jax.jit(jax.vmap(jax.value_and_grad(loss, (0, 1), has_aux=True)))(jnp.asarray(y0), jnp.asarray(th))
    return out, jg


def _both(jax_solve, torch_solve):
    """Values and the gradients of ``sum(ys**2)`` from both packages."""
    y0, th = _lanes()
    jv, jg = _jax_values_and_grads(jax_solve, y0, th)
    jv = np.asarray(jv)
    ty0 = torch.tensor(y0, requires_grad=True)
    tth = torch.tensor(th, requires_grad=True)
    tv = torch_solve(ty0, tth)
    gy0, gth = torch.autograd.grad(torch.square(tv).sum(), (ty0, tth))
    return {"values": (tv.detach().numpy(), jv), "grad_y0": (gy0.numpy(), np.asarray(jg[0])),
            "grad_theta": (gth.numpy(), np.asarray(jg[1]))}


@pytest.fixture(scope="module")
def rk4_pair():
    return _both(lambda a, b: jode.ode_rk4_fixed(jax_forced, a, 0.0, TS, b, 16),
                 lambda a, b: tode.ode_rk4_fixed(torch_forced, a, 0.0, TS, b, 16))


@pytest.fixture(scope="module")
def rk45_pair():
    return _both(lambda a, b: jode.integrate_ode_rk45(jax_forced, a, 0.0, TS, b),
                 lambda a, b: tode.integrate_ode_rk45(torch_forced, a, 0.0, TS, b))


@pytest.fixture(scope="module")
def adams_pair():
    return _both(lambda a, b: jode.integrate_ode_adams(jax_forced, a, 0.0, TS, b),
                 lambda a, b: tode.integrate_ode_adams(torch_forced, a, 0.0, TS, b))


def _close(pair, rtol):
    got, want = pair
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("part", PARTS)
def test_rk4_fixed_matches_reference(rk4_pair, part):
    _close(rk4_pair[part], 1e-12)


@pytest.mark.parametrize("part", PARTS)
def test_rk45_matches_reference(rk45_pair, part):
    _close(rk45_pair[part], 1e-9)


@pytest.mark.parametrize("part", PARTS)
def test_adams_matches_reference(adams_pair, part):
    _close(adams_pair[part], 1e-9)


def test_max_num_steps_gives_nan_as_the_reference():
    """A lane that runs out of steps is NaN; the lanes that finish are not."""
    y0, th = _lanes(1)
    th[1] *= 3.0  # faster dynamics: more steps than the other lanes
    ts = np.array([0.5, 1.0])
    got = tode.integrate_ode_rk45(torch_forced, torch.tensor(y0), 0.0, ts, torch.tensor(th), rtol=1e-9,
                                  atol=1e-11, max_num_steps=14).numpy()
    want = np.asarray(jax.vmap(lambda a, b: jode.integrate_ode_rk45(jax_forced, a, 0.0, ts, b, rtol=1e-9, atol=1e-11,
                                                                    max_num_steps=14))(jnp.asarray(y0), jnp.asarray(th)))
    assert np.isnan(got).any() and not np.isnan(got).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-9, equal_nan=True)


@pytest.mark.parametrize("solve", [tode.integrate_ode_rk45, tode.integrate_ode_adams])
def test_lane_in_a_batch_equals_the_lane_alone(solve):
    """Masked lanes: a lane takes its own step sequence whatever the others do."""
    y0, th = _lanes(2)
    th[0] *= 2.5
    batch = solve(torch_forced, torch.tensor(y0), 0.0, TS, torch.tensor(th))
    for c in range(C):
        alone = solve(torch_forced, torch.tensor(y0[c:c + 1]), 0.0, TS, torch.tensor(th[c:c + 1]))
        np.testing.assert_allclose(batch[c].numpy(), alone[0].numpy(), rtol=1e-14, atol=0)


def _scipy_lv(ts):
    def f(t, y):
        return [THETA[0] * y[0] - THETA[1] * y[0] * y[1], -THETA[2] * y[1] + THETA[3] * y[0] * y[1]]

    return solve_ivp(f, (0, float(ts[-1])), Y0, t_eval=ts, rtol=1e-10, atol=1e-12).y.T


@pytest.mark.parametrize("method,rtol", [("rk45", 1e-6), ("rk4", 1e-5), ("adams", 1e-6)])
def test_accuracy_against_scipy(method, rtol):
    """As ``tests/test_ode.py`` checks the reference: one lane, unbatched."""
    y0, th = torch.tensor(Y0), torch.tensor(THETA)
    if method == "rk45":
        ys = tode.integrate_ode_rk45(lv_rk4.lv_rhs, y0, 0.0, TS, th, rtol=1e-8, atol=1e-10)
    elif method == "rk4":
        ys = tode.ode_rk4_fixed(lv_rk4.lv_rhs, y0, 0.0, TS, th, 64)
    else:
        ys = tode.integrate_ode_adams(lv_rk4.lv_rhs, y0, 0.0, TS, th)
    assert ys.shape == (len(TS), 2)
    want = _scipy_lv(TS)
    np.testing.assert_allclose(ys.numpy(), want, rtol=rtol, atol=rtol * np.abs(want).max())


def test_adjoint_is_first_order_only():
    y0 = torch.tensor(Y0[None], requires_grad=True)
    th = torch.tensor(THETA[None], requires_grad=True)
    ys = tode.integrate_ode_rk45(lv_rk4.lv_rhs, y0, 0.0, TS[:2], th)
    (g,) = torch.autograd.grad(ys.sum(), th, create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(g.sum(), th)


LV_SHAPES = [(4, 20, 24), (5, 3, 1), (3, 3, 7)]  # (lanes, times, steps an interval)


def _lv_case(c, nt, steps, seed):
    rng = np.random.default_rng(seed)
    ts = np.arange(1, nt + 1, dtype=np.float64)
    z0 = np.array([33.0, 6.0]) * np.exp(0.2 * rng.normal(size=(c, 2)))
    th = np.array([0.55, 0.028, 0.80, 0.024]) * np.exp(0.2 * rng.normal(size=(c, 4)))
    return ts, z0, th, rng.normal(size=(c, nt, 2))


@pytest.mark.parametrize("c,nt,steps", LV_SHAPES)
def test_lv_adjoint_reference_matches_autograd(c, nt, steps):
    ts, z0, th, g = _lv_case(c, nt, steps, seed=c + steps)
    tz, tth = torch.tensor(z0, requires_grad=True), torch.tensor(th, requires_grad=True)
    ys = lv_rk4.lv_rk4_plain(tz, 0.0, ts, tth, steps)
    want = torch.autograd.grad(ys, (tz, tth), torch.tensor(g))
    got = lv_rk4.lv_rk4_adjoint_reference(tz.detach(), 0.0, ts, tth.detach(), steps, ys.detach(), torch.tensor(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-12 * float(b.abs().max()))


@pytest.mark.parametrize("c,nt,steps", LV_SHAPES)
def test_lv_adjoint_reference_matches_jax(c, nt, steps):
    """Against ``jax.vjp`` of the reference's ``ode_rk4_fixed`` on its own
    right-hand side (``math_tpu/models/lotka_volterra.py::dz_dt``): the sweep
    that recomputes each interval from ``ys`` and the adjoint kernel's sweep
    over the stored states."""
    from math_tpu.models.lotka_volterra import dz_dt

    ts, z0, th, g = _lv_case(c, nt, steps, seed=10 + c + steps)
    solve = jax.vmap(lambda a, b: jode.ode_rk4_fixed(dz_dt, a, 0.0, ts, b, steps))
    jys, vjp = jax.vjp(solve, jnp.asarray(z0), jnp.asarray(th))
    want = vjp(jnp.asarray(g))
    ys = lv_rk4.lv_rk4_plain(torch.tensor(z0), 0.0, ts, torch.tensor(th), steps)
    np.testing.assert_allclose(ys.numpy(), np.asarray(jys), rtol=1e-12)
    got = lv_rk4.lv_rk4_adjoint_reference(torch.tensor(z0), 0.0, ts, torch.tensor(th), steps, ys, torch.tensor(g))
    _, states = lv_rk4.lv_rk4_states_reference(torch.tensor(z0), 0.0, ts, torch.tensor(th), steps)
    swept = lv_rk4.lv_rk4_adjoint_states_reference(0.0, ts, torch.tensor(th), steps, states, torch.tensor(g))
    for a, s, b in zip(got, swept, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-12, atol=1e-12 * np.abs(b).max())
        np.testing.assert_allclose(s.numpy(), b, rtol=1e-12, atol=1e-12 * np.abs(b).max())


def test_lv_rk4_takes_the_plain_version_on_the_cpu():
    ts, z0, th, _ = _lv_case(2, 3, 2, seed=0)
    before, plain = dict(lv_rk4.LAUNCHES), lv_rk4.PLAIN_CALLS["lv_rk4_plain"]
    got = lv_rk4.lv_rk4(torch.tensor(z0), 0.0, ts, torch.tensor(th), 2)
    want = tode.ode_rk4_fixed(lv_rk4.lv_rhs, torch.tensor(z0), 0.0, ts, torch.tensor(th), 2)
    assert torch.equal(got, want)
    assert lv_rk4.LAUNCHES == before and lv_rk4.PLAIN_CALLS["lv_rk4_plain"] == plain + 1
    with pytest.raises(ValueError, match="no kernel for device"):
        lv_rk4.lv_rk4(torch.empty(2, 2, device="meta"), 0.0, ts, torch.empty(2, 4, device="meta"), 2)


@pytest.mark.parametrize("entry", ["lv_rk4_forward_f32", "lv_rk4_forward_f64", "lv_rk4_adjoint_f32", "lv_rk4_adjoint_f64",
                                   "lv_rk4_dual_forward_f32", "lv_rk4_dual_forward_f64", "lv_rk4_dual_adjoint_f32",
                                   "lv_rk4_dual_adjoint_f64", "op_latency_probe"])
def test_lv_entry_point_is_declared_and_bound(entry):
    with open(os.path.join(ROOT, "math_tpu_torch", "csrc", "lv_rk4.cu"), encoding="utf-8") as f:
        cu = f.read()
    with open(os.path.join(ROOT, "math_tpu_torch", "ops", "lv_rk4.py"), encoding="utf-8") as f:
        py = f.read()
    assert f'extern "C" int {entry}(' in cu
    assert entry.rsplit("_", 1)[0] in py and ("f32" in py and "f64" in py)
    # the ctypes declaration gives as many arguments as the C entry point takes
    decl = cu.split(f'extern "C" int {entry}(', 1)[1].split(")", 1)[0]
    argtypes = lv_rk4._PROBE_ARGTYPES if entry == "op_latency_probe" else lv_rk4._ARGTYPES[entry.rsplit("_", 1)[0]]
    assert decl.count(",") + 1 == len(argtypes), (entry, decl)


# ---------------------------------------------------------------------------
# The stiff solver, the DAE and the algebraic solvers (float64): the systems of
# tests/test_ode_stiff.py, tests/test_dae.py and tests/test_ops.py, at short
# horizons (the port's TR-BDF2 adjoint is eager Newton per step), two lanes.
# ---------------------------------------------------------------------------


def jax_stiff_lin(t, y, th):
    return jnp.stack([-th[0] * y[0] + th[1] * y[1], -th[1] * y[1]])


def torch_stiff_lin(t, y, th):
    a, b = th.unbind(-1)
    u, v = y.unbind(-1)
    return torch.stack([-a * u + b * v, -b * v], -1)


def jax_vdp(t, y, th):
    return jnp.stack([y[1], th[0] * ((1 - y[0] ** 2) * y[1]) - y[0]])


def torch_vdp(t, y, th):
    u, v = y.unbind(-1)
    return torch.stack([v, th[:, 0] * ((1 - u ** 2) * v) - u], -1)


STIFF_TH = np.array([[50.0, 3.0], [40.0, 2.5]])
STIFF_Y0 = np.array([[1.0, 1.0], [1.0, 0.8]])
STIFF_TS = np.array([0.05, 0.1])


@pytest.fixture(scope="module")
def bdf_pair():
    return _both_lanes(
        lambda a, b: jode.integrate_ode_bdf(jax_stiff_lin, a, 0.0, STIFF_TS, b),
        lambda a, b: tode.integrate_ode_bdf(torch_stiff_lin, a, 0.0, STIFF_TS, b),
        STIFF_Y0, STIFF_TH,
    )


def _both_lanes(jax_solve, torch_solve, y0, th):
    jv, jg = _jax_values_and_grads(jax_solve, y0, th)
    jv = np.asarray(jv)
    ty0, tth = torch.tensor(y0, requires_grad=True), torch.tensor(th, requires_grad=True)
    tv = torch_solve(ty0, tth)
    gy0, gth = torch.autograd.grad(torch.square(tv).sum(), (ty0, tth))
    return {"values": (tv.detach().numpy(), jv), "grad_y0": (gy0.numpy(), np.asarray(jg[0])),
            "grad_theta": (gth.numpy(), np.asarray(jg[1]))}


@pytest.mark.parametrize("part", PARTS)
def test_bdf_matches_reference(bdf_pair, part):
    """TR-BDF2 and its TR-BDF2 adjoint on the stiff linear system of
    ``tests/test_ode_stiff.py::test_stiff_gradients``."""
    _close(bdf_pair[part], 1e-9)


def test_bdf_van_der_pol_matches_reference():
    """Van der Pol at mu = 100 and 60 (stiff), values."""
    ts, mu, y0 = np.array([0.3, 0.6, 1.0]), np.array([[100.0], [60.0]]), np.array([[2.0, 0.0], [2.0, 0.0]])
    want = np.asarray(jax.vmap(lambda a, b: jode.integrate_ode_bdf(jax_vdp, a, 0.0, ts, b, rtol=1e-7, atol=1e-9))(
        jnp.asarray(y0), jnp.asarray(mu)))
    got = tode.integrate_ode_bdf(torch_vdp, torch.tensor(y0), 0.0, ts, torch.tensor(mu), rtol=1e-7, atol=1e-9).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * np.abs(want).max())


def test_bdf_stiff_decay_exact():
    """``y' = -k y`` at k = 1e4 (L-stable), the reference's test at the
    default tolerances (its 1e-8 / 1e-12 take ~2,000 eager steps)."""
    ts = np.array([0.1, 1.0, 2.0])

    def f(t, y, th):
        return -th * y

    ys = tode.integrate_ode_bdf(f, torch.tensor([1.0], dtype=torch.float64), 0.0, ts,
                                torch.tensor([1e4], dtype=torch.float64), max_num_steps=5000)
    assert np.abs(ys.numpy() - np.exp(-1e4 * ts)[:, None]).max() < 1e-8


def jax_dae_f(t, y, z, th):
    return -z


def jax_dae_g(t, y, z, th):
    return z ** 3 + z - th[0] * y


def torch_dae_g(t, y, z, th):
    return z ** 3 + z - th[:, :1] * y


DAE_TS = np.linspace(0.5, 2.0, 4)
DAE_TH = np.array([[0.9], [0.7]])
DAE_Y0 = np.array([[2.0], [1.5]])
DAE_Z0 = np.array([0.5])


@pytest.fixture(scope="module")
def dae_pair():
    """The nonlinear DAE of ``tests/test_dae.py``: values of y and z, and the
    gradient of ``sum(ys**2)``."""
    def jax_solve(a, b):
        return jode.integrate_dae(jax_dae_f, jax_dae_g, a, jnp.asarray(DAE_Z0), 0.0, DAE_TS, b)

    (jys, jzs), jg = _jax_values_and_grads(jax_solve, DAE_Y0, DAE_TH, ys=lambda out: out[0])
    ty0, tth = torch.tensor(DAE_Y0, requires_grad=True), torch.tensor(DAE_TH, requires_grad=True)
    tys, tzs = tode.integrate_dae(jax_dae_f, torch_dae_g, ty0, torch.tensor(DAE_Z0), 0.0, DAE_TS, tth)
    gy0, gth = torch.autograd.grad(torch.square(tys).sum(), (ty0, tth))
    return {"ys": (tys.detach().numpy(), np.asarray(jys)), "zs": (tzs.detach().numpy(), np.asarray(jzs)),
            "grad_y0": (gy0.numpy(), np.asarray(jg[0])), "grad_theta": (gth.numpy(), np.asarray(jg[1]))}


@pytest.mark.parametrize("part", ["ys", "zs", "grad_y0", "grad_theta"])
def test_dae_matches_reference(dae_pair, part):
    _close(dae_pair[part], 1e-9)


def test_dae_linear_analytic():
    """``y' = -z, 0 = z - theta y``: ``y = y0 exp(-theta t)``, as ``tests/test_dae.py``."""
    ts = np.linspace(0.5, 3.0, 6)
    ys, zs = tode.integrate_dae(lambda t, y, z, th: -z, lambda t, y, z, th: z - th * y,
                                torch.tensor([2.0], dtype=torch.float64), torch.tensor([0.5], dtype=torch.float64),
                                0.0, ts, torch.tensor([0.7], dtype=torch.float64))
    want = 2.0 * np.exp(-0.7 * ts)
    np.testing.assert_allclose(ys.numpy()[:, 0], want, rtol=1e-6)
    np.testing.assert_allclose(zs.numpy()[:, 0], 0.7 * want, rtol=1e-6)


def jax_circle(x, th):
    return jnp.stack([x[0] ** 2 + x[1] ** 2 - th[0], x[0] - x[1] * th[1]])


def torch_circle(x, th):
    return torch.stack([x[:, 0] ** 2 + x[:, 1] ** 2 - th[:, 0], x[:, 0] - x[:, 1] * th[:, 1]], -1)


SOLVER_TH = np.array([[4.0, 1.0], [5.0, 2.0], [3.0, 0.5]])


@pytest.mark.parametrize("name", ["algebra_solver_newton", "algebra_solver_powell"])
@pytest.mark.parametrize("part", ["root", "jacobian"])
def test_algebra_solver_matches_reference(name, part):
    """Roots and implicit-function Jacobians d x* / d theta per lane."""
    from math_tpu.ops import solve as jsolve

    from math_tpu_torch.ops import solve as tsolve

    jfn, tfn = getattr(jsolve, name), getattr(tsolve, name)
    x0 = np.array([1.0, 1.0])
    if part == "root":
        want = np.asarray(jax.vmap(lambda t: jfn(jax_circle, jnp.asarray(x0), t))(SOLVER_TH))
        got = tfn(torch_circle, torch.tensor(x0), torch.tensor(SOLVER_TH)).numpy()
    else:
        want = np.asarray(jax.vmap(jax.jacrev(lambda t: jfn(jax_circle, jnp.asarray(x0), t)))(SOLVER_TH))
        th = torch.tensor(SOLVER_TH, requires_grad=True)
        x = tfn(torch_circle, torch.tensor(x0), th)
        got = torch.stack([torch.autograd.grad(x[:, i].sum(), th, retain_graph=True)[0] for i in range(2)], 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("part", ["root", "gradient"])
def test_algebra_solver_fp_matches_reference(part):
    """``x = theta cos(x)`` per lane (``tests/test_ops.py``'s fixed point)."""
    from math_tpu.ops import solve as jsolve

    from math_tpu_torch.ops import solve as tsolve

    th_np = np.array([[1.0], [0.8], [0.5]])

    def jsol(t):
        return jsolve.algebra_solver_fp(lambda x, th: jnp.cos(x) * th, jnp.asarray([0.5]), t)

    th = torch.tensor(th_np, requires_grad=True)
    x = tsolve.algebra_solver_fp(lambda x, t: torch.cos(x) * t, torch.tensor([0.5], dtype=torch.float64), th)
    if part == "root":
        np.testing.assert_allclose(x.detach().numpy(), np.asarray(jax.vmap(jsol)(th_np)), rtol=1e-9)
    else:
        (g,) = torch.autograd.grad(x.sum(), th)
        want = np.asarray(jax.vmap(jax.grad(lambda t: jsol(t)[0]))(th_np))
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-9)
