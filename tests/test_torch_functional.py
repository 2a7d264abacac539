"""PyTorch port: ``functional.py``, ``testing.py``, ``ops/integrate.py`` and
``utils/profiling.py`` against ``math_tpu`` (CPU, float64).

The twins of ``tests/test_functional.py``, the ``integrate_1d`` cases of
``tests/test_ops.py`` and the profiling case of ``tests/test_runtime.py``:
the same functions and points go through both packages.  Tolerances: AD
results ``1e-10`` relative (``expect_near_rel``) against JAX's, the
reference tests' own tolerances against closed forms and finite differences.
"""

import math

import numpy as np
import pytest
import scipy.integrate

import jax
import jax.numpy as jnp
import torch

from math_tpu import functional as jfn
from math_tpu.ops.integrate import integrate_1d as j_integrate_1d
from math_tpu.testing import expect_near_rel as j_expect_near_rel

from math_tpu_torch import functional as fn
from math_tpu_torch import special as tsp
from math_tpu_torch import testing as tst
from math_tpu_torch.ops import glm_fused as gf
from math_tpu_torch.ops import integrate as tint
from math_tpu_torch.ops.integrate import integrate_1d
from math_tpu_torch.testing import expect_near_rel
from math_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)


def rosen(x):
    return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


def j_rosen(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


X = np.array([0.3, -0.5, 1.2])
XT = torch.tensor(X)  # the port's functionals run where their tensor lies (the card for a host array)


def test_gradient_jacobian_hessian():
    fx, g = fn.gradient(rosen, XT)
    expect_near_rel(g, fn.finite_diff_gradient(rosen, X), 1e-5)
    expect_near_rel(g, jax.jit(lambda x: jfn.gradient(j_rosen, x)[1])(X), 1e-10)
    expect_near_rel(fx, float(j_rosen(jnp.asarray(X))), 1e-12)

    fvec = lambda x: torch.stack([torch.sum(x**2), torch.prod(x)])  # noqa: E731
    _, J = fn.jacobian(fvec, XT)
    _, J2 = fn.jacobian(fvec, XT, mode="fwd")
    expect_near_rel(J, J2, 1e-12)
    expect_near_rel(J, jax.jit(lambda x: jfn.jacobian(lambda x: jnp.stack([jnp.sum(x**2), jnp.prod(x)]), x)[1])(X), 1e-10)

    _, _, H = fn.hessian(rosen, XT)
    expect_near_rel(H, fn.finite_diff_hessian(rosen, XT), 1e-3)
    expect_near_rel(H, jax.jit(lambda x: jfn.hessian(j_rosen, x)[2])(X), 1e-10)

    v = np.array([1.0, -2.0, 0.5])
    hv = fn.hessian_times_vector(rosen, XT, torch.tensor(v))
    expect_near_rel(hv, H.numpy() @ v, 1e-10)

    g_tr = fn.grad_tr_mat_times_hessian(rosen, XT, torch.eye(3, dtype=torch.float64))
    g_fd2 = fn.finite_diff_gradient(lambda x: float(torch.trace(fn.hessian(rosen, x)[2])), X, h=1e-5)
    expect_near_rel(g_tr, g_fd2, 1e-4)
    expect_near_rel(g_tr, jax.jit(lambda x: jfn.grad_tr_mat_times_hessian(j_rosen, x, np.eye(3)))(X), 1e-10)

    _, H3, gH = fn.grad_hessian(rosen, XT)
    assert tuple(gH.shape) == (3, 3, 3)
    expect_near_rel(gH, jax.jit(lambda x: jfn.grad_hessian(j_rosen, x)[2])(X), 1e-10)
    expect_near_rel(gH, fn.finite_diff_grad_hessian(rosen, XT), 1e-5)


def test_derivative():
    _, dx = fn.derivative(torch.sin, torch.tensor(0.7, dtype=torch.float64))
    expect_near_rel(dx, np.cos(0.7), 1e-12)
    _, d1 = fn.partial_derivative(rosen, XT, 1)
    expect_near_rel(d1, fn.finite_diff_gradient(rosen, X)[1], 1e-5)
    expect_near_rel(d1, float(jfn.partial_derivative(j_rosen, X, 1)[1]), 1e-10)


def test_a_host_array_takes_the_configured_device():
    """An ``x`` that is not a tensor goes to ``get_config().device`` (the card
    by default), or to the device of a tensor argument."""
    from math_tpu_torch.config import get_config, update_config

    before = get_config().device
    update_config(device="cpu")
    try:
        fx, g = fn.gradient(rosen, X)
    finally:
        update_config(device=before)
    assert g.device.type == "cpu" and g.dtype == torch.float64
    expect_near_rel(g, fn.gradient(rosen, XT)[1], 1e-15)
    assert fn._x(X, XT).device == XT.device and fn._x(XT) is XT


def test_map_rect_matches_serial():
    """The vmapped map equals the serial loop and the JAX package's map."""

    def job(shared, theta, x_r, x_i):
        return torch.stack([shared[0] + theta[0] * x_r[0], theta[1] ** 2])

    shared = torch.tensor([1.5], dtype=torch.float64)
    job_params = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]], dtype=torch.float64)
    x_r = torch.tensor([[0.1], [0.2], [0.3]], dtype=torch.float64)
    x_i = torch.zeros((3, 1), dtype=torch.int32)
    got = fn.map_rect(job, shared, job_params, x_r, x_i)
    expect_near_rel(got, torch.cat([job(shared, job_params[i], x_r[i], x_i[i]) for i in range(3)]), 1e-12)
    want = jfn.map_rect(lambda s, t, r, i: jnp.stack([s[0] + t[0] * r[0], t[1] ** 2]), jnp.asarray([1.5]),
                        job_params.numpy(), x_r.numpy(), x_i.numpy())
    expect_near_rel(got, want, 1e-12)
    g = torch.func.grad(lambda s: torch.sum(fn.map_rect(job, s, job_params, x_r, x_i)))(shared)
    expect_near_rel(g, np.array([3.0]), 1e-12)
    # a rank's jobs: axis_name changes nothing, the consumer reduces across
    # the ranks (the reference ignores it too)
    assert torch.equal(fn.map_rect(job, shared, job_params, x_r, x_i, axis_name="jobs"), got)


def test_adj_jac_apply():
    """A hand-written adjoint: y = softmax(x), under autograd and torch.func."""

    def mult_adj_jac(args, adj):
        (x,) = args
        y = torch.softmax(x, -1)
        return (y * (adj - torch.dot(adj, y)),)

    soft = fn.adj_jac_apply(lambda x: torch.softmax(x, -1), mult_adj_jac)
    w = torch.arange(3.0, dtype=torch.float64)
    x = torch.tensor(X, requires_grad=True)
    (g1,) = torch.autograd.grad(torch.sum(soft(x) * w), x)
    (g2,) = torch.autograd.grad(torch.sum(torch.softmax(x, -1) * w), x)
    expect_near_rel(g1, g2, 1e-10)
    expect_near_rel(torch.func.grad(lambda x: torch.sum(soft(x) * w))(torch.tensor(X)), g2, 1e-10)


def test_testing_harness_on_kernel_functions():
    """``expect_ad`` (reverse == jacfwd == finite differences, vmap, and the
    Hessian forward over reverse == reverse over reverse == finite
    differences) through a GLM kernel's rules and a special's; the harness
    itself against the JAX one on a failing comparison."""
    rng = np.random.default_rng(3)
    x, y = torch.tensor(rng.normal(size=(20, 2))), torch.tensor(rng.integers(0, 2, 20).astype(float))

    def glm(a, b):
        return gf.bernoulli_logit_glm_lpmf_chains(y, x, a[None], b[:, None])[0]

    tst.expect_ad(glm, 0.3, np.array([0.2, -0.4]), hessian=True)
    tst.expect_ad(lambda a, z: tsp.gamma_p(a, z), 2.0, 1.5, tol=1e-4, hessian=True, hess_tol=5e-3)
    tst.expect_ad_vectorized(lambda a, z: torch.sum(tsp.gamma_q(a, z)), 2.0, 1.5, tol=1e-4)
    tst.expect_all_throw_or_invalid(lambda a, z: tsp.gamma_p(a, z), -1.0, 1.5)
    for check in (expect_near_rel, j_expect_near_rel):
        check(np.array([1.0, np.inf]), np.array([1.0 + 1e-9, np.inf]), 1e-8)
        with pytest.raises(AssertionError):
            check(np.array([1.0, 2.0]), np.array([1.0, 2.1]), 1e-8)


# --- integrate_1d (the twins of tests/test_ops.py's cases) ---------------------


def test_integrate_1d_finite():
    # int_0^1 x^theta dx = 1/(theta+1)
    t = torch.tensor(2.5, dtype=torch.float64)
    got = integrate_1d(lambda x, t: torch.pow(x, t), 0.0, 1.0, t)
    expect_near_rel(got, 1 / 3.5, 1e-10)
    expect_near_rel(got, float(j_integrate_1d(lambda x, t: jnp.power(x, t), 0.0, 1.0, 2.5)), 1e-13)
    g = torch.func.grad(lambda t: integrate_1d(lambda x, tt: torch.pow(x, tt), 0.0, 1.0, t))(t)
    expect_near_rel(g, -1 / 3.5**2, 1e-8)


def test_integrate_1d_half_infinite():
    # int_0^inf exp(-t x) dx = 1/t, and the mirrored interval
    t = torch.tensor(1.7, dtype=torch.float64)
    got = integrate_1d(lambda x, t: torch.exp(-t * x), 0.0, math.inf, t)
    expect_near_rel(got, 1 / 1.7, 1e-9)
    expect_near_rel(got, float(j_integrate_1d(lambda x, t: jnp.exp(-t * x), 0.0, np.inf, 1.7)), 1e-13)
    expect_near_rel(integrate_1d(lambda x, t: torch.exp(t * x), -math.inf, 0.0, t), 1 / 1.7, 1e-9)


def test_integrate_1d_doubly_infinite():
    # int exp(-x^2/(2 s^2)) = s sqrt(2 pi)
    s = torch.tensor(1.3, dtype=torch.float64)
    got = integrate_1d(lambda x, s: torch.exp(-0.5 * (x / s) ** 2), -math.inf, math.inf, s)
    expect_near_rel(got, 1.3 * np.sqrt(2 * np.pi), 1e-9)
    want = float(j_integrate_1d(lambda x, s: jnp.exp(-0.5 * (x / s) ** 2), -np.inf, np.inf, 1.3))
    expect_near_rel(got, want, 1e-13)


@pytest.mark.parametrize("kind", ["ts", "es", "ss"])
def test_integrate_1d_nodes_are_the_reference_nodes(kind):
    """7 levels, as the JAX package builds them (the builders are the
    port's own: ``special/incbeta.py``, ``special/bessel.py``); float32 drops
    the nodes and weights it cannot hold."""
    from math_tpu.ops import integrate as jint

    got = {"ts": (tint._TS_X, tint._TS_W), "es": (tint._ES_X, tint._ES_W), "ss": (tint._SS_X, tint._SS_W)}[kind]
    want = {"ts": (jint._TS_X, jint._TS_W), "es": (jint._ES_X, jint._ES_W), "ss": (jint._SS_X, jint._SS_W)}[kind]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-15, atol=2e-16)
    x32, w32 = tint._nodes(kind, torch.float32, "cpu")
    assert bool(torch.isfinite(x32).all() and torch.isfinite(w32).all())
    assert x32.numel() <= got[0].size


def test_integrate_1d_float32_and_forward_mode():
    """float32 (the overflowing nodes dropped) against scipy, and the
    gradient in theta by forward mode against JAX's ``jacfwd``."""
    for a, b, f, jf in [
        (0.0, 1.0, lambda x, t: torch.pow(x, t), lambda x, t: jnp.power(x, t)),
        (0.0, math.inf, lambda x, t: torch.exp(-t * x), lambda x, t: jnp.exp(-t * x)),
        (-math.inf, math.inf, lambda x, t: torch.exp(-0.5 * (x / t) ** 2), lambda x, t: jnp.exp(-0.5 * (x / t) ** 2)),
    ]:
        want = scipy.integrate.quad(lambda x: float(jf(x, 1.7)), a, b)[0]
        got = integrate_1d(f, a, b, torch.tensor(1.7, dtype=torch.float32))
        assert got.dtype == torch.float32
        expect_near_rel(got, want, 1e-5)
        d = torch.func.jacfwd(lambda t: integrate_1d(f, a, b, t))(torch.tensor(1.7, dtype=torch.float64))
        expect_near_rel(d, float(jax.jacfwd(lambda t: j_integrate_1d(jf, a, b, t))(1.7)), 1e-12)


def test_integrate_1d_device_of_theta():
    """Nodes follow theta's device and dtype; with no tensor they take the
    ``device`` argument (the card by default)."""
    got = integrate_1d(lambda x, t: x * t, 0.0, 2.0, 3.0, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.float64
    expect_near_rel(got, 6.0, 1e-12)


# --- profiling (the twin of tests/test_runtime.py::test_profiling_spans) --------


def test_profiling_spans(tmp_path):
    profiling.reset_spans()
    with profiling.span("unit-test-span"):
        _ = torch.sum(torch.arange(10.0))
    s = profiling.span_stats()
    assert s["unit-test-span"]["count"] == 1
    assert s["unit-test-span"]["total_s"] >= 0
    with profiling.device_trace(str(tmp_path)) as log_dir:
        with profiling.span("traced-span"):
            torch.sum(torch.arange(10.0) ** 2)
    assert log_dir == str(tmp_path)
    traces = list(tmp_path.iterdir())
    assert traces and "traced-span" in traces[0].read_text()
    assert profiling.span_stats()["traced-span"]["count"] == 1
    profiling.reset_spans()
    assert profiling.span_stats() == {}
