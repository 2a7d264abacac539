"""PyTorch port: ``special/basic.py`` against ``math_tpu.special`` (CPU, float64).

Every function the port exports is evaluated at the points of
``tests/test_special.py`` (and a few more across each domain) by both
packages: values, first derivatives in every argument, and second
derivatives (the full Hessian) where JAX has them.  Tolerances (float64):
values and first derivatives relative ``1e-12`` with an absolute floor of
``1e-12``; second derivatives relative ``1e-9``, because torch's trigamma
(``polygamma(1, .)``, which is also the derivative of its digamma) is good to
~5e-10 relative (against mpmath: 12.2453645449 at 0.3, true 12.2453645461),
so ``trigamma``'s value and ``digamma``'s derivative get ``1e-9`` too;
``log_Phi``'s derivatives at x = -30 get ``2e-10`` and ``2e-7``: there JAX's
are the ones off (first 30.0332596722 and second -0.99889637 against mpmath's
30.0332596674 and -0.99889623; torch's 30.0332596674 and -0.99889623).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import math_tpu.special as js
import math_tpu_torch.special as ts
from math_tpu_torch.special import basic as tb
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)

RTOL, ATOL = 1e-12, 1e-12
RTOL_HESSIAN = 1e-9
LOOSE = {"trigamma": 1e-9, "digamma d/d0": 1e-9, "log_Phi d/d0": 2e-10, "log_Phi d2/d0d0": 2e-7}

UNARY = {
    "inv": [0.5, 1.7, -2.3],
    "inv_sqrt": [0.5, 1.7, 4.0],
    "inv_square": [0.5, -1.7],
    "square": [-1.3, 0.7],
    "cbrt": [-8.0, 0.3, 27.0],
    "expm1": [-1.0, 1e-5, 2.0],
    "inv_logit": [-3.0, 0.7, 25.0],
    "logit": [0.1, 0.5, 0.93],
    "log_inv_logit": [-30.0, 0.7, 30.0],
    "log1m_inv_logit": [-30.0, 0.7, 30.0],
    "log1m": [-2.0, 0.3, 0.99],
    "log1p_exp": [-40.0, 0.3, 40.0],
    "log1m_exp": [-1e-8, -0.1, -0.3, -0.5, -0.6931, -1.0, -2.0, -10.0, -50.0],
    "log1m_p": [-0.3, -2.0],
    "lgamma": [0.3, 2.5, 17.2],
    "digamma": [0.3, 2.5, 17.2],
    "trigamma": [0.3, 1.7, 17.2],
    "Phi": [-5.0, 0.3, 3.0],
    "log_Phi": [-30.0, -2.0, 0.3, 5.0],
    "inv_Phi": [0.01, 0.3, 0.5, 0.975],
    "Phi_approx": [-3.0, 0.3, 2.0],
    "erf": [-1.2, 0.3, 2.5],
    "erfc": [-1.2, 0.3, 2.5],
    "inv_erfc": [0.1, 0.7, 1.5],
    "log_i0": [0.1, 1.0, 2.0, 5.0, 20.0, 100.0],
    "inv_cloglog": [-3.0, 0.2, 1.5],
}
MULTI = {
    "hypot": [(3.0, 4.0), (-1.2, 0.5)],
    "logaddexp": [(1.0, 2.0), (-30.0, 5.0)],
    "log_diff_exp": [(2.0, 1.0), (0.5, -3.0)],
    "log_sum_exp": [(1.0, 2.0), (-30.0, 5.0)],
    "multiply_log": [(2.0, 3.0), (0.5, 0.2)],
    "lmultiply": [(2.0, 3.0)],
    "binary_log_loss": [(1.0, 0.3), (0.0, 0.8), (0.4, 0.6)],
    "lbeta": [(2.0, 3.0), (0.3, 7.5)],
    "lchoose": [(10.0, 3.0), (7.5, 2.5)],
    "log_falling_factorial": [(5.5, 2.0), (10.0, 3.5)],
    "log_rising_factorial": [(2.5, 3.0), (0.7, 1.2)],
    "log_modified_bessel_first_kind": [(v, z) for v in (0.0, 0.5, 1.5, 3.0) for z in (0.5, 2.0, 10.0)],
    "beta": [(2.0, 3.0), (0.3, 7.5)],
    "falling_factorial": [(5.5, 2.0)],
    "rising_factorial": [(2.5, 3.0)],
    "log_inv_logit_diff": [(1.5, -0.5), (3.0, 2.9)],
    "fma": [(1.2, -0.5, 3.0)],
    "log_mix": [(0.3, -1.0, -2.0), (0.9, 2.0, -5.0)],
}
VALUE_ONLY = {
    "step": [(-1.0,), (0.0,), (2.0,), (float("nan"),)],
    "int_step": [(-1.0,), (0.0,), (2.0,)],
    "sign": [(-1.5,), (0.0,), (2.0,)],
    "choose": [(10.0, 3.0), (7.0, 7.0)],
    "multiply_log": [(0.0, 0.0)],
}
CONSTANTS = ("LOG_TWO", "LOG_PI", "LOG_SQRT_TWO_PI", "LOG_TWO_PI", "SQRT_TWO")
NOT_PORTED = {"gamma_p", "gamma_q", "inc_beta"}  # held in tests/test_torch_{special_more,incbeta}.py
FROM_OTHER_MODULES = {  # math_tpu/special/__init__.py re-exports these from bessel / hyper / incbeta / owens_t
    "owens_t", "inc_beta_dda", "inc_beta_ddb", "inc_beta_ddz", "grad_2F1", "grad_F32", "bessel_first_kind",
    "bessel_second_kind", "modified_bessel_first_kind", "modified_bessel_second_kind", "F32", "grad_inc_beta",
    "grad_reg_inc_beta", "grad_reg_inc_gamma", "grad_reg_lower_inc_gamma",
}


def close(got, want, name, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64),
                               rtol=LOOSE.get(name, rtol), atol=ATOL, err_msg=name)


def cases():
    for name, pts in UNARY.items():
        yield name, [np.array(pts)]
    for name, pts in MULTI.items():
        yield name, [np.array(col) for col in zip(*pts)]


CASES = dict(cases())


@pytest.fixture(scope="module")
def jax_reference():
    """Values, gradients and Hessians of every case from one compiled JAX
    function (one compilation instead of one per function)."""

    def one(name, args):
        jf = getattr(js, name)
        argnums = tuple(range(len(args)))
        return jf(*args), jax.vmap(jax.grad(jf, argnums))(*args), jax.vmap(jax.hessian(jf, argnums))(*args)

    inputs = {n: [jnp.asarray(a, dtype=jnp.float64) for a in args] for n, args in CASES.items()}
    return jax.jit(lambda d: {n: one(n, a) for n, a in d.items()})(inputs)


@pytest.mark.parametrize("name", list(CASES))
def test_value_grad_hessian(name, jax_reference):
    """All points of one function at once (every function here is
    elementwise): values, the derivative in each argument, and the Hessian."""
    args = CASES[name]
    want, want_g, want_h = jax_reference[name]

    ta = [torch.tensor(a, dtype=torch.float64, requires_grad=True) for a in args]
    got = getattr(ts, name)(*ta)
    assert got.dtype == torch.float64 and got.shape == ta[0].shape
    close(got.detach(), want, name)
    grads = torch.autograd.grad(got.sum(), ta, create_graph=True)
    for i, (g, w) in enumerate(zip(grads, want_g)):
        close(g.detach(), w, f"{name} d/d{i}")
    for i, g in enumerate(grads):
        row = torch.autograd.grad(g.sum(), ta, allow_unused=True, retain_graph=True) if g.requires_grad else [None] * len(ta)
        for j, h in enumerate(row):
            h = torch.zeros_like(ta[0]) if h is None else h
            close(h.detach(), want_h[i][j], f"{name} d2/d{i}d{j}", rtol=RTOL_HESSIAN)


@pytest.mark.parametrize("name,args", [(n, a) for n, pts in VALUE_ONLY.items() for a in pts])
def test_values_without_derivatives(name, args):
    want = np.asarray(getattr(js, name)(*[jnp.asarray(a) for a in args]))
    got = getattr(ts, name)(*[torch.tensor(a, dtype=torch.float64) for a in args])
    np.testing.assert_array_equal(np.asarray(got, dtype=np.float64), want.astype(np.float64))


def test_log_sum_exp_reduction_and_log_i1():
    x = np.random.default_rng(0).normal(size=(3, 7)) * 10
    close(ts.log_sum_exp(torch.tensor(x)), js.log_sum_exp(jnp.asarray(x)), "log_sum_exp")
    close(ts.log_sum_exp(torch.tensor(x), axis=-1), js.log_sum_exp(jnp.asarray(x), axis=-1), "log_sum_exp")
    z = np.array([0.1, 1.0, 5.0, 20.0, 100.0])
    from math_tpu.special import basic as jb
    close(tb.log_i1(torch.tensor(z)), jb.log_i1(jnp.asarray(z)), "log_i1")


@pytest.mark.parametrize("p,x", [(3, 4.5), (3, 2.2), (1, 0.7), (4, 3.1)])
def test_lmgamma(p, x):
    """``lmgamma(p, x)``: value, derivative and second derivative in ``x``."""
    jf = lambda u: js.lmgamma(p, u)  # noqa: E731
    t = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    got = ts.lmgamma(p, t)
    close(got.detach(), jf(x), "lmgamma")
    (g,) = torch.autograd.grad(got, t, create_graph=True)
    close(g.detach(), jax.grad(jf)(x), "lmgamma")
    (h,) = torch.autograd.grad(g, t)
    close(h, jax.hessian(jf)(x), "lmgamma d2/d0d0", rtol=RTOL_HESSIAN)


def test_constants_and_names():
    for c in CONSTANTS:
        assert getattr(ts, c) == getattr(js, c), c
    exported = {n for n in dir(js) if not n.startswith("_") and callable(getattr(js, n))} - NOT_PORTED - FROM_OTHER_MODULES
    missing = sorted(n for n in exported if not hasattr(ts, n) and n not in ("basic", "bessel", "hyper", "incbeta", "owens_t"))
    assert not missing, missing
    covered = set(UNARY) | set(MULTI) | set(VALUE_ONLY) | {"lmgamma"}
    assert sorted(n for n in exported if n not in covered and n not in ("basic", "bessel", "hyper", "incbeta", "owens_t")) == []


def test_reference_points():
    """The checks of ``tests/test_special.py`` on the port."""
    x = torch.tensor([-1e-8, -0.1, -0.5, -0.6931, -1.0, -10.0, -50.0], dtype=torch.float64)
    np.testing.assert_allclose(ts.log1m_exp(x).numpy(), np.log(-np.expm1(x.numpy())), rtol=1e-12, atol=1e-15)
    assert torch.isnan(ts.log1m_exp(torch.tensor(0.5, dtype=torch.float64)))
    assert float(ts.multiply_log(0.0, 0.0)) == 0.0
    p = torch.tensor([0.01, 0.3, 0.5, 0.975], dtype=torch.float64)
    np.testing.assert_allclose(ts.Phi(ts.inv_Phi(p)).numpy(), p.numpy(), rtol=1e-12)
    np.testing.assert_allclose(float(ts.lchoose(10.0, 3.0)), np.log(120.0), rtol=1e-12)


def test_float32_and_python_numbers():
    """Python numbers become float64, a float32 tensor keeps float32 (like
    JAX's weak types); ``lmgamma`` below its domain gives the reference's
    number where ``torch.special.multigammaln`` would raise."""
    assert ts.lbeta(2.0, 3.0).dtype == torch.float64
    assert ts.lbeta(torch.tensor(2.0), 3.0).dtype == torch.float32
    close(ts.lmgamma(3, torch.tensor(0.2, dtype=torch.float64)), js.lmgamma(3, 0.2), "lmgamma")
