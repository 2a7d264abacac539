"""PyTorch port: ``transforms`` against ``math_tpu.transforms`` (CPU, float64).

For every name ``math_tpu.transforms`` exports, the same seeded inputs go
through both packages:

- ``constrain``, ``constrain_lp`` and ``free`` with ``batch_ndims=0`` on one
  chain's block (the JAX function's own call) and with ``batch_ndims=1`` on
  ``C`` chains at once (against ``jax.vmap`` of the JAX function: one
  log-Jacobian a chain), with the gradients of a random projection of the
  value and of the log-Jacobian; tolerance ``1e-12`` relative (float64), an
  absolute floor of ``1e-12``;
- round trips ``free(constrain(x)) == x``;
- saturated ``tanh`` (trouble spot of the matrix transforms): the value, the
  log-Jacobian (``-inf`` or NaN where JAX gives them) and finite gradients
  where JAX's are finite, in float64 and float32;
- every class's ``unconstrained_shape`` and ``constrain_lp`` against the JAX
  class, and the position layout: the port's ``free`` of the JAX package's
  constrained values is the JAX package's unconstrained vector.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import math_tpu.transforms as jt
import math_tpu_torch.transforms as tt
from math_tpu.model import make_log_density as j_make
from math_tpu_torch.model import make_log_density as t_make
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)

RTOL, ATOL = 1e-12, 1e-12
C = 3
RNG = np.random.default_rng(9)

# name -> (constrain, constrain_lp, free, static args, free dimension)
SPECS = {
    "identity": ("identity_constrain", None, "identity_free", (), 3),
    "lb": ("lb_constrain", "lb_constrain_lp", "lb_free", (1.5,), 3),
    "ub": ("ub_constrain", "ub_constrain_lp", "ub_free", (2.5,), 3),
    "lub": ("lub_constrain", "lub_constrain_lp", "lub_free", (-2.0, 5.0), 3),
    "offset_multiplier": ("offset_multiplier_constrain", "offset_multiplier_constrain_lp", "offset_multiplier_free",
                          (3.0, 2.0), 3),
    "positive": ("positive_constrain", "positive_constrain_lp", "positive_free", (), 3),
    "prob": ("prob_constrain", "prob_constrain_lp", "prob_free", (), 3),
    "corr": ("corr_constrain", "corr_constrain_lp", "corr_free", (), 3),
    "ordered": ("ordered_constrain", "ordered_constrain_lp", "ordered_free", (), 4),
    "positive_ordered": ("positive_ordered_constrain", "positive_ordered_constrain_lp", "positive_ordered_free", (), 4),
    "simplex": ("simplex_constrain", "simplex_constrain_lp", "simplex_free", (), 4),
    "unit_vector": ("unit_vector_constrain", "unit_vector_constrain_lp", "unit_vector_free", (), 4),
    "cholesky_corr": ("cholesky_corr_constrain", "cholesky_corr_constrain_lp", "cholesky_corr_free", (4,), 6),
    "corr_matrix": ("corr_matrix_constrain", "corr_matrix_constrain_lp", "corr_matrix_free", (4,), 6),
    "cov_matrix": ("cov_matrix_constrain", "cov_matrix_constrain_lp", "cov_matrix_free", (3,), 6),
    "cov_matrix_lkj": ("cov_matrix_constrain_lkj", "cov_matrix_constrain_lkj_lp", "cov_matrix_free_lkj", (3,), 6),
    "cholesky_factor": ("cholesky_factor_constrain", "cholesky_factor_constrain_lp", "cholesky_factor_free", (4, 3), 9),
}
OTHER_EXPORTS = {"read_corr_L", "read_corr_matrix", "read_cov_L", "read_cov_matrix", "factor_U", "factor_cov_matrix",
                 "make_nu"}
CLASSES = ("Transform", "Identity", "LowerBound", "UpperBound", "Bounded", "OffsetMultiplier", "Ordered",
           "PositiveOrdered", "Simplex", "UnitVector", "CholeskyCorr", "CholeskyCov", "CorrMatrix", "CovMatrix")


def close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64), rtol=rtol, atol=atol,
                               err_msg=what)


def t64(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float64, requires_grad=grad)


def free_args(name):
    """``free``'s static args: the constrain args, except that the
    offset/multiplier and bounds are the same and the matrix sizes too."""
    return SPECS[name][3]


def test_every_export_is_ported_and_covered():
    exported = {n for n in dir(jt) if not n.startswith("_") and n not in ("api", "matrix", "scalar", "vector")}
    assert sorted(n for n in exported if not hasattr(tt, n)) == []
    covered = {f for spec in SPECS.values() for f in spec[:3] if f} | OTHER_EXPORTS | set(CLASSES)
    assert sorted(exported - covered) == []


def grad(out, x, retain=False):
    """d out / d x; zeros where ``out`` does not depend on ``x``."""
    if not out.requires_grad:
        return torch.zeros_like(x)
    return torch.autograd.grad(out, x, retain_graph=retain, allow_unused=True, materialize_grads=True)[0]


def jax_side(name, x, w):
    """Everything the JAX package gives for one spec, from one compiled
    function: one chain's constrain / constrain_lp / gradients, the same under
    ``jax.vmap`` over the chains, and ``free`` of the constrained values."""
    c_name, lp_name, free_name, args, _ = SPECS[name]
    con = lambda u: getattr(jt, c_name)(u, *args)  # noqa: E731
    free = lambda v: getattr(jt, free_name)(v, *free_args(name))  # noqa: E731

    def run(x, w):
        out = {"y": jax.vmap(con)(x)}
        out["free"] = jax.vmap(free)(out["y"])
        if lp_name:
            jf = lambda u: getattr(jt, lp_name)(u, *args)  # noqa: E731
            out["y_lp"], out["lp"] = jax.vmap(jf)(x)
            out["g_val"] = jax.vmap(jax.grad(lambda u, ww: jnp.sum(jf(u)[0] * ww)))(x, w)
            out["g_lp"] = jax.vmap(jax.grad(lambda u: jf(u)[1]))(x)
        return out

    return {k: np.asarray(v) for k, v in jax.jit(run)(jnp.asarray(x), jnp.asarray(w)).items()}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_constrain_lp_free_against_jax(name):
    c_name, lp_name, free_name, args, n = SPECS[name]
    x = RNG.normal(size=(C, n)) * 0.8
    w = RNG.normal(size=(C,) + np.shape(getattr(jt, c_name)(jnp.asarray(x[0]), *args)))
    want = jax_side(name, x, w)
    # one chain, the JAX function's own call, against the first chain of
    # the vmapped one (the same numbers)
    close(getattr(tt, c_name)(t64(x[0]), *args), want["y"][0], f"{name} constrain")
    close(getattr(tt, c_name)(t64(x), *args), want["y"], f"{name} constrain, leading axis")
    if lp_name:
        xt = t64(x[0], grad=True)
        y_t, lp_t = getattr(tt, lp_name)(xt, *args)
        assert lp_t.ndim == 0
        close(y_t.detach(), want["y_lp"][0], f"{name} constrain_lp value")
        close(lp_t.detach(), want["lp"][0], f"{name} log-Jacobian")
        close(grad((y_t * t64(w[0])).sum(), xt, True), want["g_val"][0], f"{name} d value")
        close(grad(lp_t, xt), want["g_lp"][0], f"{name} d log-Jacobian")
        # batch_ndims=1: C chains at once, one log-Jacobian a chain
        xt = t64(x, grad=True)
        y_t, lp_t = getattr(tt, lp_name)(xt, *args, batch_ndims=1)
        assert lp_t.shape == (C,)
        close(y_t.detach(), want["y_lp"], f"{name} batched value")
        close(lp_t.detach(), want["lp"], f"{name} batched log-Jacobian")
        close(grad((y_t * t64(w)).sum(), xt, True), want["g_val"], f"{name} batched d value")
        close(grad(lp_t.sum(), xt), want["g_lp"], f"{name} batched d log-Jacobian")
    # free, on the JAX package's constrained values (one chain and all chains)
    close(getattr(tt, free_name)(t64(want["y"][0]), *free_args(name)), want["free"][0], f"{name} free")
    close(getattr(tt, free_name)(t64(want["y"]), *free_args(name)), want["free"], f"{name} batched free")
    if name != "unit_vector":  # any point on the ray maps to the same unit vector
        close(getattr(tt, free_name)(getattr(tt, c_name)(t64(x), *args), *free_args(name)), x, f"{name} round trip",
              rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("dtype,big", [(np.float64, 20.0), (np.float32, 10.0)])
@pytest.mark.parametrize("name", ["cholesky_corr", "corr_matrix", "cov_matrix_lkj", "corr"])
def test_saturated_tanh(name, dtype, big):
    """|x| where tanh is exactly +-1 in the dtype: ``1 - z^2`` is 0, so
    ``_excl_cumprod`` has a zero factor.  The port gives JAX's value and
    log-Jacobian (``-inf`` / NaN included) and a finite gradient wherever
    JAX's is finite."""
    c_name, lp_name, _, args, n = SPECS[name]
    x = (RNG.normal(size=n) * 0.5).astype(dtype)
    x[0], x[-1] = big, -big
    jf = lambda u: getattr(jt, lp_name)(u, *args)  # noqa: E731
    y_j, lp_j, g_j = jax.jit(lambda u: (*jf(u), jax.grad(lambda v: jf(v)[1] + jnp.sum(jf(v)[0]))(u)))(jnp.asarray(x))
    g_j = np.asarray(g_j)
    xt = torch.tensor(x, requires_grad=True)
    y_t, lp_t = getattr(tt, lp_name)(xt, *args)
    g_t = grad(lp_t + y_t.sum(), xt)
    tol = 1e-12 if dtype == np.float64 else 2e-6
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), rtol=tol, atol=tol)
    np.testing.assert_allclose(float(lp_t.detach()), float(lp_j), rtol=tol, atol=tol)  # -inf against -inf, NaN against NaN
    fin = np.isfinite(g_j)
    assert np.isfinite(g_t.numpy()[fin]).all(), (g_t, g_j)
    np.testing.assert_allclose(g_t.numpy()[fin], g_j[fin], rtol=max(tol, 1e-10), atol=max(tol, 1e-10))


def test_read_and_factor_functions():
    k = 4
    cpcs = np.tanh(RNG.normal(size=(C, k * (k - 1) // 2)))
    sds = np.exp(RNG.normal(size=(C, k)) * 0.3)
    close(tt.read_corr_L(t64(cpcs), k), jax.vmap(lambda c: jt.read_corr_L(c, k))(cpcs), "read_corr_L")
    close(tt.read_corr_matrix(t64(cpcs), k), jax.vmap(lambda c: jt.read_corr_matrix(c, k))(cpcs), "read_corr_matrix")
    close(tt.read_cov_L(t64(cpcs), t64(sds)), jax.vmap(jt.read_cov_L)(cpcs, sds), "read_cov_L")
    y = np.asarray(jax.vmap(jt.read_cov_matrix)(cpcs, sds))
    close(tt.read_cov_matrix(t64(cpcs), t64(sds)), y, "read_cov_matrix")
    got_c, got_s = tt.factor_cov_matrix(t64(y))
    want_c, want_s = jax.vmap(jt.factor_cov_matrix)(jnp.asarray(y))
    close(got_c, want_c, "factor_cov_matrix cpcs", rtol=1e-10, atol=1e-10)
    close(got_s, want_s, "factor_cov_matrix log sds")
    U = np.swapaxes(np.asarray(jax.vmap(lambda c: jt.read_corr_L(c, k))(cpcs)), -1, -2)
    close(tt.factor_U(t64(U), k), jax.vmap(lambda u: jt.factor_U(u, k))(U), "factor_U", rtol=1e-10, atol=1e-10)
    for eta in (1.5, np.array(2.0)):
        close(tt.make_nu(eta, 5), jt.make_nu(eta, 5), "make_nu")
    assert tt.make_nu(torch.tensor(1.5, dtype=torch.float32), 4).dtype == torch.float32


def test_not_positive_definite_free_gives_nan_per_chain():
    """``corr_matrix_free`` / ``cov_matrix_free`` factor through the blocked
    path: a matrix that is not positive definite gives NaN in its own
    chain's vector and no exception."""
    y = np.stack([np.eye(3), np.array([[1.0, 2.0, 0.0], [2.0, 1.0, 0.0], [0.0, 0.0, 1.0]]), np.eye(3)])
    for f in (tt.cov_matrix_free, tt.corr_matrix_free):
        got = f(t64(y), 3).numpy()
        assert np.isfinite(got[[0, 2]]).all() and np.isnan(got[1]).any()


SHAPES = {
    "Identity": (jt.Identity((2, 3)), tt.Identity((2, 3))),
    "LowerBound": (jt.LowerBound((3,), 1.5), tt.LowerBound((3,), 1.5)),
    "UpperBound": (jt.UpperBound((3,), 2.5), tt.UpperBound((3,), 2.5)),
    "Bounded": (jt.Bounded((3,), -1.0, 3.0), tt.Bounded((3,), -1.0, 3.0)),
    "OffsetMultiplier": (jt.OffsetMultiplier((3,), 3.0, 2.0), tt.OffsetMultiplier((3,), 3.0, 2.0)),
    "Ordered": (jt.Ordered((4,)), tt.Ordered((4,))),
    "PositiveOrdered": (jt.PositiveOrdered((4,)), tt.PositiveOrdered((4,))),
    "Simplex": (jt.Simplex((5,)), tt.Simplex((5,))),
    "UnitVector": (jt.UnitVector((4,)), tt.UnitVector((4,))),
    "CholeskyCorr": (jt.CholeskyCorr((4, 4)), tt.CholeskyCorr((4, 4))),
    "CorrMatrix": (jt.CorrMatrix((4, 4)), tt.CorrMatrix((4, 4))),
    "CovMatrix": (jt.CovMatrix((3, 3)), tt.CovMatrix((3, 3))),
    "CholeskyCov": (jt.CholeskyCov((4, 3)), tt.CholeskyCov((4, 3))),
}


@pytest.mark.parametrize("cls", sorted(SHAPES))
def test_class_shapes_and_constrain_lp(cls):
    jtr, ttr = SHAPES[cls]
    assert tuple(ttr.unconstrained_shape) == tuple(jtr.unconstrained_shape) and ttr.shape == jtr.shape
    x = RNG.normal(size=(C,) + tuple(jtr.unconstrained_shape))
    y_j, lp_j = jax.jit(jax.vmap(jtr.constrain_lp))(jnp.asarray(x))
    y_t, lp_t = ttr.constrain_lp(t64(x), batch_ndims=1)
    close(y_t, y_j, f"{cls} value")
    close(lp_t, lp_j, f"{cls} log-Jacobian")
    close(ttr.constrain(t64(x)), y_j, f"{cls} constrain")
    if cls != "UnitVector":
        close(ttr.free(y_t), x, f"{cls} round trip", rtol=1e-10, atol=1e-10)


def test_position_layout():
    """State carried across: for the same constrained values, a position of
    the JAX package and one of the port are the same numbers (the packing
    order of ``make_log_density``, row-major strict lower triangle for
    cholesky_corr, column-major C-vine CPCs for corr_matrix, row-major tril
    for cov_matrix, the trapezoid order of cholesky_factor)."""
    names = ("omega_l", "omega", "sigma", "theta", "L", "p", "u")
    blocks = (SHAPES["CholeskyCorr"], SHAPES["CorrMatrix"], SHAPES["CovMatrix"], SHAPES["Simplex"], SHAPES["CholeskyCov"],
              SHAPES["Bounded"], SHAPES["UnitVector"])
    jm = j_make({n: b[0] for n, b in zip(names, blocks)}, lambda v: 0.0)
    tm = t_make({n: b[1] for n, b in zip(names, blocks)}, lambda v: torch.zeros(()))
    assert jm.dim == tm.dim
    theta = RNG.normal(size=jm.dim)
    theta[-4:] /= np.linalg.norm(theta[-4:])  # a unit vector is its own free value
    values = {k: np.asarray(v) for k, v in jm.constrain(jnp.asarray(theta)).items()}
    close(tm.ravel_constrained(values), jm.ravel_constrained(values), "ravel_constrained")
    close(tm.ravel_constrained(values), theta, "positions", rtol=1e-10, atol=1e-10)
    got = tm.constrain(t64(theta[None]))
    for k in names:
        close(got[k][0], values[k], f"constrain {k}")
