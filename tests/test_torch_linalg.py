"""PyTorch port: ``ops/linalg.py`` against ``math_tpu.ops.linalg`` (CPU, float64).

Every function of the JAX module is called by both packages on the same
seeded inputs (the matrices of ``tests/test_ops.py`` and a batch of chains
where the function broadcasts); values agree to ``1e-10`` relative with an
absolute floor of ``1e-10`` (the port factors through the blocked path and
its explicit block inverses, LAPACK does not), gradients of the differentiable
ones likewise.  Eigenvectors and QR factors are compared up to the sign of
each column.  A matrix that is not positive definite gives NaN in its own
chain, never an exception.
"""

import numpy as np
import pytest
import scipy.linalg

import jax
import jax.numpy as jnp
import torch

from math_tpu.ops import linalg as jl
from math_tpu_torch.ops import linalg as tl
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)

RTOL, ATOL = 1e-10, 1e-10
RNG = np.random.default_rng(0)
A = RNG.normal(size=(5, 5))
SPD = A @ A.T + 5 * np.eye(5)
B = RNG.normal(size=(5, 3))
V = RNG.normal(size=5)
SPD_C = np.stack([SPD, SPD + np.eye(5), 2 * SPD])
LOW = np.tril(A + 5 * np.eye(5))
D = RNG.normal(size=(3, 3))


def close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64), rtol=rtol, atol=atol,
                               err_msg=what)


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


# name -> positional args (numpy); the same on both sides
CASES = {
    "cholesky_decompose": [(SPD,), (SPD_C,)],
    "mdivide_left": [(SPD, B), (SPD, V)],
    "mdivide_right": [(B.T, SPD)],
    "mdivide_left_tri_low": [(LOW, B), (LOW, V)],
    "mdivide_right_tri_low": [(B.T, LOW)],
    "mdivide_left_spd": [(SPD, B), (SPD, V), (SPD_C, np.stack([B] * 3))],
    "log_determinant": [(A,), (SPD_C,)],
    "log_determinant_spd": [(SPD,), (SPD_C,)],
    "masked_diagonal": [(A,)],
    "determinant": [(A,)],
    "inverse": [(A,)],
    "inverse_spd": [(SPD,)],
    "quad_form": [(SPD, B), (SPD, V)],
    "quad_form_sym": [(SPD, B), (SPD, V)],
    "quad_form_diag": [(SPD, np.arange(1.0, 6.0)), (SPD_C, RNG.normal(size=(3, 5)))],
    "trace_quad_form": [(SPD, B)],
    "trace_gen_quad_form": [(D, SPD, B)],
    "multiply_lower_tri_self_transpose": [(A,), (SPD_C,)],
    "tcrossprod": [(B,)],
    "crossprod": [(B,)],
    "matrix_exp": [(A * 0.3,)],
    "matrix_exp_2x2": [(A[:2, :2],), (np.array([[0.3, 2.0], [-1.5, 0.1]]),), (np.array([[1.0, 1e-12], [0.0, 1.0]]),)],
    "matrix_power": [(A, 3)],
    "eigenvalues_sym": [(SPD,)],
    "singular_values": [(B,)],
    "dot_self": [(V,), (B,)],
    "columns_dot_self": [(B,)],
    "rows_dot_self": [(B,)],
    "distance": [(V, V[::-1].copy())],
    "squared_distance": [(V, V[::-1].copy())],
    "mdivide_left_tri": [(LOW, B), (LOW,), (LOW.T, B, False)],
    "mdivide_right_tri": [(B.T, LOW), (B.T, LOW.T, False)],
    "mdivide_right_spd": [(B.T, SPD)],
    "chol2inv": [(np.linalg.cholesky(SPD),)],
    "cumulative_sum": [(V,)],
    "autocorrelation": [(RNG.normal(size=50),), (RNG.normal(size=(2, 33)),)],
    "autocovariance": [(RNG.normal(size=50),)],
    "sort_indices_asc": [(np.array([3.0, 1.0, 2.0, 1.0]),)],
    "sort_indices_desc": [(np.array([3.0, 1.0, 2.0, 1.0]),)],
    "rank": [(np.array([3.0, 1.0, 2.0, 1.0]), 1)],
    "softmax": [(V,), (B,)],
    "log_softmax": [(V,), (B,)],
    "csr_extract_w": [(B,)],
    "csr_extract_v": [(B,)],
    "csr_extract_u": [(B,)],
}
SIGNED_COLUMNS = {"eigenvectors_sym": [(SPD,)], "qr_Q": [(B,)], "qr_thin_Q": [(B,)]}
SIGNED_ROWS = {"qr_R": [(B,)], "qr_thin_R": [(B,)]}
LDLT = ("mdivide_left_ldlt", "log_determinant_ldlt", "trace_inv_quad_form_ldlt", "mdivide_right_ldlt",
        "trace_gen_inv_quad_form_ldlt", "ldlt_factor")
ACTION = ("scale_matrix_exp_multiply", "matrix_exp_multiply")
CSR = ("csr_matrix_times_vector", "csr_to_dense_matrix", "csr_u_to_z")


def torch_args(args):
    return [t(a) if isinstance(a, np.ndarray) else a for a in args]


def test_every_function_is_ported_and_covered():
    names = {n for n, v in vars(jl).items() if callable(v) and not n.startswith("_") and getattr(v, "__module__", "") == jl.__name__}
    assert sorted(n for n in names if not hasattr(tl, n)) == []
    covered = set(CASES) | set(SIGNED_COLUMNS) | set(SIGNED_ROWS) | set(LDLT) | set(ACTION) | set(CSR)
    assert sorted(names - covered) == []


@pytest.mark.parametrize("name,args", [(n, a) for n, cases in CASES.items() for a in cases],
                         ids=lambda v: v if isinstance(v, str) else "")
def test_values_against_jax(name, args):
    want = getattr(jl, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args])
    got = getattr(tl, name)(*torch_args(args))
    assert tuple(got.shape) == tuple(np.shape(want)), name
    close(got, want, name)


@pytest.mark.parametrize("name,args", [(n, a) for table in (SIGNED_COLUMNS, SIGNED_ROWS) for n, cases in table.items() for a in cases])
def test_factors_up_to_sign(name, args):
    want = np.asarray(getattr(jl, name)(*map(jnp.asarray, args)))
    got = getattr(tl, name)(*torch_args(args)).numpy()
    if name in SIGNED_COLUMNS:
        sign = np.sign(got[:1, :] * want[:1, :])
    else:
        sign = np.sign(np.diagonal(got) * np.diagonal(want))[:, None]
    close(got * sign, want, name)


def test_ldlt_family():
    ldlt_j, ldlt_t = jl.ldlt_factor(jnp.asarray(SPD)), tl.ldlt_factor(t(SPD))
    close(ldlt_t[0], ldlt_j[0], "ldlt_factor")
    close(tl.mdivide_left_ldlt(ldlt_t, t(B)), jl.mdivide_left_ldlt(ldlt_j, B), "mdivide_left_ldlt")
    close(tl.log_determinant_ldlt(ldlt_t), jl.log_determinant_ldlt(ldlt_j), "log_determinant_ldlt")
    close(tl.trace_inv_quad_form_ldlt(ldlt_t, t(B)), jl.trace_inv_quad_form_ldlt(ldlt_j, B), "trace_inv_quad_form_ldlt")
    close(tl.mdivide_right_ldlt(t(B.T), ldlt_t), jl.mdivide_right_ldlt(B.T, ldlt_j), "mdivide_right_ldlt")
    close(tl.trace_gen_inv_quad_form_ldlt(t(D), ldlt_t, t(B)), jl.trace_gen_inv_quad_form_ldlt(D, ldlt_j, B),
          "trace_gen_inv_quad_form_ldlt")


@pytest.mark.parametrize("scale", [0.1, 1.0, 8.0, 40.0])
def test_matrix_exp_action(scale):
    """The action algorithm against the JAX package and dense expm (the
    points of ``tests/test_ops.py``: 40 needs ~9 substeps)."""
    got = tl.matrix_exp_multiply(t(scale * A), t(B))
    close(got, jl.matrix_exp_multiply(jnp.asarray(scale * A), jnp.asarray(B)), "matrix_exp_multiply", rtol=1e-9, atol=1e-9)
    close(got, scipy.linalg.expm(scale * A) @ B, "against expm", rtol=1e-8, atol=1e-8)
    close(tl.scale_matrix_exp_multiply(2.5, t(A), t(B)), jl.scale_matrix_exp_multiply(2.5, jnp.asarray(A), jnp.asarray(B)),
          "scale_matrix_exp_multiply", rtol=1e-9, atol=1e-9)
    assert torch.isnan(tl.matrix_exp_multiply(t(A * np.inf), t(B))).all()


def test_csr():
    dense = np.array([[1.0, 0.0, 2.0], [0.0, 0.0, 3.0], [4.0, 5.0, 0.0]])
    w, v, u = np.array([1.0, 2.0, 3.0, 4.0, 5.0]), np.array([1, 3, 3, 1, 2]), np.array([1, 3, 4, 6])
    b = RNG.normal(size=3)
    close(tl.csr_matrix_times_vector(3, 3, t(w), v, u, t(b)), jl.csr_matrix_times_vector(3, 3, w, v, u, b), "csr times vector")
    close(tl.csr_to_dense_matrix(3, 3, t(w), v, u), dense, "csr to dense")
    assert int(tl.csr_u_to_z(u, 2)) == int(jl.csr_u_to_z(u, 2)) == 1


@pytest.mark.parametrize("name", ["log_determinant_spd", "inverse_spd", "mdivide_left_spd", "cholesky_decompose", "quad_form_sym"])
def test_gradients_through_a_symmetric_construction(name):
    """Gradients with respect to ``M`` of ``f(M M^T + 5 I)``: the symmetric
    construction, where the blocked factorization's cotangent and the
    symmetrized one of ``jnp.linalg.cholesky`` must agree."""
    w = RNG.normal(size=(5, 5))
    extra = {"mdivide_left_spd": (B,), "quad_form_sym": (B,)}.get(name, ())

    def jf(m):
        out = getattr(jl, name)(m @ m.T + 5 * jnp.eye(5), *extra)
        return jnp.sum(out * (w[: out.shape[0], : out.shape[-1]] if out.ndim == 2 else 1.0))

    want = jax.grad(jf)(jnp.asarray(A))
    m = t(A).requires_grad_(True)
    out = getattr(tl, name)(m @ m.T + 5 * torch.eye(5, dtype=torch.float64), *torch_args(extra))
    val = (out * (t(w)[: out.shape[0], : out.shape[-1]] if out.ndim == 2 else 1.0)).sum()
    close(val.detach(), jf(jnp.asarray(A)), f"{name} value")
    close(torch.autograd.grad(val, m)[0], want, f"{name} gradient")


def test_not_positive_definite_is_nan_in_its_own_chain():
    """NaN, not an exception, and only in the chain whose matrix is not
    positive definite (``torch.linalg.cholesky`` would raise)."""
    bad = SPD_C.copy()
    bad[1] = -np.eye(5)
    close(tl.inverse_spd(t(SPD_C)), np.linalg.inv(SPD_C), "batched inverse_spd")
    for name in ("cholesky_decompose", "log_determinant_spd", "inverse_spd"):
        got = getattr(tl, name)(t(bad)).numpy()
        assert np.isnan(got[1]).any() and np.isfinite(got[[0, 2]]).all(), name
    got = tl.mdivide_left_spd(t(bad), t(np.stack([B] * 3))).numpy()
    assert np.isnan(got[1]).all() and np.isfinite(got[[0, 2]]).all()
