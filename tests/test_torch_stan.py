"""PyTorch port: the flat Stan-name surface (``math_tpu_torch.stan``) and the
numeric checks of its long-tail functions (CPU, float64).

The twins of ``tests/test_stan_surface.py`` (the same inventory of the
reference's ``prim/{scal,arr,mat}/fun`` and ``prim/*/err`` files: every name
resolves in the port or stands in ``NOT_APPLICABLE``, which has the JAX
package's names) and of ``tests/test_stan_extras.py`` (the same inputs
through both packages, ``rtol=1e-10``, the closed forms at the reference
tests' tolerances).  Factories run with ``device="cpu"`` (the card by
default).
"""

import numpy as np
import pytest
import scipy.linalg as sla

import jax.numpy as jnp
import torch

import math_tpu.stan as jstan
import math_tpu_torch.stan as stan
from math_tpu import transforms as jtransforms
from math_tpu.ops import linalg as jlinalg
from math_tpu_torch import transforms
from math_tpu_torch.ops import chol_blocked as tcb
from math_tpu_torch.ops import linalg
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)

SCAL_FUN = [
    "F32", "Phi", "Phi_approx", "abs", "acosh", "as_bool", "asinh",
    "atanh", "bessel_first_kind", "bessel_second_kind", "beta",
    "binary_log_loss", "binomial_coefficient_log", "boost_policy", "cbrt",
    "choose", "common_type", "constants", "corr_constrain", "corr_free",
    "digamma", "distance", "divide", "erf", "erfc", "exp", "exp2",
    "expm1", "falling_factorial", "fdim", "fill", "finite_diff_stepsize",
    "fma", "fmax", "fmin", "gamma_p", "gamma_q", "grad_2F1", "grad_F32",
    "grad_inc_beta", "grad_reg_inc_beta", "grad_reg_inc_gamma",
    "grad_reg_lower_inc_gamma", "hypot", "ibeta", "identity_constrain",
    "identity_free", "if_else", "inc_beta", "inc_beta_dda",
    "inc_beta_ddb", "inc_beta_ddz", "int_step", "inv", "inv_Phi",
    "inv_cloglog", "inv_logit", "inv_sqrt", "inv_square", "is_any_nan",
    "is_inf", "is_integer", "is_nan", "is_nonpositive_integer",
    "is_uninitialized", "lb_constrain", "lb_free", "lbeta", "ldexp",
    "lgamma", "lmgamma", "log", "log1m", "log1m_exp", "log1m_inv_logit",
    "log1p", "log1p_exp", "log2", "log_diff_exp", "log_falling_factorial",
    "log_inv_logit", "log_inv_logit_diff", "log_mix",
    "log_modified_bessel_first_kind", "log_rising_factorial",
    "log_sum_exp", "logical_and", "logical_eq", "logical_gt",
    "logical_gte", "logical_lt", "logical_lte", "logical_negation",
    "logical_neq", "logical_or", "logit", "lub_constrain", "lub_free",
    "modified_bessel_first_kind", "modified_bessel_second_kind",
    "modulus", "multiply_log", "offset_multiplier_constrain",
    "offset_multiplier_free", "owens_t", "positive_constrain",
    "positive_free", "primitive_value", "prob_constrain", "prob_free",
    "promote_elements", "promote_scalar", "promote_scalar_type",
    "rising_factorial", "round", "sign", "size_zero", "sqrt", "square",
    "squared_distance", "step", "sum", "tgamma", "trigamma", "trunc",
    "ub_constrain", "ub_free", "value_of", "value_of_rec",
]
ARR_FUN = [
    "array_builder", "common_type", "dot", "dot_self", "fill",
    "inverse_softmax", "log_sum_exp", "promote_elements",
    "promote_scalar", "promote_scalar_type", "rep_array", "scaled_add",
    "sort_asc", "sort_desc", "sum", "value_of", "value_of_rec",
    "vec_concat",
]
MAT_FUN = [
    "Eigen", "LDLT_factor", "MatrixExponential.h", "Phi", "Phi_approx",
    "accumulator", "acos", "acosh", "add", "add_diag", "append_array",
    "append_col", "append_row", "asin", "asinh", "assign", "atan",
    "atanh", "autocorrelation", "autocovariance", "block", "cbrt", "ceil",
    "chol2inv", "cholesky_corr_constrain", "cholesky_corr_free",
    "cholesky_decompose", "cholesky_factor_constrain",
    "cholesky_factor_free", "col", "cols", "columns_dot_product",
    "columns_dot_self", "common_type", "corr_matrix_constrain",
    "corr_matrix_free", "cos", "cosh", "cov_exp_quad",
    "cov_matrix_constrain", "cov_matrix_constrain_lkj", "cov_matrix_free",
    "cov_matrix_free_lkj", "crossprod", "csr_extract_u", "csr_extract_v",
    "csr_extract_w", "csr_matrix_times_vector", "csr_to_dense_matrix",
    "csr_u_to_z", "cumulative_sum", "determinant", "diag_matrix",
    "diag_post_multiply", "diag_pre_multiply", "diagonal", "digamma",
    "dims", "distance", "divide", "divide_columns", "dot_product",
    "dot_self", "eigenvalues_sym", "eigenvectors_sym", "elt_divide",
    "elt_multiply", "erf", "erfc", "exp", "exp2", "expm1", "fabs",
    "factor_U", "factor_cov_matrix", "fill", "floor", "get_base1",
    "get_base1_lhs", "get_lp", "gp_dot_prod_cov", "gp_exp_quad_cov",
    "gp_exponential_cov", "gp_matern32_cov", "gp_matern52_cov",
    "gp_periodic_cov", "head", "initialize", "inv", "inv_Phi",
    "inv_cloglog", "inv_logit", "inv_sqrt", "inv_square", "inverse",
    "inverse_spd", "lgamma", "log", "log10", "log1m", "log1m_exp",
    "log1m_inv_logit", "log1p", "log1p_exp", "log2", "log_determinant",
    "log_determinant_ldlt", "log_determinant_spd", "log_inv_logit",
    "log_mix", "log_softmax", "log_sum_exp", "logit", "make_nu",
    "matrix_exp", "matrix_exp_2x2", "matrix_exp_action_handler",
    "matrix_exp_multiply", "matrix_exp_pade", "matrix_power", "max",
    "mdivide_left", "mdivide_left_ldlt", "mdivide_left_spd",
    "mdivide_left_tri", "mdivide_left_tri_low", "mdivide_right",
    "mdivide_right_ldlt", "mdivide_right_spd", "mdivide_right_tri",
    "mdivide_right_tri_low", "mean", "min", "minus", "multiply",
    "multiply_lower_tri_self_transpose", "num_elements",
    "ordered_constrain", "ordered_free", "positive_ordered_constrain",
    "positive_ordered_free", "prod", "promote_common", "promote_elements",
    "promote_scalar", "promote_scalar_type", "qr_Q", "qr_R", "qr_thin_Q",
    "qr_thin_R", "quad_form", "quad_form_diag", "quad_form_sym", "rank",
    "read_corr_L", "read_corr_matrix", "read_cov_L", "read_cov_matrix",
    "rep_matrix", "rep_row_vector", "rep_vector", "resize", "round",
    "row", "rows", "rows_dot_product", "rows_dot_self",
    "scale_matrix_exp_multiply", "sd", "segment", "simplex_constrain",
    "simplex_free", "sin", "singular_values", "sinh", "size", "softmax",
    "sort_asc", "sort_desc", "sort_indices", "sort_indices_asc",
    "sort_indices_desc", "sqrt", "square", "squared_distance",
    "stan_print", "sub_col", "sub_row", "subtract", "sum", "tail", "tan",
    "tanh", "tcrossprod", "tgamma", "to_array_1d", "to_array_2d",
    "to_matrix", "to_row_vector", "to_vector", "trace",
    "trace_gen_inv_quad_form_ldlt", "trace_gen_quad_form",
    "trace_inv_quad_form_ldlt", "trace_quad_form", "transpose",
    "trigamma", "trunc", "typedefs", "unit_vector_constrain",
    "unit_vector_free", "value_of", "value_of_rec", "variance",
    "welford_covar_estimator", "welford_var_estimator",
]

RENAMES = {"dot": "dot_product", "Eigen": None, "MatrixExponential.h": None}


def _covered(name):
    if name in stan.NOT_APPLICABLE:
        return True
    name = RENAMES.get(name, name)
    if name is None:
        return name in stan.NOT_APPLICABLE
    return hasattr(stan, name)


@pytest.mark.parametrize("inventory", ["scal", "arr", "mat"])
def test_fun_surface(inventory):
    names = {"scal": SCAL_FUN, "arr": ARR_FUN, "mat": MAT_FUN}[inventory]
    missing = [n for n in names if not _covered(n)]
    assert not missing, f"prim/{inventory}/fun names unmapped: {missing}"


def test_na_list_is_the_reference_list():
    """``NOT_APPLICABLE`` has the JAX package's names, every one in the
    reference inventory, each with a reason."""
    assert set(stan.NOT_APPLICABLE) == set(jstan.NOT_APPLICABLE)
    inv = set(SCAL_FUN) | set(ARR_FUN) | set(MAT_FUN)
    assert not [n for n in stan.NOT_APPLICABLE if n not in inv]
    assert all(isinstance(v, str) and v for v in stan.NOT_APPLICABLE.values())


ERR_FUN = [
    "check_2F1_converges", "check_3F2_converges", "check_bounded",
    "check_cholesky_factor", "check_cholesky_factor_corr",
    "check_column_index", "check_consistent_size",
    "check_consistent_size_mvt", "check_consistent_sizes",
    "check_consistent_sizes_mvt", "check_corr_matrix", "check_cov_matrix",
    "check_finite", "check_flag_sundials", "check_greater",
    "check_greater_or_equal", "check_ldlt_factor", "check_less",
    "check_less_or_equal", "check_lower_triangular",
    "check_matching_dims", "check_matching_sizes", "check_multiplicable",
    "check_nonempty", "check_nonnegative", "check_nonzero_size",
    "check_not_nan", "check_ordered", "check_pos_definite",
    "check_pos_semidefinite", "check_positive", "check_positive_finite",
    "check_positive_ordered", "check_range", "check_row_index",
    "check_simplex", "check_size_match", "check_square",
    "check_std_vector_index", "check_symmetric", "check_unit_vector",
    "check_vector", "constraint_tolerance", "domain_error",
    "domain_error_vec", "invalid_argument", "invalid_argument_vec",
    "is_cholesky_factor", "is_cholesky_factor_corr", "is_column_index",
    "is_corr_matrix", "is_ldlt_factor", "is_less_or_equal",
    "is_lower_triangular", "is_mat_finite", "is_matching_dims",
    "is_matching_size", "is_nonzero_size", "is_not_nan", "is_ordered",
    "is_pos_definite", "is_positive", "is_scal_finite", "is_size_match",
    "is_square", "is_symmetric", "is_unit_vector", "out_of_range",
    "system_error", "validate_non_negative_index",
]


def test_err_surface():
    """Every prim/*/err validator name resolves in math_tpu_torch.utils.checks."""
    from math_tpu_torch.utils import checks

    missing = [n for n in ERR_FUN if not hasattr(checks, n)]
    assert not missing, f"prim err names unmapped: {missing}"


def t64(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def close(got, want, rtol=1e-10, atol=1e-12):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


# --- the twins of tests/test_stan_extras.py ------------------------------------


def test_autocorrelation_matches_definition():
    y = np.random.default_rng(0).normal(size=64)
    ac = linalg.autocorrelation(t64(y))
    yc = y - y.mean()
    n = len(y)
    raw = np.array([np.sum(yc[: n - k] * yc[k:]) / (n - k) for k in range(n)])
    close(ac, raw / raw[0], atol=1e-12)
    close(ac, jlinalg.autocorrelation(y))
    close(linalg.autocovariance(t64(y)), raw / raw[0] * yc.var(), atol=1e-12)


def test_chol2inv_and_mdivide_variants():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(5, 5))
    a = a @ a.T + 5 * np.eye(5)
    L = np.linalg.cholesky(a)
    close(linalg.chol2inv(t64(L)), np.linalg.inv(a), rtol=1e-9, atol=1e-10)
    b = rng.normal(size=(3, 5))
    close(linalg.mdivide_right_spd(t64(b), t64(a)), b @ np.linalg.inv(a), rtol=1e-8)
    u = np.triu(rng.normal(size=(5, 5))) + 5 * np.eye(5)
    close(linalg.mdivide_left_tri(t64(u), t64(b.T), lower=False), np.linalg.solve(u, b.T), rtol=1e-9)
    close(linalg.mdivide_right_tri(t64(b), t64(u), lower=False), b @ np.linalg.inv(u), rtol=1e-8)
    d = rng.normal(size=(3, 3))
    got = linalg.trace_gen_inv_quad_form_ldlt(t64(d), linalg.ldlt_factor(t64(a)), t64(b.T))
    close(got, np.trace(d @ b @ np.linalg.inv(a) @ b.T), rtol=1e-8)
    close(got, jlinalg.trace_gen_inv_quad_form_ldlt(d, jlinalg.ldlt_factor(a), b.T))


def test_matrix_exp_2x2():
    rng = np.random.default_rng(2)
    for a in [rng.normal(size=(2, 2)) for _ in range(5)] + [np.array([[0.0, -2.0], [2.0, 0.0]])]:
        close(linalg.matrix_exp_2x2(t64(a)), sla.expm(a), rtol=1e-9, atol=1e-10)
        close(stan.matrix_exp_pade(t64(a)), sla.expm(a), rtol=1e-9, atol=1e-10)


def test_csr_roundtrip():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(4, 6))
    w, v, u = linalg.csr_extract_w(t64(a)), linalg.csr_extract_v(t64(a)), linalg.csr_extract_u(t64(a))
    close(linalg.csr_to_dense_matrix(4, 6, w, v, u), a, rtol=1e-12)
    assert int(linalg.csr_u_to_z(u, 2)) == 6
    b = rng.normal(size=6)
    close(linalg.csr_matrix_times_vector(4, 6, w, v, u, t64(b)), a @ b)


def test_sort_rank_helpers():
    x = t64([3.0, 1.0, 2.0])
    np.testing.assert_array_equal(np.asarray(linalg.sort_indices_asc(x)), [2, 3, 1])
    np.testing.assert_array_equal(np.asarray(linalg.sort_indices_desc(x)), [1, 3, 2])
    assert int(linalg.rank(x, 1)) == 2  # two elements smaller than 3.0
    close(stan.sort_desc(x), [3.0, 2.0, 1.0], rtol=0)
    close(stan.sort_asc(x), [1.0, 2.0, 3.0], rtol=0)


def test_lkj_cov_transform_roundtrip_and_jacobian():
    k = 4
    x = np.random.default_rng(4).normal(size=k * (k - 1) // 2 + k) * 0.5
    y = transforms.cov_matrix_constrain_lkj(t64(x), k)
    assert np.all(np.linalg.eigvalsh(y.numpy()) > 0)
    close(y, jtransforms.cov_matrix_constrain_lkj(x, k))
    close(transforms.cov_matrix_free_lkj(y, k), x, rtol=1e-8, atol=1e-8)
    _, lp = transforms.cov_matrix_constrain_lkj_lp(t64(x), k)
    iu = np.tril_indices(k)
    J = torch.func.jacfwd(lambda xx: transforms.cov_matrix_constrain_lkj(xx, k)[iu[0], iu[1]])(t64(x))
    close(lp, np.linalg.slogdet(J.numpy())[1], rtol=1e-8)


def test_read_corr_and_factor_roundtrip():
    k = 5
    rng = np.random.default_rng(5)
    cpcs = np.tanh(rng.normal(size=k * (k - 1) // 2) * 0.4)
    L = transforms.read_corr_L(t64(cpcs), k)
    corr = (L @ L.mT).numpy()
    assert np.allclose(np.diag(corr), 1.0)
    close(transforms.read_corr_matrix(t64(cpcs), k), corr)
    close(np.tanh(transforms.factor_U(L.mT, k).numpy()), cpcs, rtol=1e-7, atol=1e-8)
    sds = np.exp(rng.normal(size=k) * 0.3)
    cov = transforms.read_cov_matrix(t64(cpcs), t64(sds))
    close(torch.sqrt(torch.diagonal(cov)), sds, rtol=1e-9)
    cpcs2, logsds2 = transforms.factor_cov_matrix(cov, k)
    close(np.tanh(cpcs2.numpy()), cpcs, rtol=1e-6, atol=1e-8)
    close(logsds2, np.log(sds), rtol=1e-8)


def test_make_nu():
    close(transforms.make_nu(2.0, 4), [6.0, 6.0, 6.0, 5.0, 5.0, 4.0])
    close(transforms.make_nu(2.0, 4), jtransforms.make_nu(2.0, 4))


def test_stan_surface_smoke():
    assert float(stan.fdim(3.0, 1.0)) == 2.0
    assert float(stan.fdim(1.0, 3.0)) == 0.0
    assert int(stan.logical_gte(3, 3)) == 1
    assert float(stan.if_else(True, 1.0, 2.0)) == 1.0
    assert int(stan.modulus(-7, 3)) == -1  # C++ truncation semantics
    assert int(stan.divide(torch.tensor(-7), torch.tensor(2))) == -3
    close(stan.inv_cloglog(0.0), 1 - np.exp(-1))
    x = t64([[1.0, 2.0], [3.0, 4.0]])
    close(stan.to_vector(x), [1, 3, 2, 4])
    close(stan.to_matrix(stan.to_vector(x), 2, 2), x)
    y = t64([[1.0, 4.0], [2.0, 5.0], [3.0, 6.0]])
    close(stan.to_matrix(y, 2, 3), [[1.0, 3.0, 5.0], [2.0, 4.0, 6.0]])
    close(stan.block(x, 1, 2, 2, 1), [[2.0], [4.0]])
    close(stan.diag_pre_multiply([2.0, 3.0], x), [[2, 4], [9, 12]])
    close(stan.diag_post_multiply(x, [2.0, 3.0]), [[2, 6], [6, 12]])
    assert float(stan.variance(np.array([1.0, 2.0, 3.0]))) == 1.0
    close(stan.tgamma(-0.5), -2 * np.sqrt(np.pi))
    close(stan.tgamma(-1.5), float(jstan.tgamma(-1.5)))
    close(stan.tgamma(4.0), 6.0)

    data = np.random.default_rng(6).normal(size=(10, 2))
    w = stan.welford_var_estimator(2, device="cpu")
    wc = stan.welford_covar_estimator(2, device="cpu")
    for r in data:
        w.add_sample(r)
        wc.add_sample(r)
    close(w.sample_mean(), data.mean(0), rtol=1e-9)
    close(w.sample_variance(), data.var(0, ddof=1), rtol=1e-9)
    close(wc.sample_covariance(), np.cov(data.T, ddof=1), rtol=1e-9)
    acc = stan.accumulator(device="cpu")
    assert float(acc.sum()) == 0.0
    acc.add(1.0).add(np.array([2.0, 3.0]))
    assert float(acc.sum()) == 6.0


def test_indexing_is_one_based():
    m = t64(np.arange(12.0).reshape(3, 4))
    v = t64(np.arange(5.0))
    jm, jv = jnp.arange(12.0).reshape(3, 4), jnp.arange(5.0)
    for name, args in [("row", (2,)), ("col", (3,)), ("sub_col", (2, 2, 2)), ("sub_row", (1, 2, 3)),
                       ("block", (2, 1, 2, 3))]:
        close(getattr(stan, name)(m, *args), getattr(jstan, name)(jm, *args), rtol=0)
    for name, args in [("head", (2,)), ("tail", (2,)), ("segment", (2, 3))]:
        close(getattr(stan, name)(v, *args), getattr(jstan, name)(jv, *args), rtol=0)
    assert float(stan.get_base1(m, 2, 3)) == float(jstan.get_base1(jm, 2, 3)) == 6.0


@pytest.mark.parametrize("name,args", [
    ("rep_vector", (2.5, 3)), ("rep_row_vector", (2.5, 3)), ("rep_array", (1.5, 2)),
    ("rep_matrix", (0.5, 2, 3)), ("rep_matrix", (np.array([1.0, 2.0]), 3)),
])
def test_factories_on_the_requested_device(name, args):
    """A factory of Python values makes its tensor on ``device`` (the card
    unless ``device="cpu"``), equal to the JAX package's."""
    got = getattr(stan, name)(*args, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.float64
    close(got, getattr(jstan, name)(*args), rtol=0)


@pytest.mark.parametrize("name,args", [
    ("exp", (0.3,)), ("atan2", (0.3, -1.2)), ("hypot", (3.0, 4.0)), ("cbrt", (-8.0,)), ("fma", (2.0, 3.0, 1.0)),
    ("expm1", (1e-8,)), ("log1p", (1e-8,)), ("logical_lt", (1, 2)), ("logical_negation", (0,)),
    ("dot_product", ([1.0, 2.0], [3.0, 4.0])), ("multiply", ([[1.0, 2.0], [3.0, 4.0]], [1.0, -1.0])),
    ("mean", ([1.0, 2.0, 4.0],)), ("sd", ([1.0, 2.0, 4.0],)), ("finite_diff_stepsize", (3.0,)),
    ("binomial_coefficient_log", (10.0, 3.0)), ("ibeta", (2.0, 3.0, 0.4)), ("is_any_nan", (1.0, np.nan)),
    ("diag_matrix", ([1.0, 2.0],)), ("trace", ([[1.0, 2.0], [3.0, 4.0]],)), ("append_row", ([1.0, 2.0], [3.0, 4.0])),
    ("append_col", ([[1.0], [2.0]], [[3.0], [4.0]])), ("divide_columns", ([[1.0, 2.0], [3.0, 4.0]], [2.0, 4.0])),
    ("columns_dot_product", ([[1.0, 2.0], [3.0, 4.0]], [[1.0, 0.0], [2.0, 1.0]])), ("scaled_add", ([1.0], [2.0], 3.0)),
])
def test_surface_values_equal_the_reference(name, args):
    targs = [t64(a) if isinstance(a, list) else a for a in args]
    want = getattr(jstan, name)(*[jnp.asarray(a) if isinstance(a, list) else a for a in args])
    close(getattr(stan, name)(*targs), want)


def test_names_through_the_block_cholesky():
    """The names whose port reaches the blocked factorization (B4's plain
    version here: CPU tensors) against the JAX package."""
    rng = np.random.default_rng(7)
    a = rng.normal(size=(6, 6))
    a = a @ a.T + 6 * np.eye(6)
    b = rng.normal(size=(6, 2))
    tcb.reset_counts()
    for name, args in [("cholesky_decompose", (a,)), ("inverse_spd", (a,)), ("mdivide_left_spd", (a, b)),
                       ("log_determinant_spd", (a,))]:
        close(getattr(stan, name)(*map(t64, args)), getattr(jstan, name)(*args), rtol=1e-9)
    close(stan.mdivide_left_ldlt(stan.ldlt_factor(t64(a)), t64(b)), jstan.mdivide_left_ldlt(jstan.ldlt_factor(a), b),
          rtol=1e-9)
    assert tcb.PLAIN_CALLS[tcb.KERNEL] >= 5
