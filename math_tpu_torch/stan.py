"""Flat Stan-Math-named function surface over ``prim/{scal,arr,mat}/fun``.

Counterpart: ``math_tpu/stan.py``.  Every public function file in the
reference's three ``fun`` directories resolves here to a callable under its
exact Stan name (re-exported from the port's ``special`` / ``ops`` /
``transforms``, aliased to the torch equivalent, or defined below), or
appears in ``NOT_APPLICABLE`` with the reason it has no runtime analog in a
functional framework.  ``tests/test_torch_stan.py`` walks the full inventory.

Semantics notes (applying throughout):
- Mutating reference signatures (``fill``, ``resize``, output-parameter
  returns) become functional: the result is *returned*.
- Stan's 1-based container indexing is preserved in the indexing helpers
  (``get_base1``, ``block``, ``head``, ...): they take 1-based positions.
- Arguments that are not tensors become tensors as the port's special
  functions make them (``special.basic._f``: float64 on the CPU, or on the
  device of a tensor argument).  A factory that makes a tensor from nothing
  but Python values (``rep_*``, the Welford estimators, an empty
  ``accumulator``'s sum) takes ``device=``: the card unless
  ``device="cpu"`` (or the device of a tensor value).
- ``check_*`` throwing behavior is in ``math_tpu_torch.utils.checks``;
  invalid values inside a density follow the documented -inf/nan convention.
"""

from __future__ import annotations

import builtins

import numpy as np
import torch

from math_tpu_torch import special as _sp
from math_tpu_torch.config import get_config
from math_tpu_torch.special.basic import _f

# --- re-exports: scalar specials (ref: prim/scal/fun) -----------------------

from math_tpu_torch.special import (  # noqa: F401
    F32,
    Phi,
    Phi_approx,
    bessel_first_kind,
    bessel_second_kind,
    beta,
    binary_log_loss,
    choose,
    digamma,
    erf,
    erfc,
    falling_factorial,
    gamma_p,
    gamma_q,
    grad_2F1,
    grad_F32,
    grad_inc_beta,
    grad_reg_inc_beta,
    grad_reg_inc_gamma,
    grad_reg_lower_inc_gamma,
    inc_beta,
    inc_beta_dda,
    inc_beta_ddb,
    inc_beta_ddz,
    int_step,
    inv,
    inv_Phi,
    inv_cloglog,
    inv_logit,
    inv_sqrt,
    inv_square,
    lbeta,
    lgamma,
    lmgamma,
    log1m,
    log1m_exp,
    log1m_inv_logit,
    log1p_exp,
    log_diff_exp,
    log_falling_factorial,
    log_inv_logit,
    log_inv_logit_diff,
    log_mix,
    log_modified_bessel_first_kind,
    log_rising_factorial,
    log_sum_exp,
    logit,
    modified_bessel_first_kind,
    modified_bessel_second_kind,
    multiply_log,
    owens_t,
    rising_factorial,
    sign,
    square,
    step,
    trigamma,
)

# --- re-exports: matrix functions (ref: prim/mat/fun) -----------------------

from math_tpu_torch.ops.linalg import (  # noqa: F401
    autocorrelation,
    autocovariance,
    chol2inv,
    cholesky_decompose,
    columns_dot_self,
    crossprod,
    csr_extract_u,
    csr_extract_v,
    csr_extract_w,
    csr_matrix_times_vector,
    csr_to_dense_matrix,
    csr_u_to_z,
    cumulative_sum,
    determinant,
    distance,
    dot_self,
    eigenvalues_sym,
    eigenvectors_sym,
    inverse,
    inverse_spd,
    ldlt_factor,
    log_determinant,
    log_determinant_ldlt,
    log_determinant_spd,
    log_softmax,
    matrix_exp,
    matrix_exp_2x2,
    matrix_exp_multiply,
    matrix_power,
    mdivide_left,
    mdivide_left_ldlt,
    mdivide_left_spd,
    mdivide_left_tri,
    mdivide_left_tri_low,
    mdivide_right,
    mdivide_right_ldlt,
    mdivide_right_spd,
    mdivide_right_tri,
    mdivide_right_tri_low,
    multiply_lower_tri_self_transpose,
    qr_Q,
    qr_R,
    qr_thin_Q,
    qr_thin_R,
    quad_form,
    quad_form_diag,
    quad_form_sym,
    rank,
    rows_dot_self,
    scale_matrix_exp_multiply,
    singular_values,
    softmax,
    sort_indices_asc,
    sort_indices_desc,
    squared_distance,
    tcrossprod,
    trace_gen_inv_quad_form_ldlt,
    trace_gen_quad_form,
    trace_inv_quad_form_ldlt,
    trace_quad_form,
)
from math_tpu_torch.ops.gp import (  # noqa: F401
    add_diag,
    gp_dot_prod_cov,
    gp_exp_quad_cov,
    gp_exponential_cov,
    gp_matern32_cov,
    gp_matern52_cov,
    gp_periodic_cov,
)
from math_tpu_torch.transforms import (  # noqa: F401
    identity_constrain,
    identity_free,
    cholesky_corr_constrain,
    cholesky_corr_free,
    cholesky_factor_constrain,
    cholesky_factor_free,
    corr_constrain,
    corr_free,
    corr_matrix_constrain,
    corr_matrix_free,
    cov_matrix_constrain,
    cov_matrix_constrain_lkj,
    cov_matrix_free,
    cov_matrix_free_lkj,
    factor_U,
    factor_cov_matrix,
    lb_constrain,
    lb_free,
    lub_constrain,
    lub_free,
    make_nu,
    offset_multiplier_constrain,
    offset_multiplier_free,
    ordered_constrain,
    ordered_free,
    positive_constrain,
    positive_free,
    positive_ordered_constrain,
    positive_ordered_free,
    prob_constrain,
    prob_free,
    read_corr_L,
    read_corr_matrix,
    read_cov_L,
    read_cov_matrix,
    simplex_constrain,
    simplex_free,
    ub_constrain,
    ub_free,
    unit_vector_constrain,
    unit_vector_free,
)

# LDLT_factor: the reference's cached-factorization type (LDLT_factor.hpp)
LDLT_factor = ldlt_factor

# cov_exp_quad: deprecated pre-2.x name for gp_exp_quad_cov
cov_exp_quad = gp_exp_quad_cov


def _floats(*args):
    return list(_f(*args)) if len(args) > 1 else [_f(*args)]


def _t(x):
    """``x`` as a tensor, integers kept integer (a tensor as it is)."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _device(device, *values):
    """A factory's device: ``device``, else a tensor value's, else the card
    (``get_config().device``)."""
    if device is not None:
        return torch.device(device)
    for v in values:
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device(get_config().device)


def _value(v, device):
    """A factory's fill value as a tensor on ``device`` (float64 for a Python
    number, its own dtype for a tensor)."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.as_tensor(np.asarray(v, dtype=np.float64), device=device)


def _elementwise(fn, doc):
    def wrapped(*args):
        return fn(*_floats(*args))

    wrapped.__doc__ = doc
    return wrapped


# --- elementwise math (ref: prim/{scal,mat}/fun) -----------------------------

abs = _elementwise(torch.abs, "|x| (ref: abs.hpp)")  # noqa: A001
acos = _elementwise(torch.acos, "ref: acos.hpp")
acosh = _elementwise(torch.acosh, "ref: acosh.hpp")
asin = _elementwise(torch.asin, "ref: asin.hpp")
asinh = _elementwise(torch.asinh, "ref: asinh.hpp")
atan = _elementwise(torch.atan, "ref: atan.hpp")
atan2 = _elementwise(torch.atan2, "ref: atan2.hpp")
atanh = _elementwise(torch.atanh, "ref: atanh.hpp")
cbrt = _sp.cbrt
ceil = _elementwise(torch.ceil, "ref: ceil.hpp")
cos = _elementwise(torch.cos, "ref: cos.hpp")
cosh = _elementwise(torch.cosh, "ref: cosh.hpp")
exp = _elementwise(torch.exp, "ref: exp.hpp")
exp2 = _elementwise(torch.exp2, "ref: exp2.hpp")
expm1 = _elementwise(torch.expm1, "ref: expm1.hpp")
fabs = abs
fdim = _elementwise(lambda x, y: torch.clamp_min(x - y, 0.0), "max(x - y, 0) (ref: fdim.hpp)")
floor = _elementwise(torch.floor, "ref: floor.hpp")
fma = _elementwise(_sp.fma, "x * y + z (ref: fma.hpp)")
fmax = _elementwise(torch.maximum, "ref: fmax.hpp")
fmin = _elementwise(torch.minimum, "ref: fmin.hpp")
hypot = _sp.hypot
ldexp = _elementwise(torch.ldexp, "x * 2^e (ref: ldexp.hpp)")
log = _elementwise(torch.log, "ref: log.hpp")
log10 = _elementwise(torch.log10, "ref: log10.hpp")
log1p = _elementwise(torch.log1p, "ref: log1p.hpp")
log2 = _elementwise(torch.log2, "ref: log2.hpp")
round = _elementwise(torch.round, "ref: round.hpp")  # noqa: A001
sin = _elementwise(torch.sin, "ref: sin.hpp")
sinh = _elementwise(torch.sinh, "ref: sinh.hpp")
sqrt = _elementwise(torch.sqrt, "ref: sqrt.hpp")
tan = _elementwise(torch.tan, "ref: tan.hpp")
tanh = _elementwise(torch.tanh, "ref: tanh.hpp")
trunc = _elementwise(torch.trunc, "ref: trunc.hpp")


def tgamma(x):
    """Gamma function incl. negative non-integer arguments (ref: tgamma.hpp):
    exp(lgamma(x)) times the sign of Gamma (negative where floor(x) is odd
    and x < 0)."""
    x = _f(x)
    sign = torch.where((x < 0) & (torch.remainder(torch.floor(x), 2.0) == 1.0), -1.0, 1.0)
    return torch.exp(torch.lgamma(x)) * sign


def divide(a, b):
    """Scalar/elementwise division; integer args use C++ truncation toward
    zero (ref: divide.hpp)."""
    a, b = _t(a), _t(b)
    if not a.is_floating_point() and not b.is_floating_point():
        return torch.div(a, b, rounding_mode="trunc")
    return a / b


def modulus(a, b):
    """C++ integer % (truncated, sign follows dividend) (ref: modulus.hpp)."""
    a, b = _t(a), _t(b)
    return torch.fmod(a, b)


def multiply(a, b):
    """Stan multiply: matrix product for matrix/vector operands, scalar
    multiplication otherwise (ref: multiply.hpp)."""
    a, b = _t(a), _t(b)
    if a.ndim == 0 or b.ndim == 0:
        return a * b
    return a @ b


def add(a, b):
    return _t(a) + b


def subtract(a, b):
    return _t(a) - b


def minus(a):
    return -_t(a)


def elt_multiply(a, b):
    return _t(a) * _t(b)


def elt_divide(a, b):
    return _t(a) / _t(b)


def dot_product(a, b):
    return torch.sum(_t(a) * _t(b), dim=-1)


dot = dot_product  # ref: prim/arr/fun/dot.hpp


def columns_dot_product(a, b):
    return torch.sum(_t(a) * _t(b), dim=-2)


def rows_dot_product(a, b):
    return torch.sum(_t(a) * _t(b), dim=-1)


def scaled_add(x, y, lam):
    """x + lambda * y (functional form of ref: prim/arr/fun/scaled_add.hpp)."""
    return _t(x) + lam * _t(y)


# --- reductions & statistics (ref: sum.hpp, mean.hpp, sd.hpp, ...) ----------


def sum(x):  # noqa: A001
    """ref: sum.hpp."""
    return torch.sum(_t(x))


def prod(x):
    return torch.prod(_t(x))


def mean(x):
    return torch.mean(_floats(x)[0])


def max(x):  # noqa: A001
    return torch.max(_t(x))


def min(x):  # noqa: A001
    return torch.min(_t(x))


def variance(x):
    """Sample variance, n-1 denominator (ref: variance.hpp)."""
    return torch.var(_floats(x)[0], correction=1)


def sd(x):
    """Sample standard deviation (ref: sd.hpp)."""
    return torch.std(_floats(x)[0], correction=1)


def sort_asc(x):
    return torch.sort(_t(x), dim=-1).values


def sort_desc(x):
    return torch.sort(_t(x), dim=-1, descending=True).values


def inverse_softmax(x):
    """log of a simplex (functional form of ref: prim/arr/fun/
    inverse_softmax.hpp)."""
    return torch.log(_floats(x)[0])


# --- shapes, construction, rearrangement (ref: dims.hpp, rep_*.hpp, ...) ----


def _shape(x):
    return tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)


def dims(x):
    return list(_shape(x))


def num_elements(x):
    return int(np.prod(_shape(x), dtype=np.int64))


def size(x):  # Stan size() = length of an array's leading dimension
    return _shape(x)[0]


def rows(x):
    return _shape(x)[-2]


def cols(x):
    return _shape(x)[-1]


def rep_array(v, n, device=None):
    v = _value(v, _device(device, v))
    return v.expand((n,) + tuple(v.shape)).clone()


def rep_vector(v, n, device=None):
    return _value(v, _device(device, v)).expand((n,)).clone()


def rep_row_vector(v, n, device=None):
    return rep_vector(v, n, device)


def rep_matrix(v, m, n=None, device=None):
    v = _value(v, _device(device, v))
    if n is None:  # vector -> replicate columns ; row_vector -> rows
        return v[..., None].expand(tuple(v.shape) + (m,)).clone()
    return v.expand((m, n)).clone()


def fill(x, v):
    """Functional fill: array of x's shape holding v (ref: fill.hpp)."""
    return torch.full_like(_floats(x)[0], v)


def initialize(x, v):
    return fill(x, v)


def append_array(a, b):
    return torch.cat([_t(a), _t(b)], dim=0)


vec_concat = append_array  # ref: prim/arr/fun/vec_concat.hpp


def append_row(a, b):
    return torch.vstack([torch.atleast_2d(_t(a)), torch.atleast_2d(_t(b))])


def append_col(a, b):
    return torch.hstack([_t(a), _t(b)])


def array_builder(*xs):
    """Build an array from elements (ref: prim/arr/fun/array_builder.hpp's
    fluent builder, collapsed to a single call)."""
    return torch.stack([_t(x) for x in xs])


def diag_matrix(v):
    v = _t(v)
    return v[..., None] * torch.eye(v.shape[-1], dtype=v.dtype, device=v.device)


def diagonal(m):
    return torch.diagonal(_t(m), dim1=-2, dim2=-1)


def diag_pre_multiply(v, m):
    v, m = _floats(v, m)
    return v[..., :, None] * m


def diag_post_multiply(m, v):
    m, v = _floats(m, v)
    return m * v[..., None, :]


def divide_columns(m, v):
    """Divide each row elementwise by vector v (ref: divide_columns.hpp)."""
    m, v = _floats(m, v)
    return m / v[..., None, :]


def transpose(m):
    return _t(m).mT


def trace(m):
    """ref: trace.hpp."""
    return torch.diagonal(_t(m), dim1=-2, dim2=-1).sum(-1)


def to_vector(x):
    x = _t(x)
    # Stan matrices are column-major: to_vector stacks columns
    if x.ndim >= 2:
        return x.mT.reshape(tuple(x.shape[:-2]) + (-1,))
    return x.reshape(-1)


def to_row_vector(x):
    return to_vector(x)


def to_matrix(x, m=None, n=None):
    x = _t(x)
    if m is None:
        return torch.atleast_2d(x)
    # Stan reads the SOURCE column-major too (Eigen::Map over the matrix's
    # storage), so matrix inputs are flattened column by column before the
    # column-major (n, m).T refill
    return to_vector(x).reshape(n, m).mT


def to_array_1d(x):
    return to_vector(x)


def to_array_2d(x):
    return _t(x)


# --- 1-based indexing helpers (ref: block.hpp, head.hpp, get_base1.hpp) -----


def block(m, i, j, nrows, ncols):
    """Submatrix at 1-based (i, j) (ref: block.hpp)."""
    return _t(m)[..., i - 1 : i - 1 + nrows, j - 1 : j - 1 + ncols]


def row(m, i):
    return _t(m)[..., i - 1, :]


def col(m, j):
    return _t(m)[..., :, j - 1]


def head(v, n):
    return _t(v)[..., :n]


def tail(v, n):
    return _t(v)[..., -n:]


def segment(v, i, n):
    """n elements starting at 1-based i (ref: segment.hpp)."""
    return _t(v)[..., i - 1 : i - 1 + n]


def sub_col(m, i, j, nrows):
    return _t(m)[..., i - 1 : i - 1 + nrows, j - 1]


def sub_row(m, i, j, ncols):
    return _t(m)[..., i - 1, j - 1 : j - 1 + ncols]


def get_base1(x, i, *idxs):
    """1-based element access (ref: get_base1.hpp)."""
    out = _t(x)[i - 1]
    for k in idxs:
        out = out[k - 1]
    return out


get_base1_lhs = get_base1  # assignment-lvalue variant is N/A functionally


# --- predicates & value utilities (ref: is_*.hpp, value_of.hpp) -------------


def is_nan(x):
    return torch.isnan(_floats(x)[0])


def is_inf(x):
    return torch.isinf(_floats(x)[0])


def is_any_nan(*xs):
    """Whether any argument holds a NaN (a boolean tensor)."""
    return torch.stack([torch.isnan(_floats(x)[0]).any() for x in xs]).any()


def is_integer(x):
    x = _t(x)
    return torch.floor(x) == x


def is_nonpositive_integer(x):
    x = _t(x)
    return (x <= 0) & (torch.floor(x) == x)


def as_bool(x):
    return _t(x) != 0


def if_else(c, a, b):
    return torch.where(_t(c), *_floats(a, b))


def _logical(fn):
    def wrapped(*args):
        return fn(*[_t(a) for a in args]).to(torch.int32)

    return wrapped


logical_and = _logical(lambda a, b: (a != 0) & (b != 0))
logical_or = _logical(lambda a, b: (a != 0) | (b != 0))
logical_negation = _logical(lambda a: a == 0)
logical_eq = _logical(lambda a, b: a == b)
logical_neq = _logical(lambda a, b: a != b)
logical_lt = _logical(lambda a, b: a < b)
logical_lte = _logical(lambda a, b: a <= b)
logical_gt = _logical(lambda a, b: a > b)
logical_gte = _logical(lambda a, b: a >= b)


def value_of(x):
    """Strip derivative information (ref: value_of.hpp == detach)."""
    return x.detach() if isinstance(x, torch.Tensor) else x


value_of_rec = value_of
primitive_value = value_of


def size_zero(*xs):
    return builtins.any(num_elements(x) == 0 for x in xs)


def ibeta(a, b, x):
    """Regularized incomplete beta (ref: ibeta.hpp -> boost ibeta)."""
    return inc_beta(a, b, x)


def binomial_coefficient_log(n, k):
    return _sp.lchoose(n, k)


def finite_diff_stepsize(u):
    """cbrt(eps) * max(1, |u|) (ref: finite_diff_stepsize.hpp)."""
    eps_cbrt = float(np.cbrt(np.finfo(np.float64).eps))
    return eps_cbrt * torch.clamp_min(torch.abs(_f(u)), 1.0)


def stan_print(fmt_or_value, *args):
    """Print (ref: stan_print.hpp); with ``args``, ``fmt_or_value`` is a
    ``str.format`` string.  Reading a CUDA tensor's value synchronises."""
    if args:
        print(fmt_or_value.format(*args))
    else:
        print("{}".format(fmt_or_value))


def matrix_exp_pade(m):
    """Pade matrix exponential (ref: matrix_exp_pade.hpp); ``torch.linalg.matrix_exp``
    is a scaled Pade / Taylor implementation."""
    return matrix_exp(m)


# --- accumulators (ref: accumulator.hpp, welford_{var,covar}_estimator.hpp) -


class accumulator:
    """Functional log-prob accumulator (ref: accumulator.hpp)."""

    def __init__(self, device=None):
        self._terms = []
        self._device = device

    def add(self, x):
        self._terms.append(torch.sum(_floats(x)[0]))
        return self

    def sum(self):  # noqa: A003
        if not self._terms:
            return torch.zeros((), dtype=torch.float64, device=_device(self._device))
        out = self._terms[0]
        for t in self._terms[1:]:
            out = out + t.to(out.device)
        return out


class welford_var_estimator:
    """Online mean/variance (ref: welford_var_estimator.hpp).

    Stateful convenience facade over the functional core the warmup uses
    (``infer.adapt``)."""

    def __init__(self, dim, dtype=torch.float64, device=None):
        device = _device(device)
        self._n = 0.0
        self._mean = torch.zeros(dim, dtype=dtype, device=device)
        self._m2 = torch.zeros(dim, dtype=dtype, device=device)

    def add_sample(self, x):
        x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                            dtype=self._mean.dtype, device=self._mean.device)
        self._n += 1.0
        delta = x - self._mean
        self._mean = self._mean + delta / self._n
        self._m2 = self._m2 + delta * (x - self._mean)

    def num_samples(self):
        return self._n

    def sample_mean(self):
        return self._mean

    def sample_variance(self):
        return self._m2 / (self._n - 1.0)


class welford_covar_estimator:
    """Online mean/covariance (ref: welford_covar_estimator.hpp)."""

    def __init__(self, dim, dtype=torch.float64, device=None):
        device = _device(device)
        self._n = 0.0
        self._mean = torch.zeros(dim, dtype=dtype, device=device)
        self._m2 = torch.zeros((dim, dim), dtype=dtype, device=device)

    def add_sample(self, x):
        x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                            dtype=self._mean.dtype, device=self._mean.device)
        self._n += 1.0
        delta = x - self._mean
        self._mean = self._mean + delta / self._n
        self._m2 = self._m2 + torch.outer(x - self._mean, delta)

    def num_samples(self):
        return self._n

    def sample_mean(self):
        return self._mean

    def sample_covariance(self):
        return self._m2 / (self._n - 1.0)


# --- names with no runtime analog here --------------------------------------

NOT_APPLICABLE = {
    # C++ compile-time metaprogramming: types, not runtime functions
    "common_type": "C++ type trait; torch dtype promotion plays this role",
    "promote_common": "C++ type promotion; torch.result_type",
    "promote_elements": "C++ type promotion; torch.result_type",
    "promote_scalar": "C++ type promotion; torch.as_tensor(dtype=...)",
    "promote_scalar_type": "C++ type trait",
    "typedefs": "Eigen typedef header",
    "Eigen": "Eigen forward-declaration header",
    "MatrixExponential.h": "vendored Eigen internal; matrix_exp covers it",
    "matrix_exp_action_handler": (
        "implemented: ops/linalg._expm_action_core (shifted truncated-Taylor"
        " action with static substeps), dispatched by matrix_exp_multiply"
    ),
    "boost_policy": "boost error-policy configuration header",
    "constants": "constants live in math_tpu_torch.special.basic (LOG_TWO, ...)",
    "is_uninitialized": "no uninitialized vars in a functional framework",
    "resize": "a functional surface allocates anew; allocate with rep_*/fill",
    "assign": "in-place assignment; use out-of-place updates (index_put, torch.where)",
    "get_lp": "Stan-language accumulator plumbing; model layer handles lp",
    "sort_indices": "internal comparator of sort_indices_{asc,desc}",
    "read_corr_matrix": None,  # provided (transforms); listed for clarity
    "stan_print": None,  # provided above
}
NOT_APPLICABLE = {k: v for k, v in NOT_APPLICABLE.items() if v is not None}
