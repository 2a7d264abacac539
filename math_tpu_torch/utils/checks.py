"""Argument validation: the reference's ``check_*`` / ``is_*`` layer.

Counterpart: ``math_tpu/utils/checks.py``.  Reference: ``prim/{scal,mat,arr}/err/``
(~75 validators, SURVEY.md §2.2).  The layer splits by what a check reads:

- **Structural checks** (shapes, sizes, index bounds, static structure): a
  plain Python ``raise``, at the call, as the JAX package raises at trace time.
- **Value checks** (positivity, finiteness, positive definiteness): the
  ``is_*`` predicates return boolean tensors; a ``check_*`` of a value runs
  only under ``enable_debug_checks()`` (thread-local, as the reference's),
  and then raises on the host: reading the verdict of a CUDA tensor is a
  synchronisation.  Outside it a value check computes nothing and costs
  nothing, so the sampler's hot path keeps its synchronisations as they are
  (densities already guard by returning -inf, the sampler-facing semantics).

``CONSTRAINT_TOLERANCE`` matches the reference
(``prim/mat/err/constraint_tolerance.hpp``).  Positive definiteness is read
off ``torch.linalg.cholesky_ex``'s status, as the JAX package reads
``jnp.linalg.cholesky``'s finite diagonal (this layer sits below ``ops``).
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

CONSTRAINT_TOLERANCE = 1e-8

_state = threading.local()


def debug_checks_enabled() -> bool:
    return getattr(_state, "enabled", False)


@contextlib.contextmanager
def enable_debug_checks():
    """Within this context, ``check_*`` raise host-side on violation."""
    prev = debug_checks_enabled()
    _state.enabled = True
    try:
        yield
    finally:
        _state.enabled = prev


def _t(x):
    """``x`` as a tensor (a tensor is returned as it is, on its device)."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _shape(x):
    return tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)


def _size(x):
    return int(np.prod(_shape(x), dtype=np.int64))


# --- is_* predicates (boolean tensors; ref: prim/*/err/is_*.hpp) ------------


def is_not_nan(x):
    return torch.all(~torch.isnan(_t(x)))


def is_finite(x):
    return torch.all(torch.isfinite(_t(x)))


def is_positive(x):
    return torch.all(_t(x) > 0)


def is_nonnegative(x):
    return torch.all(_t(x) >= 0)


def is_positive_finite(x):
    x = _t(x)
    return torch.all((x > 0) & torch.isfinite(x))


def is_bounded(x, lb, ub):
    x = _t(x)
    return torch.all((x >= lb) & (x <= ub))


def is_prob(x):
    return is_bounded(x, 0.0, 1.0)


def is_less_or_equal(x, ub):
    return torch.all(_t(x) <= ub)


def is_greater_or_equal(x, lb):
    return torch.all(_t(x) >= lb)


def is_ordered(x):
    return torch.all(torch.diff(_t(x), dim=-1) > 0)


def is_positive_ordered(x):
    x = _t(x)
    return is_ordered(x) & torch.all(x[..., 0] > 0)


def is_simplex(x, tol=CONSTRAINT_TOLERANCE):
    x = _t(x)
    return torch.all(x >= 0) & torch.all(torch.abs(torch.sum(x, dim=-1) - 1.0) <= tol)


def is_unit_vector(x, tol=CONSTRAINT_TOLERANCE):
    x = _t(x)
    return torch.all(torch.abs(torch.sum(torch.square(x), dim=-1) - 1.0) <= tol)


def is_symmetric(x, tol=CONSTRAINT_TOLERANCE):
    x = _t(x)
    return torch.all(torch.abs(x - x.mT) <= tol)


def is_pos_definite(x):
    return torch.all(torch.linalg.cholesky_ex(_t(x)).info == 0)


def is_corr_matrix(x, tol=CONSTRAINT_TOLERANCE):
    x = _t(x)
    return (
        is_symmetric(x, tol)
        & is_pos_definite(x)
        & torch.all(torch.abs(torch.diagonal(x, dim1=-2, dim2=-1) - 1.0) <= tol)
    )


def is_cholesky_factor(x, tol=CONSTRAINT_TOLERANCE):
    x = _t(x)
    upper_zero = torch.all(torch.abs(torch.triu(x, 1)) <= tol)
    return upper_zero & torch.all(torch.diagonal(x, dim1=-2, dim2=-1) > 0)


def is_cholesky_factor_corr(x, tol=CONSTRAINT_TOLERANCE):
    x = _t(x)
    unit_rows = torch.all(torch.abs(torch.sum(torch.square(x), dim=-1) - 1.0) <= float(np.sqrt(tol)))
    return is_cholesky_factor(x, tol) & unit_rows


def is_square(x):
    shape = _shape(x)
    return len(shape) >= 2 and shape[-1] == shape[-2]


def is_lower_triangular(x, tol=CONSTRAINT_TOLERANCE):
    return torch.all(torch.abs(torch.triu(_t(x), 1)) <= tol)


# --- check_* (a plain raise for structure; a host check for values) ----------


def _value_check(pred, function, name, must):
    """Raise where ``pred()`` is false, under ``enable_debug_checks()`` only;
    ``pred`` is not called (nothing is computed) outside it."""
    if not debug_checks_enabled():
        return
    if not bool(pred()):
        raise ValueError(f"{function}: {name} must be {must}")


def check_size_match(function, name1, size1, name2, size2):
    if int(size1) != int(size2):
        raise ValueError(f"{function}: {name1} ({size1}) != {name2} ({size2})")


def check_consistent_sizes(function, *name_value_pairs):
    sizes = [(name, _shape(v)) for name, v in zip(name_value_pairs[::2], name_value_pairs[1::2])]
    shapes = [s for _, s in sizes if s != ()]
    if shapes:
        try:
            np.broadcast_shapes(*shapes)
        except ValueError as e:
            raise ValueError(f"{function}: inconsistent sizes {sizes}") from e


def check_square(function, name, x):
    if not is_square(x):
        raise ValueError(f"{function}: {name} must be square, got {_shape(x)}")


def check_vector(function, name, x):
    if len(_shape(x)) != 1:
        raise ValueError(f"{function}: {name} must be a vector, got {_shape(x)}")


def check_multiplier(function, name, x):
    check_positive(function, name, x)


def check_not_nan(function, name, x):
    _value_check(lambda: is_not_nan(x), function, name, "not nan")


def check_finite(function, name, x):
    _value_check(lambda: is_finite(x), function, name, "finite")


def check_positive(function, name, x):
    _value_check(lambda: is_positive(x), function, name, "positive")


def check_nonnegative(function, name, x):
    _value_check(lambda: is_nonnegative(x), function, name, "nonnegative")


def check_positive_finite(function, name, x):
    _value_check(lambda: is_positive_finite(x), function, name, "positive finite")


def check_bounded(function, name, x, lb, ub):
    _value_check(lambda: is_bounded(x, lb, ub), function, name, f"in [{lb}, {ub}]")


def check_less_or_equal(function, name, x, ub):
    _value_check(lambda: is_less_or_equal(x, ub), function, name, f"<= {ub}")


def check_greater_or_equal(function, name, x, lb):
    _value_check(lambda: is_greater_or_equal(x, lb), function, name, f">= {lb}")


def check_ordered(function, name, x):
    _value_check(lambda: is_ordered(x), function, name, "strictly ordered")


def check_simplex(function, name, x):
    _value_check(lambda: is_simplex(x), function, name, "a simplex")


def check_unit_vector(function, name, x):
    _value_check(lambda: is_unit_vector(x), function, name, "a unit vector")


def check_symmetric(function, name, x):
    check_square(function, name, x)
    _value_check(lambda: is_symmetric(x), function, name, "symmetric")


def check_pos_definite(function, name, x):
    check_square(function, name, x)
    _value_check(lambda: is_pos_definite(x), function, name, "positive definite")


def check_corr_matrix(function, name, x):
    check_square(function, name, x)
    _value_check(lambda: is_corr_matrix(x), function, name, "a correlation matrix")


def check_cholesky_factor(function, name, x):
    _value_check(lambda: is_cholesky_factor(x), function, name, "a Cholesky factor")


def check_cholesky_factor_corr(function, name, x):
    check_square(function, name, x)
    _value_check(lambda: is_cholesky_factor_corr(x), function, name, "a correlation Cholesky factor")


def check_lower_triangular(function, name, x):
    _value_check(lambda: is_lower_triangular(x), function, name, "lower triangular")


def check_range(function, name, max_value, index):
    if not (1 <= int(index) <= int(max_value)):
        raise IndexError(f"{function}: {name} index {index} out of range [1, {max_value}]")


# --- structural/index checks (ref: prim/mat/err, prim/arr/err) --------------


def check_nonzero_size(function, name, x):
    """ref: check_nonzero_size.hpp."""
    if _size(x) == 0:
        raise ValueError(f"{function}: {name} must have non-zero size")


def check_nonempty(function, name, x):
    check_nonzero_size(function, name, x)


def check_consistent_size(function, name, x, expected_size):
    """ref: check_consistent_size.hpp: vector-ish x must have the given size
    (scalars always pass)."""
    shp = _shape(x)
    if shp != () and shp[0] != int(expected_size):
        raise ValueError(f"{function}: {name} has size {shp[0]}, expected {expected_size}")


def check_consistent_size_mvt(function, name, x, expected_size):
    """ref: check_consistent_size_mvt.hpp: length of a sequence of vectors."""
    shp = _shape(x)
    if len(shp) >= 2 and shp[0] != int(expected_size):
        raise ValueError(f"{function}: {name} has {shp[0]} vectors, expected {expected_size}")


def check_consistent_sizes_mvt(function, *name_value_pairs):
    """ref: check_consistent_sizes_mvt.hpp."""
    lens = []
    for name, v in zip(name_value_pairs[::2], name_value_pairs[1::2]):
        shp = _shape(v)
        if len(shp) >= 2:
            lens.append((name, shp[0]))
    sizes = {s for _, s in lens if s != 1}
    if len(sizes) > 1:
        raise ValueError(f"{function}: inconsistent mvt sizes {lens}")


def check_matching_sizes(function, name1, x1, name2, x2):
    """ref: check_matching_sizes.hpp (total element counts)."""
    s1, s2 = _size(x1), _size(x2)
    if s1 != s2:
        raise ValueError(f"{function}: {name1} size {s1} != {name2} size {s2}")


def check_matching_dims(function, name1, x1, name2, x2):
    """ref: check_matching_dims.hpp (full shape equality)."""
    if _shape(x1) != _shape(x2):
        raise ValueError(f"{function}: {name1} {_shape(x1)} != {name2} {_shape(x2)}")


def check_multiplicable(function, name1, x1, name2, x2):
    """ref: check_multiplicable.hpp: inner dimensions must agree."""
    check_nonzero_size(function, name1, x1)
    check_nonzero_size(function, name2, x2)
    c1 = _shape(x1)[-1]
    r2 = _shape(x2)[0] if len(_shape(x2)) >= 1 else 1
    if c1 != r2:
        raise ValueError(f"{function}: {name1} cols ({c1}) != {name2} rows ({r2})")


def check_column_index(function, name, y, i):
    """1-based column index bound (ref: check_column_index.hpp)."""
    if not (1 <= int(i) <= _shape(y)[-1]):
        raise IndexError(f"{function}: column index {i} out of range [1, {_shape(y)[-1]}]")


def check_row_index(function, name, y, i):
    """1-based row index bound (ref: check_row_index.hpp)."""
    if not (1 <= int(i) <= _shape(y)[-2]):
        raise IndexError(f"{function}: row index {i} out of range [1, {_shape(y)[-2]}]")


def check_std_vector_index(function, name, y, i):
    """1-based array index bound (ref: check_std_vector_index.hpp)."""
    if not (1 <= int(i) <= _shape(y)[0]):
        raise IndexError(f"{function}: index {i} out of range [1, {_shape(y)[0]}]")


def validate_non_negative_index(name, expr, i):
    """ref: prim/mat/err/validate_non_negative_index.hpp."""
    if int(i) < 0:
        raise ValueError(f"{name} must be non-negative, found {expr} = {i}")


# --- remaining value checks --------------------------------------------------


def is_matching_dims(x1, x2):
    return _shape(x1) == _shape(x2)


def is_matching_size(x1, x2):
    return _size(x1) == _size(x2)


is_size_match = is_matching_size


def is_nonzero_size(x):
    return _size(x) != 0


def is_column_index(y, i):
    return 1 <= int(i) <= _shape(y)[-1]


def is_scal_finite(x):
    return torch.all(torch.isfinite(_t(x)))


def is_mat_finite(x):
    return torch.all(torch.isfinite(_t(x)))


def is_ldlt_factor(ldlt):
    """Factorization handle validity: finite Cholesky factor with positive
    diagonal (ref: is_ldlt_factor.hpp)."""
    L = _t(ldlt[0] if isinstance(ldlt, tuple) else ldlt)
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    return torch.all(torch.isfinite(L)) & torch.all(d > 0)


def check_ldlt_factor(function, name, ldlt):
    _value_check(lambda: is_ldlt_factor(ldlt), function, name, "a valid factorization")


def check_greater(function, name, x, low):
    _value_check(lambda: torch.all(_t(x) > low), function, name, f"> {low}")


def check_less(function, name, x, high):
    _value_check(lambda: torch.all(_t(x) < high), function, name, f"< {high}")


def check_positive_ordered(function, name, x):
    def ok():
        xx = _t(x)
        return torch.all(xx[..., 0] > 0) & torch.all(torch.diff(xx, dim=-1) > 0)

    _value_check(ok, function, name, "positive and strictly increasing")


def check_cov_matrix(function, name, x):
    """ref: check_cov_matrix.hpp: symmetric positive definite."""
    check_square(function, name, x)
    check_symmetric(function, name, x)
    check_pos_definite(function, name, x)


def check_pos_semidefinite(function, name, x):
    check_square(function, name, x)
    _value_check(lambda: torch.all(torch.linalg.eigvalsh(_t(x)) >= -CONSTRAINT_TOLERANCE), function, name,
                 "positive semi-definite")


# --- hypergeometric convergence (ref: check_2F1_converges.hpp,
# --- check_3F2_converges.hpp); host-side on concrete arguments --------------


def _poly_terms(*as_):
    num_terms = 0
    is_poly = False
    for a in as_:
        a = float(a)
        if a <= 0 and a == np.floor(a) and abs(a) >= num_terms:
            is_poly = True
            num_terms = int(np.floor(abs(a)))
    return is_poly, num_terms


def check_2F1_converges(function, a1, a2, b1, z):
    is_poly, num_terms = _poly_terms(a1, a2)
    undefined = float(b1) <= 0 and float(b1) == np.floor(float(b1)) and abs(float(b1)) <= num_terms
    z = float(z)
    if not undefined and (is_poly or abs(z) < 1 or (abs(z) == 1 and float(b1) > float(a1) + float(a2))):
        return
    raise ValueError(f"{function}: 2F1 does not converge for a1={a1}, a2={a2}, b1={b1}, z={z}")


def check_3F2_converges(function, a1, a2, a3, b1, b2, z):
    is_poly, num_terms = _poly_terms(a1, a2, a3)
    undefined = any(
        float(b) <= 0 and float(b) == np.floor(float(b)) and abs(float(b)) <= num_terms for b in (b1, b2)
    )
    z = float(z)
    cond = (
        is_poly
        or abs(z) < 1
        or (abs(z) == 1 and float(b1) + float(b2) > float(a1) + float(a2) + float(a3))
    )
    if not undefined and cond:
        return
    raise ValueError(f"{function}: 3F2 does not converge for given arguments (z={z})")


def check_flag_sundials(flag, name="solver"):
    """Solver status flag must be >= 0 (ref: check_flag_sundials.hpp; the
    port's solvers surface status codes the same way)."""
    if int(flag) < 0:
        raise RuntimeError(f"{name} failed with flag {flag}")


# --- error-raising helpers (ref: domain_error.hpp, invalid_argument.hpp,
# --- out_of_range.hpp, system_error.hpp), raised on the host -----------------


def domain_error(function, name, value, msg1="", msg2=""):
    raise ValueError(f"{function}: {name} {msg1}{value}{msg2}")


def domain_error_vec(function, name, value, index, msg1="", msg2=""):
    raise ValueError(f"{function}: {name}[{index}] {msg1}{value}{msg2}")


def invalid_argument(function, name, value, msg1="", msg2=""):
    raise TypeError(f"{function}: {name} {msg1}{value}{msg2}")


def invalid_argument_vec(function, name, value, index, msg1="", msg2=""):
    raise TypeError(f"{function}: {name}[{index}] {msg1}{value}{msg2}")


def out_of_range(function, max_value, index, msg1="", msg2=""):
    raise IndexError(f"{function}: index {index} out of range [1, {max_value}] {msg1}{msg2}")


def system_error(function, name, sys_err, msg):
    raise OSError(f"{function}: {name}: {msg} ({sys_err})")


# name parity: the reference keeps the tolerance in its own header
constraint_tolerance = CONSTRAINT_TOLERANCE
