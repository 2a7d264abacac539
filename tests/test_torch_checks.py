"""PyTorch port: the ``check_*`` / ``is_*`` validation layer
(``math_tpu_torch/utils/checks.py``) against ``math_tpu/utils/checks.py`` (CPU).

The twins of ``tests/test_checks_sweep.py`` and of the debug-check cases of
``tests/test_runtime.py``: each value check raises under
``enable_debug_checks()`` on a violating input, passes on a valid one, and is
a no-op outside debug mode (there it computes nothing at all); structural
checks raise at the call; every ``is_*`` predicate gives the JAX package's
verdict on the same input.
"""

import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from math_tpu.utils import checks as jchecks
from math_tpu_torch.utils import checks
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)

GOOD_CORR = np.array([[1.0, 0.3], [0.3, 1.0]])
BAD_CORR = np.array([[1.0, 1.5], [1.5, 1.0]])  # not PSD
GOOD_CHOL = np.array([[1.0, 0.0], [0.5, 2.0]])
BAD_CHOL = np.array([[1.0, 0.7], [0.5, 2.0]])  # upper junk
GOOD_CHOL_CORR = np.array([[1.0, 0.0], [0.6, 0.8]])

# (check name, passing args, failing args) — all value-level validators
VALUE_CASES = [
    ("check_not_nan", (1.0,), (np.nan,)),
    ("check_finite", (1.0,), (np.inf,)),
    ("check_positive", (2.0,), (0.0,)),
    ("check_nonnegative", (0.0,), (-1e-9,)),
    ("check_positive_finite", (2.0,), (np.inf,)),
    ("check_bounded", (0.5, 0.0, 1.0), (1.5, 0.0, 1.0)),
    ("check_less_or_equal", (1.0, 1.0), (1.1, 1.0)),
    ("check_greater_or_equal", (1.0, 1.0), (0.9, 1.0)),
    ("check_greater", (1.1, 1.0), (1.0, 1.0)),
    ("check_less", (0.9, 1.0), (1.0, 1.0)),
    ("check_ordered", (np.array([1.0, 2.0, 3.0]),), (np.array([1.0, 1.0]),)),
    ("check_positive_ordered", (np.array([1.0, 2.0]),), (np.array([-1.0, 2.0]),)),
    ("check_simplex", (np.array([0.3, 0.7]),), (np.array([0.5, 0.6]),)),
    ("check_unit_vector", (np.array([0.6, 0.8]),), (np.array([1.0, 1.0]),)),
    ("check_symmetric", (GOOD_CORR,), (np.array([[1.0, 2.0], [0.0, 1.0]]),)),
    ("check_pos_definite", (GOOD_CORR,), (BAD_CORR,)),
    ("check_corr_matrix", (GOOD_CORR,), (BAD_CORR,)),
    ("check_cholesky_factor", (GOOD_CHOL,), (BAD_CHOL,)),
    ("check_cholesky_factor_corr", (GOOD_CHOL_CORR,), (GOOD_CHOL,)),
    ("check_lower_triangular", (GOOD_CHOL,), (BAD_CHOL,)),
    ("check_cov_matrix", (GOOD_CORR,), (BAD_CORR,)),
    ("check_pos_semidefinite", (GOOD_CORR,), (BAD_CORR,)),
    ("check_multiplier", (2.0,), (-1.0,)),
    ("check_ldlt_factor", (GOOD_CHOL,), (np.array([[1.0, 0.0], [0.5, -2.0]]),)),
]


def t64(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


@pytest.mark.parametrize("name,good,bad", VALUE_CASES, ids=[c[0] for c in VALUE_CASES])
def test_value_check_behavior(name, good, bad):
    fn = getattr(checks, name)
    args_good = tuple(t64(a) for a in good)
    args_bad = tuple(t64(a) for a in bad)
    # no-op outside debug mode, even on violating values
    fn("f", "x", *args_bad)
    with checks.enable_debug_checks():
        fn("f", "x", *args_good)  # valid input must NOT raise
        with pytest.raises(ValueError):
            fn("f", "x", *args_bad)
    # the JAX package's check agrees on the failing input
    with jchecks.enable_debug_checks(), pytest.raises(Exception):
        getattr(jchecks, name)("f", "x", *[jnp.asarray(a) for a in bad])
        jax.effects_barrier()


STRUCT_CASES = [
    ("check_square", (np.zeros((2, 3)),)),
    ("check_vector", (np.zeros((2, 2)),)),
    ("check_nonzero_size", (np.zeros((0,)),)),
    ("check_nonempty", (np.zeros((0,)),)),
]


@pytest.mark.parametrize("name,bad", STRUCT_CASES, ids=[c[0] for c in STRUCT_CASES])
def test_structural_check_raises_eagerly(name, bad):
    fn = getattr(checks, name)
    with pytest.raises(ValueError):
        fn("f", "x", *[t64(b) for b in bad])
    with pytest.raises(ValueError):
        fn("f", "x", *bad)  # numpy in, as in the JAX package


def test_value_check_costs_nothing_outside_debug_mode():
    """Off, a value check does not look at its argument (the sampler's path
    keeps its synchronisations); on, the state is the thread's own."""
    checks.check_positive("f", "x", object())  # never evaluated
    seen = []
    with checks.enable_debug_checks():
        assert checks.debug_checks_enabled()
        t = threading.Thread(target=lambda: seen.append(checks.debug_checks_enabled()))
        t.start()
        t.join()
    assert seen == [False] and not checks.debug_checks_enabled()
    assert checks.CONSTRAINT_TOLERANCE == jchecks.CONSTRAINT_TOLERANCE == checks.constraint_tolerance


def test_value_check_inside_a_transform():
    """A debug check fires from inside ``torch.func.grad`` too (the analog of
    the JAX test's check inside ``jax.jit``)."""

    def f(x):
        checks.check_positive("f", "x", x)
        return x * 2

    with checks.enable_debug_checks():
        assert float(torch.func.grad(f)(torch.tensor(2.0))) == 2.0
        with pytest.raises(ValueError):
            torch.func.grad(f)(torch.tensor(-1.0))


# --- the debug-check cases of tests/test_runtime.py ----------------------------


PREDICATES = [
    ("is_positive", ([1.0, 2.0],)), ("is_positive", ([1.0, -2.0],)), ("is_simplex", ([0.2, 0.3, 0.5],)),
    ("is_simplex", ([0.2, 0.3, 0.6],)), ("is_ordered", ([1.0, 2.0, 3.0],)), ("is_ordered", ([1.0, 3.0, 2.0],)),
    ("is_pos_definite", ([[2.0, 0.5], [0.5, 1.0]],)), ("is_pos_definite", ([[-2.0, -0.5], [-0.5, -1.0]],)),
    ("is_cholesky_factor", (np.linalg.cholesky([[2.0, 0.5], [0.5, 1.0]]),)), ("is_corr_matrix", (GOOD_CORR,)),
    ("is_unit_vector", ([0.6, 0.8],)), ("is_cholesky_factor_corr", (GOOD_CHOL_CORR,)), ("is_bounded", ([0.5], 0.0, 1.0)),
    ("is_prob", ([1.5],)), ("is_not_nan", ([1.0, np.nan],)), ("is_finite", ([1.0, np.inf],)),
    ("is_positive_ordered", ([0.5, 1.0],)), ("is_lower_triangular", (BAD_CHOL,)), ("is_symmetric", (GOOD_CORR,)),
    ("is_ldlt_factor", (GOOD_CHOL,)), ("is_mat_finite", ([[1.0, np.nan]],)), ("is_scal_finite", (1.0,)),
    ("is_square", (np.zeros((2, 3)),)), ("is_matching_dims", (np.zeros(2), np.zeros(3))),
    ("is_matching_size", (np.zeros((2, 3)), np.zeros(6))), ("is_nonzero_size", (np.zeros(0),)),
    ("is_column_index", (np.zeros((2, 3)), 3)),
]


@pytest.mark.parametrize("name,args", PREDICATES, ids=[f"{c[0]}-{i}" for i, c in enumerate(PREDICATES)])
def test_is_predicates(name, args):
    targs = [t64(a) if isinstance(a, (list, np.ndarray)) else a for a in args]
    jargs = [jnp.asarray(a) if isinstance(a, (list, np.ndarray)) else a for a in args]
    assert bool(getattr(checks, name)(*targs)) == bool(getattr(jchecks, name)(*jargs))


def test_structural_checks_raise_at_the_call():
    with pytest.raises(ValueError):
        checks.check_square("f", "m", torch.zeros((2, 3)))
    with pytest.raises(ValueError):
        checks.check_size_match("f", "a", 3, "b", 4)
    with pytest.raises(ValueError):
        checks.check_consistent_sizes("f", "x", np.zeros(3), "y", np.zeros(4))
    checks.check_consistent_sizes("f", "x", torch.zeros(3), "y", 1.0)  # broadcastable sizes pass
    with pytest.raises(IndexError):
        checks.check_range("f", "i", 3, 4)
    with pytest.raises(IndexError):
        checks.check_row_index("f", "m", torch.zeros((2, 3)), 3)
    with pytest.raises(ValueError):
        checks.check_multiplicable("f", "a", torch.zeros((2, 3)), "b", torch.zeros((2, 2)))
    with pytest.raises(ValueError):
        checks.check_2F1_converges("f", 1.0, 1.0, 1.0, 2.0)
    checks.check_3F2_converges("f", 1.0, 1.0, 1.0, 2.0, 2.0, 0.5)
    with pytest.raises(RuntimeError):
        checks.check_flag_sundials(-1)


def test_debug_value_checks():
    # outside debug mode: no-op
    checks.check_positive("f", "x", torch.tensor(-1.0))
    with checks.enable_debug_checks():
        with pytest.raises(ValueError):
            checks.check_positive("f", "x", torch.tensor(-1.0))
