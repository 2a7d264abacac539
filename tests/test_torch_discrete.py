"""PyTorch port: ordered transforms, ``log1m_exp``, every function of
``dists/discrete.py`` and the three GLM densities that need them, against
``math_tpu`` (CPU, float64).

The points are the JAX package's own sweep (``tests/dist_fixtures.py``: the
value rows, the invalid rows that must give ``-inf``, and the point where the
sweep differentiates; ``CDFS`` and ``TAILS`` for the cdfs).  Values and
gradients agree to ``rtol=1e-12`` (the same float64 arithmetic up to the
order of a sum).  With ``batch_ndims=1`` each density equals a Python loop
over the chains.  The cdfs are held in ``tests/test_torch_discrete_cdf.py``,
the ``_rng`` functions in ``tests/test_torch_univariate_rng.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from math_tpu import dists as jd
from math_tpu import special as jspecial
from math_tpu import transforms as jt
from math_tpu_torch import dists as td
from math_tpu_torch import special as tspecial
from math_tpu_torch import transforms as tt

from math_tpu.dists import discrete as jdisc

from dist_fixtures import FAMS

RTOL = 1e-12
C = 3
DISCRETE = sorted({n[: -len("_lpmf")] for n in dir(jdisc) if n.endswith("_lpmf")})
FIRST_NAMES = [
    "neg_binomial_2_log", "categorical_logit", "ordered_logistic",
    "neg_binomial_2_log_glm", "ordered_logistic_glm", "categorical_logit_glm",
]
NAMES = FIRST_NAMES + [n for n in DISCRETE if n not in FIRST_NAMES]
FAM = {f.name: f for f in FAMS if f.name in NAMES}
DIFFERENTIABLE = [n for n in NAMES if FAM[n].point is not None]
# one outcome a row, parameters elementwise: a chain's parameters are (C, 1)
ELEMENTWISE = {n for n in DISCRETE if not n.startswith(("categorical", "ordered"))}



def t64(a, grad=False):
    return torch.tensor(np.asarray(a, dtype=np.float64), dtype=torch.float64, requires_grad=grad)


def close(got, want, rtol=RTOL, atol=1e-13):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def lp_of(pkg, name):
    return getattr(pkg, name + "_lpmf")


# --- transforms -------------------------------------------------------------

X_UNC = np.random.default_rng(0).normal(size=(C, 4))
TRANSFORMS = {
    "ordered": (tt.ordered_constrain, tt.ordered_constrain_lp, tt.ordered_free, jt.ordered_constrain,
                jt.ordered_constrain_lp, tt.Ordered, jt.Ordered),
    "positive_ordered": (tt.positive_ordered_constrain, tt.positive_ordered_constrain_lp, tt.positive_ordered_free,
                         jt.positive_ordered_constrain, jt.positive_ordered_constrain_lp, tt.PositiveOrdered,
                         jt.PositiveOrdered),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_ordered_transforms_against_jax(name):
    """Value, log-Jacobian (all of it, and per chain with ``batch_ndims=1``),
    the round trip through ``*_free``, and the gradient of the log-Jacobian
    adjusted value."""
    con, con_lp, free, jcon, jcon_lp, tcls, jcls = TRANSFORMS[name]
    x = t64(X_UNC, grad=True)
    y, lj = con_lp(x)
    jy, jlj = jcon_lp(jnp.asarray(X_UNC))
    close(y.detach(), jy)
    close(lj.detach(), jlj)
    close(con(x).detach(), jcon(jnp.asarray(X_UNC)))
    assert bool(torch.all(torch.diff(y, dim=-1) > 0))
    close(free(y).detach(), X_UNC)
    _, lj_b = con_lp(x, batch_ndims=1)
    assert lj_b.shape == (C,)
    close(lj_b.detach(), [float(jcon_lp(jnp.asarray(row))[1]) for row in X_UNC])
    weights = np.arange(1.0, 5.0)
    (g,) = torch.autograd.grad((con_lp(x)[0] * t64(weights)).sum() + lj, x)
    want = jax.grad(lambda a: jnp.sum(jcon_lp(a)[0] * weights) + jcon_lp(a)[1])(jnp.asarray(X_UNC))
    close(g, want)
    tr, jtr = tcls(shape=(4,)), jcls(shape=(4,))
    assert tr.unconstrained_shape == jtr.unconstrained_shape == (4,)
    y_api, lj_api = tr.constrain_lp(x.detach(), batch_ndims=1)
    close(y_api, jy)
    close(lj_api, lj_b.detach())
    close(tr.free(y_api), jtr.free(jnp.asarray(y_api.numpy())))


def test_log1m_exp_against_jax():
    """Both branches, the switch at -log 2, and NaN at x >= 0; the gradient is
    finite wherever the value is (each branch sees a clamped argument)."""
    xs = np.array([-1e-8, -0.1, -0.6931, -0.6932, -2.0, -30.0, -800.0])
    x = t64(xs, grad=True)
    got = tspecial.log1m_exp(x)
    close(got.detach(), jspecial.log1m_exp(jnp.asarray(xs)))
    (g,) = torch.autograd.grad(got.sum(), x)
    assert bool(torch.isfinite(g).all())
    close(g, jax.grad(lambda a: jnp.sum(jspecial.log1m_exp(a)))(jnp.asarray(xs)))
    assert bool(torch.isnan(tspecial.log1m_exp(t64([0.0, 1.5]))).all())


# --- densities at the sweep's points -----------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_values_at_the_sweep_rows(name):
    fam = FAM[name]
    for args in [fam.args] + fam.rows:
        got = lp_of(td, name)(*args)
        want = lp_of(jd, name)(*args)
        assert got.ndim == 0 and got.dtype == torch.float64
        close(got, want)
        # the sweep's own tolerance for the families added later (its oracle,
        # scipy on expit(-20) for bernoulli_logit, is good to ~2e-9 there)
        close(got, fam.oracle(*args), rtol=1e-9 if name in FIRST_NAMES else fam.val_tol)


@pytest.mark.parametrize("name", NAMES)
def test_invalid_rows_give_neg_inf(name):
    fam = FAM[name]
    for args in fam.invalid:
        assert float(lp_of(td, name)(*args)) == float(lp_of(jd, name)(*args)) == -np.inf


@pytest.mark.parametrize("propto", [False, True])
@pytest.mark.parametrize("name", DIFFERENTIABLE)
def test_value_and_grad_at_the_sweep_point(name, propto):
    """Differentiated at the sweep's point, the parameters as tensors (so with
    ``propto`` only their constant-free terms stay, as for JAX arrays)."""
    fam = FAM[name]
    data = fam.args[: len(fam.args) - len(fam.point)]
    jf = lambda *p: lp_of(jd, name)(*data, *p, propto=propto)  # noqa: E731
    jp = tuple(jnp.asarray(p, jnp.float64) for p in fam.point)
    want, want_g = jax.jit(jax.value_and_grad(jf, tuple(range(len(jp)))))(*jp)
    tp = [t64(p, grad=True) for p in fam.point]
    got = lp_of(td, name)(*data, *tp, propto=propto)
    close(got.detach(), want)
    for g, w in zip(torch.autograd.grad(got, tp), want_g):
        close(g, w)


def _chains(p, rng):
    """C per-chain copies of one parameter, each moved a little; an ordered
    vector is shifted as a whole so that it stays ordered."""
    p = np.asarray(p, dtype=np.float64)
    if p.ndim == 1 and p.size > 1 and bool(np.all(np.diff(p) > 0)):
        return p[None, :] + 0.1 * rng.normal(size=(C, 1))
    return p[None] + 0.1 * rng.normal(size=(C,) + p.shape)


@pytest.mark.parametrize("name", DIFFERENTIABLE)
def test_batch_ndims_1_is_a_loop_over_chains(name):
    fam = FAM[name]
    rng = np.random.default_rng(1)
    data = fam.args[: len(fam.args) - len(fam.point)]
    params = [t64(_chains(p, rng)) for p in fam.point]
    if name in ELEMENTWISE:  # elementwise: one parameter set per chain against all of y
        params = [p[:, None] for p in params]
    got = lp_of(td, name)(*data, *params, propto=True, batch_ndims=1)
    want = torch.stack([lp_of(td, name)(*data, *[q[c] for q in params], propto=True) for c in range(C)])
    assert got.shape == (C,)
    close(got, want)
    # and each chain agrees with JAX
    close(got, [float(lp_of(jd, name)(*data, *[jnp.asarray(q[c].numpy()) for q in params], propto=True)) for c in range(C)])


def test_a_chain_with_unordered_cuts_alone_is_neg_inf():
    fam = FAM["ordered_logistic_glm"]
    y, x, beta, cuts = fam.args
    cb = np.stack([cuts, cuts[::-1], cuts + 0.2])
    bb = np.stack([beta, beta, beta])
    got = td.ordered_logistic_glm_lpmf(y, x, t64(bb), t64(cb), batch_ndims=1)
    assert np.isfinite(float(got[0])) and float(got[1]) == -np.inf and np.isfinite(float(got[2]))

