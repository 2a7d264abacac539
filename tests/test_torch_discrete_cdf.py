"""PyTorch port: the cdfs of ``dists/discrete.py`` against ``math_tpu``
(CPU, float64), at the JAX package's ``CDFS`` rows and ``TAILS`` far tails
(``tests/dist_fixtures.py``), and the completeness of the module.

Values to ``1e-10`` relative (``inc_beta``'s value is XLA's continued
fraction, ``lgamma`` ulps apart), beside the oracle's probabilities;
gradients in every floating parameter to ``1e-9`` (the outcome and a count
``n`` are data).  With ``batch_ndims=1`` each cdf equals a loop over the
chains, and a chain with an invalid parameter is NaN (a cdf: a product over
an invalid argument, as in JAX) or ``-inf`` (a log-cdf) alone.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from math_tpu import dists as jd
from math_tpu.dists import discrete as jdisc
from math_tpu_torch import dists as td
from math_tpu_torch.dists import discrete as tdisc

from dist_fixtures import CDFS, TAILS

C = 3
DISCRETE = sorted({n[: -len("_lpmf")] for n in dir(jdisc) if n.endswith("_lpmf")})
ELEMENTWISE = {n for n in DISCRETE if not n.startswith(("categorical", "ordered"))}
CDF = {c.name: c for c in CDFS if c.name in DISCRETE}


def t64(a, grad=False):
    return torch.tensor(np.asarray(a, dtype=np.float64), dtype=torch.float64, requires_grad=grad)


def close(got, want, rtol, atol=1e-300):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def test_every_function_is_ported():
    names = sorted(n for n in dir(jdisc) if not n.startswith("_") and callable(getattr(jdisc, n))
                   and getattr(getattr(jdisc, n), "__module__", "") == "math_tpu.dists.discrete")
    assert [n for n in names if not hasattr(tdisc, n)] == []
    assert sorted(tdisc.__all__) == names


def _cdf_cases():
    for name in sorted(CDF):
        for kind in ("cdf", "lcdf", "lccdf"):
            if hasattr(jdisc, f"{name}_{kind}"):
                yield name, kind


@pytest.mark.parametrize("name,kind", list(_cdf_cases()))
def test_cdfs_values_and_grads(name, kind):
    """At the ``CDFS`` rows: the value against JAX and the oracle, the
    gradient in every floating parameter against JAX's (the outcome and a
    count ``n`` are data)."""
    c = CDF[name]
    jf, tf = getattr(jd, f"{name}_{kind}"), getattr(td, f"{name}_{kind}")
    y, *params = c.args
    floats = [i for i, p in enumerate(params) if isinstance(p, float)]
    probs = np.asarray(c.probs(*c.args), dtype=np.float64)
    if kind == "lccdf" and c.logsf is not None:
        oracle = np.sum(c.logsf(*c.args))
    else:
        oracle = {"cdf": np.prod(probs), "lcdf": np.sum(np.log(probs)), "lccdf": np.sum(np.log1p(-probs))}[kind]

    def jfun(*fp):
        full = list(params)
        for i, v in zip(floats, fp):
            full[i] = v
        return jf(y, *full)

    want, want_g = jax.value_and_grad(jfun, tuple(range(len(floats))))(*[jnp.asarray(params[i], jnp.float64) for i in floats])
    tp = [t64(params[i], grad=True) for i in floats]
    full = list(params)
    for i, v in zip(floats, tp):
        full[i] = v
    got = tf(y, *full)
    close(got.detach(), want, rtol=1e-10)
    close(got.detach(), oracle, rtol=1e-6, atol=1e-10)
    for g, w in zip(torch.autograd.grad(got, tp), want_g):
        close(g, w, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("row", [r for r in TAILS if r[0] in DISCRETE], ids=lambda r: f"{r[0]}-{r[1]}")
def test_far_tails(row):
    name, kind, args, want, tol = row
    got = getattr(td, f"{name}_{kind}")(*args)
    close(got, want, rtol=tol)
    close(got, getattr(jd, f"{name}_{kind}")(*args), rtol=1e-10)


@pytest.mark.parametrize("name", sorted(n for n in CDF if n in ELEMENTWISE and hasattr(tdisc, n + "_cdf")))
def test_cdfs_batch_ndims_1(name):
    """Each floating parameter with a chain axis ``(C, 1)``; chain 1 of the
    first one made invalid (negative): that chain alone is NaN / -inf."""
    c = CDF[name]
    y, *params = c.args
    rng = np.random.default_rng(3)
    cp = [t64(p * (1.0 + 0.05 * rng.uniform(size=C)))[:, None] if isinstance(p, float) else p for p in params]
    first = next(i for i, p in enumerate(params) if isinstance(p, float))
    bad = cp[first].clone()
    bad[1] = -1.0
    for kind in ("cdf", "lcdf", "lccdf"):
        fn = getattr(td, f"{name}_{kind}")
        got = fn(y, *cp, batch_ndims=1)
        want = torch.stack([fn(y, *[p[k] if isinstance(p, torch.Tensor) else p for p in cp]) for k in range(C)])
        assert got.shape == (C,)
        close(got, want, rtol=1e-13)
        mixed = list(cp)
        mixed[first] = bad
        out = fn(y, *mixed, batch_ndims=1)
        close(out[[0, 2]], got[[0, 2]], rtol=1e-13)
        assert bool(torch.isnan(out[1])) if kind == "cdf" else float(out[1]) == -np.inf


def test_ordered_probit_gradient_at_the_end_categories():
    """Outcomes in the first and the last category: the gradient in eta and
    the cuts against JAX's (PyTorch's log_ndtr has an infinite gradient at
    the +-1e30 boundary cuts, which must not reach the selected branch)."""
    y, eta, c = np.array([2, 1, 4]), np.array([0.3, -0.2, 0.5]), np.array([-0.5, 0.8, 2.0])
    want = jax.grad(lambda e, cc: jd.ordered_probit_lpmf(y, e, cc), (0, 1))(jnp.asarray(eta), jnp.asarray(c))
    te, tc = t64(eta, grad=True), t64(c, grad=True)
    got = torch.autograd.grad(td.ordered_probit_lpmf(y, te, tc), (te, tc))
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        close(g, w, rtol=1e-12, atol=1e-14)
