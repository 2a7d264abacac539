"""PyTorch port: the densities of ``dists/continuous.py`` against
``math_tpu.dists`` (CPU, float64); the cdfs are in
``tests/test_torch_continuous_cdf.py``.

The points are the JAX package's own sweep (``tests/dist_fixtures.py``
``FAMS``: value rows, invalid rows that must give ``-inf``, the point where
the sweep differentiates and its ``ad_rows``).  Tolerances (float64):
densities relative ``1e-11`` (the same arithmetic up to the order of a sum
and ``lgamma`` ulps); gradients relative ``1e-9``.  With ``batch_ndims=1``
each density and cdf equals a loop over the chains, and a chain with an
invalid parameter is ``-inf`` alone (its cdfs are what they are for that
chain alone: NaN for a product over an invalid argument, as in JAX).
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from math_tpu import dists as jd
from math_tpu.dists import continuous as jcont
from math_tpu_torch import dists as td
from math_tpu_torch.dists import continuous as tcont

from dist_fixtures import FAMS
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)

RTOL, GRAD_RTOL, CDF_RTOL = 1e-11, 1e-9, 1e-10
CONT = {n[: -len("_lpdf")] for n in dir(jcont) if n.endswith("_lpdf")}
FAM = {f.name: f for f in FAMS if f.name in CONT}
C = 3
# sweep points that do not list every argument (``n_obs`` is data)
POINT_FN = {
    "normal_sufficient": (lambda pkg: lambda yb, ss, m, s, **kw: pkg.normal_sufficient_lpdf(yb, ss, 10.0, m, s, **kw)),
}


def t64(a, grad=False):
    return torch.tensor(np.asarray(a, dtype=np.float64), dtype=torch.float64, requires_grad=grad)


def close(got, want, rtol, atol=1e-300, msg=""):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


def test_every_function_is_ported():
    names = sorted(n for n in dir(jcont) if not n.startswith("_") and callable(getattr(jcont, n))
                   and getattr(getattr(jcont, n), "__module__", "") == "math_tpu.dists.continuous")
    assert [n for n in names if not hasattr(tcont, n)] == []
    assert sorted(tcont.__all__) == names
    assert set(FAM) == CONT


@pytest.mark.parametrize("name", sorted(FAM))
def test_values_and_invalid_rows(name):
    fam = FAM[name]
    for args in [fam.args] + fam.rows:
        got = getattr(td, name + "_lpdf")(*args)
        assert got.ndim == 0 and got.dtype == torch.float64
        close(got, getattr(jd, name + "_lpdf")(*args), RTOL, msg=str(args))
        close(got, fam.oracle(*args), fam.val_tol)
    for args in fam.invalid:
        assert float(getattr(td, name + "_lpdf")(*args)) == -np.inf, args


@pytest.mark.parametrize("propto", [False, True])
@pytest.mark.parametrize("name", sorted(FAM))
def test_value_and_grad_at_the_sweep_point(name, propto):
    """Every argument of the sweep's point as a tensor (so with ``propto``
    only the constant-free terms stay, as for JAX arrays), the ``ad_rows``
    near the support's edges as well."""
    fam = FAM[name]
    jf, tf = (POINT_FN[name](jd), POINT_FN[name](td)) if name in POINT_FN else (getattr(jd, name + "_lpdf"), getattr(td, name + "_lpdf"))
    for point in [fam.point] + fam.ad_rows:
        jp = [jnp.asarray(p, jnp.float64) for p in point]
        want, want_g = jax.value_and_grad(lambda *p: jf(*p, propto=propto), tuple(range(len(jp))))(*jp)
        tp = [t64(p, grad=True) for p in point]
        got = tf(*tp, propto=propto)
        close(got.detach(), want, RTOL)
        for i, (g, w) in enumerate(zip(torch.autograd.grad(got, tp, allow_unused=True), want_g)):
            close(torch.zeros_like(tp[i]) if g is None else g, w, GRAD_RTOL, atol=1e-12, msg=f"{name} d/d{i} at {point}")


def _chains(p, rng):
    p = np.asarray(p, dtype=np.float64)
    return p[None] * (1.0 + 0.05 * rng.uniform(size=(C,) + p.shape))


@pytest.mark.parametrize("name", sorted(FAM))
def test_batch_ndims_1_is_a_loop_over_chains(name):
    """Each parameter of the point gets a chain axis (``(C, 1)`` against the
    data ``y``): the density and every cdf with ``batch_ndims=1`` against a
    loop over the chains."""
    fam = FAM[name]
    rng = np.random.default_rng(2)
    y, *params = fam.args
    cp = [t64(_chains(p, rng))[:, None] for p in params]
    if not params:  # std_normal: the chain axis on y
        y = t64(_chains(y, rng))
    kinds = ["lpdf"] + [k for k in ("cdf", "lcdf", "lccdf") if hasattr(td, f"{name}_{k}")]
    for kind in kinds:
        fn = getattr(td, f"{name}_{kind}")
        got = fn(y, *cp, batch_ndims=1)
        want = torch.stack([fn(y[c] if not params else y, *[p[c] for p in cp]) for c in range(C)])
        assert got.shape == (C,)
        close(got, want, 1e-13, msg=kind)


def _bad_parameter(fam):
    """``(index, bad row)`` of the sweep's first invalid row whose bad value
    sits in a scalar parameter (the data as in the valid row), else None."""
    y, *params = fam.args
    for bad in fam.invalid:
        i = next((j for j, (b, p) in enumerate(zip(bad[1:], params)) if np.ndim(b) == 0 and b != p and np.ndim(p) == 0), None)
        if i is not None and np.shape(bad[0]) == np.shape(y) and np.allclose(bad[0], y):
            return i, bad
    return None


@pytest.mark.parametrize("name", sorted(n for n in FAM if _bad_parameter(FAM[n]) is not None))
def test_an_invalid_chain_alone_is_neg_inf(name):
    """The sweep's first invalid row whose bad value sits in a parameter: put
    in chain 1 of 3, the other chains stay finite."""
    fam = FAM[name]
    y, *params = fam.args
    i, bad = _bad_parameter(fam)
    cp = [t64(np.full(C, float(p)))[:, None] for p in params]
    cp[i] = t64(np.array([params[i], bad[1 + i], params[i]], dtype=np.float64))[:, None]
    got = getattr(td, name + "_lpdf")(y, *cp, batch_ndims=1)
    assert bool(torch.isfinite(got[[0, 2]]).all()) and float(got[1]) == -math.inf
    for kind in ("cdf", "lcdf", "lccdf"):
        if hasattr(td, f"{name}_{kind}"):
            fn = getattr(td, f"{name}_{kind}")
            got = fn(y, *cp, batch_ndims=1)
            alone = [fn(y, *[p[c] for p in cp]) for c in range(C)]
            close(got[[0, 2]], [alone[0], alone[2]], 1e-13, msg=kind)
            close(got[1], jd.__dict__[f"{name}_{kind}"](y, *[np.asarray(p[1].numpy()) for p in cp]), CDF_RTOL, msg=kind)
