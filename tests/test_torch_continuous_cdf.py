"""PyTorch port: the cdfs of ``dists/continuous.py`` (``_cdf``, ``_lcdf``,
``_lccdf``) against ``math_tpu.dists`` (CPU, float64), at the JAX package's
``CDFS`` rows and ``TAILS`` far tails (``tests/dist_fixtures.py``).

Values relative ``1e-10`` (absolute ``1e-15`` for log-cdfs near 0), with the
oracle's probabilities beside them: JAX's ``log_ndtr`` is off by up to
7.7e-12 relative in the far tail (z = -22, against mpmath), where PyTorch's
agrees with scipy to 1e-16, and its gradient there by 3.1e-9 (PyTorch's
2.6e-14), hence ``LOOSE_GRAD``.  Gradients in every argument relative
``1e-9``; those of the gamma-family cdfs in the shape go through the port's
``gamma_p`` / ``gamma_q`` (the Gautschi series of ``special/hyper.py``)
where JAX differentiates ``jsp.gammainc`` with XLA's ``igamma_grad_a``:
held at ``1e-8`` relative.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from math_tpu import dists as jd
from math_tpu.dists import continuous as jcont
from math_tpu_torch import dists as td

from dist_fixtures import CDFS, TAILS

GRAD_RTOL, CDF_RTOL, GAMMA_GRAD_RTOL = 1e-9, 1e-10, 1e-8
# JAX's log_ndtr gradient at z = -20.7 is 3.1e-9 off (mpmath); PyTorch's 2.6e-14
LOOSE_GRAD = {("normal", "lccdf"): 5e-9, ("normal", "lcdf"): 5e-9}
GAMMA_FAMILY = {"gamma", "inv_gamma", "chi_square", "inv_chi_square", "scaled_inv_chi_square"}
CONT = {n[: -len("_lpdf")] for n in dir(jcont) if n.endswith("_lpdf")}
CDF = {c.name: c for c in CDFS if c.name in CONT}


def t64(a, grad=False):
    return torch.tensor(np.asarray(a, dtype=np.float64), dtype=torch.float64, requires_grad=grad)


def close(got, want, rtol, atol=1e-300, msg=""):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


def _cdf_args(c):
    return [c.args] + c.rows


@pytest.mark.parametrize("kind", ["cdf", "lcdf", "lccdf"])
@pytest.mark.parametrize("name", sorted(CDF))
def test_cdfs_values_and_grads(name, kind):
    """Value against JAX and the oracle's probabilities; the gradient in every
    argument against JAX's."""
    c = CDF[name]
    if not hasattr(jd, f"{name}_{kind}"):
        assert not hasattr(td, f"{name}_{kind}")
        return
    jf, tf = getattr(jd, f"{name}_{kind}"), getattr(td, f"{name}_{kind}")
    for args in _cdf_args(c):
        probs = np.asarray(c.probs(*args), dtype=np.float64)
        if kind == "lccdf" and c.logsf is not None:
            oracle = np.sum(c.logsf(*args))
        else:
            oracle = {"cdf": np.prod(probs), "lcdf": np.sum(np.log(probs)), "lccdf": np.sum(np.log1p(-probs))}[kind]
        jp = [jnp.asarray(a, jnp.float64) for a in args]
        want, want_g = jax.value_and_grad(jf, tuple(range(len(jp))))(*jp)
        tp = [t64(a, grad=True) for a in args]
        got = tf(*tp)
        close(got.detach(), want, CDF_RTOL, atol=0.0 if kind == "cdf" else 1e-15)
        close(got.detach(), oracle, max(c.tol, 1e-9) if kind == "cdf" else 1e-6, atol=1e-10)
        rtol = LOOSE_GRAD.get((name, kind), GAMMA_GRAD_RTOL if name in GAMMA_FAMILY else GRAD_RTOL)
        for i, (g, w) in enumerate(zip(torch.autograd.grad(got, tp), want_g)):
            close(g, w, rtol, atol=1e-12, msg=f"{name}_{kind} d/d{i}")


@pytest.mark.parametrize("row", [r for r in TAILS if r[0] in CONT], ids=lambda r: f"{r[0]}-{r[1]}-{r[2][0]}")
def test_far_tails(row):
    name, kind, args, want, tol = row
    got = float(getattr(td, f"{name}_{kind}")(*args))
    close(got, want, tol)
    close(got, getattr(jd, f"{name}_{kind}")(*args), max(tol, CDF_RTOL))
