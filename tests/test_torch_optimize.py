"""PyTorch port: ``infer/optimize.py`` against ``math_tpu.infer.optimize``
(CPU, float64): the optimum of ``map_estimate`` within 1e-6 of JAX's
(Gaussian, the jacobian semantics, eight-schools; the chain-batched L-BFGS
takes the same number of iterations as ``optax.lbfgs`` there), the Hessian
at the same mode within 1e-8 relative, ``log_q`` and the draws exact given
the same standard normals, and the twins of ``tests/test_optimize.py``;
lanes of ``lbfgs`` that converge or stall stop on their own.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import math_tpu.infer.optimize as jo
from math_tpu import dists as jd, transforms as jt
from math_tpu.model import make_log_density as j_make
from math_tpu.models import eight_schools as j8
from math_tpu_torch import dists as td, transforms as tt
from math_tpu_torch.infer import optimize as to
from math_tpu_torch.model import make_log_density as t_make
from math_tpu_torch.models import eight_schools as t8
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)

MU = np.array([1.0, -2.0, 0.5])
COV = np.array([[2.0, 0.4, 0.0], [0.4, 0.5, -0.1], [0.0, -0.1, 1.0]])
PREC = np.linalg.inv(COV)
CPU64 = dict(device="cpu", dtype=torch.float64)


def _jgauss(z, *args):
    d = z - jnp.asarray(MU)
    return -0.5 * d @ jnp.asarray(PREC) @ d


def _tgauss(z, *args):
    d = z - torch.tensor(MU)
    return -0.5 * ((d @ torch.tensor(PREC)) * d).sum(-1)


def _lognormal_models():
    spec = {"sigma": jt.LowerBound(shape=(), lb=0.0)}
    jm = j_make(spec, lambda p: jd.lognormal_lpdf(p["sigma"], 0.0, 0.5))
    tm = t_make({"sigma": tt.LowerBound(shape=(), lb=0.0)},
                lambda p: td.lognormal_lpdf(p["sigma"], 0.0, 0.5, batch_ndims=1))
    return jm, tm


def test_map_gaussian_is_the_reference():
    want, got = jo.map_estimate(_jgauss, 3), to.map_estimate(_tgauss, 3, **CPU64)
    assert got.converged and want.converged
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta), atol=1e-6)
    np.testing.assert_allclose(got.theta.numpy(), MU, atol=1e-6)
    assert abs(float(got.value)) < 1e-10
    assert got.iterations == want.iterations


def test_map_jacobian_semantics():
    jm, tm = _lognormal_models()
    unadj = to.map_estimate(tm.logp, tm.dim, jacobian=False, unadjusted_fn=tm.logp_unadjusted, **CPU64)
    adj = to.map_estimate(tm.logp, tm.dim, jacobian=True, **CPU64)
    assert abs(float(tm.constrain(unadj.theta)["sigma"]) - np.exp(-0.25)) < 1e-4
    assert abs(float(tm.constrain(adj.theta)["sigma"]) - 1.0) < 1e-4
    want = jo.map_estimate(jm.logp, jm.dim, jacobian=False, unadjusted_fn=jm.logp_unadjusted)
    np.testing.assert_allclose(unadj.theta.numpy(), np.asarray(want.theta), atol=1e-6)


@pytest.fixture(scope="module")
def eight_schools_laplace():
    jm = j8.make()
    return jm, jo.laplace_sample(jm.logp, jax.random.PRNGKey(1), jm.dim, num_samples=4000)


def test_map_and_hessian_eight_schools(eight_schools_laplace):
    jm, want = eight_schools_laplace
    tm = t8.make()
    got = to.laplace_sample(tm.logp, torch.Generator().manual_seed(1), tm.dim, num_samples=4000, **CPU64)
    assert got.opt.converged and want.opt.converged
    np.testing.assert_allclose(got.mode.numpy(), np.asarray(want.mode), atol=1e-6)
    assert got.opt.iterations == want.opt.iterations
    # the Hessian at the same mode
    h = to.hessian(tm.logp, torch.tensor(np.asarray(want.mode)))
    scale = np.max(np.abs(np.asarray(want.hessian)))
    np.testing.assert_allclose(0.5 * (h + h.T).numpy(), np.asarray(want.hessian), rtol=0, atol=1e-8 * scale)
    # given JAX's standard normals, the draws and log_q are JAX's
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (4000, jm.dim), jnp.float64))
    draws, log_q, _ = to._gaussian_draws(torch.tensor(np.asarray(want.mode)), torch.tensor(np.asarray(want.hessian)),
                                         torch.tensor(z))
    np.testing.assert_allclose(draws.numpy(), np.asarray(want.draws), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(log_q.numpy(), np.asarray(want.log_q), rtol=1e-10)
    # the reference's smoke checks
    d = got.draws
    assert torch.isfinite(d).all()
    mu = tm.transform_draws(d)["mu"].numpy()
    mode_mu = float(tm.constrain(got.mode)["mu"])
    assert abs(mu.mean() - mode_mu) < 4.0 * mu.std() / np.sqrt(len(mu))
    assert abs(4.4 - mu.mean()) < 1.5 * mu.std()
    assert torch.isfinite(got.log_p - got.log_q).all()


def test_laplace_gaussian_is_exact():
    res = to.laplace_sample(_tgauss, torch.Generator().manual_seed(0), 3, num_samples=20000, **CPU64)
    np.testing.assert_allclose(res.mode.numpy(), MU, atol=1e-6)
    np.testing.assert_allclose(res.hessian.numpy(), -PREC, atol=1e-8)
    d = res.draws.numpy()
    np.testing.assert_allclose(d.mean(0), MU, atol=0.05)
    np.testing.assert_allclose(np.cov(d.T), COV, atol=0.08)
    assert float((res.log_p - res.log_q).std()) < 1e-6


def test_lbfgs_lanes_stop_on_their_own():
    """Four lanes: two Gaussians from different starts, one that converges at
    once, one whose density is -inf past a wall (its line search fails):
    the converged lanes report it, the failing one stops stalled with a
    finite gradient norm, and none runs to ``max_iters``."""
    prec = torch.tensor(PREC)

    def fun(z):
        d = z - torch.tensor(MU)
        v = 0.5 * ((d @ prec) * d).sum(-1)
        v = torch.where((z[:, 0] > 1.5) & (torch.arange(4) == 3), torch.inf, v)
        return v, d @ prec

    z0 = torch.tensor([[5.0, 5.0, 5.0], [-3.0, 0.0, 2.0], list(MU), [1.4, 3.0, 3.0]], dtype=torch.float64)
    res = to.lbfgs(fun, z0, max_iters=200)
    assert res.converged[:3].tolist() == [True, True, True]
    assert int(res.iterations[2]) == 0 and int(res.iterations.max()) < 200
    assert bool(torch.isfinite(res.z).all()) and bool(torch.isfinite(res.grad).all())
    assert bool(res.stalled[3]) and not bool(res.converged[3])


def test_lbfgs_float32_lanes_stall_at_their_noise_floor():
    """A float32 logistic regression whose objective sits near 6e4 (one ulp
    ~4e-3, as the GLM's on the card): ``tol=1e-8`` is out of reach, so each
    lane stops stalled (after at most ``_STALL_ITERS`` iterations without a
    decrease of more than 4 ulps), not at ``max_iters``, with a finite
    gradient norm,
    at the float64 optimum to float32's noise."""
    rng = np.random.default_rng(0)
    x64 = torch.tensor(rng.normal(size=(2000, 3)))
    y64 = (torch.tensor(rng.uniform(size=2000)) < torch.sigmoid(x64 @ torch.tensor([1.0, -0.5, 0.3], dtype=torch.float64))).double()

    def make(x, y):
        def fun(z):
            eta = z @ x.T
            return (torch.nn.functional.softplus(eta) - y * eta).sum(-1) + 6e4, (torch.sigmoid(eta) - y) @ x
        return fun

    z0 = torch.tensor([[2.0, 2.0, 2.0], [0.0, 0.0, 0.0]], dtype=torch.float64)
    ref = to.lbfgs(make(x64, y64), z0, max_iters=200)
    assert ref.converged.all()
    fun = make(x64.float(), y64.float())
    res = to.lbfgs(fun, z0.float(), max_iters=200, record=True)
    assert res.stalled.all() and not res.converged.any()
    assert int(res.iterations.max()) < 200 and bool(torch.isfinite(res.grad).all())
    # each lane's iterations since its last decrease of more than 4 ulps:
    # at least its last one (a failed line search stops a lane at once), at
    # most ``_STALL_ITERS`` (the rule that stopped one of them)
    vals = torch.stack([fun(z)[0] for z, _, _ in res.path])  # (iterations + 1, C)
    eps = torch.finfo(torch.float32).eps
    flat = []
    for c in range(2):
        v, k = vals[: int(res.iterations[c]) + 1, c].tolist(), 0
        while k + 1 < len(v) and v[-k - 2] - v[-k - 1] <= 4.0 * eps * abs(v[-k - 2]):
            k += 1
        flat.append(k)
    assert min(flat) >= 1 and max(flat) == to._STALL_ITERS, flat
    np.testing.assert_allclose(res.z.double().numpy(), ref.z.numpy(), atol=1e-3)
