"""PyTorch port: the log-density layer against ``math_tpu.model`` (CPU, float64).

``LogDensity.logp`` and its gradient for eight-schools and for the logistic
GLM (n=500, k=5, 4 chains; the likelihood goes through the fused GLM op, here
its plain version) against ``jax.vmap(jax.value_and_grad(model.logp))`` at
``rtol=1e-10`` (float64 both sides; the GLM sums 500 terms in another order).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from math_tpu.models import eight_schools as jes
from math_tpu.models import glm_logistic as jglm

from math_tpu_torch import transforms
from math_tpu_torch.model import make_log_density
from math_tpu_torch.models import eight_schools as tes
from math_tpu_torch.models import glm_logistic as tglm
from math_tpu_torch.ops import glm_fused
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)

RTOL = 1e-10
C = 4


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close(got, want, rtol=RTOL, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def test_eight_schools_logp_and_grad():
    jm, tm = jes.make(), tes.make()
    assert tm.dim == jm.dim == 10
    z = np.random.default_rng(0).normal(size=(C, jm.dim))
    want, want_g, want_un = jax.jit(lambda q: jax.vmap(jax.value_and_grad(jm.logp))(q) + (jax.vmap(jm.logp_unadjusted)(q),))(
        jnp.asarray(z))
    got, got_g = tm.logp_and_grad(t64(z))
    assert got.shape == (C,) and got_g.shape == (C, tm.dim)
    close(got, want)
    close(got_g, want_g)
    close(tm.logp(t64(z[0])), want[0])  # a single point gives the scalar
    close(tm.logp_unadjusted(t64(z)), want_un)


def test_glm_logistic_logp_and_grad_through_the_fused_op():
    n, k = 500, 5
    X, y, _, _ = tglm.synthetic_data(n, k, seed=3, dtype=np.float64)
    Xj, yj, _, _ = jglm.synthetic_data(n, k, seed=3, dtype=np.float64)
    assert np.array_equal(X, Xj) and np.array_equal(y, yj)  # same data for both packages
    jm, tm = jglm.make(k), tglm.make(k)
    z = np.random.default_rng(1).normal(size=(C, jm.dim)) * 0.5
    want, want_g = jax.jit(jax.vmap(jax.value_and_grad(lambda th: jm.logp(th, jnp.asarray(X), y))))(jnp.asarray(z))
    before = glm_fused.PLAIN_CALLS["bernoulli_logit"]
    got, got_g = tm.logp_and_grad(t64(z), t64(X), t64(y))
    assert glm_fused.PLAIN_CALLS["bernoulli_logit"] == before + 1
    close(got, want)
    close(got_g, want_g)


def test_unravel_constrain_transform_draws():
    jm, tm = jes.make(), tes.make()
    rng = np.random.default_rng(2)
    z = rng.normal(size=(C, jm.dim))
    blocks = tm.unravel(t64(z))
    assert blocks["mu"].shape == (C,) and blocks["tau"].shape == (C,) and blocks["theta_tilde"].shape == (C, 8)
    cons = tm.constrain(t64(z))
    jcons = jax.vmap(jm.constrain)(jnp.asarray(z))
    for name in jcons:
        close(cons[name], jcons[name], rtol=1e-12)
    vals, lj = tm.constrain_lp(t64(z))
    _, jlj = jax.vmap(jm.constrain_lp)(jnp.asarray(z))
    assert lj.shape == (C,)
    close(lj, jlj, rtol=1e-12)
    draws = rng.normal(size=(3, 7, jm.dim))
    got = tm.transform_draws(t64(draws))
    want = jm.transform_draws(jnp.asarray(draws))
    for name in want:
        assert tuple(got[name].shape) == tuple(want[name].shape)
        close(got[name], want[name], rtol=1e-12)
    theta = tm.ravel_constrained({k: v[0] for k, v in cons.items()})
    close(theta, z[0], rtol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_initial_positions(dtype):
    tm = tes.make()
    g = torch.Generator().manual_seed(0)
    z0 = tm.initial_positions(g, 64, device="cpu", dtype=dtype)
    assert z0.shape == (64, 10) and z0.dtype == dtype and z0.device.type == "cpu"
    assert float(z0.min()) >= -2.0 and float(z0.max()) <= 2.0 and float(z0.std()) > 0.9
    g2 = torch.Generator().manual_seed(0)
    assert torch.equal(z0, tm.initial_positions(g2, 64, device="cpu", dtype=dtype))


def test_make_log_density_packs_blocks_in_order():
    ld = make_log_density(
        {"a": transforms.Identity(shape=(2,)), "s": transforms.LowerBound(shape=(), lb=1.0), "m": transforms.Identity(shape=(2, 2))},
        lambda p: p["a"].sum(-1) + p["s"] + p["m"].sum((-1, -2)),
    )
    assert ld.dim == 7
    z = t64(np.arange(14.0).reshape(2, 7) * 0.1)
    want = z[:, :2].sum(-1) + torch.exp(z[:, 2]) + 1.0 + z[:, 3:].sum(-1) + z[:, 2]
    close(ld.logp(z), want, rtol=1e-14)
