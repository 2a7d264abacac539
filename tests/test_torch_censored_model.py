"""PyTorch port: the top-coded negative-binomial regression of
``tools/univariate_models.py`` against the same model written with
``math_tpu``'s API, on the CPU.

Sizes: N = 2,000 rows, K = 8 features (``glm_logistic.synthetic_data``'s
design), 5% of the rows top-coded.  ``logp`` and its gradient at 8 seeded
chain-batched positions: the port in float64 against ``jax.vmap`` of the JAX
model (its NB-2 GLM with ``propto=True``: the chain-batched GLM drops
``-lgamma(y + 1)`` as the JAX package's does) within ``1e-10`` relative (an
absolute floor of ``1e-10``); the port in float32 within ``2e-4`` of the
largest magnitude.  The port's ``neg_binomial_2_lccdf`` is ``log
I_{mu/(mu+phi)}(U, phi)``, JAX's ``log1p(-I_{phi/(phi+mu)}(phi, U))``: the
same value (DLMF 8.17.4), but where ``1 - I`` is ~1e-11 (some top-coded rows
at the broad positions, scale 0.3 about alpha = 1.5, log phi = log 5) JAX's
form loses digits to cancellation (its value there 3.4e-7 off, its
phi-partial 2.5e-5).  So the JAX twin is written in both forms: with
``jd.neg_binomial_2_lccdf`` at positions near the posterior, where both
forms agree to 1e-10, and with ``math_tpu.special.inc_beta`` in the port's
form at the broad positions; the port's per-row lccdf there is held against
scipy's ``nbinom.logsf`` (``test_lccdf_tail_against_scipy``), and in float32
it stays finite where JAX's form gives ``-inf``
(``test_float32_lccdf_stays_finite``).
"""

import os
import sys

import numpy as np
import pytest
import scipy.stats as st

import jax
import jax.numpy as jnp
import torch

import math_tpu.dists as jd
import math_tpu.special as jspecial
import math_tpu.transforms as jt
from math_tpu.model import make_log_density as j_make
from math_tpu_torch.infer import run_pooled_chains
from math_tpu_torch.models import glm_logistic
from math_tpu_torch.ops import glm_fused
from math_tpu_torch.special import incbeta

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import univariate_models as um  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)

N, K, CHAINS = 2000, 8, 8
RTOL = ATOL = 1e-10
F32_REL = 2e-4


def jax_censored_nb(k, symmetric=False):
    params = {"alpha": jt.Identity(()), "beta": jt.Identity((k,)), "phi": jt.LowerBound((), 0.0)}

    def log_prob(v, x_u, y_u, x_c, u):
        alpha, beta, phi = v["alpha"], v["beta"], v["phi"]
        lp = jd.normal_lpdf(alpha, 0.0, 5.0) + jd.student_t_lpdf(beta, 3.0, 0.0, 1.0) + jd.gamma_lpdf(phi, 2.0, 0.1)
        lp = lp + jd.neg_binomial_2_log_glm_lpmf(y_u, x_u, alpha, beta, phi, propto=True)
        mu = jnp.exp(alpha + x_c @ beta)
        if symmetric:
            return lp + jnp.sum(jnp.log(jspecial.inc_beta(u, phi, mu / (mu + phi))))
        return lp + jd.neg_binomial_2_lccdf(u - 1.0, mu, phi)

    return j_make(params, log_prob)


@pytest.fixture(scope="module")
def data():
    x = glm_logistic.synthetic_data(N, K)[0]
    return um.censored_nb_data(x, seed=0)


def test_top_code_is_the_five_percent_point(data):
    y = data["y"]
    # independently: the largest observed value whose upper share is >= 5%
    candidates = [u for u in range(int(y.max()) + 1) if np.mean(y >= u) >= 0.05]
    assert data["U"] == max(candidates)
    assert 0.05 <= data["share"] < 0.10
    assert len(data["x_u"]) + len(data["x_c"]) == N and np.all(data["y_u"] < data["U"])


def positions(dim, seed, scale=0.3):
    z = np.random.default_rng(seed).normal(size=(CHAINS, dim)) * scale
    z[:, 0] += 1.5  # alpha near its generating value
    z[:, -1] += np.log(5.0)  # log phi
    return z


def jax_logp_grad(model, z, args):
    f = jax.jit(jax.vmap(jax.value_and_grad(lambda th: model.logp(th, *args))))
    lp, g = f(jnp.asarray(z))
    return np.asarray(lp), np.asarray(g)


@pytest.mark.parametrize("scale", [0.3, 0.03], ids=["broad", "near"])
@pytest.mark.parametrize("naive", [False, True], ids=["censored", "naive"])
def test_logp_and_grad_against_jax(data, naive, scale):
    tmodel, jmodel = um.make_censored_nb(K), jax_censored_nb(K, symmetric=scale == 0.3)
    assert tmodel.dim == jmodel.dim == K + 2
    x_u, y_u, x_c, u = um.censored_args(data, device="cpu", dtype=torch.float64, naive=naive)
    jargs = (x_u.numpy(), y_u.numpy(), x_c.numpy(), u)
    z = positions(tmodel.dim, 1, scale)
    if scale == 0.03:
        z[:, 1:-1] += data["beta"]
    want_lp, want_g = jax_logp_grad(jmodel, z, jargs)
    assert np.isfinite(want_lp).all()
    incbeta.reset_counts()
    lp, g = tmodel.logp_and_grad(torch.tensor(z), x_u, y_u, x_c, u)
    np.testing.assert_allclose(lp.numpy(), want_lp, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(g.numpy(), want_g, rtol=RTOL, atol=ATOL)
    assert incbeta.LENTZ["calls"] >= (0 if naive else 1)
    args32 = um.censored_args(data, device="cpu", dtype=torch.float32, naive=naive)
    lp32, g32 = tmodel.logp_and_grad(torch.tensor(z, dtype=torch.float32), *args32)
    assert lp32.dtype == torch.float32
    np.testing.assert_allclose(lp32.double().numpy(), want_lp, rtol=0, atol=F32_REL * np.abs(want_lp).max())
    np.testing.assert_allclose(g32.double().numpy(), want_g, rtol=0, atol=F32_REL * np.abs(want_g).max())


def test_the_glm_rows_go_through_the_chain_batched_dispatcher(data):
    """On CPU tensors the NB-2 GLM takes its plain version, once a call."""
    tmodel = um.make_censored_nb(K)
    args = um.censored_args(data, device="cpu", dtype=torch.float64)
    glm_fused.reset_counts()
    tmodel.logp_and_grad(torch.tensor(positions(tmodel.dim, 2)), *args)
    assert glm_fused.PLAIN_CALLS["neg_binomial_2_log"] == 1
    assert sum(glm_fused.LAYOUT_COPIES.values()) == 0


def test_a_few_transitions(data):
    tmodel = um.make_censored_nb(K)
    args = um.censored_args(data, device="cpu", dtype=torch.float64)
    gen = torch.Generator().manual_seed(0)
    z0 = tmodel.initial_positions(gen, 4, 0.5, device="cpu", dtype=torch.float64)
    res = run_pooled_chains(gen, z0, tmodel.logp, args=args, num_warmup=4, num_samples=2, max_depth=3, device="cpu")
    assert res.position.shape == (4, 2, K + 2) and bool(torch.isfinite(res.position).all())


def test_float32_lccdf_stays_finite():
    """P(Y >= 15) for NB2(mu = 0.27, phi = 1) is ~7e-11: the port's float32
    lccdf is finite and within 1e-5 of float64; ``log1p(-I)`` in float32 is
    ``-inf`` there (``I`` rounds to 1)."""
    from math_tpu_torch import dists

    args = (14.0, torch.tensor([0.27, 2.0]), torch.tensor([1.0, 5.0]))
    got = dists.neg_binomial_2_lccdf(*args, batch_ndims=1)
    want = dists.neg_binomial_2_lccdf(14.0, args[1].double(), args[2].double(), batch_ndims=1)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=1e-5)
    np.testing.assert_allclose(want.numpy(), [float(jd.neg_binomial_2_lccdf(14.0, m, p)) for m, p in ((0.27, 1.0), (2.0, 5.0))],
                               rtol=1e-6)
    naive = torch.log1p(-torch.special.betainc(*[torch.tensor(v) for v in (1.0, 15.0, 1.0 / 1.27)])) if hasattr(
        torch.special, "betainc") else torch.log1p(-torch.tensor(1.0))
    assert not bool(torch.isfinite(naive))


def test_lccdf_tail_against_scipy(data):
    """At the broad positions: the port's per-row lccdf of every chain against
    scipy's ``nbinom.logsf`` (1e-12 relative), where JAX's ``log1p(-I)``
    form is off by up to ~1e-5 relative on the rows with the smallest tails."""
    from math_tpu_torch import dists

    z = positions(K + 2, 1, 0.3)
    alpha, beta, phi = z[:, 0], z[:, 1:-1], np.exp(z[:, -1])
    mu = np.exp(alpha[:, None] + beta @ data["x_c"].astype(np.float64).T)
    got = dists.neg_binomial_2_lccdf(data["U"] - 1.0, torch.tensor(mu), torch.tensor(phi)[:, None])
    want = st.nbinom.logsf(data["U"] - 1, phi[:, None], phi[:, None] / (phi[:, None] + mu))
    np.testing.assert_allclose(float(got), want.sum(), rtol=1e-12)
    per_row = dists.neg_binomial_2_lccdf(data["U"] - 1.0, torch.tensor(mu[2]), phi[2], batch_ndims=1)
    assert per_row.shape == mu[2].shape
    np.testing.assert_allclose(per_row.numpy(), want[2], rtol=1e-12)


def test_sweep_evaluates_every_special_function_as_a_special_function():
    """``univariate_models.evaluate`` sums a special function by row; the
    names ``dists`` re-exports from ``special`` (``inc_beta``, ``owens_t``)
    take the special-function path, not a density's ``batch_ndims``."""
    from math_tpu_torch import special

    for name, args in um.special_inputs(rows=3, cols=4).items():
        value, grads = um.evaluate(name, args, um.SPECIAL_FLOATS[name], "cpu", torch.float64)
        want = getattr(special, name)(*[torch.tensor(a, dtype=torch.float64) if np.asarray(a).dtype.kind == "f"
                                        else torch.tensor(a) for a in args]).sum(-1)
        np.testing.assert_allclose(value.numpy(), want.detach().numpy(), rtol=1e-12)
        assert len(grads) == len(um.SPECIAL_FLOATS[name])
