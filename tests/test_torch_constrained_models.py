"""PyTorch port: the two user models of ``tools/constrained_models.py``
(varying slopes, constrained prior) against the same models written with
``math_tpu``'s API, on the CPU.

``logp`` and its gradient at 8 seeded chain-batched positions: the port in
float64 against ``jax.vmap`` of the JAX model within ``1e-10`` relative (an
absolute floor of ``1e-10``); the port in float32 against the same within
``2e-4`` of the largest magnitude (the float32 unit roundoff, ~6e-8, times the
~1e3 terms a logp sums).  Sizes: 8 groups, K = 3, 80 observations.  Also the
position layout of both models (``free`` of the JAX model's constrained values
is the JAX model's position) and the varying-slopes gradient repeatable bit
for bit.
"""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import math_tpu.dists as jd
import math_tpu.transforms as jt
from math_tpu.model import make_log_density as j_make
from math_tpu.ops import linalg as jl

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import constrained_models as cm  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)

GROUPS, K, PER_GROUP, CHAINS = 8, 3, 10, 8
RTOL = ATOL = 1e-10
F32_REL = 2e-4


def jax_varying_slopes(groups, k):
    params = {"Omega": jt.CorrMatrix((k, k)), "tau": jt.LowerBound((k,), 0.0), "mu": jt.Identity((k,)),
              "beta": jt.Identity((groups, k)), "sigma": jt.LowerBound((), 0.0)}

    def log_prob(v, x, g, y):
        lp = jd.lkj_corr_lpdf(v["Omega"], 2.0)
        lp = lp + jd.cauchy_lpdf(v["tau"], 0.0, 2.5)
        lp = lp + jd.normal_lpdf(v["mu"], 0.0, 5.0)
        lp = lp + jd.multi_normal_lpdf(v["beta"], v["mu"], jl.quad_form_diag(v["Omega"], v["tau"]))
        lp = lp + jd.cauchy_lpdf(v["sigma"], 0.0, 2.5)
        return lp + jd.normal_lpdf(y, jnp.sum(x * v["beta"][g], axis=-1), v["sigma"])

    return j_make(params, log_prob)


def jax_constrained_prior():
    b = {"L_corr": jt.CholeskyCorr((6, 6)), "R_corr": jt.CorrMatrix((4, 4)), "theta": jt.Simplex((8,)),
         "W": jt.CovMatrix((3, 3)), "V": jt.CovMatrix((3, 3)), "u": jt.Bounded((), -1.0, 3.0), "ub": jt.UpperBound((), 2.0),
         "om": jt.OffsetMultiplier((), 3.0, 2.0), "dir": jt.UnitVector((4,)), "L_cov": jt.CholeskyCov((4, 3)),
         "t": jt.Identity((3,)), "z": jt.Identity((3,))}

    def log_prob(v):
        lp = jd.lkj_corr_cholesky_lpdf(v["L_corr"], cm.ETA_CHOL)
        lp = lp + jd.lkj_corr_lpdf(v["R_corr"], cm.ETA_CORR)
        lp = lp + jd.dirichlet_lpdf(v["theta"], cm.ALPHA)
        lp = lp + jd.wishart_lpdf(v["W"], cm.NU_WISHART, cm.S_WISHART)
        lp = lp + jd.inv_wishart_lpdf(v["V"], cm.NU_INV_WISHART, cm.S_WISHART)
        lp = lp + jd.normal_lpdf(v["ub"], 0.0, 1.0) + jd.normal_lpdf(v["om"], 3.0, 2.0)
        L = v["L_cov"]
        lp = lp + jd.normal_lpdf(L[cm.LCOV_ROWS, cm.LCOV_COLS], 0.0, 1.0)
        lp = lp + jd.lognormal_lpdf(jnp.diagonal(L), 0.0, 0.5)
        lp = lp + jd.multi_student_t_lpdf(v["t"], cm.NU_T, cm.MU_T, cm.SIGMA_T)
        return lp + jd.multi_normal_prec_lpdf(v["z"], cm.MU_PREC, cm.OMEGA_PREC)

    return j_make(b, log_prob)


@pytest.fixture(scope="module")
def varying_slopes():
    x, g, y, truth = cm.varying_slopes_data(GROUPS, K, PER_GROUP, seed=3)
    return cm.make_varying_slopes(GROUPS, K), jax_varying_slopes(GROUPS, K), (x, g, y), truth


def positions(dim, seed):
    return np.random.default_rng(seed).normal(size=(CHAINS, dim)) * 0.7


def jax_logp_grad(model, z, data):
    f = jax.jit(jax.vmap(jax.value_and_grad(lambda th: model.logp(th, *data))))
    lp, g = f(jnp.asarray(z))
    return np.asarray(lp), np.asarray(g)


def torch_data(data, dtype):
    x, g, y = data
    return torch.tensor(x, dtype=dtype), torch.tensor(g), torch.tensor(y, dtype=dtype)


def check(tmodel, jmodel, z, data, tdata64, tdata32):
    want_lp, want_g = jax_logp_grad(jmodel, z, data)
    assert np.isfinite(want_lp).all()
    lp, g = tmodel.logp_and_grad(torch.tensor(z), *tdata64)
    np.testing.assert_allclose(lp.numpy(), want_lp, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(g.numpy(), want_g, rtol=RTOL, atol=ATOL)
    lp32, g32 = tmodel.logp_and_grad(torch.tensor(z, dtype=torch.float32), *tdata32)
    assert lp32.dtype == torch.float32
    np.testing.assert_allclose(lp32.double().numpy(), want_lp, rtol=0, atol=F32_REL * np.abs(want_lp).max())
    np.testing.assert_allclose(g32.double().numpy(), want_g, rtol=0, atol=F32_REL * np.abs(want_g).max())


def test_varying_slopes_against_jax(varying_slopes):
    tmodel, jmodel, data, _ = varying_slopes
    assert tmodel.dim == jmodel.dim == K * (K - 1) // 2 + 2 * K + GROUPS * K + 1
    check(tmodel, jmodel, positions(tmodel.dim, 0), data, torch_data(data, torch.float64), torch_data(data, torch.float32))


def test_constrained_prior_against_jax():
    tmodel, jmodel = cm.make_constrained_prior(), jax_constrained_prior()
    assert tmodel.dim == jmodel.dim == 62
    check(tmodel, jmodel, positions(tmodel.dim, 1), (), (), ())


def test_varying_slopes_layout_and_repeatable(varying_slopes):
    tmodel, jmodel, data, truth = varying_slopes
    values = {"Omega": truth["Omega"], "tau": truth["tau"], "mu": truth["mu"], "beta": truth["beta"],
              "sigma": np.asarray(truth["sigma"])}
    np.testing.assert_allclose(tmodel.ravel_constrained(values).numpy(), np.asarray(jmodel.ravel_constrained(values)),
                               rtol=1e-12, atol=1e-12)
    z = torch.tensor(positions(tmodel.dim, 2))
    a = tmodel.logp_and_grad(z, *torch_data(data, torch.float64))
    b = tmodel.logp_and_grad(z, *torch_data(data, torch.float64))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_prior_layout_and_moments_table():
    tmodel, jmodel = cm.make_constrained_prior(), jax_constrained_prior()
    theta = positions(tmodel.dim, 4)[0]
    jvals = {k: np.asarray(v) for k, v in jmodel.constrain(jnp.asarray(theta)).items()}
    np.testing.assert_allclose(tmodel.ravel_constrained(jvals).numpy(), np.asarray(jmodel.ravel_constrained(jvals)),
                               rtol=1e-10, atol=1e-10)
    draws = {k: v.double().numpy()[:, None] for k, v in tmodel.transform_draws(torch.tensor(positions(tmodel.dim, 5))).items()}
    table = cm.prior_moments(draws)
    assert set(table) >= {"L_corr_r", "R_corr_r2", "theta", "W", "V", "u", "ub", "om", "dir", "L_cov", "t", "z"}
    for name, (vals, expected) in table.items():
        assert vals.shape[:2] == (CHAINS, 1) and vals.shape[-1] == expected.shape[-1], name
