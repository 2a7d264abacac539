"""PyTorch port: ``infer/advi.py`` against ``math_tpu`` (CPU, float64).

Deterministic pieces exactly: the two entropies against the reference's to
1e-12, and one step of Stan's stochastic gradient ascent on given gradients
against a numpy transcription of ``math_tpu/infer/advi.py:138-157``.  The
fits are held statistically with the reference tests' own tolerances
(``tests/test_advi_smc.py:28-92``): meanfield on a Gaussian target, fullrank
on a correlated one, the eta search, eight-schools.  And the noise contract:
every eta candidate starts from the same generator state, so two equal
candidates give the same trial ELBO.
"""

import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch


from math_tpu_torch.models import eight_schools
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)

# the modules (the packages export functions of the same name)
jadvi = importlib.import_module("math_tpu.infer.advi")
tadvi = importlib.import_module("math_tpu_torch.infer.advi")

MU = np.array([1.0, -2.0, 0.5])
COV = np.diag([2.0, 0.5, 1.0])
F64 = dict(dtype=torch.float64, device="cpu")


def _gauss_target(mu, cov):
    prec = torch.tensor(np.linalg.inv(cov))
    mu = torch.tensor(mu)

    def ld(z, *args):
        d = z - mu
        return -0.5 * torch.sum((d @ prec) * d, -1)

    return ld


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_entropies_match_reference():
    rng = np.random.default_rng(0)
    omega = rng.normal(size=6)
    L = np.tril(rng.normal(size=(6, 6))) + 3.0 * np.eye(6)
    np.testing.assert_allclose(
        float(tadvi._entropy_meanfield(torch.tensor(omega))), float(jadvi._entropy_meanfield(jnp.asarray(omega))),
        rtol=1e-12,
    )
    np.testing.assert_allclose(
        float(tadvi._entropy_fullrank(torch.tensor(L))), float(jadvi._entropy_fullrank(jnp.asarray(L))), rtol=1e-12
    )


def _sga_numpy(eta, params, grads, s, t, alpha=0.1, tau=1.0, eps_pow=1e-16):
    """advi.py:138-157 in numpy: the accumulator, the rate, the update."""
    s = [np.where(t <= 1.0, np.square(g), alpha * np.square(g) + (1.0 - alpha) * sv) for g, sv in zip(grads, s)]
    lr = eta * np.power(t, -0.5 + eps_pow)
    return [p - lr * g / (tau + np.sqrt(sv)) for p, g, sv in zip(params, grads, s)], s


@pytest.mark.parametrize("t", [1.0, 2.0, 37.0])
def test_sga_update_matches_numpy_transcription(t):
    rng = np.random.default_rng(int(t))
    params = [rng.normal(size=5), rng.normal(size=15)]
    grads = [rng.normal(size=5) * 3, rng.normal(size=15)]
    s = [rng.uniform(size=5), rng.uniform(size=15)]
    want_p, want_s = _sga_numpy(0.7, params, grads, s, t)
    got_p, got_s = tadvi._sga_update(
        0.7, [torch.tensor(p) for p in params], [torch.tensor(g) for g in grads], [torch.tensor(v) for v in s], t
    )
    for g, w in zip(got_p + got_s, want_p + want_s):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-14, atol=1e-15)


def test_advi_meanfield_gaussian():
    res = tadvi.advi(_gauss_target(MU, COV), _gen(0), 3, num_steps=6000, learning_rate=1.0, num_elbo_mc=2000, **F64)
    np.testing.assert_allclose(res.mu.numpy(), MU, atol=0.1)
    np.testing.assert_allclose(np.exp(2 * res.omega.numpy()), np.diag(COV), rtol=0.25)
    # Stan termination rule fired before the step cap
    assert res.converged and res.num_steps_run < 6000
    tr = res.elbo_trace.numpy()
    assert tr[-1] > tr[0]


def test_advi_fullrank_correlated():
    A = np.array([[1.0, 0.0], [0.9, 0.5]])
    cov = A @ A.T
    res = tadvi.advi(_gauss_target(np.zeros(2), cov), _gen(1), 2, method="fullrank", num_steps=8000, learning_rate=1.0, **F64)
    got_cov = (res.L @ res.L.T).numpy()
    np.testing.assert_allclose(got_cov, cov, atol=0.25)
    s = tadvi.advi_sample(_gen(2), res, 40_000).numpy()
    np.testing.assert_allclose(np.cov(s.T), cov, atol=0.25)


def test_advi_eta_search_runs():
    res = tadvi.advi(_gauss_target(MU, COV), _gen(3), 3, num_steps=300, **F64)
    assert np.isfinite(float(res.final_elbo))
    assert res.learning_rate in (100.0, 10.0, 1.0, 0.1, 0.01)
    assert [eta for eta, _ in res.eta_trial_elbos] == [100.0, 10.0, 1.0, 0.1, 0.01]


def test_every_eta_candidate_sees_the_same_noise():
    """Two equal candidates: the trial generators are restored before each,
    so both trial ELBOs are equal bit for bit."""
    res = tadvi.advi(_gauss_target(MU, COV), _gen(4), 3, num_steps=100, eta_candidates=(1.0, 0.5, 1.0), **F64)
    (eta_a, elbo_a), (_, elbo_b), (eta_c, elbo_c) = res.eta_trial_elbos
    assert eta_a == eta_c == 1.0 and elbo_a == elbo_c and elbo_a != elbo_b


def test_advi_eight_schools():
    model = eight_schools.make()
    # 4000 steps where the reference test takes 8000: the port's run does not
    # stop early by the tolerance rule, and a CPU step is ~1.2 ms
    res = tadvi.advi(model.logp, _gen(4), model.dim, num_steps=4000, learning_rate=1.0, **F64)
    s = tadvi.advi_sample(_gen(5), res, 4000)
    mu = model.constrain(s)["mu"].numpy()
    # mean-field underestimates variance but the location should be right
    assert abs(mu.mean() - 4.4) < 1.2, mu.mean()
