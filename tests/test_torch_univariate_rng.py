"""PyTorch port: every ``_rng`` of ``dists/{continuous,discrete,more}.py``
(CPU generator, float64 parameters).

Each draws 200,000 values (the DLM rng 2,000 sequences) from a seeded
``torch.Generator``: the mean and the variance (of a statistic where the
draws' own are not finite or not the point: the median for cauchy, the
cosine about the mean direction for von Mises) within 5 Monte-Carlo standard
errors of the closed forms of ``tools/univariate_models.py`` ``RNG_ROWS``
(scipy.stats' moments), and the same draws again from a generator with the
same seed.  Draws cannot equal JAX's (counter-based ``jax.random`` against
PyTorch's Philox / Mersenne Twister), so the moments stand in.
"""

import os
import sys

import numpy as np
import pytest
import torch

from math_tpu_torch import dists as td
from math_tpu_torch.dists import continuous, discrete, more

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import univariate_models as um  # noqa: E402

N = 200_000
Z_LIMIT = 5.0


def gen(seed):
    return torch.Generator().manual_seed(seed)


def test_every_rng_has_a_row():
    names = sorted(n[: -len("_rng")] for mod in (continuous, discrete, more) for n in mod.__all__ if n.endswith("_rng"))
    assert sorted(set(um.RNG_ROWS) | {"gaussian_dlm_obs", "matrix_normal_prec"}) == names


@pytest.mark.parametrize("name", sorted(um.RNG_ROWS))
def test_moments_and_replay(name):
    draws = um.rng_draws(name, gen(7), N)
    assert bool(torch.isfinite(draws).all())
    z = um.rng_z_scores(name, draws)
    assert max(abs(v) for v in z.values()) < Z_LIMIT, z
    again = um.rng_draws(name, gen(7), N)
    assert torch.equal(draws, again)
    assert not torch.equal(draws, um.rng_draws(name, gen(8), N))


def test_integer_draws_and_supports():
    g = gen(1)
    assert td.poisson_rng(g, 2.5, (10,)).dtype == torch.int32
    assert td.bernoulli_rng(g, 0.3, (10,)).dtype == torch.int32
    h = td.hypergeometric_rng(g, 5, 6, 8, (5000,))
    assert int(h.min()) >= 0 and int(h.max()) <= 5
    o = td.ordered_logistic_rng(g, 0.3, torch.tensor(um.CUTS), (5000,))
    assert set(np.unique(o.numpy())) <= {1, 2, 3, 4}
    v = td.von_mises_rng(g, 0.5, 60.0, (5000,))
    assert float(v.abs().max()) <= np.pi + 1e-6
    s = td.std_normal_rng(g, (3, 4))
    assert s.shape == (3, 4) and s.dtype == torch.float64


def test_matrix_normal_prec_rng():
    r = np.random.default_rng(3)
    n, p = 3, 2
    a, b = r.normal(size=(n, n)), r.normal(size=(p, p))
    sigma, d = a @ a.T + n * np.eye(n), b @ b.T + p * np.eye(p)
    mu = r.normal(size=(n, p))
    ys = td.matrix_normal_prec_rng(gen(1), mu, sigma, d, shape=(N,)).numpy()
    assert ys.shape == (N, n, p)
    cov = np.kron(np.linalg.inv(d), np.linalg.inv(sigma))
    vecs = ys.transpose(0, 2, 1).reshape(N, n * p)
    se = np.sqrt(np.diag(cov) / N)
    assert np.max(np.abs(vecs.mean(0) - mu.T.ravel()) / se) < Z_LIMIT
    np.testing.assert_allclose(np.cov(vecs.T), cov, atol=0.02 * np.abs(cov).max())
    assert torch.equal(td.matrix_normal_prec_rng(gen(1), mu, sigma, d, shape=(5,)),
                       td.matrix_normal_prec_rng(gen(1), mu, sigma, d, shape=(5,)))


def test_gaussian_dlm_obs_rng_local_level():
    """The local-level model: y_t has mean 0 and variance C0 + t W + V."""
    F, G, V, W, m0, C0 = np.eye(1), np.eye(1), np.eye(1) * 0.5, np.eye(1) * 0.2, np.zeros(1), np.eye(1)
    T, reps = 6, 2000
    g = gen(2)
    ys = np.stack([td.gaussian_dlm_obs_rng(g, F, G, V, W, m0, C0, T).numpy() for _ in range(reps)])
    assert ys.shape == (reps, 1, T)
    var = 1.0 + 0.2 * np.arange(1, T + 1) + 0.5
    assert np.max(np.abs(ys[:, 0].mean(0)) / np.sqrt(var / reps)) < Z_LIMIT
    assert np.max(np.abs(ys[:, 0].var(0) / var - 1.0)) < 5.0 * np.sqrt(2.0 / reps)
