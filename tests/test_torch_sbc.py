"""PyTorch port: ``diagnostics/sbc.py`` against ``math_tpu.diagnostics.sbc``
(CPU): the ranks equal, chi2 and the p-values (the port's ``gamma_q``)
within 1e-12 relative, on the exact and mis-calibrated samplers of
``tests/test_sbc.py`` and the non-divisible bins; and an SBC loop of the
port's ``sample_nuts`` on the conjugate normal model, sized to tell a
calibrated sampler from the under-dispersed one (the reference's twin runs
20 replications of 100 + 128 transitions one after another; this one 400
replications of 100 + 32 x 4 at once: each replication is one chain of one
``sample_nuts`` call on 400 chains, every chain with its own data through a
chain-batched density).
"""

import numpy as np
import pytest
import torch

import math_tpu.diagnostics.sbc as js
import math_tpu_torch.diagnostics.sbc as ts
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)


def _exact_sbc_ranks(M, L, scale=1.0, rng=None):
    rng = rng or np.random.default_rng(0)
    theta = rng.normal(size=M)
    y = theta + rng.normal(size=M)
    post = rng.normal(y[:, None] / 2, scale * np.sqrt(0.5), size=(M, L))
    return np.sum(post < theta[:, None], axis=1)[:, None], theta, post


@pytest.mark.parametrize("scale,n_bins", [(1.0, 16), (0.6, 16), (1.0, 12), (1.3, 20)])
def test_ranks_chi2_and_p_are_the_reference(scale, n_bins):
    L = 63
    ranks, theta, post = _exact_sbc_ranks(4000, L, scale)
    for j in range(0, 4000, 397):
        np.testing.assert_array_equal(ts.sbc_rank(theta[j:j + 1], post[j][:, None]),
                                      js.sbc_rank(theta[j:j + 1], post[j][:, None]))
    got, want = ts.sbc_uniformity(ranks, L, n_bins=n_bins), js.sbc_uniformity(ranks, L, n_bins=n_bins)
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_allclose(got.chi2, want.chi2, rtol=1e-12)
    np.testing.assert_allclose(got.p_value, np.asarray(want.p_value), rtol=1e-12, atol=1e-300)
    assert got.n_bins == want.n_bins


def test_exact_calibrated_underdispersed_flagged():
    L = 63
    ok = ts.sbc_uniformity(_exact_sbc_ranks(4000, L)[0], L, n_bins=16)
    assert ok.counts.sum() == 4000 and ok.p_value[0] > 0.01
    bad = ts.sbc_uniformity(_exact_sbc_ranks(4000, L, scale=0.6)[0], L, n_bins=16)
    assert bad.p_value[0] < 1e-6
    assert bad.counts[0, 0] > 1.5 * 4000 / 16 and bad.counts[0, -1] > 1.5 * 4000 / 16


def test_nondivisible_bins_use_exact_expectations():
    rng = np.random.default_rng(4)
    res = ts.sbc_uniformity(rng.integers(0, 64, size=(3000, 1)), 63, n_bins=12)
    assert res.p_value[0] > 0.001 and res.counts.sum() == 3000
    assert ts.sbc_uniformity(rng.integers(0, 4, size=(500, 1)), 3, n_bins=20).n_bins == 4


def test_nuts_sbc_on_conjugate_model():
    """theta ~ N(0, 1), y | theta ~ N(theta, 1): one replication a chain.
    With L = 32 thinned draws in 4 bins the under-dispersed sampler of
    ``_exact_sbc_ranks`` (scale 0.6) reads chi2 ~ 3 + 0.1375 M, a
    calibrated one chi2_3 ~ 3; with the reference's limit 16, M = 400 puts
    the under-dispersed one 2.8 sd above the limit (58 +- 15; 80
    replications read 4.0, unseparated) and the calibrated one 13 above
    its mean (P = 0.001)."""
    from math_tpu_torch.infer import sample_nuts

    M, L = 400, 32
    rng = np.random.default_rng(1)
    theta = rng.normal(size=M)
    y = torch.tensor(theta + rng.normal(size=M))

    def logp(z, yv):  # chain c carries replication c's data
        return -0.5 * z[:, 0] ** 2 - 0.5 * (yv - z[:, 0]) ** 2

    res = sample_nuts(logp, torch.Generator().manual_seed(0), dim=1, args=(y,), num_warmup=100, num_samples=L,
                      num_chains=M, thin=4, device="cpu", dtype=torch.float64)
    post = res.position.reshape(M, L)
    ranks = np.stack([ts.sbc_rank(theta[j:j + 1], post[j][:, None]) for j in range(M)])
    res = ts.sbc_uniformity(ranks, L, n_bins=4)
    assert res.chi2[0] < 16.0
    assert 0 < ranks.mean() < L
    under = ts.sbc_uniformity(_exact_sbc_ranks(M, L, scale=0.6, rng=np.random.default_rng(2))[0], L, n_bins=4)
    assert under.chi2[0] > 16.0
