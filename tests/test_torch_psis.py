"""PyTorch port: ``diagnostics/psis.py`` against ``math_tpu.diagnostics.psis``
(CPU, float64).

- ``gpd_fit`` / ``psis_smooth`` (the plain version, host numpy) equal the JAX
  package's functions to 1e-12 relative on seeded inputs;
- ``gpd_fit_batched`` / ``psis_smooth_batched`` (observations as columns of
  a tensor) equal the plain version column by column to 1e-12 relative, at
  every branch of ``gpd_fit`` (fewer than 5 exceedances, a largest
  exceedance <= 0, ``|k| < 1e-12`` through the smoothing, a flat profile)
  and with tied weights, where the smoothed values are compared by rank;
- the twins of ``tests/test_pathfinder.py:32-56``.
"""

import numpy as np
import pytest
import torch

import math_tpu.diagnostics.psis as jp
import math_tpu_torch.diagnostics.psis as tp
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)


def _weights(seed, s=2000, n=6):
    rng = np.random.default_rng(seed)
    cols = [rng.standard_t(df=df, size=s) for df in (3, 5, 30)]
    cols += [rng.exponential(size=s), rng.normal(size=s) * 0.01, np.round(rng.normal(size=s), 1)]  # the last has ties
    return np.stack(cols[:n], axis=1)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_version_is_the_reference(seed):
    lw = _weights(seed)
    for i in range(lw.shape[1]):
        got, k = tp.psis_smooth(lw[:, i])
        want, kw = jp.psis_smooth(lw[:, i])
        np.testing.assert_allclose(np.sort(got), np.sort(want), rtol=1e-12, atol=1e-300)
        assert k == pytest.approx(kw, rel=1e-12)
    x = np.abs(lw[:40, 0])
    np.testing.assert_allclose(tp.gpd_fit(x), jp.gpd_fit(x), rtol=1e-12)


@pytest.mark.parametrize("s", [7, 30, 2000])
def test_batched_equals_plain_by_column(s):
    lw = _weights(3, s=s)
    got, k = tp.psis_smooth_batched(torch.tensor(lw))
    for i in range(lw.shape[1]):
        want, kw = tp.psis_smooth(lw[:, i])
        # ties: compare the smoothed values by rank (neither sort is stable)
        np.testing.assert_allclose(np.sort(got[:, i].numpy()), np.sort(want), rtol=1e-12, atol=1e-300)
        if len(np.unique(lw[:, i])) == s:
            np.testing.assert_allclose(got[:, i].numpy(), want, rtol=1e-12, atol=1e-300)
        assert float(k[i]) == pytest.approx(kw, rel=1e-12) or (np.isinf(kw) and np.isinf(float(k[i])))


def test_gpd_fit_batched_branches():
    rng = np.random.default_rng(4)
    x = rng.exponential(size=(50, 5))
    x[:, 1] = 0.0  # largest exceedance <= 0
    x[:, 2] = 1.0  # flat: every candidate's profile the same
    x[:, 3] = rng.pareto(3.0, size=50)
    k, sigma = tp.gpd_fit_batched(torch.tensor(x))
    for i in range(x.shape[1]):
        kw, sw = tp.gpd_fit(x[:, i])
        assert float(k[i]) == pytest.approx(kw, rel=1e-12, abs=1e-300) or (np.isnan(kw) and np.isnan(float(k[i])))
        assert float(sigma[i]) == pytest.approx(sw, rel=1e-12, abs=1e-300) or (np.isnan(sw) and np.isnan(float(sigma[i])))
    k4, s4 = tp.gpd_fit_batched(torch.tensor(x[:4]))  # fewer than 5 exceedances
    for i in range(x.shape[1]):
        assert (float(k4[i]), float(s4[i])) == pytest.approx(tp.gpd_fit(x[:4, i]), rel=1e-12)


def test_zero_shape_branch_of_the_smoothing(monkeypatch):
    """``|k| < 1e-12`` takes the logarithmic quantiles; data do not reach
    it through the regularised fit, so both fits are replaced by one that
    returns k = 0 (and then k = -0.2) and the two versions compared."""
    lw = _weights(5, s=500)[:, :2]
    for k_fixed in (0.0, -0.2):
        monkeypatch.setattr(tp, "gpd_fit", lambda x, k=k_fixed: (k, 0.7))
        monkeypatch.setattr(tp, "gpd_fit_batched", lambda x, k=k_fixed: (torch.full((x.shape[1],), k, dtype=x.dtype),
                                                                         torch.full((x.shape[1],), 0.7, dtype=x.dtype)))
        got, _ = tp.psis_smooth_batched(torch.tensor(lw))
        for i in range(2):
            np.testing.assert_allclose(got[:, i].numpy(), tp.psis_smooth(lw[:, i])[0], rtol=1e-12, atol=1e-300)


def test_gpd_fit_recovers_shape():
    rng = np.random.default_rng(0)
    for k_true in (0.2, 0.5):
        u = rng.uniform(size=4000)
        x = ((1.0 - u) ** (-k_true) - 1.0) / k_true  # GPD(k, sigma=1)
        k, sigma = tp.gpd_fit(x)
        kb, sb = tp.gpd_fit_batched(torch.tensor(x)[:, None])
        assert abs(k - k_true) < 0.08, (k_true, k)
        assert abs(sigma - 1.0) < 0.12
        assert float(kb[0]) == pytest.approx(k, rel=1e-12) and float(sb[0]) == pytest.approx(sigma, rel=1e-12)


def test_psis_smooth_basics():
    rng = np.random.default_rng(1)
    lw = rng.standard_t(df=5, size=2000)  # heavy-ish importance weights
    sm, k_hat = tp.psis_smooth(lw)
    assert np.isfinite(sm).all() and np.isfinite(k_hat)
    assert sm.max() <= 0.0 + 1e-12
    assert (np.argsort(lw) == np.argsort(sm)).mean() > 0.99
    sm2, _ = tp.psis_smooth(np.zeros(500))
    np.testing.assert_allclose(sm2, 0.0, atol=1e-12)
    smb, _ = tp.psis_smooth_batched(torch.zeros(500, 3, dtype=torch.float64))
    np.testing.assert_allclose(smb.numpy(), 0.0, atol=1e-12)
