"""PyTorch port: ``diagnostics/loo.py`` against ``math_tpu.diagnostics.loo``
(CPU, float64): elpd, se, p_loo, the pointwise vectors and Pareto k of
``loo`` and ``waic`` at 1e-10 relative on the conjugate normal model of
``tests/test_loo.py`` and on heavy-tailed matrices, with the observations
taken a few at a time (a small chunk) and all at once; ``loo_compare``;
``pointwise_log_lik`` on a chain-batched function; the warnings; and the
twins of ``tests/test_loo.py`` (the exact conjugate LOO).
"""

import importlib
import warnings

import numpy as np
import pytest
import torch

import math_tpu_torch.diagnostics as td
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)

jl = importlib.import_module("math_tpu.diagnostics.loo")  # the package's ``loo`` is the function
S2, T2, N_OBS, N_DRAWS = 1.0, 4.0, 40, 8000


def _data():
    return np.random.default_rng(7).normal(1.2, np.sqrt(S2), N_OBS)


def _posterior_draws(y, rng):
    prec = y.size / S2 + 1.0 / T2
    return rng.normal((y.sum() / S2) / prec, np.sqrt(1.0 / prec), N_DRAWS)


def _exact_elpd_loo(y):
    out = 0.0
    for i in range(y.size):
        rest = np.delete(y, i)
        prec = rest.size / S2 + 1.0 / T2
        mean = (rest.sum() / S2) / prec
        var = 1.0 / prec + S2
        out += -0.5 * np.log(2 * np.pi * var) - 0.5 * (y[i] - mean) ** 2 / var
    return out


def _log_lik_matrix(mu_draws, y, s2=S2):
    return -0.5 * np.log(2 * np.pi * s2) - 0.5 * (y[None, :] - mu_draws[:, None]) ** 2 / s2


def _matrices():
    y = _data()
    mu = _posterior_draws(y, np.random.default_rng(0))
    heavy = np.random.default_rng(3).standard_t(df=2.5, size=(1200, 25)) - 3.0
    return {"conjugate": _log_lik_matrix(mu, y), "wide": _log_lik_matrix(mu, y, s2=25.0), "heavy": heavy}


def _close(got, want, rtol=1e-10):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got, dtype=torch.float64)), np.asarray(want), rtol=rtol, atol=1e-12)


@pytest.mark.parametrize("name", ["conjugate", "wide", "heavy"])
@pytest.mark.parametrize("chunk_elements", [None, 7 * 8000])
def test_loo_and_waic_are_the_reference(name, chunk_elements, monkeypatch):
    if chunk_elements:  # a few observations a chunk
        monkeypatch.setattr(importlib.import_module("math_tpu_torch.diagnostics.loo"), "_CHUNK_ELEMENTS", chunk_elements)
    ll = _matrices()[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want, got = jl.loo(ll), td.loo(torch.tensor(ll))
        wwant, wgot = jl.waic(ll), td.waic(torch.tensor(ll))
    for i in (0, 1, 2, 3):
        _close(got[i], want[i])
    _close(got.pointwise, want.pointwise)
    _close(got.pareto_k, want.pareto_k)
    assert got.n_bad_k == want.n_bad_k
    for i in (0, 1, 2, 3):
        _close(wgot[i], wwant[i])
    _close(wgot.pointwise, wwant.pointwise)
    assert wgot.n_high_var == wwant.n_high_var
    assert got.pointwise.dtype == torch.float64


def test_psis_loo_matches_exact_conjugate_loo():
    y = _data()
    res = td.loo(_log_lik_matrix(_posterior_draws(y, np.random.default_rng(0)), y))
    assert abs(res.elpd_loo - _exact_elpd_loo(y)) < 0.1
    assert res.n_bad_k == 0 and bool((res.pareto_k < 0.7).all())
    assert 0.5 < res.p_loo < 2.0
    assert res.looic == pytest.approx(-2.0 * res.elpd_loo)
    w = td.waic(_log_lik_matrix(_posterior_draws(y, np.random.default_rng(1)), y))
    assert w.n_high_var == 0 and 0.5 < w.p_waic < 2.0


def test_loo_compare_and_chain_axis():
    y = _data()
    mu = _posterior_draws(y, np.random.default_rng(2))
    good, bad = td.loo(_log_lik_matrix(mu, y)), td.loo(_log_lik_matrix(mu, y, s2=25.0))
    cmp = td.loo_compare(good, bad)
    want = jl.loo_compare(jl.loo(_log_lik_matrix(mu, y)), jl.loo(_log_lik_matrix(mu, y, s2=25.0)))
    _close(list(cmp), list(want))
    assert cmp.elpd_diff > 0 and cmp.z > 4.0
    with pytest.raises(ValueError):
        td.loo_compare(good, td.loo(_log_lik_matrix(mu, y[:10])))
    ll = _log_lik_matrix(mu, y)
    assert td.loo(ll.reshape(4, -1, N_OBS)).elpd_loo == pytest.approx(td.loo(ll).elpd_loo)


def test_pointwise_log_lik_is_chain_batched():
    y = torch.tensor(_data())
    mu = _posterior_draws(_data(), np.random.default_rng(3))

    def ll_fn(theta, yv):  # (S, 1) -> (S, n_obs)
        return -0.5 * np.log(2 * np.pi * S2) - 0.5 * (yv[None, :] - theta[:, :1]) ** 2 / S2

    draws = torch.tensor(mu[:400].reshape(4, 100, 1))
    mat = td.pointwise_log_lik(ll_fn, draws, y)
    assert tuple(mat.shape) == (4, 100, N_OBS) and mat.device == draws.device
    _close(mat.reshape(-1, N_OBS), _log_lik_matrix(mu, _data())[:400], rtol=1e-14)


def test_pathological_weights_flagged():
    lw = np.random.default_rng(5).exponential(size=4000)
    with pytest.warns(UserWarning, match="Pareto k_hat"):
        res = td.loo(-lw[:, None])
    assert res.n_bad_k == 1 and float(res.pareto_k[0]) > 0.7
    with pytest.warns(UserWarning, match="WAIC"):
        td.waic(np.random.default_rng(6).normal(scale=3.0, size=(500, 3)))
