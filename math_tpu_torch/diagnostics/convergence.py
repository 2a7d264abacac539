"""Convergence diagnostics: split-R-hat and effective sample size.

Counterpart: ``math_tpu/diagnostics/convergence.py`` (the port keeps its own
copy: it imports nothing of the JAX package).  Implements the rank-normalized
split-R-hat and bulk/tail ESS of Vehtari, Gelman, Simpson, Carpenter, Bürkner
(2021) with Geyer initial-monotone autocorrelation truncation — the same
estimator family Stan's analyze module uses.

Post-processing runs host-side in numpy: move draws off the device first
(``result.position.cpu().numpy()``).  Input convention: draws shaped
(chains, num_samples) or (chains, num_samples, dim).
"""

from __future__ import annotations

import numpy as np
import scipy.special as sp


def _split(x):
    """(m, n) -> (2m, n//2) split-in-half chains."""
    m, n = x.shape
    half = n // 2
    return np.concatenate([x[:, :half], x[:, half : 2 * half]], axis=0)


def _rank_normalize(x):
    """Fractional ranks -> inverse normal (Vehtari et al 2021 eq. 14)."""
    shape = x.shape
    flat = x.reshape(-1)
    ranks = np.argsort(np.argsort(flat)) + 1.0
    u = (ranks - 0.375) / (flat.size + 0.25)
    return sp.ndtri(u).reshape(shape)


def _rhat_one(x):
    """Split R-hat of one (chains, n) array (already transformed)."""
    x = _split(np.asarray(x, np.float64))
    m, n = x.shape
    if n < 2:
        return np.nan
    chain_mean = x.mean(axis=1)
    chain_var = x.var(axis=1, ddof=1)
    w = chain_var.mean()
    b = n * chain_mean.var(ddof=1)
    var_plus = (n - 1) / n * w + b / n
    if w == 0:
        return np.nan
    return float(np.sqrt(var_plus / w))


def _acov_fft(x):
    """Per-chain autocovariance via FFT, biased (divided by n)."""
    m, n = x.shape
    xc = x - x.mean(axis=1, keepdims=True)
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, nfft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), nfft, axis=1)[:, :n].real
    return acov / n


def _ess_one(x):
    """ESS of one (chains, n) array via Geyer initial monotone sequence."""
    x = _split(np.asarray(x, np.float64))
    m, n = x.shape
    if n < 4:
        return np.nan
    chain_mean = x.mean(axis=1)
    chain_var = x.var(axis=1, ddof=1)
    w = chain_var.mean()
    b = n * chain_mean.var(ddof=1) if m > 1 else 0.0
    var_plus = (n - 1) / n * w + (b / n if m > 1 else 0.0)
    if var_plus == 0 or not np.isfinite(var_plus):
        return np.nan
    acov = _acov_fft(x).mean(axis=0)
    rho = 1.0 - (w - acov) / var_plus
    rho[0] = 1.0
    # Geyer: sum of adjacent pairs, keep while positive, enforce monotone
    max_pairs = (n - 1) // 2
    tau = 0.0
    prev = np.inf
    s = 0.0
    for k in range(max_pairs):
        pair = rho[2 * k] + rho[2 * k + 1]
        if pair <= 0:
            break
        pair = min(pair, prev)
        prev = pair
        s += pair
    tau = -1.0 + 2.0 * s
    tau = max(tau, 1.0 / np.log10(max(m * n, 10)))
    return float(m * n / tau)


def _apply(x, fn):
    x = np.asarray(x)
    if x.ndim == 2:
        return fn(x)
    return np.array([fn(x[:, :, i]) for i in range(x.shape[-1])])


def rhat(x):
    """Plain split R-hat (no rank normalization)."""
    return _apply(x, _rhat_one)


def split_rhat(x):
    """Rank-normalized split R-hat: max of bulk and folded variants."""

    def one(xx):
        bulk = _rhat_one(_rank_normalize(xx))
        folded = _rhat_one(_rank_normalize(np.abs(xx - np.median(xx))))
        return max(bulk, folded)

    return _apply(x, one)


def ess(x):
    """Raw (non-rank-normalized) ESS of the mean."""
    return _apply(x, _ess_one)


def ess_bulk(x):
    return _apply(x, lambda xx: _ess_one(_rank_normalize(xx)))


def ess_tail(x):
    """min of the 5% / 95% quantile-indicator ESSs."""

    def one(xx):
        q05, q95 = np.quantile(xx, [0.05, 0.95])
        e1 = _ess_one((xx <= q05).astype(np.float64))
        e2 = _ess_one((xx <= q95).astype(np.float64))
        return np.nanmin([e1, e2])

    return _apply(x, one)


def summary(x, names=None):
    """Per-parameter table: mean, sd, split_rhat, ess_bulk, ess_tail."""
    x = np.asarray(x)
    if x.ndim == 2:
        x = x[:, :, None]
    dim = x.shape[-1]
    names = names or [f"theta[{i}]" for i in range(dim)]
    rows = []
    for i in range(dim):
        xi = x[:, :, i]
        rows.append(
            dict(
                name=names[i],
                mean=float(xi.mean()),
                sd=float(xi.std()),
                rhat=float(split_rhat(xi)),
                ess_bulk=float(ess_bulk(xi)),
                ess_tail=float(ess_tail(xi)),
            )
        )
    return rows
