"""Pareto-smoothed importance sampling (PSIS).

Counterpart: ``math_tpu/diagnostics/psis.py``.  Vehtari, Simpson, Gelman,
Yao, Gabry (2024): fit a generalized Pareto distribution to the largest
importance ratios, replace them by the expected order statistics of the fit,
truncate at the raw maximum, and report the shape k_hat as a reliability
diagnostic (k_hat < 0.7 usable).  The GPD fit is the Zhang & Stephens (2009)
quasi-Bayesian profile estimator, as in Stan's PSIS implementation.

Two forms of each function:

- ``gpd_fit`` / ``psis_smooth``: the reference's, host-side numpy on one
  vector of weights (the plain version; Pathfinder's one pooled vector);
- ``gpd_fit_batched`` / ``psis_smooth_batched``: the same arithmetic for
  many vectors at once, the observations of PSIS-LOO, as ``(draws, n)``
  tensors on any device.  ``gpd_fit``'s branches are masks (fewer than 5
  exceedances, a largest exceedance <= 0, ``|k| < 1e-12``, a profile with no
  finite point), the sort is ``torch.sort`` along the draws, and the
  ``m = 30 + floor(sqrt(M))`` profile candidates by ``M`` exceedances are
  evaluated a chunk of columns at a time.

Where log weights tie, which of the tied draws takes which smoothed value may
differ from numpy's ``argsort`` (neither sort is stable); the set of values,
and so every estimate built from them, does not.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["gpd_fit", "psis_smooth", "gpd_fit_batched", "psis_smooth_batched", "psis_tail_size"]

# Elements of the (candidates, exceedances, columns) profile a chunk of
# columns of ``gpd_fit_batched`` holds at once (256 MiB in float64).
_PROFILE_CHUNK = 1 << 25


def gpd_fit(x):
    """(k, sigma) of a generalized Pareto fit to exceedances ``x`` >= 0.

    Zhang & Stephens (2009) profile posterior-mean estimator; the same
    estimator PSIS prescribes (no location parameter; x are exceedances
    over the cutpoint).
    """
    x = np.sort(np.asarray(x, dtype=np.float64))
    n = x.size
    if n < 5 or x[-1] <= 0:
        return 0.5, float(max(x.mean() if n else 1.0, 1e-300))
    x = np.maximum(x, 1e-300 * x[-1])  # guard exact-tie zeros
    prior_bs = 3.0
    m = 30 + int(np.sqrt(n))
    jj = np.arange(1, m + 1)
    xstar = max(x[int(np.floor(n / 4.0 + 0.5)) - 1], 1e-12 * x[-1])
    bs = 1.0 / x[-1] + (1.0 - np.sqrt(m / (jj - 0.5))) / (prior_bs * xstar)
    # Zhang-Stephens work in the k_ZS = -xi convention: F = 1-(1-bx)^{1/k},
    # b = k/sigma; profile MLE k(b) = -mean(log(1 - b x))
    ks = -np.mean(np.log1p(-bs[:, None] * x[None, :]), axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        L = n * (np.log(bs / ks) + ks - 1.0)
    L = np.where(np.isfinite(L), L, -np.inf)
    w = np.exp(L - L.max())
    w = w / w.sum()
    b = np.sum(bs * w)
    k_zs = -float(np.mean(np.log1p(-b * x)))
    sigma = k_zs / b
    k = -k_zs  # modern xi convention (positive = heavy tail)
    # PSIS regularization toward k=0.5 with 10 pseudo-observations
    k = (n * k + 5.0) / (n + 10.0)
    return float(k), float(sigma)


def psis_tail_size(n):
    """M = min(ceil(0.2 n), ceil(3 sqrt(n))), the tail PSIS smooths."""
    return int(min(np.ceil(0.2 * n), np.ceil(3.0 * np.sqrt(n))))


def psis_smooth(log_weights):
    """(smoothed log weights, k_hat) — the PSIS transform.

    Tail size M = min(0.2 n, 3 sqrt(n)) as prescribed; weights below the
    cutpoint are untouched; smoothed tail weights are truncated at the
    raw maximum.  k_hat > 0.7 signals an unreliable importance
    approximation (report it; do not silently resample).
    """
    lw = np.asarray(log_weights, dtype=np.float64).copy()
    n = lw.size
    if n < 10:
        return lw - lw.max(), float("inf")
    m = psis_tail_size(n)
    if m < 5:
        return lw - lw.max(), float("inf")
    lw_max = lw.max()
    lw = lw - lw_max  # stabilize; smoothing is shift-invariant
    order = np.argsort(lw)
    tail_idx = order[-m:]
    cut = lw[order[-m - 1]]
    exceed = np.exp(lw[tail_idx]) - np.exp(cut)
    k, sigma = gpd_fit(exceed)
    if np.isfinite(k) and sigma > 0:
        # expected order statistics of the fitted GPD
        p = (np.arange(1, m + 1) - 0.5) / m
        if abs(k) < 1e-12:
            q = -np.log1p(-p) * sigma
        else:
            q = sigma * np.expm1(-k * np.log1p(-p)) / k  # sigma*((1-p)^-k -1)/k
        smoothed = np.log(np.exp(cut) + q)
        # preserve the rank order of the original tail
        rank = np.argsort(lw[tail_idx])
        lw[tail_idx[rank]] = np.minimum(smoothed, 0.0)  # truncate at max
    return lw, float(k)


def _gpd_columns(x):
    """``gpd_fit`` on sorted exceedances ``x (n, M)``, one fit a row, M >= 5,
    every row with ``x[:, -1] > 0`` (the caller masks the others)."""
    n_exc = x.shape[1]
    x = torch.maximum(x, 1e-300 * x[:, -1:])
    m = 30 + int(np.sqrt(n_exc))
    jj = torch.arange(1, m + 1, dtype=x.dtype, device=x.device)
    xstar = torch.maximum(x[:, int(np.floor(n_exc / 4.0 + 0.5)) - 1], 1e-12 * x[:, -1])
    bs = 1.0 / x[:, -1:] + (1.0 - torch.sqrt(m / (jj - 0.5))) / (3.0 * xstar[:, None])  # (n, m)
    ks = -torch.log1p(-bs[:, :, None] * x[:, None, :]).mean(-1)
    L = n_exc * (torch.log(bs / ks) + ks - 1.0)
    L = torch.where(torch.isfinite(L), L, -math.inf)
    w = torch.exp(L - L.amax(-1, keepdim=True))
    w = w / w.sum(-1, keepdim=True)
    b = (bs * w).sum(-1)
    k_zs = -torch.log1p(-b[:, None] * x).mean(-1)
    sigma = k_zs / b
    k = (n_exc * -k_zs + 5.0) / (n_exc + 10.0)
    return k, sigma


def gpd_fit_batched(x):
    """``gpd_fit`` of every column of ``x (M, n)`` (exceedances, any order):
    ``(k (n,), sigma (n,))`` on ``x``'s device and dtype."""
    x = torch.sort(torch.as_tensor(x).t(), dim=-1).values  # (n, M)
    n, n_exc = x.shape
    if n_exc < 5:
        mean = x.mean(-1) if n_exc else torch.ones(n, dtype=x.dtype, device=x.device)
        return torch.full((n,), 0.5, dtype=x.dtype, device=x.device), torch.clamp_min(mean, 1e-300)
    degenerate = x[:, -1] <= 0
    xs = torch.where(degenerate[:, None], 1.0, x)
    m = 30 + int(np.sqrt(n_exc))
    step = max(1, _PROFILE_CHUNK // (m * n_exc))
    ks, sigmas = [], []
    for s in range(0, n, step):
        k, sigma = _gpd_columns(xs[s:s + step])
        ks.append(k)
        sigmas.append(sigma)
    k, sigma = torch.cat(ks), torch.cat(sigmas)
    k = torch.where(degenerate, 0.5, k)
    sigma = torch.where(degenerate, torch.clamp_min(x.mean(-1), 1e-300), sigma)
    return k, sigma


def psis_smooth_batched(log_weights):
    """``psis_smooth`` of every column of ``log_weights (S, n)`` at once:
    ``(smoothed log weights (S, n), k_hat (n,))`` on the input's device and
    dtype (float64 for the reference's arithmetic)."""
    lw = torch.as_tensor(log_weights)
    s, n = lw.shape
    lw = lw.t()  # (n, S): sort along the contiguous axis
    lw = lw - lw.amax(-1, keepdim=True)
    m = psis_tail_size(s)
    if s < 10 or m < 5:
        return lw.t().contiguous(), torch.full((n,), math.inf, dtype=lw.dtype, device=lw.device)
    sorted_lw, order = torch.sort(lw, dim=-1)
    cut = sorted_lw[:, -m - 1]
    exceed = torch.exp(sorted_lw[:, -m:]) - torch.exp(cut)[:, None]  # (n, m), ascending
    k, sigma = gpd_fit_batched(exceed.t())
    p = (torch.arange(1, m + 1, dtype=lw.dtype, device=lw.device) - 0.5) / m
    log1m_p = torch.log1p(-p)
    small = k.abs() < 1e-12
    k_safe = torch.where(small, 1.0, k)
    q = torch.where(small[:, None], -log1m_p * sigma[:, None],
                    sigma[:, None] * torch.expm1(-k_safe[:, None] * log1m_p) / k_safe[:, None])
    smoothed = torch.clamp_max(torch.log(torch.exp(cut)[:, None] + q), 0.0)
    ok = torch.isfinite(k) & (sigma > 0)
    tail = torch.where(ok[:, None], smoothed, sorted_lw[:, -m:])
    out = lw.scatter(-1, order[:, -m:], tail)
    return out.t().contiguous(), k
