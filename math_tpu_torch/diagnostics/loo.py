"""PSIS-LOO cross-validation and WAIC (downstream ``loo`` package parity).

Counterpart: ``math_tpu/diagnostics/loo.py``.  Vehtari, Gelman, Gabry (2017):
approximate leave-one-out expected log predictive density from posterior
draws by importance sampling with PSIS-stabilized weights
(``diagnostics.psis``), plus WAIC and paired model comparison.

Inputs are pointwise log-likelihood matrices — ``log_lik[..., s, i] =
log p(y_i | theta_s)`` with draws flattened over chains — as numpy arrays or
tensors on any device; ``pointwise_log_lik`` builds one on the draws' device
from a chain-batched per-observation log likelihood.

The work runs where the matrix is, in float64 (the reference's precision),
a chunk of observations at a time: ``loo`` smooths every observation of a
chunk at once (``psis_smooth_batched``), where the reference loops over
them one by one.  A (12,800, 100,000) float32 matrix on the card takes a
few hundred MiB of float64 temporaries a chunk.  Results: the sums as Python
floats, the pointwise vectors as float64 tensors on the matrix's device.
"""

from __future__ import annotations

import math
import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch

from math_tpu_torch.diagnostics.psis import psis_smooth_batched

__all__ = ["LooResult", "WaicResult", "LooComparison", "loo", "waic", "loo_compare", "pointwise_log_lik"]

# float64 elements of a chunk of the (draws, observations) matrix (256 MiB).
_CHUNK_ELEMENTS = 1 << 25


class LooResult(NamedTuple):
    elpd_loo: float  # expected log pointwise predictive density (sum)
    se_elpd_loo: float
    p_loo: float  # effective number of parameters
    looic: float  # -2 elpd_loo (deviance scale)
    pointwise: torch.Tensor  # (n_obs,) elpd_loo_i
    pareto_k: torch.Tensor  # (n_obs,) PSIS shape diagnostics
    n_bad_k: int  # observations with k_hat > 0.7 (unreliable)


class WaicResult(NamedTuple):
    elpd_waic: float
    se_elpd_waic: float
    p_waic: float
    waic: float  # -2 elpd_waic
    pointwise: torch.Tensor
    n_high_var: int  # observations with posterior log-lik var > 0.4


def _flatten_draws(log_lik):
    ll = torch.as_tensor(log_lik)
    if ll.ndim == 3:  # (chains, draws, n_obs)
        ll = ll.reshape(-1, ll.shape[-1])
    if ll.ndim != 2:
        raise ValueError(
            "log_lik must be (draws, n_obs) or (chains, draws, n_obs); got "
            f"shape {tuple(ll.shape)}"
        )
    return ll


def _chunks(ll):
    s, n = ll.shape
    step = max(1, _CHUNK_ELEMENTS // max(s, 1))
    for start in range(0, n, step):
        yield start, ll[:, start:start + step].to(torch.float64)


def _se(pointwise):
    n = pointwise.numel()
    return float(torch.sqrt(n * pointwise.var(unbiased=False)))


def loo(log_lik, *, k_threshold: float = 0.7) -> LooResult:
    """PSIS-LOO elpd from a pointwise log-likelihood matrix.

    Per observation i the leave-one-out importance ratios are
    ``r_s = 1 / p(y_i | theta_s)``; their log weights are PSIS-smoothed
    and the elpd contribution is the self-normalized estimate

        elpd_i = logsumexp(lw_i + ll_i) - logsumexp(lw_i).

    ``pareto_k[i] > 0.7`` flags an unreliable contribution (refit without
    observation i, or use moment matching); the count is surfaced and
    warned on, never silently dropped.
    """
    ll = _flatten_draws(log_lik)
    s, n = ll.shape
    pointwise = torch.empty(n, dtype=torch.float64, device=ll.device)
    ks = torch.empty(n, dtype=torch.float64, device=ll.device)
    lpd = torch.empty(n, dtype=torch.float64, device=ll.device)
    for start, c in _chunks(ll):
        lw, k = psis_smooth_batched(-c)
        stop = start + c.shape[1]
        pointwise[start:stop] = torch.logsumexp(lw + c, 0) - torch.logsumexp(lw, 0)
        ks[start:stop] = k
        lpd[start:stop] = torch.logsumexp(c, 0) - math.log(s)  # in-sample pointwise lpd
    p_loo = float((lpd - pointwise).sum())
    elpd = float(pointwise.sum())
    se = _se(pointwise)
    n_bad = int((ks > k_threshold).sum())
    if n_bad:
        warnings.warn(
            f"PSIS-LOO: {n_bad}/{n} observations have Pareto k_hat > "
            f"{k_threshold}; their elpd contributions are unreliable "
            "(consider refitting without them or moment matching)",
            stacklevel=2,
        )
    return LooResult(elpd, se, p_loo, -2.0 * elpd, pointwise, ks, n_bad)


def waic(log_lik) -> WaicResult:
    """Widely applicable information criterion (Watanabe 2010; the
    variance-based p_waic of Gelman, Hwang, Vehtari 2014 eq. 12)."""
    ll = _flatten_draws(log_lik)
    s, n = ll.shape
    pointwise = torch.empty(n, dtype=torch.float64, device=ll.device)
    p_i = torch.empty(n, dtype=torch.float64, device=ll.device)
    for start, c in _chunks(ll):
        stop = start + c.shape[1]
        p_i[start:stop] = c.var(0, unbiased=True)
        pointwise[start:stop] = torch.logsumexp(c, 0) - math.log(s) - p_i[start:stop]
    n_high = int((p_i > 0.4).sum())
    if n_high:
        warnings.warn(
            f"WAIC: {n_high}/{n} observations have posterior log-lik "
            "variance > 0.4; p_waic is unreliable there — prefer PSIS-LOO",
            stacklevel=2,
        )
    elpd = float(pointwise.sum())
    return WaicResult(elpd, _se(pointwise), float(p_i.sum()), -2.0 * elpd, pointwise, n_high)


class LooComparison(NamedTuple):
    elpd_diff: float  # elpd_a - elpd_b (positive favors model a)
    se_diff: float  # paired SE of the pointwise differences
    z: float  # elpd_diff / se_diff


def loo_compare(a: LooResult, b: LooResult) -> LooComparison:
    """Paired comparison of two LOO results on the SAME observations.

    The SE uses the pointwise differences (the `loo` package's
    ``loo_compare``), which is much tighter than differencing the two
    marginal SEs when the models' pointwise elpds are correlated.
    """
    pa, pb = torch.as_tensor(a.pointwise), torch.as_tensor(b.pointwise)
    if pa.shape != pb.shape:
        raise ValueError(
            "loo_compare needs results on the same observations; got "
            f"{tuple(pa.shape)} vs {tuple(pb.shape)}"
        )
    d = pa.to(torch.float64) - pb.to(device=pa.device, dtype=torch.float64)
    diff = float(d.sum())
    se = _se(d)
    return LooComparison(diff, se, diff / se if se > 0 else np.inf)


def pointwise_log_lik(log_lik_fn: Callable, draws, *args) -> torch.Tensor:
    """(draws..., n_obs) pointwise log-likelihood matrix from a model's
    per-observation log-lik function, on the draws' device.

    ``log_lik_fn(theta (S, dim), *args) -> (S, n_obs)`` is chain-batched like
    every density of the port; ``draws`` is (draws, dim) or (chains, draws,
    dim): the leading axes are flattened into one call and restored (the
    JAX package vmaps a per-draw function over them).
    """
    draws = torch.as_tensor(draws)
    lead = tuple(draws.shape[:-1])
    with torch.no_grad():
        out = log_lik_fn(draws.reshape(-1, draws.shape[-1]), *args)
    return out.reshape(lead + tuple(out.shape[1:]))
