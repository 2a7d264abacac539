"""Simulation-based calibration (Talts, Betancourt, Simpson, Vehtari, Gelman
2018).

Counterpart: ``math_tpu/diagnostics/sbc.py``.  For each of M replications:
draw theta~ from the prior, simulate y~ from the likelihood, sample the
posterior given y~, and record the RANK of theta~ among L (effectively
independent) posterior draws per scalar quantity.  If the sampler is exact,
every rank is uniform on {0, ..., L}; deviations have characteristic shapes
(U-shaped: posterior under-dispersed; peaked: over-dispersed; sloped:
biased).

Host-side numpy, as in the reference: ranks are an analysis-time statistic.
The p-values come from the port's ``special.gamma_q`` in float64.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["SbcResult", "sbc_rank", "sbc_uniformity"]


def sbc_rank(prior_draw, posterior_draws):
    """Rank statistic(s): #{posterior draws < prior draw} per quantity.

    ``prior_draw``: (dim,) the simulated ground truth; ``posterior_draws``:
    (L, dim) posterior draws given data simulated from it (arrays or
    tensors).  Returns (dim,) integer ranks in [0, L].  Posterior draws
    should be thinned to near-independence first (Talts et al. §5.1).
    """
    prior_draw = np.asarray(torch.as_tensor(prior_draw).detach().cpu())
    post = np.asarray(torch.as_tensor(posterior_draws).detach().cpu())
    return np.sum(post < prior_draw[None, :], axis=0)


class SbcResult(NamedTuple):
    counts: np.ndarray  # (dim, n_bins) histogram of ranks
    chi2: np.ndarray  # (dim,) Pearson statistic vs uniform
    p_value: np.ndarray  # (dim,) chi-squared tail probability
    n_bins: int


def sbc_uniformity(ranks, num_posterior_draws, n_bins: int = 20) -> SbcResult:
    """Pearson chi-squared uniformity check of SBC ranks.

    ``ranks``: (M, dim) rank statistics over M replications, each in
    [0, num_posterior_draws].  Bins the L+1 possible ranks into
    ``n_bins`` equal-probability bins and tests each quantity's histogram
    against uniformity; the p-value uses the chi-squared survival
    function Q((n_bins-1)/2, chi2/2) via ``special.gamma_q``.  Small
    p-values flag mis-calibration — but SBC is a diagnostic, not a gate:
    inspect the histogram shape (U / peak / slope) to see HOW it fails.
    """
    from math_tpu_torch.special import gamma_q

    r = np.asarray(ranks)
    if r.ndim == 1:
        r = r[:, None]
    M, dim = r.shape
    L = int(num_posterior_draws)
    n_bins = min(n_bins, L + 1)
    # INTEGER bin edges with exact per-bin expectations: the ranks take
    # L+1 discrete values, so when n_bins does not divide L+1 the bins
    # hold different numbers of rank values — a flat M/n_bins expectation
    # would then read systematic chi2 even from a perfectly calibrated
    # sampler
    edges = np.round(np.linspace(0, L + 1, n_bins + 1)).astype(np.int64)
    counts = np.stack(
        [np.histogram(r[:, d], bins=edges)[0] for d in range(dim)]
    )
    expected = M * np.diff(edges) / (L + 1.0)
    chi2 = ((counts - expected) ** 2 / expected).sum(axis=1)
    a = torch.full((dim,), (n_bins - 1) / 2.0, dtype=torch.float64)
    p = gamma_q(a, torch.as_tensor(chi2 / 2.0, dtype=torch.float64)).numpy()
    return SbcResult(counts, chi2, p, n_bins)
