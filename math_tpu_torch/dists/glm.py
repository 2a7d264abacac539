"""GLM likelihoods, plain PyTorch.

Counterpart: ``math_tpu/dists/glm.py`` (reference:
``prim/mat/prob/{bernoulli_logit,poisson_log,normal_id}_glm_*.hpp``):
``eta = x @ beta + alpha`` once, then the elementwise log density and its sum.
The chain-batched fused versions, which read ``x`` once for the value and all
parameter gradients in a hand-written CUDA kernel, are in
``math_tpu_torch/ops/glm_fused.py``.

With ``batch_ndims=1`` the parameters carry a leading chain axis: ``alpha
(C,)``, ``beta (C, K)``, ``sigma (C,)`` / ``phi (C,)``, ``cuts (C, K-1)``, and
for the categorical GLM ``alpha (C, K)``, ``beta (C, D, K)``; the result is
``(C,)``.
"""

from __future__ import annotations

import numpy as np
import torch

from math_tpu_torch.special import LOG_SQRT_TWO_PI
from math_tpu_torch.utils.propto import include_summand
from math_tpu_torch.utils.batch import sum_event
from math_tpu_torch.dists._util import _like, as_tensors
from math_tpu_torch.dists.discrete import _category_index, neg_binomial_2_log_lpmf, ordered_logistic_lpmf

__all__ = [
    "bernoulli_logit_glm_lpmf",
    "poisson_log_glm_lpmf",
    "neg_binomial_2_log_glm_lpmf",
    "normal_id_glm_lpdf",
    "ordered_logistic_glm_lpmf",
    "categorical_logit_glm_lpmf",
]


def _eta(x, alpha, beta, batch_ndims):
    """(eta, dtype, device); eta is (..., N) with the chain axes leading."""
    dt, device = _like(x, alpha, beta)
    x = torch.as_tensor(x, dtype=dt, device=device)
    beta = torch.as_tensor(beta, dtype=dt, device=device)
    alpha = torch.as_tensor(alpha, dtype=dt, device=device)
    if alpha.ndim == batch_ndims and batch_ndims > 0:
        alpha = alpha[..., None]  # one intercept per chain
    return beta @ x.mT + alpha, dt, device


def bernoulli_logit_glm_lpmf(y, x, alpha, beta, *, propto=False, batch_ndims=0):
    """sum_n log Bernoulli(y_n | logit^-1(x_n . beta + alpha)).

    Ref: bernoulli_logit_glm_lpmf.hpp:50-137.
    """
    eta, dt, device = _eta(x, alpha, beta, batch_ndims)
    y = torch.as_tensor(y, dtype=dt, device=device)
    ok = torch.all((y == 0.0) | (y == 1.0))  # ref: check_bounded(y, 0, 1)
    sign = 2.0 * y - 1.0
    lp = torch.zeros(eta.shape[:batch_ndims], dtype=dt, device=device)
    if include_summand(propto, x, alpha, beta):
        # logaddexp(0, t) is softplus(t) without F.softplus's threshold switch
        lp = lp - sum_event(torch.logaddexp(torch.zeros_like(eta), -sign * eta), batch_ndims)
    return torch.where(ok, lp, torch.full_like(lp, -float("inf")))


def poisson_log_glm_lpmf(y, x, alpha, beta, *, propto=False, batch_ndims=0):
    """Ref: poisson_log_glm_lpmf.hpp."""
    eta, dt, device = _eta(x, alpha, beta, batch_ndims)
    y = torch.as_tensor(y, dtype=dt, device=device)
    lp = torch.zeros(eta.shape[:batch_ndims], dtype=dt, device=device)
    if include_summand(propto, x, alpha, beta):
        lp = lp + sum_event(y * eta - torch.exp(eta), batch_ndims)
    if include_summand(propto):
        lp = lp - torch.sum(torch.lgamma(y + 1.0))
    return lp


def neg_binomial_2_log_glm_lpmf(y, x, alpha, beta, phi, *, propto=False, batch_ndims=0):
    """Ref: neg_binomial_2_log_glm_lpmf.hpp."""
    eta, _, _ = _eta(x, alpha, beta, batch_ndims)
    if batch_ndims and np.ndim(phi) == batch_ndims:
        phi = phi[..., None]  # one phi per chain
    return neg_binomial_2_log_lpmf(y, eta, phi, propto=propto, batch_ndims=batch_ndims)


def normal_id_glm_lpdf(y, x, alpha, beta, sigma, *, propto=False, batch_ndims=0):
    """Ref: normal_id_glm_lpdf.hpp."""
    eta, dt, device = _eta(x, alpha, beta, batch_ndims)
    y_t = torch.as_tensor(y, dtype=dt, device=device)
    s = torch.as_tensor(sigma, dtype=dt, device=device)
    if s.ndim == batch_ndims and batch_ndims > 0:
        s = s[..., None]  # one scale per chain
    n = y_t.shape[0] if y_t.ndim else 1
    z = (y_t - eta) / s
    lp = torch.zeros(eta.shape[:batch_ndims], dtype=dt, device=device)
    if include_summand(propto, y, x, alpha, beta, sigma):
        lp = lp - 0.5 * sum_event(torch.square(z), batch_ndims)
    if include_summand(propto, sigma):
        lp = lp - sum_event(torch.broadcast_to(torch.log(s), eta.shape), batch_ndims)
    if include_summand(propto):
        lp = lp - n * LOG_SQRT_TWO_PI
    return lp


def ordered_logistic_glm_lpmf(y, x, beta, cuts, *, propto=False, batch_ndims=0):
    """Ref: ordered_logistic_glm_lpmf.hpp (eta = x beta, no intercept)."""
    x, beta, cuts = as_tensors(x, beta, cuts)
    return ordered_logistic_lpmf(y, beta @ x.mT, cuts, propto=propto, batch_ndims=batch_ndims)


def categorical_logit_glm_lpmf(y, x, alpha, beta, *, propto=False, batch_ndims=0):
    """Ref: categorical_logit_glm_lpmf.hpp (beta is D x K, alpha K).

    Every summand depends on (x, alpha, beta), so propto=True with
    all-constant operands prunes the whole density (the reference's
    ``include_summand<propto, T_x, T_alpha, T_beta>`` gate); invalid y
    follows the -inf / nan-free-gradient convention of the other families.
    """
    xt, a, b = as_tensors(x, alpha, beta)
    dt, device = xt.dtype, xt.device
    if batch_ndims and a.ndim == batch_ndims + 1:
        a = a[..., None, :]  # one intercept vector per chain
    eta = xt @ b + a  # (batch..., N, K)
    yi = _category_index(y, device)
    k = eta.shape[-1]
    ok = (yi >= 0) & (yi < k)
    lp = torch.zeros(eta.shape[:batch_ndims], dtype=dt, device=device)
    if include_summand(propto, x, alpha, beta):
        logsm = torch.log_softmax(eta, dim=-1)
        idx = torch.clamp(yi, 0, k - 1).expand(logsm.shape[:-1])[..., None]
        picked = torch.gather(logsm, -1, idx)[..., 0]
        lp = lp + sum_event(torch.where(ok, picked, 0.0), batch_ndims)
    return torch.where(torch.all(ok), lp, torch.full_like(lp, -float("inf")))
