"""Remaining distribution families completing reference parity.

Counterpart: ``math_tpu/dists/more.py``.  Covers: wiener first-passage
(Navarro-Fuss), gaussian_dlm_obs (Kalman filter likelihood),
multi_gp[_cholesky], matrix_normal_prec, lkj_cov, beta_binomial cdf family,
neg_binomial lcdf/lccdf, and the glm/dlm rngs.  References: same-named files
under ``prim/{scal,mat}/prob``.

``batch_ndims=1``: the first axis of every argument that has more axes than
its event shape is the chain axis (as in ``dists/multivariate.py``), and the
result is one value per chain.  Every factorization goes through
``ops.cholesky`` (the blocked path; the block kernel on a CUDA tensor); the
Kalman filter's time steps are a Python loop.  The ``_rng`` functions take a
``torch.Generator``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from math_tpu_torch.special import LOG_SQRT_TWO_PI, LOG_TWO_PI, inc_beta, lbeta, lchoose
from math_tpu_torch.utils.propto import include_summand
from math_tpu_torch.dists._util import as_tensors, bcast, finish, finish_prod, ok_pos, rng_params, safe
from math_tpu_torch.dists.continuous import lognormal_lpdf
from math_tpu_torch.dists.multivariate import dirichlet_lpdf, lkj_corr_lpdf
from math_tpu_torch.ops.cholesky import cholesky_decompose
from math_tpu_torch.ops.linalg import log_determinant_spd, trace_gen_quad_form

__all__ = [
    "wiener_lpdf",
    "gaussian_dlm_obs_lpdf",
    "gaussian_dlm_obs_rng",
    "multi_gp_lpdf",
    "multi_gp_cholesky_lpdf",
    "matrix_normal_prec_lpdf",
    "matrix_normal_prec_rng",
    "lkj_cov_lpdf",
    "dirichlet_lpmf",
    "beta_binomial_cdf",
    "beta_binomial_lcdf",
    "beta_binomial_lccdf",
    "neg_binomial_lcdf",
    "neg_binomial_lccdf",
    "bernoulli_logit_glm_rng",
]


def _solve_lower(L, b):
    return torch.linalg.solve_triangular(L, b, upper=False)


# --- wiener first-passage time (ref: wiener_lpdf.hpp, Navarro & Fuss 2009) --

_WIENER_K_SMALL = 7  # terms k = -7..7; exceeds the reference's 1e-6 budget
_WIENER_K_LARGE = 16


def _signed_logsumexp(log_terms, sign):
    """``(log |sum_k sign_k exp(log_terms_k)|, sign of the sum)`` over the last axis."""
    m = torch.amax(log_terms, -1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    s = torch.sum(sign * torch.exp(log_terms - m), -1)
    return m[..., 0] + torch.log(torch.abs(s)), torch.sign(s)


def wiener_lpdf(y, alpha, tau, beta, delta, *, propto=False, batch_ndims=0):
    """Upper-boundary Wiener FPT density: y RT (s), alpha boundary sep,
    tau nondecision time, beta in (0,1) bias, delta drift."""
    yb, ab, tb, bb, db = bcast(y, alpha, tau, beta, delta)
    okp = ok_pos(ab) & ok_pos(tb) & torch.isfinite(bb) & (bb >= 0) & (bb <= 1) & torch.isfinite(db)
    sup = yb > tb
    ok = okp & sup & torch.isfinite(yb)
    a = safe(ab, okp)
    w = 1.0 - safe(bb, okp, 0.5)
    a2 = torch.square(a)
    x = safe(yb - tb, sup) / a2  # normalized time, > 0

    sqrt_x = torch.sqrt(x)
    log_x = torch.log(x)

    # number-of-terms heuristics (ref: wiener_lpdf.hpp:168-199), used only
    # to pick the better-converging series; term counts are static here.
    err = 1e-6
    kl = torch.where(
        math.pi * err * x < 1,
        torch.maximum(
            torch.sqrt(torch.clamp_min(-2.0 * math.sqrt(math.pi) * (math.log(math.pi * err) + log_x), 0.0)) / sqrt_x,
            sqrt_x / math.pi,
        ),
        sqrt_x / math.pi,
    )
    t0 = 2.0 * math.sqrt(2.0 * math.pi) * err * sqrt_x
    ks = torch.where(
        t0 < 1,
        torch.maximum(
            2.0 + sqrt_x * torch.sqrt(torch.clamp_min(-2.0 * torch.log(torch.clamp_min(t0, 1e-300)), 0.0)),
            sqrt_x + 1.0,
        ),
        torch.full_like(x, 2.0),
    )

    # small-time series: sum_k (w + 2k) exp(-(w+2k)^2 / (2x)), evaluated as
    # a signed logsumexp so deep-tail tiny x (terms ~ exp(-w^2/2x) << 1e-300)
    # keeps full log-scale accuracy instead of underflowing to a clamp
    kk = torch.arange(-_WIENER_K_SMALL, _WIENER_K_SMALL + 1, dtype=x.dtype, device=x.device)
    arg = w[..., None] + 2.0 * kk
    log_terms = torch.log(torch.clamp_min(torch.abs(arg), 1e-300)) - torch.square(arg) * 0.5 / x[..., None]
    lsum, sgn = _signed_logsumexp(log_terms, torch.sign(arg))
    log_small = torch.where(sgn > 0, lsum, -math.inf) - (0.5 * math.log(2.0) + 0.5 * math.log(math.pi)) - 1.5 * log_x

    # large-time series: sum_k k exp(-k^2 pi^2 x / 2) sin(k pi w)
    kk2 = torch.arange(1, _WIENER_K_LARGE + 1, dtype=x.dtype, device=x.device)
    large_sum = torch.sum(
        kk2 * torch.exp(-torch.square(kk2) * (0.5 * math.pi**2) * x[..., None]) * torch.sin(kk2 * math.pi * w[..., None]),
        -1,
    )
    log_large = torch.log(torch.clamp_min(large_sum, 1e-300)) + math.log(math.pi)

    log_f = torch.where(ks < kl, log_small, log_large)
    d = safe(db, okp, 0.0)
    lp = d * a * w - torch.square(d) * x * a2 / 2.0 - torch.log(a2) + log_f
    return finish(lp, ok, batch_ndims)


# --- gaussian_dlm_obs: Kalman-filter likelihood (ref: gaussian_dlm_obs_lpdf) -


def gaussian_dlm_obs_lpdf(y, F, G, V, W, m0, C0, *, propto=False, batch_ndims=0):
    """Dynamic linear model observation density.

    theta_t = G theta_{t-1} + w_t,  w_t ~ N(0, W)
    y_t     = F' theta_t + v_t,     v_t ~ N(0, V)
    theta_0 ~ N(m0, C0);  y is (r, T) with columns as time points.

    V may be (r, r) or a length-r vector (diagonal observation noise); with
    ``batch_ndims=1`` a ``(C, r)`` V that is not square holds one diagonal a
    chain.
    Likelihood evaluated by the forward Kalman recursion, a Python loop over
    the T time steps (the JAX package's ``lax.scan``).  With
    ``batch_ndims=1`` every argument may carry a leading chain axis (``y``
    then ``(C, r, T)``).
    """
    y, F, G, V, W, m0, C0 = as_tensors(y, F, G, V, W, m0, C0)
    r = y.shape[-2]
    vector = V.ndim == 1 or (batch_ndims and V.ndim == 2 and tuple(V.shape) != (r, r))
    Vm = torch.diag_embed(V) if vector else V
    eye = torch.eye(r, dtype=y.dtype, device=y.device)
    m, C = m0, C0
    lp = torch.zeros(y.shape[:batch_ndims], dtype=y.dtype, device=y.device)
    for t in range(y.shape[-1]):
        a = (G @ m[..., None])[..., 0]
        R = G @ C @ G.mT + W
        f = (F.mT @ a[..., None])[..., 0]
        Q = F.mT @ R @ F + Vm
        Lq = cholesky_decompose(Q)
        e = y[..., t] - f
        z = _solve_lower(Lq, e[..., None])[..., 0]
        lp = lp - 0.5 * (
            torch.sum(torch.square(z), -1)
            + 2.0 * torch.sum(torch.log(torch.diagonal(Lq, dim1=-2, dim2=-1)), -1)
            + r * LOG_TWO_PI
        )
        K = R @ F @ torch.cholesky_solve(eye, Lq)
        m = a + (K @ e[..., None])[..., 0]
        C = R - K @ Q @ K.mT
        C = 0.5 * (C + C.mT)
    return lp


def gaussian_dlm_obs_rng(generator, F, G, V, W, m0, C0, T):
    """Simulate a DLM observation sequence; returns (r, T)."""
    F, G, V, W, m0, C0 = rng_params(generator, F, G, V, W, m0, C0)
    Vm = torch.diag(V) if V.ndim == 1 else V
    n = G.shape[0]
    r = F.shape[1]
    opts = {"dtype": F.dtype, "device": F.device}
    L0 = cholesky_decompose(C0)
    theta = m0 + L0 @ torch.randn((n,), generator=generator, **opts)
    Lw = cholesky_decompose(W)
    Lv = cholesky_decompose(Vm)
    ys = []
    for _ in range(T):
        theta = G @ theta + Lw @ torch.randn((n,), generator=generator, **opts)
        ys.append(F.mT @ theta + Lv @ torch.randn((r,), generator=generator, **opts))
    return torch.stack(ys, -1)


# --- multi_gp (ref: multi_gp_lpdf.hpp, multi_gp_cholesky_lpdf.hpp) ----------


def _multi_gp(y, L, w, propto, batch_ndims, dep_scale):
    """Shared body: ``y (..., K, N)`` rows ~ N(0, L L^T / w_k)."""
    kk, n = y.shape[-2:]
    batch = torch.broadcast_shapes(y.shape[:batch_ndims], L.shape[:-2], w.shape[:-1])
    lp = torch.zeros(batch, dtype=y.dtype, device=y.device)
    if include_summand(propto):
        lp = lp - 0.5 * LOG_TWO_PI * kk * n
    if dep_scale:
        lp = lp - kk * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), -1)
    if include_summand(propto, w):
        lp = lp + 0.5 * n * torch.sum(torch.log(w), -1)
    z = _solve_lower(L, y.mT)  # (..., N, K)
    return lp - 0.5 * torch.sum(w * torch.sum(torch.square(z), -2), -1)


def multi_gp_lpdf(y, sigma, w, *, propto=False, batch_ndims=0):
    """y (K, N): K independent rows, row k ~ N(0, Sigma / w_k)."""
    y, sigma, w = as_tensors(y, sigma, w)
    L = cholesky_decompose(sigma)
    return _multi_gp(y, L, w, propto, batch_ndims, include_summand(propto, sigma))


def multi_gp_cholesky_lpdf(y, L, w, *, propto=False, batch_ndims=0):
    """Same with Sigma = L L^T pre-factored (ref: multi_gp_cholesky_lpdf)."""
    y, L, w = as_tensors(y, L, w)
    return _multi_gp(y, L, w, propto, batch_ndims, include_summand(propto, L))


# --- matrix_normal_prec (ref: matrix_normal_prec_lpdf.hpp) ------------------


def matrix_normal_prec_lpdf(y, mu, sigma, d, *, propto=False, batch_ndims=0):
    """Matrix normal with row precision Sigma (n x n) and column precision
    D (p x p): lp = -1/2 tr(D (y-Mu)' Sigma (y-Mu)) + 0.5(n log|D|... )"""
    y, mu, sigma, d = as_tensors(y, mu, sigma, d)
    n, p = y.shape[-2:]
    batch = torch.broadcast_shapes(y.shape[:-2], mu.shape[:-2], sigma.shape[:-2], d.shape[:-2])
    lp = torch.zeros(batch, dtype=y.dtype, device=y.device)
    if include_summand(propto):
        lp = lp - LOG_SQRT_TWO_PI * n * p
    if include_summand(propto, sigma):
        lp = lp + 0.5 * p * log_determinant_spd(sigma)
    if include_summand(propto, d):
        lp = lp + 0.5 * n * log_determinant_spd(d)
    if include_summand(propto, y, mu, sigma, d):
        lp = lp - 0.5 * trace_gen_quad_form(d, sigma, y - mu)
    return lp


def matrix_normal_prec_rng(generator, mu, sigma, d, shape=()):
    """Draw Y ~ MN(Mu, Sigma^-1, D^-1)."""
    mu, sigma, d = rng_params(generator, mu, sigma, d)
    n, p = mu.shape[-2:]
    Ls = cholesky_decompose(sigma)
    Ld = cholesky_decompose(d)
    z = torch.randn(tuple(shape) + (n, p), generator=generator, dtype=mu.dtype, device=mu.device)
    # A = Ls^-T Z Ld^-1: row cov Ls^-T Ls^-1 = Sigma^-1, col cov
    # Ld^-T Ld^-1 = D^-1 (vec(A) ~ N(0, D^-1 (x) Sigma^-1))
    c = torch.linalg.solve_triangular(Ls.mT.expand(z.shape[:-2] + Ls.shape[-2:]), z, upper=True)
    ct = c.mT
    at = torch.linalg.solve_triangular(Ld.mT.expand(ct.shape[:-2] + Ld.shape[-2:]), ct, upper=True)
    return mu + at.mT


# --- lkj_cov (ref: lkj_cov_lpdf.hpp): lognormal sds + LKJ correlation -------


def lkj_cov_lpdf(y, mu, sigma, eta, *, propto=False, batch_ndims=0):
    """Deprecated-in-reference compound prior: lognormal(mu, sigma) on the
    sqrt-diagonal, LKJ(eta) on the correlation matrix."""
    (y,) = as_tensors(y)
    sds = torch.sqrt(torch.diagonal(y, dim1=-2, dim2=-1))
    lp = lognormal_lpdf(sds, mu, sigma, propto=propto, batch_ndims=batch_ndims)
    dinv = 1.0 / sds
    corr = y * dinv[..., :, None] * dinv[..., None, :]
    return lp + lkj_corr_lpdf(corr, eta, propto=propto, batch_ndims=batch_ndims)


def dirichlet_lpmf(theta, alpha, *, propto=False, batch_ndims=0):
    return dirichlet_lpdf(theta, alpha, propto=propto, batch_ndims=batch_ndims)


# --- beta_binomial cdfs (ref: beta_binomial_cdf.hpp) ------------------------


def _beta_binomial_cdf_elem(y, n, a, b, kmax):
    k = torch.arange(kmax + 1, dtype=a.dtype, device=a.device)
    logpmf = lchoose(n[..., None], k) + lbeta(k + a[..., None], n[..., None] - k + b[..., None]) - lbeta(a[..., None], b[..., None])
    pmf = torch.where(k <= n[..., None], torch.exp(logpmf), 0.0)
    return torch.sum(torch.where(k <= y[..., None], pmf, 0.0), -1)


def _beta_binomial_cdf_args(y, n, alpha, beta):
    """The support bound comes from the raw ``n`` (data): a numpy or Python
    ``n`` on the host, a tensor ``n`` read once (as the JAX package needs a
    concrete ``n``)."""
    kmax = int(n.max()) if isinstance(n, torch.Tensor) else int(np.max(np.asarray(n)))
    yb, nb, ab, bb = bcast(y, n, alpha, beta)
    ok = ok_pos(ab) & ok_pos(bb) & (nb >= 0)
    p = torch.where(
        yb < 0,
        0.0,
        torch.where(yb >= nb, 1.0, _beta_binomial_cdf_elem(torch.floor(yb), nb, safe(ab, ok), safe(bb, ok), kmax)),
    )
    return p, ok


def beta_binomial_cdf(y, n, alpha, beta, *, batch_ndims=0):
    p, ok = _beta_binomial_cdf_args(y, n, alpha, beta)
    return finish_prod(p, ok, batch_ndims)


def beta_binomial_lcdf(y, n, alpha, beta, *, batch_ndims=0):
    p, ok = _beta_binomial_cdf_args(y, n, alpha, beta)
    return finish(torch.log(torch.clamp_min(p, 1e-300)), ok, batch_ndims)


def beta_binomial_lccdf(y, n, alpha, beta, *, batch_ndims=0):
    p, ok = _beta_binomial_cdf_args(y, n, alpha, beta)
    return finish(torch.log1p(-torch.clamp_max(p, 1.0 - 1e-16)), ok, batch_ndims)


# --- neg_binomial lcdf/lccdf (ref: neg_binomial_lcdf.hpp) -------------------


def _neg_binomial_p(y, alpha, beta):
    yb, ab, bb = bcast(y, alpha, beta)
    ok = ok_pos(ab) & ok_pos(bb)
    p = torch.where(yb < 0, 0.0, inc_beta(safe(ab, ok), torch.floor(torch.clamp_min(yb, 0.0)) + 1.0, bb / (1.0 + bb)))
    return p, ok


def neg_binomial_lcdf(y, alpha, beta, *, batch_ndims=0):
    p, ok = _neg_binomial_p(y, alpha, beta)
    return finish(torch.log(torch.clamp_min(p, 1e-300)), ok, batch_ndims)


def neg_binomial_lccdf(y, alpha, beta, *, batch_ndims=0):
    p, ok = _neg_binomial_p(y, alpha, beta)
    return finish(torch.log1p(-torch.clamp_max(p, 1.0 - 1e-16)), ok, batch_ndims)


# --- glm rng (ref: bernoulli_logit_glm_rng.hpp) -----------------------------


def bernoulli_logit_glm_rng(generator, x, alpha, beta, shape=None):
    x, alpha, beta = rng_params(generator, x, alpha, beta)
    eta = x @ beta + alpha
    shape = tuple(shape) if shape is not None else tuple(eta.shape)
    return torch.bernoulli(torch.sigmoid(eta).expand(shape), generator=generator).to(torch.int32)
