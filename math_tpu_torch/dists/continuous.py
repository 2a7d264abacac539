"""Continuous univariate distributions.

Counterpart: ``math_tpu/dists/continuous.py`` (reference:
``stan/math/prim/scal/prob/*_{lpdf,cdf,lcdf,lccdf,rng}.hpp``, 27 continuous
families).  Semantics preserved:

- ``*_lpdf(y, ...)`` returns the SUM of elementwise log densities over every
  axis after the first ``batch_ndims`` (0: the scalar the JAX function
  returns; 1: one value per chain); ``propto=True`` drops summands via
  ``include_summand``.
- ``*_cdf`` returns the product of elementwise cdfs (NaN where an argument
  is invalid); ``*_lcdf``/``*_lccdf`` the sum of elementwise log-(c)cdfs
  (Stan's vectorized cdf semantics), per chain with ``batch_ndims=1``.
- ``*_rng(generator, ..., shape)`` takes a ``torch.Generator`` where the JAX
  function takes a key and draws on its device; the draws cannot equal
  JAX's, they follow the same constructions.
- The gamma-family cdfs go through ``special.gamma_p`` / ``gamma_q`` (the
  JAX package calls ``jsp.gammainc`` directly): values from PyTorch's
  ``gammainc``, partials in the shape from ``special/hyper.py``.

Invalid parameters yield ``-inf`` (see ``_util``), with double-where
sanitization for nan-free gradients.
"""

from __future__ import annotations

import math

import torch

from math_tpu_torch.special import (
    LOG_TWO,
    LOG_TWO_PI,
    LOG_SQRT_TWO_PI,
    gamma_p,
    gamma_q,
    inc_beta,
    lbeta,
    log1m_exp,
    log_i0,
    owens_t,
)
from math_tpu_torch.utils.propto import include_summand
from math_tpu_torch.dists._util import bcast, finish, finish_prod, ok_pos, rng_params, rng_shape, safe

__all__ = [
    "normal_lpdf", "normal_cdf", "normal_lcdf", "normal_lccdf", "normal_rng", "std_normal_lpdf", "std_normal_rng",
    "normal_sufficient_lpdf", "lognormal_lpdf", "lognormal_cdf", "lognormal_lcdf", "lognormal_lccdf", "lognormal_rng",
    "cauchy_lpdf", "cauchy_cdf", "cauchy_lcdf", "cauchy_lccdf", "cauchy_rng", "student_t_lpdf", "student_t_cdf",
    "student_t_lcdf", "student_t_lccdf", "student_t_rng", "double_exponential_lpdf", "double_exponential_cdf",
    "double_exponential_lcdf", "double_exponential_lccdf", "double_exponential_rng", "logistic_lpdf", "logistic_cdf",
    "logistic_lcdf", "logistic_lccdf", "logistic_rng", "gumbel_lpdf", "gumbel_cdf", "gumbel_lcdf", "gumbel_lccdf",
    "gumbel_rng", "exponential_lpdf", "exponential_cdf", "exponential_lcdf", "exponential_lccdf", "exponential_rng",
    "gamma_lpdf", "gamma_cdf", "gamma_lcdf", "gamma_lccdf", "gamma_rng", "inv_gamma_lpdf", "inv_gamma_cdf",
    "inv_gamma_lcdf", "inv_gamma_lccdf", "inv_gamma_rng", "chi_square_lpdf", "chi_square_cdf", "chi_square_lcdf",
    "chi_square_lccdf", "chi_square_rng", "inv_chi_square_lpdf", "inv_chi_square_cdf", "inv_chi_square_lcdf",
    "inv_chi_square_lccdf", "inv_chi_square_rng", "scaled_inv_chi_square_lpdf", "scaled_inv_chi_square_cdf",
    "scaled_inv_chi_square_lcdf", "scaled_inv_chi_square_lccdf", "scaled_inv_chi_square_rng", "weibull_lpdf",
    "weibull_cdf", "weibull_lcdf", "weibull_lccdf", "weibull_rng", "frechet_lpdf", "frechet_cdf", "frechet_lcdf",
    "frechet_lccdf", "frechet_rng", "rayleigh_lpdf", "rayleigh_cdf", "rayleigh_lcdf", "rayleigh_lccdf",
    "rayleigh_rng", "pareto_lpdf", "pareto_cdf", "pareto_lcdf", "pareto_lccdf", "pareto_rng", "pareto_type_2_lpdf",
    "pareto_type_2_cdf", "pareto_type_2_lcdf", "pareto_type_2_lccdf", "pareto_type_2_rng", "beta_lpdf", "beta_cdf",
    "beta_lcdf", "beta_lccdf", "beta_rng", "beta_proportion_lpdf", "beta_proportion_lcdf", "beta_proportion_lccdf",
    "beta_proportion_rng", "uniform_lpdf", "uniform_cdf", "uniform_lcdf", "uniform_lccdf", "uniform_rng",
    "von_mises_lpdf", "von_mises_rng", "skew_normal_lpdf", "skew_normal_cdf", "skew_normal_lcdf", "skew_normal_lccdf",
    "skew_normal_rng", "exp_mod_normal_lpdf", "exp_mod_normal_cdf", "exp_mod_normal_lcdf", "exp_mod_normal_lccdf",
    "exp_mod_normal_rng",
]


def _softplus(t):
    """log(1 + exp(t)) exactly (``jax.nn.softplus``; ``F.softplus`` switches to t past 20)."""
    return torch.logaddexp(t, torch.zeros_like(t))


# --- draws from a generator, on its device ----------------------------------


def _empty(shape, like):
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def _normal(generator, shape, like):
    return torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)


def _exponential(generator, shape, like):
    return _empty(shape, like).exponential_(generator=generator)


def _uniform_open(generator, shape, like):
    """uniform(0, 1) without the endpoint 0."""
    u = torch.rand(shape, generator=generator, dtype=like.dtype, device=like.device)
    return torch.clamp_min(u, torch.finfo(like.dtype).tiny)


def _gamma(generator, alpha, shape):
    """gamma(alpha, 1) draws of ``shape`` (``alpha`` broadcast to it)."""
    return torch._standard_gamma(alpha.expand(shape).contiguous(), generator=generator)


def _beta(generator, a, b, shape):
    ga, gb = _gamma(generator, a, shape), _gamma(generator, b, shape)
    return ga / (ga + gb)


# ---------------------------------------------------------------------------
# normal family (ref: normal_lpdf.hpp:36-112, std_normal_lpdf.hpp,
# lognormal_lpdf.hpp, normal_sufficient_lpdf.hpp)
# ---------------------------------------------------------------------------


def normal_lpdf(y, mu, sigma, *, propto=False, batch_ndims=0):
    """Ref: normal_lpdf.hpp:36-112."""
    yb, mub, sb = bcast(y, mu, sigma)
    ok = torch.isfinite(yb) & torch.isfinite(mub) & ok_pos(sb)
    s = safe(sb, ok)
    z = (yb - safe(mub, ok, 0.0)) / s
    lp = torch.zeros_like(z)
    if include_summand(propto, y, mu, sigma):
        lp = lp - 0.5 * torch.square(z)
    if include_summand(propto, sigma):
        lp = lp - torch.log(s)
    if include_summand(propto):
        lp = lp - LOG_SQRT_TWO_PI
    return finish(lp, ok, batch_ndims)


def normal_cdf(y, mu, sigma, *, batch_ndims=0):
    yb, mub, sb = bcast(y, mu, sigma)
    ok = ok_pos(sb)
    return finish_prod(torch.special.ndtr((yb - mub) / safe(sb, ok)), ok, batch_ndims)


def normal_lcdf(y, mu, sigma, *, batch_ndims=0):
    yb, mub, sb = bcast(y, mu, sigma)
    ok = ok_pos(sb)
    return finish(torch.special.log_ndtr((yb - mub) / safe(sb, ok)), ok, batch_ndims)


def normal_lccdf(y, mu, sigma, *, batch_ndims=0):
    yb, mub, sb = bcast(y, mu, sigma)
    ok = ok_pos(sb)
    return finish(torch.special.log_ndtr(-(yb - mub) / safe(sb, ok)), ok, batch_ndims)


def normal_rng(generator, mu, sigma, shape=None):
    mu, sigma = rng_params(generator, mu, sigma)
    return mu + sigma * _normal(generator, rng_shape(shape, mu, sigma), mu)


def std_normal_lpdf(y, *, propto=False, batch_ndims=0):
    """Ref: std_normal_lpdf.hpp."""
    (yb,) = bcast(y)
    ok = torch.isfinite(yb)
    lp = -0.5 * torch.square(safe(yb, ok, 0.0))
    if include_summand(propto):
        lp = lp - LOG_SQRT_TWO_PI
    return finish(lp, ok, batch_ndims)


def std_normal_rng(generator, shape=()):
    return torch.randn(tuple(shape), generator=generator, dtype=torch.float64, device=generator.device)


def normal_sufficient_lpdf(y_bar, s_squared, n_obs, mu, sigma, *, propto=False, batch_ndims=0):
    """Ref: normal_sufficient_lpdf.hpp — s_squared is the summed squared dev."""
    yb, ss, nb, mub, sb = bcast(y_bar, s_squared, n_obs, mu, sigma)
    ok = torch.isfinite(yb) & (ss >= 0) & (nb > 0) & torch.isfinite(mub) & ok_pos(sb)
    s = safe(sb, ok)
    lp = -(ss + nb * torch.square(yb - safe(mub, ok, 0.0))) / (2.0 * torch.square(s))
    if include_summand(propto, sigma):
        lp = lp - nb * torch.log(s)
    if include_summand(propto):
        lp = lp - nb * LOG_SQRT_TWO_PI
    return finish(lp, ok, batch_ndims)


def lognormal_lpdf(y, mu, sigma, *, propto=False, batch_ndims=0):
    """Ref: lognormal_lpdf.hpp.  ``y <= 0`` lies off the support (-inf); a
    non-finite ``y``, ``mu`` or a bad ``sigma`` gives -inf as well."""
    yb, mub, sb = bcast(y, mu, sigma)
    okp = torch.isfinite(mub) & ok_pos(sb)
    sup = yb > 0
    ok = okp & torch.isfinite(yb)
    ys = safe(yb, sup)
    s = safe(sb, okp)
    z = (torch.log(ys) - safe(mub, okp, 0.0)) / s
    lp = torch.zeros_like(z)
    if include_summand(propto, y, mu, sigma):
        lp = lp - 0.5 * torch.square(z)
    if include_summand(propto, sigma):
        lp = lp - torch.log(s)
    if include_summand(propto, y):
        lp = lp - torch.log(ys)
    if include_summand(propto):
        lp = lp - LOG_SQRT_TWO_PI
    return finish(torch.where(sup, lp, -float("inf")), ok, batch_ndims)


def lognormal_cdf(y, mu, sigma, *, batch_ndims=0):
    yb, mub, sb = bcast(y, mu, sigma)
    ok = ok_pos(sb)
    ys = safe(yb, yb > 0)
    p = torch.where(yb > 0, torch.special.ndtr((torch.log(ys) - mub) / safe(sb, ok)), 0.0)
    return finish_prod(p, ok, batch_ndims)


def lognormal_lcdf(y, mu, sigma, *, batch_ndims=0):
    yb, mub, sb = bcast(y, mu, sigma)
    ok = ok_pos(sb)
    ys = safe(yb, yb > 0)
    lp = torch.where(
        yb > 0, torch.special.log_ndtr((torch.log(ys) - mub) / safe(sb, ok)), -math.inf
    )
    return finish(lp, ok, batch_ndims)


def lognormal_lccdf(y, mu, sigma, *, batch_ndims=0):
    yb, mub, sb = bcast(y, mu, sigma)
    ok = ok_pos(sb)
    ys = safe(yb, yb > 0)
    lp = torch.where(yb > 0, torch.special.log_ndtr(-(torch.log(ys) - mub) / safe(sb, ok)), 0.0)
    return finish(lp, ok, batch_ndims)


def lognormal_rng(generator, mu, sigma, shape=None):
    mu, sigma = rng_params(generator, mu, sigma)
    return torch.exp(mu + sigma * _normal(generator, rng_shape(shape, mu, sigma), mu))


# ---------------------------------------------------------------------------
# heavy tails: cauchy, student_t (ref: cauchy_lpdf.hpp, student_t_lpdf.hpp)
# ---------------------------------------------------------------------------


def cauchy_lpdf(y, mu, sigma, *, propto=False, batch_ndims=0):
    """Ref: cauchy_lpdf.hpp."""
    yb, mub, sb = bcast(y, mu, sigma)
    ok = torch.isfinite(yb) & torch.isfinite(mub) & ok_pos(sb)
    s = safe(sb, ok)
    z = (yb - safe(mub, ok, 0.0)) / s
    lp = torch.zeros_like(z)
    if include_summand(propto, y, mu, sigma):
        lp = lp - torch.log1p(torch.square(z))
    if include_summand(propto, sigma):
        lp = lp - torch.log(s)
    if include_summand(propto):
        lp = lp - math.log(math.pi)
    return finish(lp, ok, batch_ndims)


def cauchy_cdf(y, mu, sigma, *, batch_ndims=0):
    yb, mub, sb = bcast(y, mu, sigma)
    ok = ok_pos(sb)
    z = (yb - mub) / safe(sb, ok)
    return finish_prod(torch.arctan(z) / math.pi + 0.5, ok, batch_ndims)


def cauchy_lcdf(y, mu, sigma, *, batch_ndims=0):
    yb, mub, sb = bcast(y, mu, sigma)
    ok = ok_pos(sb)
    z = (yb - mub) / safe(sb, ok)
    return finish(torch.log(torch.arctan(z) / math.pi + 0.5), ok, batch_ndims)


def cauchy_lccdf(y, mu, sigma, *, batch_ndims=0):
    yb, mub, sb = bcast(y, mu, sigma)
    ok = ok_pos(sb)
    z = (yb - mub) / safe(sb, ok)
    return finish(torch.log(0.5 - torch.arctan(z) / math.pi), ok, batch_ndims)


def cauchy_rng(generator, mu, sigma, shape=None):
    mu, sigma = rng_params(generator, mu, sigma)
    return mu + sigma * _empty(rng_shape(shape, mu, sigma), mu).cauchy_(generator=generator)


def student_t_lpdf(y, nu, mu, sigma, *, propto=False, batch_ndims=0):
    yb, nub, mub, sb = bcast(y, nu, mu, sigma)
    ok = torch.isfinite(yb) & ok_pos(nub) & torch.isfinite(mub) & ok_pos(sb)
    n = safe(nub, ok)
    s = safe(sb, ok)
    z = (yb - safe(mub, ok, 0.0)) / s
    lp = torch.zeros_like(z)
    if include_summand(propto, y, nu, mu, sigma):
        lp = lp - 0.5 * (n + 1.0) * torch.log1p(torch.square(z) / n)
    if include_summand(propto, nu):
        lp = lp + torch.lgamma(0.5 * (n + 1.0)) - torch.lgamma(0.5 * n)
        lp = lp - 0.5 * torch.log(n)
    if include_summand(propto, sigma):
        lp = lp - torch.log(s)
    if include_summand(propto):
        lp = lp - 0.5 * math.log(math.pi)
    return finish(lp, ok, batch_ndims)


def _student_t_cdf_elem(z, nu):
    """CDF of standard t via the regularized incomplete beta (the
    differentiable ``special.inc_beta``, so gradients wrt nu work —
    ref: inc_beta_dda/ddb powering student_t_cdf derivatives)."""
    q = nu / (nu + torch.square(z))
    ib = inc_beta(0.5 * nu, 0.5 * torch.ones_like(nu), q)
    return torch.where(z > 0, 1.0 - 0.5 * ib, 0.5 * ib)


def student_t_cdf(y, nu, mu, sigma, *, batch_ndims=0):
    yb, nub, mub, sb = bcast(y, nu, mu, sigma)
    ok = ok_pos(nub) & ok_pos(sb)
    z = (yb - mub) / safe(sb, ok)
    return finish_prod(_student_t_cdf_elem(z, safe(nub, ok)), ok, batch_ndims)


def student_t_lcdf(y, nu, mu, sigma, *, batch_ndims=0):
    yb, nub, mub, sb = bcast(y, nu, mu, sigma)
    ok = ok_pos(nub) & ok_pos(sb)
    z = (yb - mub) / safe(sb, ok)
    return finish(torch.log(_student_t_cdf_elem(z, safe(nub, ok))), ok, batch_ndims)


def student_t_lccdf(y, nu, mu, sigma, *, batch_ndims=0):
    yb, nub, mub, sb = bcast(y, nu, mu, sigma)
    ok = ok_pos(nub) & ok_pos(sb)
    z = (yb - mub) / safe(sb, ok)
    return finish(torch.log(_student_t_cdf_elem(-z, safe(nub, ok))), ok, batch_ndims)


def student_t_rng(generator, nu, mu, sigma, shape=None):
    nu, mu, sigma = rng_params(generator, nu, mu, sigma)
    shape = rng_shape(shape, nu, mu, sigma)
    z = _normal(generator, shape, mu)
    chi2_over_nu = _gamma(generator, 0.5 * nu, shape) / (0.5 * nu)
    return mu + sigma * z / torch.sqrt(chi2_over_nu)


# ---------------------------------------------------------------------------
# double_exponential, logistic, gumbel (ref: same-named *_lpdf.hpp)
# ---------------------------------------------------------------------------


def double_exponential_lpdf(y, mu, sigma, *, propto=False, batch_ndims=0):
    yb, mub, sb = bcast(y, mu, sigma)
    ok = torch.isfinite(yb) & torch.isfinite(mub) & ok_pos(sb)
    s = safe(sb, ok)
    z = (yb - safe(mub, ok, 0.0)) / s
    lp = torch.zeros_like(z)
    if include_summand(propto, y, mu, sigma):
        lp = lp - torch.abs(z)
    if include_summand(propto, sigma):
        lp = lp - torch.log(s)
    if include_summand(propto):
        lp = lp - LOG_TWO
    return finish(lp, ok, batch_ndims)


def double_exponential_cdf(y, mu, sigma, *, batch_ndims=0):
    yb, mub, sb = bcast(y, mu, sigma)
    ok = ok_pos(sb)
    z = (yb - mub) / safe(sb, ok)
    p = torch.where(
        z < 0, 0.5 * torch.exp(torch.clamp_max(z, 0.0)), 1.0 - 0.5 * torch.exp(-torch.clamp_min(z, 0.0))
    )
    return finish_prod(p, ok, batch_ndims)


def double_exponential_lcdf(y, mu, sigma, *, batch_ndims=0):
    yb, mub, sb = bcast(y, mu, sigma)
    ok = ok_pos(sb)
    z = (yb - mub) / safe(sb, ok)
    lp = torch.where(
        z < 0,
        torch.clamp_max(z, 0.0) - LOG_TWO,
        torch.log1p(-0.5 * torch.exp(-torch.clamp_min(z, 0.0))),
    )
    return finish(lp, ok, batch_ndims)


def double_exponential_lccdf(y, mu, sigma, *, batch_ndims=0):
    yb, mub, sb = bcast(y, mu, sigma)
    ok = ok_pos(sb)
    z = (yb - mub) / safe(sb, ok)
    lp = torch.where(
        z > 0,
        -torch.clamp_min(z, 0.0) - LOG_TWO,
        torch.log1p(-0.5 * torch.exp(torch.clamp_max(z, 0.0))),
    )
    return finish(lp, ok, batch_ndims)


def double_exponential_rng(generator, mu, sigma, shape=None):
    mu, sigma = rng_params(generator, mu, sigma)
    shape = rng_shape(shape, mu, sigma)
    return mu + sigma * (_exponential(generator, shape, mu) - _exponential(generator, shape, mu))


def logistic_lpdf(y, mu, sigma, *, propto=False, batch_ndims=0):
    yb, mub, sb = bcast(y, mu, sigma)
    ok = torch.isfinite(yb) & torch.isfinite(mub) & ok_pos(sb)
    s = safe(sb, ok)
    z = (yb - safe(mub, ok, 0.0)) / s
    lp = torch.zeros_like(z)
    if include_summand(propto, y, mu, sigma):
        lp = lp - z - 2.0 * _softplus(-z)
    if include_summand(propto, sigma):
        lp = lp - torch.log(s)
    return finish(lp, ok, batch_ndims)


def logistic_cdf(y, mu, sigma, *, batch_ndims=0):
    yb, mub, sb = bcast(y, mu, sigma)
    ok = ok_pos(sb)
    return finish_prod(torch.sigmoid((yb - mub) / safe(sb, ok)), ok, batch_ndims)


def logistic_lcdf(y, mu, sigma, *, batch_ndims=0):
    yb, mub, sb = bcast(y, mu, sigma)
    ok = ok_pos(sb)
    return finish(-_softplus(-(yb - mub) / safe(sb, ok)), ok, batch_ndims)


def logistic_lccdf(y, mu, sigma, *, batch_ndims=0):
    yb, mub, sb = bcast(y, mu, sigma)
    ok = ok_pos(sb)
    return finish(-_softplus((yb - mub) / safe(sb, ok)), ok, batch_ndims)


def logistic_rng(generator, mu, sigma, shape=None):
    mu, sigma = rng_params(generator, mu, sigma)
    u = _uniform_open(generator, rng_shape(shape, mu, sigma), mu)
    return mu + sigma * (torch.log(u) - torch.log1p(-u))


def gumbel_lpdf(y, mu, beta, *, propto=False, batch_ndims=0):
    yb, mub, bb = bcast(y, mu, beta)
    ok = torch.isfinite(yb) & torch.isfinite(mub) & ok_pos(bb)
    b = safe(bb, ok)
    z = (yb - safe(mub, ok, 0.0)) / b
    lp = torch.zeros_like(z)
    if include_summand(propto, y, mu, beta):
        lp = lp - z - torch.exp(-z)
    if include_summand(propto, beta):
        lp = lp - torch.log(b)
    return finish(lp, ok, batch_ndims)


def gumbel_cdf(y, mu, beta, *, batch_ndims=0):
    yb, mub, bb = bcast(y, mu, beta)
    ok = ok_pos(bb)
    z = (yb - mub) / safe(bb, ok)
    return finish_prod(torch.exp(-torch.exp(-z)), ok, batch_ndims)


def gumbel_lcdf(y, mu, beta, *, batch_ndims=0):
    yb, mub, bb = bcast(y, mu, beta)
    ok = ok_pos(bb)
    z = (yb - mub) / safe(bb, ok)
    return finish(-torch.exp(-z), ok, batch_ndims)


def gumbel_lccdf(y, mu, beta, *, batch_ndims=0):
    yb, mub, bb = bcast(y, mu, beta)
    ok = ok_pos(bb)
    z = (yb - mub) / safe(bb, ok)
    return finish(log1m_exp(-torch.exp(-z)), ok, batch_ndims)


def gumbel_rng(generator, mu, beta, shape=None):
    mu, beta = rng_params(generator, mu, beta)
    return mu - beta * torch.log(_exponential(generator, rng_shape(shape, mu, beta), mu))


# ---------------------------------------------------------------------------
# positive support: exponential, gamma, inv_gamma, chi_square,
# inv_chi_square, scaled_inv_chi_square, weibull, frechet, rayleigh
# ---------------------------------------------------------------------------


def exponential_lpdf(y, beta, *, propto=False, batch_ndims=0):
    """Rate parameterization (ref: exponential_lpdf.hpp)."""
    yb, bb = bcast(y, beta)
    okp = ok_pos(bb)
    sup = yb >= 0
    ok = okp & sup & torch.isfinite(yb)
    b = safe(bb, okp)
    lp = torch.zeros_like(yb)
    if include_summand(propto, beta):
        lp = lp + torch.log(b)
    if include_summand(propto, y, beta):
        lp = lp - b * safe(yb, sup, 0.0)
    return finish(lp, ok, batch_ndims)


def exponential_cdf(y, beta, *, batch_ndims=0):
    yb, bb = bcast(y, beta)
    ok = ok_pos(bb)
    p = torch.where(yb > 0, -torch.expm1(-safe(bb, ok) * torch.clamp_min(yb, 0.0)), 0.0)
    return finish_prod(p, ok, batch_ndims)


def exponential_lcdf(y, beta, *, batch_ndims=0):
    yb, bb = bcast(y, beta)
    ok = ok_pos(bb)
    lp = torch.where(
        yb > 0, log1m_exp(-safe(bb, ok) * torch.clamp_min(yb, 1e-300)), -math.inf
    )
    return finish(lp, ok, batch_ndims)


def exponential_lccdf(y, beta, *, batch_ndims=0):
    yb, bb = bcast(y, beta)
    ok = ok_pos(bb)
    return finish(torch.where(yb > 0, -safe(bb, ok) * torch.clamp_min(yb, 0.0), 0.0), ok, batch_ndims)


def exponential_rng(generator, beta, shape=None):
    (beta,) = rng_params(generator, beta)
    return _exponential(generator, rng_shape(shape, beta), beta) / beta


def gamma_lpdf(y, alpha, beta, *, propto=False, batch_ndims=0):
    """Shape/rate (ref: gamma_lpdf.hpp)."""
    yb, ab, bb = bcast(y, alpha, beta)
    okp = ok_pos(ab) & ok_pos(bb)
    sup = yb > 0
    ok = okp & sup
    a, b, ys = safe(ab, okp), safe(bb, okp), safe(yb, sup)
    lp = torch.zeros_like(yb)
    if include_summand(propto, alpha):
        lp = lp - torch.lgamma(a)
    if include_summand(propto, alpha, beta):
        lp = lp + a * torch.log(b)
    if include_summand(propto, y, alpha):
        lp = lp + (a - 1.0) * torch.log(ys)
    if include_summand(propto, y, beta):
        lp = lp - b * ys
    return finish(lp, ok, batch_ndims)


def gamma_cdf(y, alpha, beta, *, batch_ndims=0):
    yb, ab, bb = bcast(y, alpha, beta)
    ok = ok_pos(ab) & ok_pos(bb)
    p = torch.where(yb > 0, gamma_p(safe(ab, ok), safe(bb, ok) * torch.clamp_min(yb, 0.0)), 0.0)
    return finish_prod(p, ok, batch_ndims)


def gamma_lcdf(y, alpha, beta, *, batch_ndims=0):
    yb, ab, bb = bcast(y, alpha, beta)
    ok = ok_pos(ab) & ok_pos(bb)
    p = torch.where(
        yb > 0,
        gamma_p(safe(ab, ok), safe(bb, ok) * torch.clamp_min(yb, 1e-300)),
        0.0,
    )
    return finish(torch.log(p), ok, batch_ndims)


def gamma_lccdf(y, alpha, beta, *, batch_ndims=0):
    yb, ab, bb = bcast(y, alpha, beta)
    ok = ok_pos(ab) & ok_pos(bb)
    p = torch.where(
        yb > 0,
        gamma_q(safe(ab, ok), safe(bb, ok) * torch.clamp_min(yb, 0.0)),
        1.0,
    )
    return finish(torch.log(p), ok, batch_ndims)


def gamma_rng(generator, alpha, beta, shape=None):
    alpha, beta = rng_params(generator, alpha, beta)
    return _gamma(generator, alpha, rng_shape(shape, alpha, beta)) / beta


def inv_gamma_lpdf(y, alpha, beta, *, propto=False, batch_ndims=0):
    """Ref: inv_gamma_lpdf.hpp."""
    yb, ab, bb = bcast(y, alpha, beta)
    okp = ok_pos(ab) & ok_pos(bb)
    sup = yb > 0
    ok = okp & sup
    a, b, ys = safe(ab, okp), safe(bb, okp), safe(yb, sup)
    lp = torch.zeros_like(yb)
    if include_summand(propto, alpha):
        lp = lp - torch.lgamma(a)
    if include_summand(propto, alpha, beta):
        lp = lp + a * torch.log(b)
    if include_summand(propto, y, alpha):
        lp = lp - (a + 1.0) * torch.log(ys)
    if include_summand(propto, y, beta):
        lp = lp - b / ys
    return finish(lp, ok, batch_ndims)


def inv_gamma_cdf(y, alpha, beta, *, batch_ndims=0):
    yb, ab, bb = bcast(y, alpha, beta)
    ok = ok_pos(ab) & ok_pos(bb)
    p = torch.where(
        yb > 0, gamma_q(safe(ab, ok), safe(bb, ok) / torch.clamp_min(yb, 1e-300)), 0.0
    )
    return finish_prod(p, ok, batch_ndims)


def inv_gamma_lcdf(y, alpha, beta, *, batch_ndims=0):
    yb, ab, bb = bcast(y, alpha, beta)
    ok = ok_pos(ab) & ok_pos(bb)
    p = torch.where(
        yb > 0, gamma_q(safe(ab, ok), safe(bb, ok) / torch.clamp_min(yb, 1e-300)), 0.0
    )
    return finish(torch.log(p), ok, batch_ndims)


def inv_gamma_lccdf(y, alpha, beta, *, batch_ndims=0):
    yb, ab, bb = bcast(y, alpha, beta)
    ok = ok_pos(ab) & ok_pos(bb)
    p = torch.where(
        yb > 0, gamma_p(safe(ab, ok), safe(bb, ok) / torch.clamp_min(yb, 1e-300)), 1.0
    )
    return finish(torch.log(p), ok, batch_ndims)


def inv_gamma_rng(generator, alpha, beta, shape=None):
    alpha, beta = rng_params(generator, alpha, beta)
    return beta / _gamma(generator, alpha, rng_shape(shape, alpha, beta))


def chi_square_lpdf(y, nu, *, propto=False, batch_ndims=0):
    yb, nb = bcast(y, nu)
    okp = ok_pos(nb)
    sup = yb > 0
    ok = okp & sup
    n, ys = safe(nb, okp), safe(yb, sup)
    half_n = 0.5 * n
    lp = torch.zeros_like(yb)
    if include_summand(propto, nu):
        lp = lp - torch.lgamma(half_n) - half_n * LOG_TWO
    if include_summand(propto, y, nu):
        lp = lp + (half_n - 1.0) * torch.log(ys)
    if include_summand(propto, y):
        lp = lp - 0.5 * ys
    return finish(lp, ok, batch_ndims)


def chi_square_cdf(y, nu, *, batch_ndims=0):
    yb, nb = bcast(y, nu)
    ok = ok_pos(nb)
    p = torch.where(yb > 0, gamma_p(0.5 * safe(nb, ok), 0.5 * torch.clamp_min(yb, 0.0)), 0.0)
    return finish_prod(p, ok, batch_ndims)


def chi_square_lcdf(y, nu, *, batch_ndims=0):
    yb, nb = bcast(y, nu)
    ok = ok_pos(nb)
    p = torch.where(yb > 0, gamma_p(0.5 * safe(nb, ok), 0.5 * torch.clamp_min(yb, 1e-300)), 0.0)
    return finish(torch.log(p), ok, batch_ndims)


def chi_square_lccdf(y, nu, *, batch_ndims=0):
    yb, nb = bcast(y, nu)
    ok = ok_pos(nb)
    p = torch.where(yb > 0, gamma_q(0.5 * safe(nb, ok), 0.5 * torch.clamp_min(yb, 0.0)), 1.0)
    return finish(torch.log(p), ok, batch_ndims)


def chi_square_rng(generator, nu, shape=None):
    (nu,) = rng_params(generator, nu)
    return 2.0 * _gamma(generator, 0.5 * nu, rng_shape(shape, nu))


def inv_chi_square_lpdf(y, nu, *, propto=False, batch_ndims=0):
    yb, nb = bcast(y, nu)
    okp = ok_pos(nb)
    sup = yb > 0
    ok = okp & sup
    n, ys = safe(nb, okp), safe(yb, sup)
    half_n = 0.5 * n
    lp = torch.zeros_like(yb)
    if include_summand(propto, nu):
        lp = lp - torch.lgamma(half_n) - half_n * LOG_TWO
    if include_summand(propto, y, nu):
        lp = lp - (half_n + 1.0) * torch.log(ys)
    if include_summand(propto, y):
        lp = lp - 0.5 / ys
    return finish(lp, ok, batch_ndims)


def inv_chi_square_cdf(y, nu, *, batch_ndims=0):
    yb, nb = bcast(y, nu)
    ok = ok_pos(nb)
    p = torch.where(
        yb > 0, gamma_q(0.5 * safe(nb, ok), 0.5 / torch.clamp_min(yb, 1e-300)), 0.0
    )
    return finish_prod(p, ok, batch_ndims)


def inv_chi_square_lcdf(y, nu, *, batch_ndims=0):
    yb, nb = bcast(y, nu)
    ok = ok_pos(nb)
    p = torch.where(
        yb > 0, gamma_q(0.5 * safe(nb, ok), 0.5 / torch.clamp_min(yb, 1e-300)), 0.0
    )
    return finish(torch.log(p), ok, batch_ndims)


def inv_chi_square_lccdf(y, nu, *, batch_ndims=0):
    yb, nb = bcast(y, nu)
    ok = ok_pos(nb)
    p = torch.where(
        yb > 0, gamma_p(0.5 * safe(nb, ok), 0.5 / torch.clamp_min(yb, 1e-300)), 1.0
    )
    return finish(torch.log(p), ok, batch_ndims)


def inv_chi_square_rng(generator, nu, shape=None):
    (nu,) = rng_params(generator, nu)
    return 0.5 / _gamma(generator, 0.5 * nu, rng_shape(shape, nu))


def scaled_inv_chi_square_lpdf(y, nu, s, *, propto=False, batch_ndims=0):
    yb, nb, sb = bcast(y, nu, s)
    okp = ok_pos(nb) & ok_pos(sb)
    sup = yb > 0
    ok = okp & sup
    n, sc, ys = safe(nb, okp), safe(sb, okp), safe(yb, sup)
    half_n = 0.5 * n
    lp = torch.zeros_like(yb)
    if include_summand(propto, nu):
        lp = lp + half_n * torch.log(half_n) - torch.lgamma(half_n)
    if include_summand(propto, nu, s):
        lp = lp + n * torch.log(sc)
    if include_summand(propto, y, nu):
        lp = lp - (half_n + 1.0) * torch.log(ys)
    if include_summand(propto, y, nu, s):
        lp = lp - half_n * torch.square(sc) / ys  # nu*s^2/(2y)
    return finish(lp, ok, batch_ndims)


def scaled_inv_chi_square_cdf(y, nu, s, *, batch_ndims=0):
    yb, nb, sb = bcast(y, nu, s)
    ok = ok_pos(nb) & ok_pos(sb)
    arg = 0.5 * safe(nb, ok) * torch.square(safe(sb, ok)) / torch.clamp_min(yb, 1e-300)
    p = torch.where(yb > 0, gamma_q(0.5 * safe(nb, ok), arg), 0.0)
    return finish_prod(p, ok, batch_ndims)


def scaled_inv_chi_square_lcdf(y, nu, s, *, batch_ndims=0):
    yb, nb, sb = bcast(y, nu, s)
    ok = ok_pos(nb) & ok_pos(sb)
    arg = 0.5 * safe(nb, ok) * torch.square(safe(sb, ok)) / torch.clamp_min(yb, 1e-300)
    p = torch.where(yb > 0, gamma_q(0.5 * safe(nb, ok), arg), 0.0)
    return finish(torch.log(p), ok, batch_ndims)


def scaled_inv_chi_square_lccdf(y, nu, s, *, batch_ndims=0):
    yb, nb, sb = bcast(y, nu, s)
    ok = ok_pos(nb) & ok_pos(sb)
    arg = 0.5 * safe(nb, ok) * torch.square(safe(sb, ok)) / torch.clamp_min(yb, 1e-300)
    p = torch.where(yb > 0, gamma_p(0.5 * safe(nb, ok), arg), 1.0)
    return finish(torch.log(p), ok, batch_ndims)


def scaled_inv_chi_square_rng(generator, nu, s, shape=None):
    nu, s = rng_params(generator, nu, s)
    return 0.5 * nu * torch.square(s) / _gamma(generator, 0.5 * nu, rng_shape(shape, nu, s))


def weibull_lpdf(y, alpha, sigma, *, propto=False, batch_ndims=0):
    """Shape alpha, scale sigma (ref: weibull_lpdf.hpp)."""
    yb, ab, sb = bcast(y, alpha, sigma)
    okp = ok_pos(ab) & ok_pos(sb)
    sup = yb >= 0
    ok = okp & sup & torch.isfinite(yb)
    a, s, ys = safe(ab, okp), safe(sb, okp), safe(yb, yb > 0)
    lp = torch.zeros_like(yb)
    if include_summand(propto, alpha):
        lp = lp + torch.log(a)
    if include_summand(propto, y, alpha, sigma):
        lp = lp + (a - 1.0) * (torch.log(ys) - torch.log(s)) - torch.pow(ys / s, a)
    if include_summand(propto, sigma):
        lp = lp - torch.log(s)
    return finish(lp, ok, batch_ndims)


def weibull_cdf(y, alpha, sigma, *, batch_ndims=0):
    yb, ab, sb = bcast(y, alpha, sigma)
    ok = ok_pos(ab) & ok_pos(sb)
    p = torch.where(
        yb > 0,
        -torch.expm1(-torch.pow(torch.clamp_min(yb, 0.0) / safe(sb, ok), safe(ab, ok))),
        0.0,
    )
    return finish_prod(p, ok, batch_ndims)


def weibull_lcdf(y, alpha, sigma, *, batch_ndims=0):
    yb, ab, sb = bcast(y, alpha, sigma)
    ok = ok_pos(ab) & ok_pos(sb)
    lp = torch.where(
        yb > 0,
        log1m_exp(-torch.pow(torch.clamp_min(yb, 1e-300) / safe(sb, ok), safe(ab, ok))),
        -math.inf,
    )
    return finish(lp, ok, batch_ndims)


def weibull_lccdf(y, alpha, sigma, *, batch_ndims=0):
    yb, ab, sb = bcast(y, alpha, sigma)
    ok = ok_pos(ab) & ok_pos(sb)
    lp = torch.where(
        yb > 0, -torch.pow(torch.clamp_min(yb, 0.0) / safe(sb, ok), safe(ab, ok)), 0.0
    )
    return finish(lp, ok, batch_ndims)


def weibull_rng(generator, alpha, sigma, shape=None):
    alpha, sigma = rng_params(generator, alpha, sigma)
    e = _exponential(generator, rng_shape(shape, alpha, sigma), alpha)
    return sigma * torch.pow(e, 1.0 / alpha)


def frechet_lpdf(y, alpha, sigma, *, propto=False, batch_ndims=0):
    yb, ab, sb = bcast(y, alpha, sigma)
    okp = ok_pos(ab) & ok_pos(sb)
    sup = yb > 0
    ok = okp & sup
    a, s, ys = safe(ab, okp), safe(sb, okp), safe(yb, sup)
    lp = torch.zeros_like(yb)
    if include_summand(propto, alpha):
        lp = lp + torch.log(a)
    if include_summand(propto, y, alpha, sigma):
        lp = lp + (a + 1.0) * (torch.log(s) - torch.log(ys)) - torch.pow(s / ys, a)
    if include_summand(propto, sigma):
        lp = lp - torch.log(s)
    return finish(lp, ok, batch_ndims)


def frechet_cdf(y, alpha, sigma, *, batch_ndims=0):
    yb, ab, sb = bcast(y, alpha, sigma)
    ok = ok_pos(ab) & ok_pos(sb)
    p = torch.where(
        yb > 0,
        torch.exp(-torch.pow(safe(sb, ok) / torch.clamp_min(yb, 1e-300), safe(ab, ok))),
        0.0,
    )
    return finish_prod(p, ok, batch_ndims)


def frechet_lcdf(y, alpha, sigma, *, batch_ndims=0):
    yb, ab, sb = bcast(y, alpha, sigma)
    ok = ok_pos(ab) & ok_pos(sb)
    lp = torch.where(
        yb > 0,
        -torch.pow(safe(sb, ok) / torch.clamp_min(yb, 1e-300), safe(ab, ok)),
        -math.inf,
    )
    return finish(lp, ok, batch_ndims)


def frechet_lccdf(y, alpha, sigma, *, batch_ndims=0):
    yb, ab, sb = bcast(y, alpha, sigma)
    ok = ok_pos(ab) & ok_pos(sb)
    lp = torch.where(
        yb > 0,
        log1m_exp(-torch.pow(safe(sb, ok) / torch.clamp_min(yb, 1e-300), safe(ab, ok))),
        0.0,
    )
    return finish(lp, ok, batch_ndims)


def frechet_rng(generator, alpha, sigma, shape=None):
    alpha, sigma = rng_params(generator, alpha, sigma)
    e = _exponential(generator, rng_shape(shape, alpha, sigma), alpha)
    return sigma * torch.pow(e, -1.0 / alpha)


def rayleigh_lpdf(y, sigma, *, propto=False, batch_ndims=0):
    yb, sb = bcast(y, sigma)
    okp = ok_pos(sb)
    sup = yb >= 0
    ok = okp & sup & torch.isfinite(yb)
    s, ys = safe(sb, okp), safe(yb, yb > 0)
    lp = torch.zeros_like(yb)
    if include_summand(propto, y):
        lp = lp + torch.log(ys)
    if include_summand(propto, sigma):
        lp = lp - 2.0 * torch.log(s)
    if include_summand(propto, y, sigma):
        lp = lp - 0.5 * torch.square(ys / s)
    return finish(lp, ok, batch_ndims)


def rayleigh_cdf(y, sigma, *, batch_ndims=0):
    yb, sb = bcast(y, sigma)
    ok = ok_pos(sb)
    p = torch.where(yb > 0, -torch.expm1(-0.5 * torch.square(torch.clamp_min(yb, 0.0) / safe(sb, ok))), 0.0)
    return finish_prod(p, ok, batch_ndims)


def rayleigh_lcdf(y, sigma, *, batch_ndims=0):
    yb, sb = bcast(y, sigma)
    ok = ok_pos(sb)
    lp = torch.where(
        yb > 0,
        log1m_exp(-0.5 * torch.square(torch.clamp_min(yb, 1e-300) / safe(sb, ok))),
        -math.inf,
    )
    return finish(lp, ok, batch_ndims)


def rayleigh_lccdf(y, sigma, *, batch_ndims=0):
    yb, sb = bcast(y, sigma)
    ok = ok_pos(sb)
    return finish(torch.where(yb > 0, -0.5 * torch.square(torch.clamp_min(yb, 0.0) / safe(sb, ok)), 0.0), ok, batch_ndims)


def rayleigh_rng(generator, sigma, shape=None):
    (sigma,) = rng_params(generator, sigma)
    return sigma * torch.sqrt(2.0 * _exponential(generator, rng_shape(shape, sigma), sigma))


# ---------------------------------------------------------------------------
# pareto family (ref: pareto_lpdf.hpp, pareto_type_2_lpdf.hpp)
# ---------------------------------------------------------------------------


def pareto_lpdf(y, y_min, alpha, *, propto=False, batch_ndims=0):
    yb, mb, ab = bcast(y, y_min, alpha)
    okp = ok_pos(mb) & ok_pos(ab)
    sup = yb >= mb
    ok = okp & sup & torch.isfinite(yb)
    m, a, ys = safe(mb, okp), safe(ab, okp), safe(yb, yb > 0)
    lp = torch.zeros_like(yb)
    if include_summand(propto, alpha):
        lp = lp + torch.log(a)
    if include_summand(propto, y_min, alpha):
        lp = lp + a * torch.log(m)
    if include_summand(propto, y, alpha):
        lp = lp - (a + 1.0) * torch.log(ys)
    return finish(lp, ok, batch_ndims)


def pareto_cdf(y, y_min, alpha, *, batch_ndims=0):
    yb, mb, ab = bcast(y, y_min, alpha)
    ok = ok_pos(mb) & ok_pos(ab)
    p = torch.where(
        yb >= mb,
        -torch.expm1(safe(ab, ok) * (torch.log(safe(mb, ok)) - torch.log(torch.clamp_min(yb, 1e-300)))),
        0.0,
    )
    return finish_prod(p, ok, batch_ndims)


def pareto_lcdf(y, y_min, alpha, *, batch_ndims=0):
    yb, mb, ab = bcast(y, y_min, alpha)
    ok = ok_pos(mb) & ok_pos(ab)
    r = safe(ab, ok) * (torch.log(safe(mb, ok)) - torch.log(torch.clamp_min(yb, 1e-300)))
    lp = torch.where(yb > mb, log1m_exp(torch.clamp_max(r, -1e-300)), -math.inf)
    return finish(lp, ok, batch_ndims)


def pareto_lccdf(y, y_min, alpha, *, batch_ndims=0):
    yb, mb, ab = bcast(y, y_min, alpha)
    ok = ok_pos(mb) & ok_pos(ab)
    r = safe(ab, ok) * (torch.log(safe(mb, ok)) - torch.log(torch.clamp_min(yb, 1e-300)))
    return finish(torch.where(yb >= mb, r, 0.0), ok, batch_ndims)


def pareto_rng(generator, y_min, alpha, shape=None):
    y_min, alpha = rng_params(generator, y_min, alpha)
    e = _exponential(generator, rng_shape(shape, y_min, alpha), alpha)
    return y_min * torch.exp(e / alpha)


def pareto_type_2_lpdf(y, mu, lam, alpha, *, propto=False, batch_ndims=0):
    yb, mub, lb, ab = bcast(y, mu, lam, alpha)
    okp = torch.isfinite(mub) & ok_pos(lb) & ok_pos(ab)
    sup = yb >= mub
    ok = okp & sup & torch.isfinite(yb)
    l, a = safe(lb, okp), safe(ab, okp)
    z = (yb - safe(mub, okp, 0.0)) / l
    z = torch.clamp_min(z, 0.0)
    lp = torch.zeros_like(yb)
    if include_summand(propto, alpha):
        lp = lp + torch.log(a)
    if include_summand(propto, lam):
        lp = lp - torch.log(l)
    if include_summand(propto, y, mu, lam, alpha):
        lp = lp - (a + 1.0) * torch.log1p(z)
    return finish(lp, ok, batch_ndims)


def pareto_type_2_cdf(y, mu, lam, alpha, *, batch_ndims=0):
    yb, mub, lb, ab = bcast(y, mu, lam, alpha)
    ok = ok_pos(lb) & ok_pos(ab)
    z = torch.clamp_min((yb - mub) / safe(lb, ok), 0.0)
    p = -torch.expm1(-safe(ab, ok) * torch.log1p(z))
    return finish_prod(p, ok, batch_ndims)


def pareto_type_2_lcdf(y, mu, lam, alpha, *, batch_ndims=0):
    yb, mub, lb, ab = bcast(y, mu, lam, alpha)
    ok = ok_pos(lb) & ok_pos(ab)
    z = torch.clamp_min((yb - mub) / safe(lb, ok), 0.0)
    r = -safe(ab, ok) * torch.log1p(z)
    lp = torch.where(yb > mub, log1m_exp(torch.clamp_max(r, -1e-300)), -math.inf)
    return finish(lp, ok, batch_ndims)


def pareto_type_2_lccdf(y, mu, lam, alpha, *, batch_ndims=0):
    yb, mub, lb, ab = bcast(y, mu, lam, alpha)
    ok = ok_pos(lb) & ok_pos(ab)
    z = torch.clamp_min((yb - mub) / safe(lb, ok), 0.0)
    return finish(-safe(ab, ok) * torch.log1p(z), ok, batch_ndims)


def pareto_type_2_rng(generator, mu, lam, alpha, shape=None):
    mu, lam, alpha = rng_params(generator, mu, lam, alpha)
    e = _exponential(generator, rng_shape(shape, mu, lam, alpha), alpha)
    return mu + lam * torch.expm1(e / alpha)


# ---------------------------------------------------------------------------
# (0,1) support: beta, beta_proportion, uniform
# ---------------------------------------------------------------------------


def beta_lpdf(y, alpha, beta, *, propto=False, batch_ndims=0):
    yb, ab, bb = bcast(y, alpha, beta)
    okp = ok_pos(ab) & ok_pos(bb)
    sup = (yb > 0) & (yb < 1)
    ok = okp & sup
    a, b, ys = safe(ab, okp), safe(bb, okp), safe(yb, sup, 0.5)
    lp = torch.zeros_like(yb)
    if include_summand(propto, alpha, beta):
        lp = lp - lbeta(a, b)
    if include_summand(propto, y, alpha):
        lp = lp + (a - 1.0) * torch.log(ys)
    if include_summand(propto, y, beta):
        lp = lp + (b - 1.0) * torch.log1p(-ys)
    return finish(lp, ok, batch_ndims)


def beta_cdf(y, alpha, beta, *, batch_ndims=0):
    yb, ab, bb = bcast(y, alpha, beta)
    ok = ok_pos(ab) & ok_pos(bb)
    yc = torch.clamp(yb, 0.0, 1.0)
    return finish_prod(inc_beta(safe(ab, ok), safe(bb, ok), yc), ok, batch_ndims)


def beta_lcdf(y, alpha, beta, *, batch_ndims=0):
    yb, ab, bb = bcast(y, alpha, beta)
    ok = ok_pos(ab) & ok_pos(bb)
    yc = torch.clamp(yb, 0.0, 1.0)
    return finish(torch.log(inc_beta(safe(ab, ok), safe(bb, ok), yc)), ok, batch_ndims)


def beta_lccdf(y, alpha, beta, *, batch_ndims=0):
    yb, ab, bb = bcast(y, alpha, beta)
    ok = ok_pos(ab) & ok_pos(bb)
    yc = torch.clamp(yb, 0.0, 1.0)
    return finish(torch.log(inc_beta(safe(bb, ok), safe(ab, ok), 1.0 - yc)), ok, batch_ndims)


def beta_rng(generator, alpha, beta, shape=None):
    alpha, beta = rng_params(generator, alpha, beta)
    return _beta(generator, alpha, beta, rng_shape(shape, alpha, beta))


def beta_proportion_lpdf(y, mu, kappa, *, propto=False, batch_ndims=0):
    """mu in (0,1) mean, kappa > 0 precision (ref: beta_proportion_lpdf.hpp)."""
    yb, mub, kb = bcast(y, mu, kappa)
    okp = torch.isfinite(mub) & (mub > 0) & (mub < 1) & ok_pos(kb)
    sup = (yb > 0) & (yb < 1)
    ok = okp & sup
    m, k, ys = safe(mub, okp, 0.5), safe(kb, okp), safe(yb, sup, 0.5)
    a = m * k
    b = (1.0 - m) * k
    lp = torch.zeros_like(yb)
    if include_summand(propto, mu, kappa):
        lp = lp - lbeta(a, b)
    if include_summand(propto, y, mu, kappa):
        lp = lp + (a - 1.0) * torch.log(ys) + (b - 1.0) * torch.log1p(-ys)
    return finish(lp, ok, batch_ndims)


def beta_proportion_lcdf(y, mu, kappa, *, batch_ndims=0):
    yb, mub, kb = bcast(y, mu, kappa)
    ok = (mub > 0) & (mub < 1) & ok_pos(kb)
    m, k = safe(mub, ok, 0.5), safe(kb, ok)
    yc = torch.clamp(yb, 0.0, 1.0)
    return finish(torch.log(inc_beta(m * k, (1.0 - m) * k, yc)), ok, batch_ndims)


def beta_proportion_lccdf(y, mu, kappa, *, batch_ndims=0):
    yb, mub, kb = bcast(y, mu, kappa)
    ok = (mub > 0) & (mub < 1) & ok_pos(kb)
    m, k = safe(mub, ok, 0.5), safe(kb, ok)
    yc = torch.clamp(yb, 0.0, 1.0)
    return finish(torch.log(inc_beta((1.0 - m) * k, m * k, 1.0 - yc)), ok, batch_ndims)


def beta_proportion_rng(generator, mu, kappa, shape=None):
    mu, kappa = rng_params(generator, mu, kappa)
    return _beta(generator, mu * kappa, (1.0 - mu) * kappa, rng_shape(shape, mu, kappa))


def uniform_lpdf(y, alpha, beta, *, propto=False, batch_ndims=0):
    yb, ab, bb = bcast(y, alpha, beta)
    okp = torch.isfinite(ab) & torch.isfinite(bb) & (ab < bb)
    sup = (yb >= ab) & (yb <= bb)
    ok = okp & sup
    lp = torch.zeros_like(yb)
    if include_summand(propto, alpha, beta):
        lp = lp - torch.log(safe(bb - ab, okp))
    return finish(lp, ok, batch_ndims)


def uniform_cdf(y, alpha, beta, *, batch_ndims=0):
    yb, ab, bb = bcast(y, alpha, beta)
    ok = ab < bb
    p = torch.clamp((yb - ab) / safe(bb - ab, ok), 0.0, 1.0)
    return finish_prod(p, ok, batch_ndims)


def uniform_lcdf(y, alpha, beta, *, batch_ndims=0):
    yb, ab, bb = bcast(y, alpha, beta)
    ok = ab < bb
    p = torch.clamp((yb - ab) / safe(bb - ab, ok), 0.0, 1.0)
    return finish(torch.log(p), ok, batch_ndims)


def uniform_lccdf(y, alpha, beta, *, batch_ndims=0):
    yb, ab, bb = bcast(y, alpha, beta)
    ok = ab < bb
    p = torch.clamp((yb - ab) / safe(bb - ab, ok), 0.0, 1.0)
    return finish(torch.log1p(-p), ok, batch_ndims)


def uniform_rng(generator, alpha, beta, shape=None):
    alpha, beta = rng_params(generator, alpha, beta)
    u = torch.rand(rng_shape(shape, alpha, beta), generator=generator, dtype=alpha.dtype, device=alpha.device)
    return alpha + (beta - alpha) * u


# ---------------------------------------------------------------------------
# circular / skewed: von_mises, skew_normal, exp_mod_normal
# ---------------------------------------------------------------------------


def von_mises_lpdf(y, mu, kappa, *, propto=False, batch_ndims=0):
    yb, mub, kb = bcast(y, mu, kappa)
    ok = torch.isfinite(yb) & torch.isfinite(mub) & torch.isfinite(kb) & (kb >= 0)
    k = safe(kb, ok)
    lp = torch.zeros_like(yb)
    if include_summand(propto, y, mu, kappa):
        lp = lp + k * torch.cos(yb - safe(mub, ok, 0.0))
    if include_summand(propto, kappa):
        lp = lp - log_i0(k)
    if include_summand(propto):
        lp = lp - LOG_TWO_PI
    return finish(lp, ok, batch_ndims)


def von_mises_rng(generator, mu, kappa, shape=None):
    """Best-Fisher rejection-free approximation via wrapped inversion.

    Uses the standard Best & Fisher (1979) envelope with a fixed number of
    proposal rounds (vectorized acceptance), adequate for kappa <~ 100.
    """
    mu, kappa = rng_params(generator, mu, kappa)
    shape = rng_shape(shape, mu, kappa)
    kap = kappa.expand(shape)
    tau = 1.0 + torch.sqrt(1.0 + 4.0 * kap * kap)
    rho = (tau - torch.sqrt(2.0 * tau)) / (2.0 * torch.clamp_min(kap, 1e-10))
    r = (1.0 + rho * rho) / (2.0 * rho)
    ROUNDS = 16
    theta = torch.zeros(shape, dtype=kap.dtype, device=kap.device)
    accepted = torch.zeros(shape, dtype=torch.bool, device=kap.device)
    for _ in range(ROUNDS):
        u1, u2, u3 = (torch.rand(shape, generator=generator, dtype=kap.dtype, device=kap.device) for _ in range(3))
        z = torch.cos(math.pi * u1)
        f = (1.0 + r * z) / (r + z)
        c = kap * (r - f)
        accept = (c * (2.0 - c) - u2 > 0) | (torch.log(c / torch.clamp_min(u2, 1e-30)) + 1.0 - c >= 0)
        cand = torch.sign(u3 - 0.5) * torch.arccos(torch.clamp(f, -1.0, 1.0))
        theta = torch.where(accepted, theta, torch.where(accept, cand, theta))
        accepted = accepted | accept
    out = mu + theta
    return torch.remainder(out + math.pi, 2.0 * math.pi) - math.pi


def skew_normal_lpdf(y, xi, omega, alpha, *, propto=False, batch_ndims=0):
    yb, xb, ob, ab = bcast(y, xi, omega, alpha)
    ok = torch.isfinite(yb) & torch.isfinite(xb) & ok_pos(ob) & torch.isfinite(ab)
    o = safe(ob, ok)
    z = (yb - safe(xb, ok, 0.0)) / o
    lp = torch.zeros_like(yb)
    if include_summand(propto, y, xi, omega, alpha):
        lp = lp - 0.5 * torch.square(z) + LOG_TWO + torch.special.log_ndtr(safe(ab, ok, 0.0) * z)
    if include_summand(propto, omega):
        lp = lp - torch.log(o)
    if include_summand(propto):
        lp = lp - LOG_SQRT_TWO_PI
    return finish(lp, ok, batch_ndims)


def skew_normal_cdf(y, xi, omega, alpha, *, batch_ndims=0):
    """Phi(z) - 2*OwensT(z, alpha) (ref: skew_normal_cdf.hpp via Owen's T)."""
    yb, xb, ob, ab = bcast(y, xi, omega, alpha)
    ok = ok_pos(ob)
    z = (yb - xb) / safe(ob, ok)
    p = torch.special.ndtr(z) - 2.0 * owens_t(z, ab)
    return finish_prod(p, ok, batch_ndims)


def skew_normal_lcdf(y, xi, omega, alpha, *, batch_ndims=0):
    yb, xb, ob, ab = bcast(y, xi, omega, alpha)
    ok = ok_pos(ob)
    z = (yb - xb) / safe(ob, ok)
    p = torch.special.ndtr(z) - 2.0 * owens_t(z, ab)
    return finish(torch.log(torch.clamp_min(p, 1e-300)), ok, batch_ndims)


def skew_normal_lccdf(y, xi, omega, alpha, *, batch_ndims=0):
    yb, xb, ob, ab = bcast(y, xi, omega, alpha)
    ok = ok_pos(ob)
    z = (yb - xb) / safe(ob, ok)
    p = torch.special.ndtr(z) - 2.0 * owens_t(z, ab)
    return finish(torch.log1p(-torch.clamp_max(p, 1.0 - 1e-16)), ok, batch_ndims)


def skew_normal_rng(generator, xi, omega, alpha, shape=None):
    """Conditioning representation: |correlated normal pair| (Azzalini)."""
    xi, omega, alpha = rng_params(generator, xi, omega, alpha)
    shape = rng_shape(shape, xi, omega, alpha)
    delta = alpha / torch.sqrt(1.0 + torch.square(alpha))
    u0 = _normal(generator, shape, xi)
    v = _normal(generator, shape, xi)
    u1 = delta * u0 + torch.sqrt(1.0 - torch.square(delta)) * v
    return xi + omega * torch.where(u0 >= 0, u1, -u1)


def exp_mod_normal_lpdf(y, mu, sigma, lam, *, propto=False, batch_ndims=0):
    yb, mub, sb, lb = bcast(y, mu, sigma, lam)
    ok = torch.isfinite(yb) & torch.isfinite(mub) & ok_pos(sb) & ok_pos(lb)
    s, l = safe(sb, ok), safe(lb, ok)
    m = safe(mub, ok, 0.0)
    lp = torch.zeros_like(yb)
    if include_summand(propto, lam):
        lp = lp + torch.log(l)
    if include_summand(propto, y, mu, sigma, lam):
        lp = lp + 0.5 * l * (2.0 * m + l * torch.square(s) - 2.0 * yb)
        lp = lp + torch.special.log_ndtr((yb - m - l * torch.square(s)) / s)
    return finish(lp, ok, batch_ndims)


def exp_mod_normal_cdf(y, mu, sigma, lam, *, batch_ndims=0):
    yb, mub, sb, lb = bcast(y, mu, sigma, lam)
    ok = ok_pos(sb) & ok_pos(lb)
    s, l = safe(sb, ok), safe(lb, ok)
    u = (yb - mub) / s
    p = torch.special.ndtr(u) - torch.exp(
        torch.clamp_max(-l * (yb - mub) + 0.5 * torch.square(l * s), 30.0)
        + torch.special.log_ndtr(u - l * s)
    )
    return finish_prod(torch.clamp(p, 0.0, 1.0), ok, batch_ndims)


def exp_mod_normal_lcdf(y, mu, sigma, lam, *, batch_ndims=0):
    yb, mub, sb, lb = bcast(y, mu, sigma, lam)
    ok = ok_pos(sb) & ok_pos(lb)
    s, l = safe(sb, ok), safe(lb, ok)
    u = (yb - mub) / s
    p = torch.special.ndtr(u) - torch.exp(
        torch.clamp_max(-l * (yb - mub) + 0.5 * torch.square(l * s), 30.0)
        + torch.special.log_ndtr(u - l * s)
    )
    return finish(torch.log(torch.clamp_min(p, 1e-300)), ok, batch_ndims)


def exp_mod_normal_lccdf(y, mu, sigma, lam, *, batch_ndims=0):
    yb, mub, sb, lb = bcast(y, mu, sigma, lam)
    ok = ok_pos(sb) & ok_pos(lb)
    s, l = safe(sb, ok), safe(lb, ok)
    u = (yb - mub) / s
    p = torch.special.ndtr(u) - torch.exp(
        torch.clamp_max(-l * (yb - mub) + 0.5 * torch.square(l * s), 30.0)
        + torch.special.log_ndtr(u - l * s)
    )
    return finish(torch.log1p(-torch.clamp(p, 0.0, 1.0 - 1e-16)), ok, batch_ndims)


def exp_mod_normal_rng(generator, mu, sigma, lam, shape=None):
    mu, sigma, lam = rng_params(generator, mu, sigma, lam)
    shape = rng_shape(shape, mu, sigma, lam)
    return mu + sigma * _normal(generator, shape, mu) + _exponential(generator, shape, mu) / lam