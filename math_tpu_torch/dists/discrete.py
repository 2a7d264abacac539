"""Discrete univariate distributions.

Counterpart: ``math_tpu/dists/discrete.py`` (reference:
``prim/scal/prob/{bernoulli,binomial,beta_binomial,poisson,
neg_binomial*,hypergeometric}_*.hpp`` plus the categorical/ordered families
from ``prim/mat/prob``).  Same conventions as ``continuous.py``: the sum over
every axis after the first ``batch_ndims``, ``propto`` pruning by
``include_summand``, product-form cdf, log-form lcdf/lccdf, ``-inf`` for
invalid parameters or off-support outcomes with sanitized inputs so
gradients stay nan-free; ``_rng`` functions take a ``torch.Generator``.
Outcomes ``y`` are data (numpy arrays or tensors); categories are 1-based.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from math_tpu_torch.special import gamma_p, gamma_q, inc_beta, lbeta, lchoose, log1m, log1m_exp
from math_tpu_torch.special.incbeta import log_inc_beta
from math_tpu_torch.utils.propto import include_summand
from math_tpu_torch.dists._util import (
    all_event,
    as_tensors,
    bcast,
    finish,
    finish_prod,
    ok_ordered,
    ok_pos,
    ok_simplex,
    rng_params,
    rng_shape,
    safe,
)

__all__ = [
    "bernoulli_lpmf", "bernoulli_cdf", "bernoulli_lcdf", "bernoulli_lccdf", "bernoulli_rng", "bernoulli_logit_lpmf",
    "bernoulli_logit_rng", "binomial_lpmf", "binomial_cdf", "binomial_lcdf", "binomial_lccdf", "binomial_rng",
    "binomial_logit_lpmf", "binomial_logit_rng", "beta_binomial_lpmf", "beta_binomial_rng", "poisson_lpmf",
    "poisson_cdf", "poisson_lcdf", "poisson_lccdf", "poisson_rng", "poisson_log_lpmf", "poisson_log_rng",
    "neg_binomial_lpmf", "neg_binomial_cdf", "neg_binomial_rng", "neg_binomial_2_lpmf", "neg_binomial_2_cdf",
    "neg_binomial_2_lcdf", "neg_binomial_2_lccdf", "neg_binomial_2_rng", "neg_binomial_2_log_lpmf",
    "neg_binomial_2_log_rng", "hypergeometric_lpmf", "hypergeometric_rng", "categorical_lpmf",
    "categorical_logit_lpmf", "categorical_rng", "categorical_logit_rng", "ordered_logistic_lpmf",
    "ordered_logistic_rng", "ordered_probit_lpmf", "ordered_probit_rng",
]


def _softplus(t):
    # not F.softplus: its threshold=20 switch differs from the exact form
    return torch.logaddexp(torch.zeros_like(t), t)


def _int_ok(y):
    return torch.isfinite(y) & (y == torch.round(y))


def _category_index(y, device):
    """0-based int64 categories of 1-based outcomes (truncated as JAX's int32 cast)."""
    if isinstance(y, torch.Tensor):
        return y.to(device=device, dtype=torch.int64) - 1
    return torch.as_tensor(np.asarray(y).astype(np.int64), device=device) - 1


def _lead_axes(t, batch_ndims, event_ndims):
    """``t`` (batch..., rest..., last) with singleton axes inserted after the
    batch axes so that ``rest`` lines up with an event of ``event_ndims`` axes."""
    pad = event_ndims - (t.ndim - 1 - batch_ndims)
    if pad <= 0:
        return t
    return t.reshape(t.shape[:batch_ndims] + (1,) * pad + t.shape[batch_ndims:])


def _take_last(table, idx):
    """``table[..., idx]`` for an index tensor broadcast against the leading axes."""
    lead = torch.broadcast_shapes(table.shape[:-1], idx.shape)
    table = table.expand(lead + table.shape[-1:])
    return torch.gather(table, -1, idx.expand(lead)[..., None])[..., 0]


def _categorical_draw(generator, logits, shape):
    """1-based categories by the Gumbel-max trick (``jax.random.categorical``'s
    construction); ``shape`` defaults to the logits' leading axes."""
    shape = tuple(shape) if shape is not None else tuple(logits.shape[:-1])
    e = torch.empty(shape + logits.shape[-1:], dtype=logits.dtype, device=logits.device).exponential_(generator=generator)
    return (torch.argmax(logits - torch.log(e), -1) + 1).to(torch.int32)


# --- bernoulli (ref: bernoulli_lpmf.hpp, bernoulli_logit_lpmf.hpp) ----------


def bernoulli_lpmf(y, theta, *, propto=False, batch_ndims=0):
    yb, tb = bcast(y, theta)
    okp = torch.isfinite(tb) & (tb >= 0) & (tb <= 1)
    sup = (yb == 0) | (yb == 1)
    ok = okp & sup
    t = torch.clamp(safe(tb, okp, 0.5), 1e-300, 1.0)
    lp = torch.zeros_like(tb)
    if include_summand(propto, y, theta):
        lp = torch.special.xlogy(yb, t) + torch.special.xlog1py(1.0 - yb, -t)
    return finish(lp, ok, batch_ndims)


def bernoulli_cdf(y, theta, *, batch_ndims=0):
    yb, tb = bcast(y, theta)
    ok = (tb >= 0) & (tb <= 1)
    p = torch.where(yb < 0, 0.0, torch.where(yb < 1, 1.0 - tb, 1.0))
    return finish_prod(p, ok, batch_ndims)


def bernoulli_lcdf(y, theta, *, batch_ndims=0):
    yb, tb = bcast(y, theta)
    ok = (tb >= 0) & (tb <= 1)
    lp = torch.where(yb < 0, -math.inf, torch.where(yb < 1, log1m(tb), 0.0))
    return finish(lp, ok, batch_ndims)


def bernoulli_lccdf(y, theta, *, batch_ndims=0):
    yb, tb = bcast(y, theta)
    ok = (tb >= 0) & (tb <= 1)
    lp = torch.where(yb < 0, 0.0, torch.where(yb < 1, torch.log(tb), -math.inf))
    return finish(lp, ok, batch_ndims)


def bernoulli_rng(generator, theta, shape=None):
    (theta,) = rng_params(generator, theta)
    return torch.bernoulli(theta.expand(rng_shape(shape, theta)), generator=generator).to(torch.int32)


def bernoulli_logit_lpmf(y, alpha, *, propto=False, batch_ndims=0):
    """Fused logit bernoulli: -softplus(-sign*alpha) (ref: bernoulli_logit_lpmf.hpp)."""
    yb, ab = bcast(y, alpha)
    okp = torch.isfinite(ab)
    sup = (yb == 0) | (yb == 1)
    ok = okp & sup
    sign = 2.0 * yb - 1.0
    lp = torch.zeros_like(ab)
    if include_summand(propto, y, alpha):
        lp = -_softplus(-sign * safe(ab, okp, 0.0))
    return finish(lp, ok, batch_ndims)


def bernoulli_logit_rng(generator, alpha, shape=None):
    (alpha,) = rng_params(generator, alpha)
    return torch.bernoulli(torch.sigmoid(alpha).expand(rng_shape(shape, alpha)), generator=generator).to(torch.int32)


# --- binomial (ref: binomial_lpmf.hpp, binomial_logit_lpmf.hpp) -------------


def binomial_lpmf(y, n, theta, *, propto=False, batch_ndims=0):
    yb, nb, tb = bcast(y, n, theta)
    okp = (tb >= 0) & (tb <= 1) & (nb >= 0)
    sup = (yb >= 0) & (yb <= nb)
    ok = okp & sup
    t = safe(tb, okp, 0.5)
    lp = torch.zeros_like(tb)
    if include_summand(propto):
        lp = lp + lchoose(nb, yb)
    if include_summand(propto, theta):
        lp = lp + torch.special.xlogy(yb, t) + torch.special.xlog1py(nb - yb, -t)
    return finish(lp, ok, batch_ndims)


def binomial_cdf(y, n, theta, *, batch_ndims=0):
    yb, nb, tb = bcast(y, n, theta)
    ok = (tb >= 0) & (tb <= 1) & (nb >= 0)
    yc = torch.clamp_max(torch.clamp_min(yb, -1.0), nb)
    # P(Y <= y) = I_{1-theta}(n - y, y + 1)
    p = torch.where(
        yc < 0,
        0.0,
        torch.where(
            yc >= nb,
            1.0,
            inc_beta(torch.clamp_min(nb - yc, 1e-10), yc + 1.0, 1.0 - tb),
        ),
    )
    return finish_prod(p, ok, batch_ndims)


def binomial_lcdf(y, n, theta, *, batch_ndims=0):
    yb, nb, tb = bcast(y, n, theta)
    ok = (tb >= 0) & (tb <= 1) & (nb >= 0)
    yc = torch.clamp_max(torch.clamp_min(yb, -1.0), nb)
    p = torch.where(
        yc < 0,
        0.0,
        torch.where(
            yc >= nb,
            1.0,
            inc_beta(torch.clamp_min(nb - yc, 1e-10), yc + 1.0, 1.0 - tb),
        ),
    )
    return finish(torch.log(p), ok, batch_ndims)


def binomial_lccdf(y, n, theta, *, batch_ndims=0):
    yb, nb, tb = bcast(y, n, theta)
    ok = (tb >= 0) & (tb <= 1) & (nb >= 0)
    yc = torch.clamp_max(torch.clamp_min(yb, -1.0), nb)
    p = torch.where(
        yc < 0,
        0.0,
        torch.where(
            yc >= nb,
            1.0,
            inc_beta(torch.clamp_min(nb - yc, 1e-10), yc + 1.0, 1.0 - tb),
        ),
    )
    return finish(torch.log1p(-p), ok, batch_ndims)


def binomial_rng(generator, n, theta, shape=None):
    n, theta = rng_params(generator, n, theta)
    shape = rng_shape(shape, n, theta)
    draw = torch.binomial(n.expand(shape).contiguous(), theta.expand(shape).contiguous(), generator=generator)
    return draw.to(torch.int32)


def binomial_logit_lpmf(y, n, alpha, *, propto=False, batch_ndims=0):
    yb, nb, ab = bcast(y, n, alpha)
    okp = torch.isfinite(ab) & (nb >= 0)
    sup = (yb >= 0) & (yb <= nb)
    ok = okp & sup
    a = safe(ab, okp, 0.0)
    lp = torch.zeros_like(ab)
    if include_summand(propto):
        lp = lp + lchoose(nb, yb)
    if include_summand(propto, alpha):
        lp = lp - yb * _softplus(-a) - (nb - yb) * _softplus(a)
    return finish(lp, ok, batch_ndims)


def binomial_logit_rng(generator, n, alpha, shape=None):
    n, alpha = rng_params(generator, n, alpha)
    return binomial_rng(generator, n, torch.sigmoid(alpha), shape)


# --- beta_binomial (ref: beta_binomial_lpmf.hpp) ----------------------------


def beta_binomial_lpmf(y, n, alpha, beta, *, propto=False, batch_ndims=0):
    yb, nb, ab, bb = bcast(y, n, alpha, beta)
    okp = ok_pos(ab) & ok_pos(bb) & (nb >= 0)
    sup = (yb >= 0) & (yb <= nb)
    ok = okp & sup
    a, b = safe(ab, okp), safe(bb, okp)
    ys = torch.clamp_max(torch.clamp_min(yb, 0.0), nb)
    lp = torch.zeros_like(ab)
    if include_summand(propto):
        lp = lp + lchoose(nb, ys)
    if include_summand(propto, alpha, beta):
        lp = lp + lbeta(ys + a, nb - ys + b) - lbeta(a, b)
    return finish(lp, ok, batch_ndims)


def beta_binomial_rng(generator, n, alpha, beta, shape=None):
    n, alpha, beta = rng_params(generator, n, alpha, beta)
    shape = rng_shape(shape, n, alpha, beta)
    ga = torch._standard_gamma(alpha.expand(shape).contiguous(), generator=generator)
    gb = torch._standard_gamma(beta.expand(shape).contiguous(), generator=generator)
    return binomial_rng(generator, n, ga / (ga + gb), shape)


# --- poisson (ref: poisson_lpmf.hpp, poisson_log_lpmf.hpp) ------------------


def poisson_lpmf(y, lam, *, propto=False, batch_ndims=0):
    yb, lb = bcast(y, lam)
    okp = torch.isfinite(lb) & (lb >= 0)
    sup = (yb >= 0) & _int_ok(yb)
    ok = okp & sup
    l = torch.clamp_min(safe(lb, okp), 1e-300)
    ys = torch.clamp_min(yb, 0.0)
    lp = torch.zeros_like(lb)
    if include_summand(propto, lam):
        lp = lp - l
    if include_summand(propto, y, lam):
        lp = lp + torch.special.xlogy(ys, l)
    if include_summand(propto, y):
        lp = lp - torch.lgamma(ys + 1.0)
    return finish(lp, ok, batch_ndims)


def poisson_cdf(y, lam, *, batch_ndims=0):
    yb, lb = bcast(y, lam)
    ok = (lb >= 0) & torch.isfinite(lb)
    p = torch.where(yb < 0, 0.0, gamma_q(torch.floor(torch.clamp_min(yb, 0.0)) + 1.0, lb))
    return finish_prod(p, ok, batch_ndims)


def poisson_lcdf(y, lam, *, batch_ndims=0):
    yb, lb = bcast(y, lam)
    ok = (lb >= 0) & torch.isfinite(lb)
    p = torch.where(yb < 0, 0.0, gamma_q(torch.floor(torch.clamp_min(yb, 0.0)) + 1.0, lb))
    return finish(torch.log(p), ok, batch_ndims)


def poisson_lccdf(y, lam, *, batch_ndims=0):
    yb, lb = bcast(y, lam)
    ok = (lb >= 0) & torch.isfinite(lb)
    p = torch.where(yb < 0, 0.0, gamma_p(torch.floor(torch.clamp_min(yb, 0.0)) + 1.0, lb))
    return finish(torch.log(torch.where(yb < 0, 1.0, p)), ok, batch_ndims)


def poisson_rng(generator, lam, shape=None):
    (lam,) = rng_params(generator, lam)
    return torch.poisson(lam.expand(rng_shape(shape, lam)).contiguous(), generator=generator).to(torch.int32)


def poisson_log_lpmf(y, alpha, *, propto=False, batch_ndims=0):
    """Fused log-rate poisson: y*alpha - exp(alpha) (ref: poisson_log_lpmf.hpp)."""
    yb, ab = bcast(y, alpha)
    okp = ~torch.isnan(ab)
    sup = (yb >= 0) & _int_ok(yb)
    ok = okp & sup
    a = safe(ab, okp, 0.0)
    ys = torch.clamp_min(yb, 0.0)
    lp = torch.zeros_like(ab)
    if include_summand(propto, y, alpha):
        lp = lp + ys * a
    if include_summand(propto, alpha):
        lp = lp - torch.exp(a)
    if include_summand(propto, y):
        lp = lp - torch.lgamma(ys + 1.0)
    return finish(lp, ok, batch_ndims)


def poisson_log_rng(generator, alpha, shape=None):
    (alpha,) = rng_params(generator, alpha)
    return poisson_rng(generator, torch.exp(alpha), shape)


# --- negative binomial (ref: neg_binomial_lpmf.hpp, neg_binomial_2*.hpp) ----


def neg_binomial_lpmf(y, alpha, beta, *, propto=False, batch_ndims=0):
    """Shape/inverse-scale parameterization (ref: neg_binomial_lpmf.hpp)."""
    yb, ab, bb = bcast(y, alpha, beta)
    okp = ok_pos(ab) & ok_pos(bb)
    sup = (yb >= 0) & _int_ok(yb)
    ok = okp & sup
    a, b = safe(ab, okp), safe(bb, okp)
    ys = torch.clamp_min(yb, 0.0)
    lp = torch.zeros_like(ab)
    if include_summand(propto, y, alpha):
        lp = lp + torch.lgamma(ys + a) - torch.lgamma(a)
    if include_summand(propto, y):
        lp = lp - torch.lgamma(ys + 1.0)
    if include_summand(propto, alpha, beta):
        lp = lp + a * (torch.log(b) - torch.log1p(b))
    if include_summand(propto, y, beta):
        lp = lp - ys * torch.log1p(b)
    return finish(lp, ok, batch_ndims)


def neg_binomial_cdf(y, alpha, beta, *, batch_ndims=0):
    yb, ab, bb = bcast(y, alpha, beta)
    ok = ok_pos(ab) & ok_pos(bb)
    # P(Y <= y) = I_{b/(1+b)}(alpha, y+1)
    p = torch.where(
        yb < 0,
        0.0,
        inc_beta(safe(ab, ok), torch.floor(torch.clamp_min(yb, 0.0)) + 1.0, bb / (1.0 + bb)),
    )
    return finish_prod(p, ok, batch_ndims)


def neg_binomial_rng(generator, alpha, beta, shape=None):
    alpha, beta = rng_params(generator, alpha, beta)
    shape = rng_shape(shape, alpha, beta)
    lam = torch._standard_gamma(alpha.expand(shape).contiguous(), generator=generator) / beta
    return torch.poisson(lam, generator=generator).to(torch.int32)


def neg_binomial_2_lpmf(y, mu, phi, *, propto=False, batch_ndims=0):
    """Mean/dispersion parameterization (ref: neg_binomial_2_lpmf.hpp)."""
    yb, mb, pb = bcast(y, mu, phi)
    okp = ok_pos(mb) & ok_pos(pb)
    sup = (yb >= 0) & _int_ok(yb)
    ok = okp & sup
    m, p = safe(mb, okp), safe(pb, okp)
    ys = torch.clamp_min(yb, 0.0)
    log_mu_phi = torch.log(m + p)
    lp = torch.zeros_like(mb)
    if include_summand(propto, y, phi):
        lp = lp + torch.lgamma(ys + p) - torch.lgamma(p)
    if include_summand(propto, y):
        lp = lp - torch.lgamma(ys + 1.0)
    if include_summand(propto, y, mu, phi):
        lp = lp + ys * (torch.log(m) - log_mu_phi)
    if include_summand(propto, mu, phi):
        lp = lp + p * (torch.log(p) - log_mu_phi)
    return finish(lp, ok, batch_ndims)


def neg_binomial_2_cdf(y, mu, phi, *, batch_ndims=0):
    yb, mb, pb = bcast(y, mu, phi)
    ok = ok_pos(mb) & ok_pos(pb)
    p = torch.where(
        yb < 0,
        0.0,
        inc_beta(
            safe(pb, ok),
            torch.floor(torch.clamp_min(yb, 0.0)) + 1.0,
            pb / (pb + mb),
        ),
    )
    return finish_prod(p, ok, batch_ndims)


def neg_binomial_2_lcdf(y, mu, phi, *, batch_ndims=0):
    yb, mb, pb = bcast(y, mu, phi)
    ok = ok_pos(mb) & ok_pos(pb)
    p = torch.where(
        yb < 0,
        0.0,
        inc_beta(
            safe(pb, ok), torch.floor(torch.clamp_min(yb, 0.0)) + 1.0, pb / (pb + mb)
        ),
    )
    return finish(torch.log(p), ok, batch_ndims)


def neg_binomial_2_lccdf(y, mu, phi, *, batch_ndims=0):
    """log P(Y > y), computed as ``log I_{mu/(mu+phi)}(y+1, phi)`` by
    ``log_inc_beta``: by the symmetry of DLMF 8.17.4 the JAX package's
    ``log1p(-I_{phi/(phi+mu)}(phi, y+1))``, without its cancellation where
    ``1 - I`` is small (below ~6e-8 float32 rounds ``I`` to 1 and gives
    ``-inf``) and without the underflow of ``1 - I`` itself in the far tail
    (a top-coded count at an ordinary initial point).  The partial in
    ``phi`` is then ``inc_beta``'s b-partial; ``y`` is data, so the a-partial
    is never computed."""
    yb, mb, pb = bcast(y, mu, phi)
    ok = ok_pos(mb) & ok_pos(pb)
    lccdf = log_inc_beta(torch.floor(torch.clamp_min(yb, 0.0)) + 1.0, safe(pb, ok), mb / (pb + mb))
    return finish(torch.where(yb < 0, 0.0, lccdf), ok, batch_ndims)


def neg_binomial_2_rng(generator, mu, phi, shape=None):
    mu, phi = rng_params(generator, mu, phi)
    shape = rng_shape(shape, mu, phi)
    lam = torch._standard_gamma(phi.expand(shape).contiguous(), generator=generator) * (mu / phi)
    return torch.poisson(lam, generator=generator).to(torch.int32)


def neg_binomial_2_log_lpmf(y, eta, phi, *, propto=False, batch_ndims=0):
    """Log-mean parameterization, fused stable (ref: neg_binomial_2_log_lpmf.hpp)."""
    yb, eb, pb = bcast(y, eta, phi)
    okp = torch.isfinite(eb) & ok_pos(pb)
    sup = (yb >= 0) & _int_ok(yb)
    ok = okp & sup
    e, p = safe(eb, okp, 0.0), safe(pb, okp)
    ys = torch.clamp(yb, min=0.0)
    log_phi = torch.log(p)
    lse = torch.logaddexp(e, log_phi)
    lp = torch.zeros_like(eb)
    if include_summand(propto, y, phi):
        lp = lp + torch.lgamma(ys + p) - torch.lgamma(p)
    if include_summand(propto, y):
        lp = lp - torch.lgamma(ys + 1.0)
    if include_summand(propto, y, eta, phi):
        lp = lp + ys * (e - lse)
    if include_summand(propto, eta, phi):
        lp = lp + p * (log_phi - lse)
    return finish(lp, ok, batch_ndims)


def neg_binomial_2_log_rng(generator, eta, phi, shape=None):
    eta, phi = rng_params(generator, eta, phi)
    return neg_binomial_2_rng(generator, torch.exp(eta), phi, shape)


# --- hypergeometric (ref: hypergeometric_lpmf.hpp) --------------------------


def hypergeometric_lpmf(y, n, a, b, *, propto=False, batch_ndims=0):
    """Successes y in n draws from a successes + b failures, no replacement."""
    yb, nb, ab, bb = bcast(y, n, a, b)
    okp = (nb >= 0) & (ab >= 0) & (bb >= 0) & (nb <= ab + bb)
    sup = (yb >= torch.clamp_min(nb - bb, 0.0)) & (yb <= torch.minimum(ab, nb))
    ok = okp & sup
    ys = torch.clamp_max(torch.clamp_min(yb, 0.0), ab)
    lp = lchoose(ab, ys) + lchoose(bb, nb - ys) - lchoose(ab + bb, nb)
    return finish(lp, ok, batch_ndims)


def hypergeometric_rng(generator, n, a, b, shape=None):
    """Sequential draws via Fisher's noncentral=1 urn scheme, vectorized: a
    loop over ``max(n)`` draws (a tensor ``n`` is read to the host once for
    that count, as the JAX package's ``int(jnp.max(n))``)."""
    max_n = int(np.max(np.asarray(n))) if not isinstance(n, torch.Tensor) else int(n.max())
    n, a, b = rng_params(generator, n, a, b)
    shape = rng_shape(shape, n, a, b)
    n, rem_a, rem_b = n.expand(shape), a.expand(shape), b.expand(shape)
    drawn = torch.zeros(shape, dtype=torch.int32, device=n.device)
    for i in range(max_n if n.numel() else 0):
        p = rem_a / torch.clamp_min(rem_a + rem_b, 1.0)
        live = i < n
        take = (torch.rand(shape, generator=generator, dtype=n.dtype, device=n.device) < p) & live
        drawn = drawn + take.to(torch.int32)
        rem_a = rem_a - take.to(rem_a.dtype)
        rem_b = rem_b - (~take & live).to(rem_b.dtype)
    return drawn


# --- categorical / ordered (ref: prim/mat/prob/categorical*,ordered*) -------


def categorical_lpmf(y, theta, *, propto=False, batch_ndims=0):
    """y in 1..K (Stan 1-based); theta simplex over last axis, ``(batch...,
    [event...,] K)``; one simplex verdict a chain."""
    (theta,) = as_tensors(theta)
    yi = _category_index(y, theta.device)
    k = theta.shape[-1]
    ok_t = all_event(ok_simplex(theta), batch_ndims)
    event_ndims = max(theta.ndim - 1 - batch_ndims, yi.ndim)
    ok = (yi >= 0) & (yi < k) & ok_t.reshape(ok_t.shape + (1,) * event_ndims)
    logt = _lead_axes(torch.log(theta), batch_ndims, yi.ndim)
    lp = _take_last(logt, torch.clamp(yi, 0, k - 1))
    return finish(lp, ok, batch_ndims)


def categorical_logit_lpmf(y, beta, *, propto=False, batch_ndims=0):
    """Fused log-softmax lookup (ref: categorical_logit_lpmf.hpp).  ``beta``
    is ``(batch..., [event...,] K)``; ``y`` in 1..K over the event."""
    (beta,) = as_tensors(beta)
    yi = _category_index(y, beta.device)
    k = beta.shape[-1]
    ok = (yi >= 0) & (yi < k)
    logsm = _lead_axes(torch.log_softmax(beta, dim=-1), batch_ndims, yi.ndim)
    lp = _take_last(logsm, torch.clamp(yi, 0, k - 1))
    return finish(lp, ok, batch_ndims)


def categorical_rng(generator, theta, shape=None):
    (theta,) = rng_params(generator, theta)
    return _categorical_draw(generator, torch.log(theta), shape)


def categorical_logit_rng(generator, beta, shape=None):
    (beta,) = rng_params(generator, beta)
    return _categorical_draw(generator, beta, shape)


def _log_sigmoid_diff(a, b):
    """log(sigmoid(a) - sigmoid(b)) for a > b, stable."""
    return -_softplus(-a) - _softplus(b) + log1m_exp(torch.clamp(b - a, max=-1e-12))


def ordered_logistic_lpmf(y, eta, c, *, propto=False, batch_ndims=0):
    """y in 1..K, cutpoints c ordered length K-1 (ref: ordered_logistic_lpmf.hpp).
    ``c`` is ``(batch..., K-1)``: one cut vector per chain with ``batch_ndims=1``."""
    eta, c = as_tensors(eta, c)
    yi = _category_index(y, eta.device)
    km1 = c.shape[-1]
    k = km1 + 1
    ok_c = ok_ordered(c)  # one flag per cut vector, then one per chain
    if ok_c.ndim > batch_ndims:
        ok_c = ok_c.flatten(batch_ndims).all(-1)
    event_ndims = max(eta.ndim - batch_ndims, yi.ndim)
    ok = (yi >= 0) & (yi < k) & ok_c.reshape(ok_c.shape + (1,) * event_ndims)
    yc = torch.clamp(yi, 0, k - 1)
    big = torch.full(c.shape[:-1] + (1,), 1e30, dtype=c.dtype, device=c.device)
    cpad = _lead_axes(torch.cat([-big, c, big], dim=-1), batch_ndims, event_ndims)
    c_lo = _take_last(cpad, yc)
    c_hi = _take_last(cpad, yc + 1)
    # P(y=k) = sigmoid(eta - c_{k-1}) - sigmoid(eta - c_k)
    a = eta - c_lo  # larger
    b = eta - c_hi
    lp = torch.where(
        yc == 0,
        -_softplus(eta - c_hi),  # 1 - sigmoid(eta - c_1)
        torch.where(
            yc == k - 1,
            -_softplus(-(eta - c_lo)),
            _log_sigmoid_diff(torch.maximum(a, b), torch.minimum(a, b)),
        ),
    )
    return finish(lp, ok, batch_ndims)



def ordered_logistic_rng(generator, eta, c, shape=None):
    eta, c = rng_params(generator, eta, c)
    shape = tuple(shape) if shape is not None else tuple(eta.shape)
    u = torch.rand(shape, generator=generator, dtype=eta.dtype, device=eta.device)
    u = torch.clamp_min(u, torch.finfo(eta.dtype).tiny)
    logistic = torch.log(u) - torch.log1p(-u)
    return (1 + torch.sum((eta + logistic)[..., None] > c, -1)).to(torch.int32)


def ordered_probit_lpmf(y, eta, c, *, propto=False, batch_ndims=0):
    """Ref: ordered_probit_lpmf.hpp; stable via log_ndtr + log_diff_exp.
    ``c`` is ``(batch..., K-1)`` as in ``ordered_logistic_lpmf``."""
    eta, c = as_tensors(eta, c)
    yi = _category_index(y, eta.device)
    k = c.shape[-1] + 1
    ok_c = all_event(ok_ordered(c), batch_ndims)
    event_ndims = max(eta.ndim - batch_ndims, yi.ndim)
    ok = (yi >= 0) & (yi < k) & ok_c.reshape(ok_c.shape + (1,) * event_ndims)
    yc = torch.clamp(yi, 0, k - 1)
    big = torch.full(c.shape[:-1] + (1,), 1e30, dtype=c.dtype, device=c.device)
    cpad = _lead_axes(torch.cat([-big, c, big], dim=-1), batch_ndims, event_ndims)
    c_lo = _take_last(cpad, yc)
    c_hi = _take_last(cpad, yc + 1)
    # the middle branch on finite cuts: at the +-1e30 boundary cuts the
    # gradient of log_ndtr is infinite, and an infinite partial of an
    # unselected branch would make the selected one's NaN
    c_lo_mid = torch.where(yc == 0, c_hi - 1.0, c_lo)
    c_hi_mid = torch.where(yc == k - 1, c_lo + 1.0, c_hi)
    la = torch.special.log_ndtr(eta - c_lo_mid)  # larger
    lb = torch.special.log_ndtr(eta - c_hi_mid)
    lp = torch.where(
        yc == 0,
        torch.special.log_ndtr(c_hi - eta),
        torch.where(
            yc == k - 1,
            torch.special.log_ndtr(eta - c_lo),
            la + log1m_exp(torch.clamp_max(lb - la, -1e-300)),
        ),
    )
    return finish(lp, ok, batch_ndims)


def ordered_probit_rng(generator, eta, c, shape=None):
    eta, c = rng_params(generator, eta, c)
    shape = tuple(shape) if shape is not None else tuple(eta.shape)
    u = torch.randn(shape, generator=generator, dtype=eta.dtype, device=eta.device)
    return (1 + torch.sum((eta + u)[..., None] > c, -1)).to(torch.int32)