"""Multivariate distributions.

Counterpart: ``math_tpu/dists/multivariate.py`` (reference:
``stan/math/prim/mat/prob/*``).  Conventions:

- ``y`` may carry leading batch dimensions; the result is the summed
  log-density over the batch (matching Stan's vectorized overloads).
- ``batch_ndims=1``: the first axis of every tensor argument that has more
  axes than its event shape (``y``, ``mu``, ``theta``, ``alpha``: one;
  ``sigma``, ``L``, ``omega``, ``w``, ``s``: two; ``nu``, ``eta``: none) is
  the chain axis, and the result is one value per chain.  A vector argument
  with a chain axis is aligned with the others over its rows (``mu (C, k)``
  against ``y (C, n, k)``).  Validity checks give one verdict per chain: an
  invalid matrix sends its own chain to ``-inf`` and no other.
- Every factorization goes through ``ops.cholesky`` (the blocked path with
  the hand-written block kernel on a CUDA tensor, at every size); a matrix
  that is not positive definite gives NaN there, as ``jnp.linalg.cholesky``
  does, never an exception.  Triangular solves, ``slogdet`` and ``inv`` are
  ``torch.linalg`` calls, as their JAX counterparts are outside any Pallas
  kernel.
- The ``_rng`` functions take a ``torch.Generator`` where the JAX functions
  take a key, and draw on its device.  The draws cannot equal JAX's; they
  follow the same constructions.
"""

from __future__ import annotations

import torch

from math_tpu_torch.dists._util import all_event, as_tensors, ok_pos, ok_simplex
from math_tpu_torch.ops.cholesky import cholesky_decompose, spd_solve_logdiag
from math_tpu_torch.special import LOG_PI, LOG_TWO, LOG_TWO_PI, lmgamma
from math_tpu_torch.utils.batch import sum_event
from math_tpu_torch.utils.propto import include_summand

__all__ = [
    "multi_normal_cholesky_lpdf", "multi_normal_lpdf", "multi_normal_prec_lpdf", "multi_normal_rng",
    "multi_normal_cholesky_rng", "multi_normal_prec_rng", "multi_student_t_lpdf", "multi_student_t_rng",
    "dirichlet_lpdf", "dirichlet_rng", "multinomial_lpmf", "multinomial_rng", "do_lkj_constant",
    "lkj_corr_cholesky_lpdf", "lkj_corr_lpdf", "lkj_corr_cholesky_rng", "lkj_corr_rng", "wishart_lpdf",
    "inv_wishart_lpdf", "wishart_rng", "inv_wishart_rng",
]


def _check_batch(batch_ndims):
    if batch_ndims not in (0, 1):
        raise ValueError("multivariate densities: batch_ndims must be 0 or 1")


def _chol_logdet(L):
    return torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)


def _align_rows(batch_ndims, *vecs):
    """Vector arguments (event axis last) aligned for broadcasting: with
    ``batch_ndims=1`` one that has a chain axis gets singleton row axes after
    it, up to the deepest of them."""
    depth = max((v.ndim for v in vecs if v.ndim >= 2), default=0)
    if not batch_ndims:
        return vecs
    return [v.reshape(v.shape[:1] + (1,) * (depth - v.ndim) + v.shape[1:]) if v.ndim >= 2 else v for v in vecs]


def _per_chain(p, like, batch_ndims):
    """A parameter with one value a chain, ``(C,)``, laid along the chain axis
    of ``like``; anything else as it is."""
    if batch_ndims and p.ndim == 1 and like.ndim > 1:
        return p.reshape(p.shape + (1,) * (like.ndim - 1))
    return p


def _residual_rows(y, mu, mat, batch_ndims):
    """``(diff (lead..., nbatch, k), nbatch, lead)``: the residuals as rows,
    one block of rows a chain with ``batch_ndims=1``."""
    _check_batch(batch_ndims)
    k = mat.shape[-1]
    y, mu = _align_rows(batch_ndims, y, mu)
    diff = y - mu
    if batch_ndims:
        if diff.ndim == 1:  # shared y and mu: the chain axis comes from the matrix
            if mat.ndim < 3:
                raise ValueError("multivariate density: batch_ndims=1 but no argument has a chain axis")
            diff = diff.expand(mat.shape[0], 1, k)
        else:
            diff = diff.reshape(diff.shape[0], -1, k)
        lead = tuple(diff.shape[:1])
    else:
        diff = diff.reshape(-1, k)
        lead = ()
    return diff, diff.shape[-2], lead


def _start(lead, like):
    return torch.zeros(lead, dtype=like.dtype, device=like.device)


# --- multi_normal family (ref: multi_normal[_cholesky,_prec]_lpdf.hpp) ------


def _assemble(z, slogdiag, nbatch, k, propto, y, mu, mat):
    lp = torch.zeros_like(slogdiag)
    if include_summand(propto, y, mu, mat):
        lp = lp - 0.5 * torch.square(z).sum((-2, -1))
    if include_summand(propto, mat):
        lp = lp - nbatch * slogdiag  # = -nbatch/2 * log|Sigma|
    if include_summand(propto):
        lp = lp - 0.5 * k * nbatch * LOG_TWO_PI
    return lp


def multi_normal_cholesky_lpdf(y, mu, L, *, propto=False, batch_ndims=0):
    """MVN with Cholesky-factored covariance (ref: multi_normal_cholesky_lpdf.hpp)."""
    y_t, mu_t, L_t = as_tensors(y, mu, L)
    diff, nbatch, lead = _residual_rows(y_t, mu_t, L_t, batch_ndims)
    z = torch.linalg.solve_triangular(L_t, diff.mT, upper=False)
    slogdiag = _chol_logdet(L_t).expand(lead)
    return _assemble(z, slogdiag, nbatch, L_t.shape[-1], propto, y, mu, L)


def multi_normal_lpdf(y, mu, sigma, *, propto=False, batch_ndims=0):
    """MVN density (ref: multi_normal_lpdf.hpp).  The O(k^3) solve and
    log-determinant come from one blocked factorization
    (``ops.cholesky.spd_solve_logdiag``)."""
    y_t, mu_t, sigma_t = as_tensors(y, mu, sigma)
    diff, nbatch, lead = _residual_rows(y_t, mu_t, sigma_t, batch_ndims)
    if sigma_t.ndim == 2 and lead:
        sigma_t = sigma_t.expand(lead + sigma_t.shape)
    z, slogdiag = spd_solve_logdiag(sigma_t, diff.mT)
    return _assemble(z, slogdiag, nbatch, sigma_t.shape[-1], propto, y, mu, sigma)


def multi_normal_prec_lpdf(y, mu, omega, *, propto=False, batch_ndims=0):
    """MVN with precision matrix (ref: multi_normal_prec_lpdf.hpp)."""
    y_t, mu_t, omega_t = as_tensors(y, mu, omega)
    k = omega_t.shape[-1]
    diff, nbatch, lead = _residual_rows(y_t, mu_t, omega_t, batch_ndims)
    Lp = cholesky_decompose(omega_t)
    lp = _start(lead, diff)
    if include_summand(propto, y, mu, omega):
        lp = lp - 0.5 * ((diff @ omega_t) * diff).sum((-2, -1))
    if include_summand(propto, omega):
        lp = lp + nbatch * _chol_logdet(Lp)
    if include_summand(propto):
        lp = lp - 0.5 * k * nbatch * LOG_TWO_PI
    return lp


def multi_normal_rng(generator, mu, sigma, shape=None):
    """Draws ``mu + L z`` with ``L`` the Cholesky factor of ``sigma``."""
    mu, sigma = as_tensors(mu, sigma)
    return multi_normal_cholesky_rng(generator, mu, cholesky_decompose(sigma), shape)


def multi_normal_cholesky_rng(generator, mu, L, shape=None):
    mu, L = as_tensors(mu, L)
    shape = tuple(shape) if shape is not None else torch.broadcast_shapes(mu.shape[:-1], L.shape[:-2])
    z = torch.randn(shape + mu.shape[-1:], generator=generator, dtype=L.dtype, device=L.device)
    return mu + (L @ z[..., None])[..., 0]


def multi_normal_prec_rng(generator, mu, omega, shape=None):
    """Draw via U^-1 z with U the upper Cholesky of the precision."""
    mu, omega = as_tensors(mu, omega)
    Lp = cholesky_decompose(omega)
    shape = tuple(shape) if shape is not None else torch.broadcast_shapes(mu.shape[:-1], omega.shape[:-2])
    z = torch.randn(shape + mu.shape[-1:], generator=generator, dtype=Lp.dtype, device=Lp.device)
    u = Lp.mT.expand(z.shape[:-1] + Lp.shape[-2:])
    return mu + torch.linalg.solve_triangular(u, z[..., None], upper=True)[..., 0]


# --- multi_student_t (ref: multi_student_t_lpdf.hpp) ------------------------


def multi_student_t_lpdf(y, nu, mu, sigma, *, propto=False, batch_ndims=0):
    y_t, nu_t, mu_t, sigma_t = as_tensors(y, nu, mu, sigma)
    k = sigma_t.shape[-1]
    L = cholesky_decompose(sigma_t)
    diff, nbatch, lead = _residual_rows(y_t, mu_t, sigma_t, batch_ndims)
    q = torch.square(torch.linalg.solve_triangular(L, diff.mT, upper=False)).sum(-2)  # (lead..., nbatch)
    nu_rows = _per_chain(nu_t, q, batch_ndims)
    lp = _start(lead, q)
    if include_summand(propto, y, nu, mu, sigma):
        lp = lp - 0.5 * sum_event((nu_rows + k) * torch.log1p(q / nu_rows), batch_ndims)
    if include_summand(propto, nu):
        lp = lp + nbatch * (torch.lgamma(0.5 * (nu_t + k)) - torch.lgamma(0.5 * nu_t) - 0.5 * k * torch.log(nu_t))
    if include_summand(propto, sigma):
        lp = lp - nbatch * _chol_logdet(L)
    if include_summand(propto):
        lp = lp - 0.5 * k * nbatch * LOG_PI
    return lp


def multi_student_t_rng(generator, nu, mu, sigma, shape=None):
    mu, sigma, nu = as_tensors(mu, sigma, nu)
    shape = tuple(shape) if shape is not None else tuple(mu.shape[:-1])
    g = torch._standard_gamma((0.5 * nu).expand(shape).contiguous(), generator=generator) / (0.5 * nu)
    z = multi_normal_rng(generator, torch.zeros_like(mu), sigma, shape)
    return mu + z / torch.sqrt(g)[..., None]


# --- dirichlet / multinomial (ref: dirichlet_lpdf.hpp, multinomial_lpmf) ----


def dirichlet_lpdf(theta, alpha, *, propto=False, batch_ndims=0):
    _check_batch(batch_ndims)
    th, al = torch.broadcast_tensors(*_align_rows(batch_ndims, *as_tensors(theta, alpha)))
    lp = _start(th.shape[:batch_ndims], th)
    if include_summand(propto, alpha):
        lp = lp + sum_event(torch.lgamma(al.sum(-1)), batch_ndims) - sum_event(torch.lgamma(al), batch_ndims)
    if include_summand(propto, theta, alpha):
        lp = lp + sum_event(torch.special.xlogy(al - 1.0, th), batch_ndims)
    ok = all_event(ok_simplex(th), batch_ndims) & all_event(al > 0, batch_ndims)
    return torch.where(ok, lp, -float("inf"))


def dirichlet_rng(generator, alpha, shape=None):
    (alpha,) = as_tensors(alpha)
    shape = tuple(shape) if shape is not None else tuple(alpha.shape[:-1])
    g = torch._standard_gamma(alpha.expand(shape + alpha.shape[-1:]).contiguous(), generator=generator)
    return g / g.sum(-1, keepdim=True)


def multinomial_lpmf(y, theta, *, propto=False, batch_ndims=0):
    _check_batch(batch_ndims)
    (theta_t,) = as_tensors(theta)
    yf = torch.as_tensor(y).to(dtype=theta_t.dtype, device=theta_t.device)
    yb, tb = torch.broadcast_tensors(*_align_rows(batch_ndims, yf, theta_t))
    lp = _start(yb.shape[:batch_ndims], tb)
    if include_summand(propto):
        lp = lp + sum_event(torch.lgamma(yb.sum(-1) + 1.0), batch_ndims) - sum_event(torch.lgamma(yb + 1.0), batch_ndims)
    if include_summand(propto, theta):
        lp = lp + sum_event(torch.special.xlogy(yb, tb), batch_ndims)
    ok = all_event(yb >= 0, batch_ndims) & all_event(ok_simplex(theta_t), batch_ndims)
    return torch.where(ok, lp, -float("inf"))


def multinomial_rng(generator, theta, n, shape=None):
    """n draws over categories theta via iterated binomials (exact)."""
    (theta,) = as_tensors(theta)
    k = theta.shape[-1]
    shape = tuple(shape) if shape is not None else tuple(theta.shape[:-1])
    rem = torch.full(shape, float(n), dtype=theta.dtype, device=theta.device)
    cum = torch.zeros(shape, dtype=theta.dtype, device=theta.device)
    draws = []
    for i in range(k - 1):
        p = torch.clamp(theta[..., i] / torch.clamp_min(1.0 - cum, 1e-30), 0.0, 1.0).expand(shape).contiguous()
        draw = torch.binomial(rem, p, generator=generator)
        draws.append(draw)
        rem = rem - draw
        cum = cum + theta[..., i]
    return torch.stack(draws + [rem], dim=-1).to(torch.int32)


# --- LKJ (ref: lkj_corr_cholesky_lpdf.hpp, lkj_corr_lpdf.hpp) ---------------


def do_lkj_constant(eta, k):
    """LKJ normalizing constant, general-eta branch (ref: lkj_corr_lpdf.hpp:
    do_lkj_constant, Lewandowski-Kurowicka-Joe theorem 5)."""
    (eta,) = as_tensors(eta)
    km1 = k - 1
    ks = torch.arange(1, k, dtype=eta.dtype, device=eta.device)
    return km1 * torch.lgamma(eta + 0.5 * km1) - torch.sum(
        0.5 * ks * LOG_PI + torch.lgamma(eta[..., None] + 0.5 * (km1 - ks)), dim=-1
    )


def lkj_corr_cholesky_lpdf(L, eta, *, propto=False, batch_ndims=0):
    """lp = const(eta,K) + sum_k [(K-k-1) + (2 eta - 2)] log L_kk, k=1..K-1
    (ref: lkj_corr_cholesky_lpdf.hpp:18-40)."""
    _check_batch(batch_ndims)
    L_t, eta_t = as_tensors(L, eta)
    k = L_t.shape[-1]
    lp = _start(L_t.shape[:batch_ndims] if L_t.ndim > 2 else (), L_t)
    if include_summand(propto, eta):
        lp = lp + do_lkj_constant(eta_t, k)
    if include_summand(propto, L, eta):
        logdiag = torch.log(torch.diagonal(L_t, dim1=-2, dim2=-1)[..., 1:])
        wts = torch.arange(k - 2, -1.0, -1.0, dtype=L_t.dtype, device=L_t.device)  # K-1-k-1 for k=0..K-2
        lp = lp + sum_event((wts + 2.0 * _per_chain(eta_t, logdiag, batch_ndims) - 2.0) * logdiag, batch_ndims)
    return lp


def lkj_corr_lpdf(y, eta, *, propto=False, batch_ndims=0):
    """lp = const + (eta - 1) log|y| (ref: lkj_corr_lpdf.hpp).

    Value-level corr-matrix validation (the reference's
    ``check_corr_matrix``: unit diagonal, symmetry, positive-definite) maps
    to the -inf convention, one verdict a chain; positive definiteness is
    read off the NaN pivots of the blocked factorization (no gradient flows
    through the mask).
    """
    _check_batch(batch_ndims)
    y_t, eta_t = as_tensors(y, eta)
    k = y_t.shape[-1]
    tol = max(1e-8, 16.0 * k * torch.finfo(y_t.dtype).eps)
    diag = torch.diagonal(y_t, dim1=-2, dim2=-1)
    ok = (
        all_event(torch.isfinite(y_t), batch_ndims)
        & all_event(torch.abs(diag - 1.0) <= tol, batch_ndims)
        & all_event(torch.abs(y_t - y_t.mT) <= tol, batch_ndims)
        & all_event(ok_pos(eta_t), batch_ndims)
    )
    ldiag = torch.diagonal(cholesky_decompose(y_t.detach()), dim1=-2, dim2=-1)
    ok = ok & all_event(torch.isfinite(ldiag) & (ldiag > 0), batch_ndims)
    lp = _start(ok.shape, y_t)
    if include_summand(propto, eta):
        lp = lp + do_lkj_constant(eta_t, k)
    if include_summand(propto, y, eta):
        # double-where: slogdet of a singular y has NaN cotangents even when
        # the output is masked to -inf; feed it the identity when invalid.
        eye = torch.eye(k, dtype=y_t.dtype, device=y_t.device)
        y_safe = torch.where(ok.reshape(ok.shape + (1,) * (y_t.ndim - ok.ndim)), y_t, eye)
        logdet = torch.linalg.slogdet(y_safe)[1]
        lp = lp + sum_event((_per_chain(eta_t, logdet, batch_ndims) - 1.0) * logdet, batch_ndims)
    return torch.where(ok, lp, -float("inf"))


def _beta_draw(generator, a, b):
    """Beta(a, b) draws as ``Ga / (Ga + Gb)`` from two standard gammas."""
    ga = torch._standard_gamma(a.contiguous(), generator=generator)
    gb = torch._standard_gamma(b.contiguous(), generator=generator)
    return ga / (ga + gb)


def lkj_corr_cholesky_rng(generator, k, eta, shape=()):
    """Onion-method sampler (matches the reference's vine/onion behavior):
    row i of L is ``(sqrt(r2) u, sqrt(1 - r2), 0...)`` with the squared
    radius ``r2 ~ Beta(i/2, eta + (k-2)/2 - (i-1)/2)`` and ``u`` uniform on
    the sphere of dimension i."""
    (eta,) = as_tensors(eta)
    shape = tuple(shape)
    beta = eta + 0.5 * (k - 2)
    opts = dict(dtype=eta.dtype, device=eta.device)
    rows = [torch.nn.functional.pad(torch.ones(shape + (1,), **opts), (0, k - 1))]
    for i in range(1, k):
        b = (beta - 0.5 * (i - 1)).expand(shape)
        r2 = _beta_draw(generator, torch.full(shape, 0.5 * i, **opts), b)
        u = torch.randn(shape + (i,), generator=generator, **opts)
        u = u / torch.linalg.vector_norm(u, dim=-1, keepdim=True)
        row = torch.cat([torch.sqrt(r2)[..., None] * u, torch.sqrt(1.0 - r2)[..., None]], dim=-1)
        rows.append(torch.nn.functional.pad(row, (0, k - i - 1)))
    return torch.stack(rows, dim=-2)


def lkj_corr_rng(generator, k, eta, shape=()):
    L = lkj_corr_cholesky_rng(generator, k, eta, shape)
    return L @ L.mT


# --- wishart / inv_wishart (ref: wishart_lpdf.hpp, inv_wishart_lpdf.hpp) ----


def _wishart_parts(w, nu, s, batch_ndims):
    _check_batch(batch_ndims)
    w_t, nu_t, s_t = as_tensors(w, nu, s)
    Lw = cholesky_decompose(w_t)
    Ls = cholesky_decompose(s_t)
    lead = torch.broadcast_shapes(w_t.shape[:-2], s_t.shape[:-2], nu_t.shape)[:batch_ndims]
    return w_t.shape[-1], nu_t, Lw, Ls, _start(lead, Lw)


def wishart_lpdf(w, nu, s, *, propto=False, batch_ndims=0):
    k, nu_t, Lw, Ls, lp = _wishart_parts(w, nu, s, batch_ndims)
    if include_summand(propto, w, nu):
        ldw = _chol_logdet(Lw)
        lp = lp + sum_event((_per_chain(nu_t, ldw, batch_ndims) - k - 1.0) * ldw, batch_ndims)
    if include_summand(propto, w, s):
        # tr(S^-1 W) = || Ls^-1 Lw ||_F^2
        x = torch.linalg.solve_triangular(Ls, Lw, upper=False)
        lp = lp - 0.5 * sum_event(torch.square(x), batch_ndims)
    if include_summand(propto, nu):
        lp = lp - 0.5 * nu_t * k * LOG_TWO - lmgamma(k, 0.5 * nu_t)
    if include_summand(propto, nu, s):
        lp = lp - nu_t * _chol_logdet(Ls)
    return lp


def inv_wishart_lpdf(w, nu, s, *, propto=False, batch_ndims=0):
    k, nu_t, Lw, Ls, lp = _wishart_parts(w, nu, s, batch_ndims)
    if include_summand(propto, w, nu):
        ldw = _chol_logdet(Lw)
        lp = lp - sum_event((_per_chain(nu_t, ldw, batch_ndims) + k + 1.0) * ldw, batch_ndims)
    if include_summand(propto, w, s):
        # tr(S W^-1) = || Lw^-1 Ls ||_F^2
        x = torch.linalg.solve_triangular(Lw, Ls, upper=False)
        lp = lp - 0.5 * sum_event(torch.square(x), batch_ndims)
    if include_summand(propto, nu):
        lp = lp - 0.5 * nu_t * k * LOG_TWO - lmgamma(k, 0.5 * nu_t)
    if include_summand(propto, nu, s):
        lp = lp + nu_t * _chol_logdet(Ls)
    return lp


def wishart_rng(generator, nu, s, shape=()):
    """Bartlett decomposition: W = L A A^T L^T."""
    (s,) = as_tensors(s)
    k = s.shape[-1]
    shape = tuple(shape)
    Ls = cholesky_decompose(s)
    df = torch.as_tensor(nu, dtype=Ls.dtype, device=Ls.device) - torch.arange(k, dtype=Ls.dtype, device=Ls.device)
    c = torch.sqrt(2.0 * torch._standard_gamma((0.5 * df).expand(shape + (k,)).contiguous(), generator=generator))
    z = torch.randn(shape + (k, k), generator=generator, dtype=Ls.dtype, device=Ls.device)
    La = Ls @ (torch.tril(z, -1) + torch.diag_embed(c))
    return La @ La.mT


def inv_wishart_rng(generator, nu, s, shape=()):
    (s,) = as_tensors(s)
    return torch.linalg.inv(wishart_rng(generator, nu, torch.linalg.inv(s), shape))
