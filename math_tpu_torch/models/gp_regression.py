"""GP regression (BASELINE.md config 5): the analytically marginalized model,
the Cholesky-parameterized latent-f model, and exact recovery of the latent
field from hyperparameter draws.

Counterpart: ``math_tpu/models/gp_regression.py``.  Written for a leading chain
axis: ``rho``, ``alpha``, ``sigma`` are ``(C,)``, the kernel matrix is
``(C, n, n)``, and every factorization goes through the blocked Cholesky of
``ops/chol_blocked.py``, whose diagonal-block kernel takes all chains in one
launch.

    rho ~ inv_gamma(5, 5); alpha ~ normal+(0, 2); sigma ~ std_normal+
    marginal:  y ~ MVN(0, K_exp_quad(x; alpha, rho) + (sigma^2 + jitter) I)
    latent:    f = cholesky(K + jitter I) @ eta,  eta ~ std_normal;  y ~ normal(f, sigma)

Data flows through ``model.logp(theta, x, y)`` / the samplers' ``args=(x, y)``
as tensors on the sampler's device, in the floating type of ``theta``.
"""

from __future__ import annotations

import numpy as np
import torch

from math_tpu_torch import dists, transforms
from math_tpu_torch.config import get_config
from math_tpu_torch.model import make_log_density
from math_tpu_torch.ops import gp as gp_ops
from math_tpu_torch.ops.cholesky import cholesky_decompose, mdivide_left_tri_low, spd_solve_logdiag


def synthetic_data(n=2000, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3, 3, n)).astype(dtype)
    f = np.sin(2 * x) * np.exp(-0.2 * np.abs(x)) * 2.0
    y = (f + rng.normal(size=n) * 0.3).astype(dtype)
    return x, y


def _hyper_priors(rho, alpha, sigma):
    lp = dists.inv_gamma_lpdf(rho, 5.0, 5.0, propto=True, batch_ndims=1)
    lp = lp + dists.normal_lpdf(alpha, 0.0, 2.0, propto=True, batch_ndims=1)
    return lp + dists.normal_lpdf(sigma, 0.0, 1.0, propto=True, batch_ndims=1)


_HYPER = {
    "rho": transforms.LowerBound(shape=(), lb=0.0),
    "alpha": transforms.LowerBound(shape=(), lb=0.0),
    "sigma": transforms.LowerBound(shape=(), lb=0.0),
}


def make(n: int, jitter=1e-8):
    """The latent model: ``eta (C, n)`` beside the three hyperparameters."""

    def log_prob(p, x, y):
        rho, alpha, sigma, eta = p["rho"], p["alpha"], p["sigma"], p["eta"]
        lp = _hyper_priors(rho, alpha, sigma)
        lp = lp + dists.std_normal_lpdf(eta, propto=True, batch_ndims=1)
        k = gp_ops.add_diag(gp_ops.gp_exp_quad_cov(x, alpha, rho), jitter)
        L = cholesky_decompose(k)
        f = (L @ eta[..., None])[..., 0]
        return lp + dists.normal_lpdf(y, f, sigma[:, None], propto=True, batch_ndims=1)

    return make_log_density({**_HYPER, "eta": transforms.Identity(shape=(n,))}, log_prob)


def make_marginal(n: int, jitter=1e-3):
    """Analytically marginalized GP regression: y ~ MVN(0, K + sigma^2 I).

    The standard Stan formulation when only hyperparameters are inferred; the
    3-dim posterior mixes orders of magnitude faster than the latent-f
    parameterization while the per-leapfrog cost is the same O(n^3) blocked
    Cholesky.  One fused blocked factorization per gradient call: the solve
    and the log-determinant share the block inverses of the kernel.
    """

    def log_prob(p, x, y):
        rho, alpha, sigma = p["rho"], p["alpha"], p["sigma"]
        lp = _hyper_priors(rho, alpha, sigma)
        k = gp_ops.add_diag(gp_ops.gp_exp_quad_cov(x, alpha, rho), torch.square(sigma) + jitter)
        z, slogdiag = spd_solve_logdiag(k, y)
        return lp - 0.5 * torch.square(z).sum(-1) - slogdiag

    return make_log_density(dict(_HYPER), log_prob)


def sample_latent_conditional(generator, hyper_draws, x, y, *, jitter=1e-3, batch=16, device=None, dtype=None):
    """Exact draws of the latent f given hyperparameter draws: f | y, theta.

    For the Gaussian likelihood the latent field is conditionally Gaussian, so
    the latent-f posterior factorizes as p(theta | y) p(f | y, theta) and f
    can be recovered exactly from marginal-NUTS hyperparameter draws (Stan's
    GP docs do exactly this: marginalize f, redraw it in generated
    quantities; ref: gp_exp_quad_cov.hpp users + multi_normal_rng.hpp).

    Sampling uses Matheron's rule (pathwise conditioning) to avoid the
    float32-catastrophic cancellation of forming K - K A^{-1} K directly:

        f0 ~ N(0, K);  y0 = f0 + sigma z;  A = K + sigma^2 I
        f  = f0 + K A^{-1} (y - y0)   ~  N(K A^{-1} y, K - K A^{-1} K)

    ``hyper_draws``: (M, 3) CONSTRAINED (rho, alpha, sigma) draws.  Returns
    (M, n) draws of f on ``device``.  The noise comes from ``generator`` (a
    ``torch.Generator`` of ``device``).  ``batch`` bounds device memory (each
    draw holds two n x n factorizations): the draws go through in batches,
    each one chain-batched call.
    """
    cfg = get_config()
    device = torch.device(cfg.device if device is None else device)
    dtype = cfg.default_dtype if dtype is None else dtype
    x = torch.as_tensor(x, dtype=dtype, device=device)
    y = torch.as_tensor(y, dtype=dtype, device=device)
    hyper_draws = torch.as_tensor(hyper_draws, dtype=dtype, device=device)
    n = x.shape[0]
    eps = torch.finfo(dtype).eps
    out = []
    with torch.no_grad():
        for th in hyper_draws.split(batch):
            rho, alpha, sigma = th[:, 0], th[:, 1], th[:, 2]
            # dtype-aware stabilization: the float32 factorization of K alone
            # (lambda_max ~ n alpha^2) needs jitter >= ~3 eps n alpha^2 or tail
            # draws (large alpha) give NaN factors.  For the bulk of the
            # posterior this leaves ``jitter`` untouched; in float64 the
            # maximum never binds.
            jit_eff = torch.clamp_min(3.0 * eps * n * torch.square(alpha), jitter)
            kmat = gp_ops.add_diag(gp_ops.gp_exp_quad_cov(x, alpha, rho), jit_eff)
            amat = gp_ops.add_diag(kmat, torch.square(sigma))
            z1 = torch.randn((th.shape[0], n), generator=generator, device=device, dtype=dtype)
            z2 = torch.randn((th.shape[0], n), generator=generator, device=device, dtype=dtype)
            lk = cholesky_decompose(kmat)
            la = cholesky_decompose(amat)
            f0 = (lk @ z1[..., None])[..., 0]
            resid = y - f0 - sigma[:, None] * z2
            half = mdivide_left_tri_low(la, resid)
            w = torch.linalg.solve_triangular(la.mT, half[..., None], upper=True)
            # kmat (with its jitter) is the latent model's prior covariance:
            # make(n, jitter) factors K + jitter I too
            out.append(f0 + (kmat @ w)[..., 0])
    return torch.cat(out) if out else torch.empty((0, n), dtype=dtype, device=device)
