"""Two models written with the PyTorch port's public API, as a user writes
one (``make_log_density({name: Transform}, log_prob)``): their numpy data,
their ``log_prob`` and what their draws must show.  Imports no JAX; the CPU
test writes the same ``log_prob`` once more with ``math_tpu``'s API.

- ``varying slopes``: the varying-intercepts-and-slopes regression of the
  Stan User's Guide ("Multivariate priors for hierarchical models"), in its
  covariance-matrix form.  ``Omega`` is a ``CorrMatrix`` under
  ``lkj_corr(2)``, ``tau`` a ``LowerBound`` scale vector under
  ``cauchy(0, 2.5)``, ``mu`` under ``normal(0, 5)``; the J group
  coefficient vectors ``beta_j ~ multi_normal(mu, quad_form_diag(Omega,
  tau))``; ``y_n ~ normal(x_n . beta[g[n]], sigma)`` with ``sigma`` under
  ``cauchy(0, 2.5)``.  Both ``multi_normal_lpdf`` and ``lkj_corr_lpdf``
  factor one ``(K, K)`` matrix a chain through the blocked Cholesky.
- ``constrained prior``: one block of each constrained ``Transform`` class
  under a density whose constrained moments are known in closed form
  (``PRIOR_BLOCKS``), plus two unconstrained blocks under
  ``multi_student_t`` and ``multi_normal_prec``: no data.  A wrong
  log-Jacobian or density shifts a moment by many Monte-Carlo errors.

Run from the repository root (``tools`` is a directory, not a package:
``sys.path`` gets the root, as ``chip_smoke.py`` and the tests do).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from math_tpu_torch import dists
from math_tpu_torch.model import make_log_density
from math_tpu_torch.ops import linalg, segment
from math_tpu_torch.transforms import (
    Bounded,
    CholeskyCorr,
    CholeskyCov,
    CorrMatrix,
    CovMatrix,
    Identity,
    LowerBound,
    OffsetMultiplier,
    Simplex,
    UnitVector,
    UpperBound,
)

# --- varying slopes --------------------------------------------------------

VS_MU = np.array([1.0, -0.5, 0.8, 0.3, -1.2])
VS_TAU = np.array([1.0, 0.7, 0.5, 0.8, 0.6])
VS_OMEGA = np.array([
    [1.0, 0.3, -0.2, 0.1, 0.0],
    [0.3, 1.0, 0.25, -0.15, 0.1],
    [-0.2, 0.25, 1.0, 0.2, -0.1],
    [0.1, -0.15, 0.2, 1.0, 0.3],
    [0.0, 0.1, -0.1, 0.3, 1.0],
])
VS_SIGMA = 1.0


def varying_slopes_data(groups=100, k=5, per_group=20, seed=0):
    """``(x (N, k), g (N,), y (N,), truth)``: ``per_group`` rows a group,
    ``x = [1, normal(0, 1) x (k - 1)]``, group coefficients drawn from the
    generating ``mu``, ``tau``, ``Omega`` (their first ``k``), ``sigma = 1``.
    ``truth`` holds those and the drawn ``beta``."""
    rng = np.random.default_rng(seed)
    mu, tau, omega = VS_MU[:k], VS_TAU[:k], VS_OMEGA[:k, :k]
    beta = rng.multivariate_normal(mu, omega * tau[:, None] * tau[None, :], size=groups)
    g = np.repeat(np.arange(groups), per_group)
    x = np.concatenate([np.ones((g.shape[0], 1)), rng.normal(size=(g.shape[0], k - 1))], axis=1)
    y = np.sum(x * beta[g], axis=1) + VS_SIGMA * rng.normal(size=g.shape[0])
    return x, g, y, {"mu": mu, "tau": tau, "Omega": omega, "sigma": VS_SIGMA, "beta": beta}


def make_varying_slopes(groups, k):
    """The model; its ``logp(z, x, g, y)`` takes the data as tensors on the
    device of ``z`` (``g`` an integer tensor).  Dimension ``k (k - 1) / 2 +
    2 k + groups k + 1`` (521 at 100 groups, k = 5), packed in the order of
    ``params``."""
    params = {
        "Omega": CorrMatrix((k, k)),
        "tau": LowerBound((k,), 0.0),
        "mu": Identity((k,)),
        "beta": Identity((groups, k)),
        "sigma": LowerBound((), 0.0),
    }

    def log_prob(v, x, g, y):
        lp = dists.lkj_corr_lpdf(v["Omega"], 2.0, batch_ndims=1)
        lp = lp + dists.cauchy_lpdf(v["tau"], 0.0, 2.5, batch_ndims=1)
        lp = lp + dists.normal_lpdf(v["mu"], 0.0, 5.0, batch_ndims=1)
        sigma_beta = linalg.quad_form_diag(v["Omega"], v["tau"])
        lp = lp + dists.multi_normal_lpdf(v["beta"], v["mu"], sigma_beta, batch_ndims=1)
        lp = lp + dists.cauchy_lpdf(v["sigma"], 0.0, 2.5, batch_ndims=1)
        eta = torch.sum(x * segment.segment_gather(v["beta"], g, groups, batch_ndims=1), dim=-1)
        return lp + dists.normal_lpdf(y, eta, v["sigma"][:, None], batch_ndims=1)

    return make_log_density(params, log_prob)


# --- constrained prior -----------------------------------------------------

ETA_CHOL, ETA_CORR = 1.5, 2.0
ALPHA = np.array([1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0, 4.5])
S_WISHART = np.array([[1.0, 0.3, -0.2], [0.3, 0.8, 0.1], [-0.2, 0.1, 0.6]])
NU_WISHART, NU_INV_WISHART = 6.0, 10.0
NU_T = 7.0
MU_T = np.array([0.5, -1.0, 2.0])
SIGMA_T = np.array([[1.0, 0.4, 0.1], [0.4, 2.0, -0.3], [0.1, -0.3, 0.5]])
MU_PREC = np.array([-0.3, 0.2, 1.0])
OMEGA_PREC = np.array([[2.0, -0.5, 0.2], [-0.5, 1.5, 0.3], [0.2, 0.3, 1.0]])
LCOV_ROWS, LCOV_COLS = (np.array([1, 2, 2, 3, 3, 3]), np.array([0, 0, 1, 0, 1, 2]))  # strictly below the diagonal of (4, 3)

PRIOR_BLOCKS = {
    "L_corr": CholeskyCorr((6, 6)),
    "R_corr": CorrMatrix((4, 4)),
    "theta": Simplex((8,)),
    "W": CovMatrix((3, 3)),
    "V": CovMatrix((3, 3)),
    "u": Bounded((), -1.0, 3.0),
    "ub": UpperBound((), 2.0),
    "om": OffsetMultiplier((), 3.0, 2.0),
    "dir": UnitVector((4,)),
    "L_cov": CholeskyCov((4, 3)),
    "t": Identity((3,)),
    "z": Identity((3,)),
}


def make_constrained_prior():
    """The prior-only model (``logp(z)``, no data)."""

    def log_prob(v):
        lp = dists.lkj_corr_cholesky_lpdf(v["L_corr"], ETA_CHOL, batch_ndims=1)
        lp = lp + dists.lkj_corr_lpdf(v["R_corr"], ETA_CORR, batch_ndims=1)
        lp = lp + dists.dirichlet_lpdf(v["theta"], ALPHA, batch_ndims=1)
        lp = lp + dists.wishart_lpdf(v["W"], NU_WISHART, S_WISHART, batch_ndims=1)
        lp = lp + dists.inv_wishart_lpdf(v["V"], NU_INV_WISHART, S_WISHART, batch_ndims=1)
        lp = lp + dists.normal_lpdf(v["ub"], 0.0, 1.0, batch_ndims=1)
        lp = lp + dists.normal_lpdf(v["om"], 3.0, 2.0, batch_ndims=1)
        L = v["L_cov"]
        lp = lp + dists.normal_lpdf(L[:, LCOV_ROWS, LCOV_COLS], 0.0, 1.0, batch_ndims=1)
        lp = lp + dists.lognormal_lpdf(torch.diagonal(L, dim1=-2, dim2=-1), 0.0, 0.5, batch_ndims=1)
        lp = lp + dists.multi_student_t_lpdf(v["t"], NU_T, MU_T, SIGMA_T, batch_ndims=1)
        return lp + dists.multi_normal_prec_lpdf(v["z"], MU_PREC, OMEGA_PREC, batch_ndims=1)

    return make_log_density(PRIOR_BLOCKS, log_prob)


def _offdiag(m):
    r, c = np.tril_indices(m.shape[-1], -1)
    return m[..., r, c]


def prior_moments(draws):
    """``{name: (values (chains, draws, m), expected (m,))}``: functions of
    the constrained draws (numpy, float64) and their expectations in closed
    form.  LKJ(eta) on K x K: an off-diagonal r has (r + 1) / 2 ~ Beta(b, b),
    b = eta - 1 + K / 2, so E r = 0, E r^2 = 1 / (2 b + 1); Dirichlet: E
    theta = alpha / sum(alpha); Wishart: E W = nu S; inverse Wishart: E V =
    S / (nu - K - 1); Uniform(-1, 3): E u = 1, E u^2 = 7/3; normal(0, 1)
    below 2: E = -phi(2) / Phi(2); normal(3, 2): E = 3, E (om - 3)^2 = 4;
    uniform unit vector in R^4: E y = 0, E y_i^2 = 1/4; the Cholesky-factor
    entries: 0 and 1 below the diagonal, exp(0.125) on it; multi Student t:
    E t = mu, E (t - mu)(t - mu)^T = nu / (nu - 2) Sigma; the precision-form
    normal: E z = mu, cov Omega^-1."""
    out = {}
    corr_chol = draws["L_corr"] @ np.swapaxes(draws["L_corr"], -1, -2)
    for name, y, eta in (("L_corr", corr_chol, ETA_CHOL), ("R_corr", draws["R_corr"], ETA_CORR)):
        k = y.shape[-1]
        r = _offdiag(y)
        var = 1.0 / (2.0 * (eta - 1.0 + k / 2.0) + 1.0)
        out[f"{name}_r"] = (r, np.zeros(r.shape[-1]))
        out[f"{name}_r2"] = (r**2, np.full(r.shape[-1], var))
    out["theta"] = (draws["theta"], ALPHA / ALPHA.sum())
    out["W"] = (draws["W"].reshape(draws["W"].shape[:2] + (9,)), (NU_WISHART * S_WISHART).ravel())
    out["V"] = (draws["V"].reshape(draws["V"].shape[:2] + (9,)), (S_WISHART / (NU_INV_WISHART - 3 - 1)).ravel())
    u = draws["u"][..., None]
    out["u"] = (np.concatenate([u, u**2], -1), np.array([1.0, 16.0 / 12.0 + 1.0]))
    phi2 = math.exp(-2.0) / math.sqrt(2.0 * math.pi)
    out["ub"] = (draws["ub"][..., None], np.array([-phi2 / (0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0))))]))
    om = draws["om"][..., None]
    out["om"] = (np.concatenate([om, (om - 3.0) ** 2], -1), np.array([3.0, 4.0]))
    out["dir"] = (np.concatenate([draws["dir"], draws["dir"] ** 2], -1), np.array([0.0] * 4 + [0.25] * 4))
    lc = draws["L_cov"]
    low = lc[..., LCOV_ROWS, LCOV_COLS]
    out["L_cov"] = (np.concatenate([low, low**2, np.diagonal(lc, axis1=-2, axis2=-1)], -1),
                    np.array([0.0] * 6 + [1.0] * 6 + [math.exp(0.125)] * 3))
    for name, y, mu, cov in (("t", draws["t"], MU_T, NU_T / (NU_T - 2.0) * SIGMA_T),
                             ("z", draws["z"], MU_PREC, np.linalg.inv(OMEGA_PREC))):
        d = y - mu
        r, c = np.triu_indices(3)
        out[name] = (np.concatenate([y, d[..., r] * d[..., c]], -1), np.concatenate([mu, cov[r, c]]))
    return out
