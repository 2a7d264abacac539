"""Pathfinder: quasi-Newton variational inference (Zhang, Carpenter, Gelman,
Vehtari 2022; downstream-Stan service method since 2.33).

Counterpart: ``math_tpu/infer/pathfinder.py``.

Single path: run L-BFGS on the (jacobian-adjusted) negative log density
from a random init; at every iterate build the local Gaussian approximation

    q_k = N(theta_k + Sigma_k g_k,  Sigma_k),

where ``Sigma_k`` is the L-BFGS inverse-Hessian estimate in the
Byrd–Nocedal–Schnabel compact form over the last ``history`` curvature
pairs, ``Sigma = gamma I + T W T^T``, ``T = [S, gamma Y]`` (dim x 2J), which
a thin QR of ``T`` reduces to ``gamma I + Q E Q^T`` with a 2J x 2J
eigendecomposition.  Each iterate's ELBO is estimated with
``num_elbo_draws`` Monte-Carlo draws; the best iterate's approximation
supplies the path's draws.

Multi-path: ``num_paths`` independent paths pooled and importance RESAMPLED
with Pareto-smoothed weights (``diagnostics.psis``), returning the PSIS
k_hat diagnostic.

The port runs the ``num_paths`` paths as lanes of one chain-batched L-BFGS
(``infer.optimize.lbfgs``), not one after another; the (2J, 2J) algebra of
``_build_approx`` stays host-side numpy in float64, as in the reference.
The ELBO draws of every iterate of every path go through the log density
in one chain-batched call, and so do the final draws of all paths.  Every
draw comes from the caller's ``torch.Generator`` (``key``) on its device;
the resampling is ``torch.multinomial`` with that generator.

Deviations from Stan, documented in the reference and kept: the scalar
initial estimate gamma = s^T y / y^T y; iterates whose middle matrix is not
positive definite are discarded.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from math_tpu_torch.diagnostics.psis import psis_smooth
from math_tpu_torch.infer.optimize import _device_dtype, _value_and_grad, lbfgs

__all__ = ["PathfinderResult", "pathfinder"]


class PathfinderResult(NamedTuple):
    draws: torch.Tensor  # (num_draws, dim) unconstrained draws
    log_p: torch.Tensor  # (num_draws,) target log density of the draws
    log_q: torch.Tensor  # (num_draws,) approximation log density
    k_hat: float  # PSIS shape diagnostic of the pooled weights
    path_elbos: np.ndarray  # (num_paths,) best ELBO per path
    best_iters: np.ndarray  # (num_paths,) iterate index chosen per path
    num_grad_calls: int = 0  # chain-batched value-and-gradient calls (L-BFGS)
    num_logp_calls: int = 0  # chain-batched log-density calls (ELBOs and draws)


class _Approx(NamedTuple):
    """gamma I + Q diag-eig(E) Q^T factorization of Sigma at one iterate."""

    mu: torch.Tensor  # (dim,)
    gamma: torch.Tensor  # scalar
    q: torch.Tensor  # (dim, 2J) orthonormal
    lam: torch.Tensor  # (2J,) eigenvalues of E (Sigma eigs = gamma + lam)
    v: torch.Tensor  # (2J, 2J) eigenvectors of E
    logdet: torch.Tensor  # log |Sigma|


def _build_approx(theta, g_logp, s_cols, y_cols, *, dtype=torch.float64, device="cpu"):
    """Compact-form Sigma at one iterate; None if not positive definite.

    ``theta``, ``g_logp`` and ``s_cols``/``y_cols`` (lists of (dim,) arrays,
    oldest->newest, with y = grad(neg logp) differences) are host numpy; the
    result's tensors are of ``dtype`` on ``device``.
    """
    dim = theta.shape[0]
    S = np.stack(s_cols, axis=1)  # (dim, J)
    Y = np.stack(y_cols, axis=1)
    j = S.shape[1]
    sty = S.T @ Y  # (J, J)
    gamma = float((s_cols[-1] @ y_cols[-1]) / max(y_cols[-1] @ y_cols[-1], 1e-300))
    if not np.isfinite(gamma) or gamma <= 0:
        return None
    R = np.triu(sty)
    if np.any(np.abs(np.diag(R)) < 1e-12):
        return None
    Rinv = np.linalg.solve(R, np.eye(j))
    D = np.diag(np.diag(sty))
    # W = [[R^-T (D + gamma Y^T Y) R^-1, -R^-T], [-R^-1, 0]]
    tl = Rinv.T @ (D + gamma * (Y.T @ Y)) @ Rinv
    W = np.block([[tl, -Rinv.T], [-Rinv, np.zeros((j, j))]])
    T = np.concatenate([S, gamma * Y], axis=1)  # (dim, 2J)
    Q, Rq = np.linalg.qr(T)  # thin
    E = Rq @ W @ Rq.T
    E = 0.5 * (E + E.T)
    lam, V = np.linalg.eigh(E)
    if np.any(gamma + lam <= 1e-12 * max(1.0, gamma)):
        return None  # Sigma not PD at this iterate: discard
    logdet = float(np.sum(np.log(gamma + lam)) + (dim - 2 * j) * np.log(gamma))
    # mu = theta + Sigma g  (all thin-factor products)
    u = Q.T @ g_logp
    mu = theta + gamma * g_logp + Q @ (E @ u)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)

    return _Approx(mu=t(mu), gamma=t(gamma), q=t(Q), lam=t(lam), v=t(V), logdet=t(logdet))


def _sample_q(ap: _Approx, z):
    """Draws of q from the standard normals ``z (n, dim)`` (the JAX package's
    ``_sample_q`` draws them from a key inside)."""
    u = z @ ap.q  # (n, 2J)  == Q^T z per draw
    scaled = (torch.sqrt(ap.gamma + ap.lam) * (u @ ap.v)) @ ap.v.mT  # (n, 2J)
    return ap.mu[None, :] + torch.sqrt(ap.gamma) * (z - u @ ap.q.mT) + scaled @ ap.q.mT


def _log_q(ap: _Approx, x):
    dim = ap.mu.shape[0]
    d = x - ap.mu[None, :]
    u = d @ ap.q  # (n, 2J)
    # Sigma^-1 = (1/gamma)(I - QQ^T) + Q V diag(1/(gamma+lam)) V^T Q^T
    perp = d - u @ ap.q.mT
    quad = (perp * perp).sum(-1) / ap.gamma + (((u @ ap.v) ** 2) / (ap.gamma + ap.lam)).sum(-1)
    return -0.5 * (quad + ap.logdet + dim * math.log(2.0 * math.pi))


def _path_approximations(thetas, gnegs, history, dtype, device):
    """Every iterate's approximation of one path, ``[(k, _Approx)]``, from
    its iterates and gradients of the negative log density (host numpy)."""
    out = []
    s_hist, y_hist = [], []
    for k in range(1, len(thetas)):
        s = thetas[k] - thetas[k - 1]
        y = gnegs[k] - gnegs[k - 1]
        if (s @ y) > 1e-11 * np.linalg.norm(s) * np.linalg.norm(y):
            s_hist.append(s)
            y_hist.append(y)
            if len(s_hist) > history:
                s_hist.pop(0)
                y_hist.pop(0)
        if not s_hist:
            continue
        ap = _build_approx(thetas[k], -gnegs[k], s_hist, y_hist, dtype=dtype, device=device)
        if ap is not None:
            out.append((k, ap))
    return out


def _logp_batch(logdensity_fn, args, xs):
    with torch.no_grad():
        return logdensity_fn(xs, *args)


def pathfinder(
    logdensity_fn: Callable,
    key: torch.Generator,
    dim: int,
    *,
    args=(),
    num_paths: int = 4,
    num_draws: int = 1000,
    num_draws_per_path: int = 1000,
    num_elbo_draws: int = 25,
    history: int = 6,
    max_iters: int = 75,
    init_radius: float = 2.0,
    tol: float = 1e-8,
    resample: bool = True,
    dtype=None,
    device=None,
) -> PathfinderResult:
    """Multi-path Pathfinder (ref: downstream Stan's pathfinder service).

    ``logdensity_fn(theta (C, dim), *args) -> (C,)`` (chain-batched);
    ``key`` a ``torch.Generator`` of ``device`` (default
    ``get_config().device``; a generator on another device raises at the
    first draw); ``dtype`` default ``get_config().default_dtype`` (the dtype of
    the model's data: float32 for the GLM kernels on the card).  Draws
    ``num_draws_per_path`` from each path's best-ELBO Gaussian, pools them,
    Pareto-smooths the importance weights, and (with ``resample=True``)
    importance-resamples ``num_draws`` final draws.  ``k_hat`` > 0.7 means
    the pooled approximation is unreliable — use the draws for
    initialization, not for posterior summaries.
    """
    device, dtype = _device_dtype(None, device, dtype)
    args = tuple(args)
    u = torch.rand((num_paths, dim), generator=key, dtype=dtype, device=device)
    z0 = (2.0 * u - 1.0) * init_radius
    res = lbfgs(_value_and_grad(logdensity_fn, args), z0, memory_size=history, max_iters=max_iters, tol=tol,
                record=True)
    # every path's iterates and gradients on the host, in float64 (the
    # first entry of the path is the starting point)
    zs = torch.stack([z for z, _, _ in res.path]).double().cpu().numpy()
    gs = torch.stack([g for _, g, _ in res.path]).double().cpu().numpy()
    rec = torch.stack([m for _, _, m in res.path]).cpu().numpy()
    thetas = [[zs[0, p]] for p in range(num_paths)]
    gnegs = [[gs[0, p]] for p in range(num_paths)]
    for it in range(1, len(res.path)):
        for p in range(num_paths):
            if rec[it, p]:
                thetas[p].append(zs[it, p])
                gnegs[p].append(gs[it, p])
    approx = [_path_approximations(thetas[p], gnegs[p], history, dtype, device) for p in range(num_paths)]
    # the ELBO of every approximation: its draws in one chain-batched call
    flat = [(p, k, ap) for p in range(num_paths) for k, ap in approx[p]]
    logp_calls = 0
    elbos, iters = [-np.inf] * num_paths, [-1] * num_paths
    best = [None] * num_paths
    if flat:
        z = torch.randn((len(flat), num_elbo_draws, dim), generator=key, dtype=dtype, device=device)
        xs = torch.stack([_sample_q(ap, z[i]) for i, (_, _, ap) in enumerate(flat)])
        lq = torch.stack([_log_q(ap, xs[i]) for i, (_, _, ap) in enumerate(flat)])
        lp = _logp_batch(logdensity_fn, args, xs.reshape(-1, dim)).reshape(len(flat), num_elbo_draws)
        logp_calls += 1
        lp_np, lq_np = lp.double().cpu().numpy(), lq.double().cpu().numpy()
        for i, (p, k, ap) in enumerate(flat):
            mask = np.isfinite(lp_np[i])
            if not mask.any():
                continue
            elbo = float(np.mean(np.where(mask, lp_np[i], np.min(lp_np[i][mask])) - lq_np[i]))
            if elbo > elbos[p]:
                elbos[p], iters[p], best[p] = elbo, k, ap
    chosen = [p for p in range(num_paths) if best[p] is not None]
    if not chosen:
        raise RuntimeError(
            "pathfinder: every optimization path failed to produce a "
            "positive-definite approximation; check the log density"
        )
    z = torch.randn((len(chosen), num_draws_per_path, dim), generator=key, dtype=dtype, device=device)
    X = torch.cat([_sample_q(best[p], z[i]) for i, p in enumerate(chosen)])
    LQ = torch.cat([_log_q(best[p], X[i * num_draws_per_path:(i + 1) * num_draws_per_path])
                    for i, p in enumerate(chosen)])
    LP = _logp_batch(logdensity_fn, args, X)
    logp_calls += 1
    finite = torch.isfinite(LP)
    X, LP, LQ = X[finite], LP[finite], LQ[finite]
    lw, k_hat = psis_smooth((LP - LQ).double().cpu().numpy())
    if resample:
        w = np.exp(lw - lw.max())
        w = torch.as_tensor(w / w.sum(), dtype=torch.float64, device=device)
        idx = torch.multinomial(w, num_draws, replacement=True, generator=key)
        X, LP, LQ = X[idx], LP[idx], LQ[idx]
    return PathfinderResult(
        draws=X, log_p=LP, log_q=LQ, k_hat=float(k_hat), path_elbos=np.asarray(elbos),
        best_iters=np.asarray(iters), num_grad_calls=res.num_evals, num_logp_calls=logp_calls,
    )
