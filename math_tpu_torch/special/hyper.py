"""Hypergeometric series values and incomplete-function gradients.

Counterpart: ``math_tpu/special/hyper.py``.
ref: F32.hpp, grad_inc_beta.hpp, grad_reg_inc_beta.hpp,
     grad_reg_inc_gamma.hpp, grad_reg_lower_inc_gamma.hpp

Every reference while-loop-until-converged is a fixed-length sum: ``F32``
a Python loop over its terms (the JAX package's ``lax.scan`` step for step),
the Gautschi series of ``d/da P(a, z)`` a sum over a trailing term axis of
closed-form terms, summed a chunk of rows at a time when no graph is being
built (memory bounded as in ``special/incbeta.py``).  Branch points are
``torch.where`` over both (argument-clamped) branches.  Gradients of the
regularized incomplete beta reuse the differentiable ``inc_beta``.
"""

from __future__ import annotations

import torch

from math_tpu_torch.special.basic import _f, gamma_q
from math_tpu_torch.special.incbeta import _CHUNK_NODE_EVALS, inc_beta, inc_beta_dda, inc_beta_ddb

__all__ = [
    "F32",
    "grad_inc_beta",
    "grad_reg_inc_beta",
    "grad_reg_inc_gamma",
    "grad_reg_lower_inc_gamma",
]


def F32(a1, a2, a3, b1, b2, z, max_terms=300):
    """Generalized hypergeometric 3F2(a1,a2,a3; b1,b2; z) (ref: F32.hpp).

    Converges for |z| < 1 (and z = 1 when the parameter sum condition
    holds, as checked by the reference's check_3F2_converges).
    """
    a1, a2, a3, b1, b2, z = _f(a1, a2, a3, b1, b2, z)
    term = torch.ones_like(z)
    acc = torch.ones_like(z)
    for k in range(max_terms):
        p = (a1 + k) * (a2 + k) * (a3 + k) / ((b1 + k) * (b2 + k) * (1.0 + k))
        term = term * p * z
        acc = acc + term
    return acc


def _lbeta(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def grad_inc_beta(a, b, z):
    """(d/da, d/db) of the NON-regularized incomplete beta B(z; a, b).

    ref: ``grad_inc_beta.hpp`` (via 2F1); here via the differentiable
    regularized ``inc_beta`` and the product rule on B(a,b) I_z(a,b).
    Returns a tuple (g1, g2) instead of output-reference parameters.
    """
    a, b, z = _f(a, b, z)
    bab = torch.exp(_lbeta(a, b))
    i = inc_beta(a, b, z)
    dab = torch.digamma(a + b)
    g1 = bab * ((torch.digamma(a) - dab) * i + inc_beta_dda(a, b, z))
    g2 = bab * ((torch.digamma(b) - dab) * i + inc_beta_ddb(a, b, z))
    return g1, g2


def grad_reg_inc_beta(a, b, z):
    """(d/da, d/db) of the regularized incomplete beta I_z(a, b).

    ref: ``grad_reg_inc_beta.hpp`` (tuple return instead of the
    reference's output-parameter + precomputed-digamma signature).
    """
    return inc_beta_dda(a, b, z), inc_beta_ddb(a, b, z)


_N_SERIES = 256


def _dP_da_terms(a, z):
    """The series of ``_dP_da_series`` on flat rows."""
    n = torch.arange(_N_SERIES, dtype=z.dtype, device=z.device)
    apn1 = a[..., None] + n + 1.0
    logz = torch.log(torch.clamp_min(z, 1e-300))
    lt = (a[..., None] + n) * logz[..., None] - z[..., None] - torch.lgamma(apn1)
    return torch.sum(torch.exp(lt) * (logz[..., None] - torch.digamma(apn1)), -1)


def _dP_da_series(a, z):
    """Gautschi series for d/da P(a,z) (ref: grad_reg_lower_inc_gamma.hpp).

    dP/da = sum_n exp((a+n) log z - z - lgamma(a+n+1))
                  * (log z - psi(a+n+1))

    With no graph to build, a chunk of rows at a time.
    """
    if torch.is_grad_enabled() and (a.requires_grad or z.requires_grad):
        return _dP_da_terms(a, z)
    with torch.no_grad():
        shape = a.shape
        a, z = a.reshape(-1), z.reshape(-1)
        step = max(1, _CHUNK_NODE_EVALS // _N_SERIES)
        if a.numel() <= step:
            return _dP_da_terms(a, z).reshape(shape)
        out = torch.empty_like(a)
        for start in range(0, a.numel(), step):
            out[start:start + step] = _dP_da_terms(a[start:start + step], z[start:start + step])
        return out.reshape(shape)


def _dQ_da_asym(a, z):
    """Asymptotic d/da Q(a,z) for z >= max(a, 8) (ref: grad_reg_inc_gamma.hpp,
    DLMF 8.11.2 differentiated in a)."""
    lz = torch.log(z)
    dig = torch.digamma(a)
    s = torch.zeros_like(z)
    fac = a - 1.0  # falling_factorial(a-1, k)
    dfac = torch.ones_like(a)  # d/da falling_factorial(a-1, k)
    zpow = z
    delta = dfac / zpow
    am1k = a - 1.0
    for _ in range(1, 10):
        am1k = am1k - 1.0
        s = s + delta
        zpow = zpow * z
        dfac = am1k * dfac + fac
        fac = fac * am1k
        delta = dfac / zpow
    # through the custom-rule gamma_q: second-order AD of this partial needs
    # the hand-written backward (one recursion level per order)
    q = gamma_q(a, z)
    return q * (lz - dig) + torch.exp(-z + (a - 1.0) * lz - torch.lgamma(a)) * s


def _use_asymptotic(a, z):
    return ((z - a) > torch.clamp_max(8.0 * torch.sqrt(a) + 50.0, 150.0)) & (z >= 8.0)


def grad_reg_inc_gamma(a, z, g=None, dig=None):
    """d/da of the UPPER regularized incomplete gamma Q(a, z).

    ref: ``grad_reg_inc_gamma.hpp``.  The reference's precomputed
    ``g = tgamma(a)`` / ``dig = digamma(a)`` arguments are accepted for
    signature parity but recomputed internally.
    """
    a, z = torch.broadcast_tensors(*_f(a, z))
    # series converges in ~(z - a) + 5 sqrt(z) terms; prefer it whenever the
    # 256-term budget covers that (the 10-term asymptotic is weak near z ~ a)
    use_asym = _use_asymptotic(a, z)
    z_ser = torch.minimum(z, a + 160.0)
    out = torch.where(use_asym, _dQ_da_asym(a, torch.clamp_min(z, 8.0)), -_dP_da_series(a, z_ser))
    return torch.where((a > 0) & (z >= 0), out, torch.nan)


def grad_reg_lower_inc_gamma(a, z):
    """d/da of the LOWER regularized incomplete gamma P(a, z).

    ref: ``grad_reg_lower_inc_gamma.hpp`` (Gautschi-series region split).
    """
    a, z = torch.broadcast_tensors(*_f(a, z))
    # reference region split: use the (negated) upper gradient for large z
    use_upper = _use_asymptotic(a, z)
    z_ser = torch.minimum(z, a + 160.0)
    out = torch.where(use_upper, -_dQ_da_asym(a, torch.clamp_min(z, 8.0)), _dP_da_series(a, z_ser))
    out = torch.where(z == 0.0, torch.zeros_like(out), out)
    return torch.where((a > 0) & (z >= 0), out, torch.nan)
