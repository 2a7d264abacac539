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

The values of ``gamma_p`` / ``gamma_q`` are XLA's ``igamma`` / ``igammac``
(the JAX package's): the series of P where ``z < 1`` or ``z < a`` (for P:
unless ``z >= 1`` and ``z > a``), Legendre's continued fraction of Q
elsewhere, run by ``special/incbeta.py``'s Lentz loop, with XLA's edge cases
and its Lanczos ``lgamma`` in the prefactor ``z^a e^-z / Gamma(a)``.
"""

from __future__ import annotations

import math

import torch

from math_tpu_torch.special.basic import _f, gamma_q
from math_tpu_torch.special.incbeta import _CHECK_EVERY, _CHUNK_NODE_EVALS, _lentz, inc_beta, inc_beta_dda, inc_beta_ddb

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


# --- the values: XLA's igamma / igammac ---------------------------------------

# XLA's lgamma: the Lanczos approximation (g = 7, nine terms) in the order of
# operations XLA expands it into, with the multiply-add that XLA's compiler
# fuses rounded once.  The prefactor's exponent a log z - z - lgamma(a) is
# ~lgamma(a) in size and one of its ulps is a relative error of the value
# (4.5e-13 at a = 500): the value follows XLA's roundings where it can
# (PyTorch's lgamma is up to 6e-13 apart from XLA's at a = 500).
_LANCZOS_BASE = 0.99999999999980993227684700473478
_LANCZOS = (676.520368121885098567009190444019, -1259.13921672240287047156078755283, 771.3234287776530788486528258894,
            -176.61502916214059906584551354, 12.507343278686904814458936853, -0.13857109526572011689554707,
            9.984369578019570859563e-6, 1.50563273514931155834e-7)
_GAMMA_MAX_ITERATIONS = 2000


def _fma(a, b, c):
    """``a b + c`` rounded once (a fused multiply-add), from the exact product
    (Dekker's split) and two-sums: how XLA's compiler contracts a multiply
    followed by an add.  Finite arguments of moderate size."""
    split = 134217729.0 if a.dtype == torch.float64 else 4097.0  # 2^(ceil(mantissa bits / 2)) + 1
    ca, cb = split * a, split * b
    a_hi, b_hi = ca - (ca - a), cb - (cb - b)
    a_lo, b_lo = a - a_hi, b - b_hi
    p = a * b
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)
    return s + (t + e)


def _lgamma_lanczos(x):
    reflect = x < 0.5
    z = torch.where(reflect, -x, x - 1.0)
    s = torch.full_like(x, _LANCZOS_BASE)
    for i, c in enumerate(_LANCZOS):
        s = s + c / (z + float(i + 1))
    log_t = torch.log1p(z * (1.0 / 7.5)) + math.log(7.5)
    out = _fma((z + 0.5) - (z + 7.5) / log_t, log_t, 0.5 * math.log(2.0 * math.pi)) + torch.log(s)
    frac = x.abs() - torch.floor(x.abs())
    frac = torch.where(frac > 0.5, 1.0 - frac, frac)
    log_sin = torch.log(torch.sin(math.pi * frac))
    reflected = torch.where(torch.isfinite(log_sin), (math.log(math.pi) - log_sin) - out, -log_sin)
    out = torch.where(reflect, reflected, out)
    return torch.where(torch.isinf(x), math.inf, out)


def _igamma_series(ax, a, z, live):
    """XLA's ``_igamma_series``: ``ax / a (1 + z / (a + 1) + ...)``, each
    element summed until its term over the sum is at most eps; elements not
    ``live`` keep the sum 1.  The batch is tested once every ``_CHECK_EVERY``
    terms."""
    eps = torch.finfo(z.dtype).eps
    r, c, ans = a, torch.ones_like(a), torch.ones_like(a)
    for _ in range(0, _GAMMA_MAX_ITERATIONS, _CHECK_EVERY):
        if not bool(live.any()):
            break
        for _step in range(_CHECK_EVERY):
            r_new = r + 1.0
            c_new = c * (z / r_new)
            ans_new = ans + c_new
            r, c, ans = (torch.where(live, new, old) for new, old in ((r_new, r), (c_new, c), (ans_new, ans)))
            live = live & (c_new / ans_new > eps)
    return ans * ax / a


def _igammac_fraction(ax, a, z, live):
    """Q(a, z) = ``ax / (z + 1 - a - 1 (1 - a) / (z + 3 - a - 2 (2 - a) /
    ...))`` (Legendre's continued fraction, the one XLA's
    ``_igammac_continued_fraction`` evaluates by its convergents) by the Lentz
    loop; elements not ``live`` get XLA's first convergent."""
    a_, z_ = torch.where(live, a, 1.0), torch.where(live, z, 2.0)
    b0 = z_ + 1.0 - a_

    def terms(its):
        k = torch.tensor(list(its), dtype=z.dtype, device=z.device).reshape((-1,) + (1,) * z.ndim)
        return zip(-k * (k - a_), b0 + 2.0 * k)

    h, _ = _lentz(terms, b0, _GAMMA_MAX_ITERATIONS, done=~live)
    first = (z + 1.0) / ((z + (1.0 - a) + 1.0) * z)
    return torch.where(live, ax / h, first * ax)


def igamma_values(a, z, upper=False):
    """P(a, z), or Q(a, z) with ``upper``, as XLA's ``igamma`` / ``igammac``
    compute them (no autograd; ``a`` and ``z`` of one shape and dtype)."""
    is_nan = torch.isnan(a) | torch.isnan(z)
    z_is_inf, a_is_zero, z_is_zero = z == math.inf, a == 0, z == 0
    domain_error = (z < 0) | (a < 0) | (a_is_zero & z_is_zero) | is_nan
    use_series = ((z < 1) | (z < a)) if upper else ~((z >= 1) & (z > a))
    log_z = torch.log(z)
    finite = torch.isfinite(log_z) & torch.isfinite(a) & torch.isfinite(z)
    log_ax = torch.where(finite, _fma(a, torch.where(finite, log_z, 0.0), -torch.where(finite, z, 0.0)), a * log_z - z)
    log_ax = log_ax - _lgamma_lanczos(a)
    underflow = log_ax < -math.log(torch.finfo(z.dtype).max)
    enabled = ~(domain_error | underflow | z_is_inf | (a_is_zero if upper else z_is_zero))
    ax = torch.where(underflow, 0.0, torch.exp(log_ax))
    series = _igamma_series(ax, a, z, enabled & use_series)
    fraction = _igammac_fraction(ax, a, z, enabled & ~use_series)
    if upper:
        out = torch.where(use_series, 1.0 - series, fraction)
        out = torch.where(z_is_inf | a_is_zero, 0.0, out)
    else:
        out = torch.where(use_series, series, 1.0 - fraction)
        out = torch.where(z_is_zero, 0.0, out)
        out = torch.where(z_is_inf, 1.0, out)
    return torch.where(domain_error, math.nan, out)


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
