"""Integer-order Bessel functions J_n, Y_n, I_n, K_n.

Counterpart: ``math_tpu/special/bessel.py``.

ref: bessel_first_kind.hpp, bessel_second_kind.hpp,
     modified_bessel_first_kind.hpp, modified_bessel_second_kind.hpp
(reference delegates to boost::math::cyl_bessel_j / cyl_neumann /
cyl_bessel_i / cyl_bessel_k with integer order).

No recurrences, no data-dependent control flow.  Each
function is a *fixed-size vectorized quadrature* over precomputed nodes
(spectrally convergent trapezoid for the periodic-derivative integrands,
Gauss-Legendre for the oscillatory Neumann piece, exp-sinh for the
semi-infinite decaying pieces; node tables built with numpy at import),
combined branchlessly via ``torch.where`` with a Hankel-type asymptotic
expansion for large argument.  Everything is dense broadcast + reduce;
derivatives in ``z`` come from autograd under the (fixed) quadrature rule.

Accuracy domain (f64): relative error <~1e-10 for integer orders
|n| <= 15 over the full argument range, degrading gracefully for larger
orders (quadrature phase budget covers n + |z| <~ 600; asymptotic branch
takes over at |z| > max(500, 2 n^2) for J/Y and z > 700 for I).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from math_tpu_torch.special.basic import _f

__all__ = [
    "bessel_first_kind",
    "bessel_second_kind",
    "modified_bessel_first_kind",
    "modified_bessel_second_kind",
]

_NTRAP = 2048  # trapezoid / GL points for the [0, pi] integrals

# trapezoid nodes over [0, pi] (endpoints included, half-weighted)
_TH = np.linspace(0.0, np.pi, _NTRAP + 1)
_TW = np.full(_NTRAP + 1, np.pi / _NTRAP)
_TW[0] *= 0.5
_TW[-1] *= 0.5



@functools.lru_cache(maxsize=None)
def _gauss_legendre():
    """Gauss-Legendre nodes and weights mapped to [0, pi] (for the
    non-periodic Neumann oscillatory integrand, where trapezoid is only
    O(h^2)), made at first use: ``leggauss(2048)`` is an eigenvalue problem
    that takes 0.5 s on one core and tens of seconds where several processes
    import the package together and each starts a BLAS thread pool."""
    x, w = np.polynomial.legendre.leggauss(_NTRAP)
    return 0.5 * np.pi * (x + 1.0), 0.5 * np.pi * w

# exp-sinh nodes on (0, inf) for the semi-infinite decaying integrals:
# t_k = exp((pi/2) sinh u_k), double-exponential weights
_ES_LEVEL = 8


def _exp_sinh(level, span=6.0):
    """Every exp-sinh node and weight of step ``2^-level`` over ``|u| <= span``
    (inf where float64 overflows; the callers drop what they cannot use)."""
    h = 2.0**-level
    u = np.arange(-span / h, span / h + 1) * h
    with np.errstate(over="ignore"):
        t = np.exp(0.5 * np.pi * np.sinh(u))
        return t, h * 0.5 * np.pi * np.cosh(u) * t


_ES_T, _ES_W = _exp_sinh(_ES_LEVEL)
# t capped where sinh(t) stays finite: beyond, e^{-x sinh t} underflows for
# any representable x>0, and an inf node would poison gradients (0*inf)
_keep = np.isfinite(_ES_T) & np.isfinite(_ES_W) & (_ES_T < 705.0)
_ES_T, _ES_W = _ES_T[_keep], _ES_W[_keep]


def _es_nodes(dtype):
    """The exp-sinh nodes whose ``sinh`` / ``cosh`` stay finite in ``dtype``:
    in float32 the far nodes (t > ~89) would give ``x sinh t = inf`` and a
    NaN derivative in ``x`` (0 * inf) for a term that is 0 anyway."""
    big = float(torch.finfo(dtype).max)
    keep = np.cosh(_ES_T) < big
    return _ES_T[keep], _ES_W[keep]


def _quad(nodes, weights, integrand, dtype, device):
    """sum_k w_k * integrand(t_k), broadcasting integrand outputs."""
    t = torch.as_tensor(nodes, dtype=dtype, device=device)
    w = torch.as_tensor(weights, dtype=dtype, device=device)
    return torch.sum(integrand(t) * w, -1)


def _hankel_pq(mu, x8, nterms=9):
    """P/Q of the Hankel large-argument expansion (DLMF 10.17.1).

    P ~ sum_k (-1)^k a_{2k} / (8x)^{2k},  Q ~ sum_k (-1)^k a_{2k+1}/(8x)^{2k+1}
    with a_0 = 1, a_{j} = a_{j-1} * (mu - (2j-1)^2) / (8x * j) cumulated here
    directly in 1/(8x) powers.
    """
    term = torch.ones_like(x8)
    p = torch.ones_like(x8)
    q = torch.zeros_like(x8)
    for j in range(1, 2 * nterms):
        term = term * (mu - (2 * j - 1) ** 2) / (j * 8.0 * x8)
        if j % 2 == 1:
            q = q + term * (-1.0) ** ((j - 1) // 2)
        else:
            p = p + term * (-1.0) ** (j // 2)
    return p, q


def _jn_series(n, x, sign):
    """Power series (x/2)^n sum_k sign^k (x^2/4)^k / (k! (n+k)!).

    sign=-1 gives J_n, sign=+1 gives I_n (DLMF 10.2.2 / 10.25.2).  Used
    where x^2 < 4(n+1): terms then decrease from k=0, so the alternating
    J series suffers no cancellation.  Log-space terms keep the unused
    branch finite under the branchless ``where`` combine.
    """
    K = 30
    k = torch.arange(K, dtype=x.dtype, device=x.device)
    logx2 = torch.log(torch.clamp_min(x, 1e-300) / 2.0)
    lt = (
        (n[..., None] + 2.0 * k) * logx2[..., None]
        - torch.lgamma(k + 1.0)
        - torch.lgamma(n[..., None] + k + 1.0)
    )
    s = torch.as_tensor(sign, dtype=x.dtype, device=x.device) ** k
    out = torch.sum(s * torch.exp(lt), -1)
    return torch.where(x == 0.0, (n == 0).to(x.dtype), out)


def _jy_asym(n, x):
    """Large-|x| Hankel asymptotics for (J_n, Y_n)."""
    mu = 4.0 * n * n
    p, q = _hankel_pq(mu, x)
    omega = x - (0.5 * n + 0.25) * math.pi
    amp = torch.sqrt(2.0 / (math.pi * x))
    jv = amp * (p * torch.cos(omega) - q * torch.sin(omega))
    yv = amp * (p * torch.sin(omega) + q * torch.cos(omega))
    return jv, yv


def _j_quad(n, x, dtype, device):
    # J_n(x) = (1/pi) int_0^pi cos(n t - x sin t) dt   (DLMF 10.9.2);
    # integrand has vanishing odd derivatives at both endpoints =>
    # trapezoid converges spectrally.
    def integrand(t):
        nt = n[..., None] * t
        xs = x[..., None] * torch.sin(t)
        return torch.cos(nt - xs)

    return _quad(_TH, _TW, integrand, dtype, device) / math.pi


def _y_quad(n, x, dtype, device):
    # Y_n(x) = (1/pi) int_0^pi sin(x sin t - n t) dt
    #        - (1/pi) int_0^inf (e^{nt} + (-1)^n e^{-nt}) e^{-x sinh t} dt
    # (DLMF 10.9.7).  Oscillatory part via Gauss-Legendre; decay part via
    # exp-sinh in log space (avoids inf*0 at the far nodes).
    def osc(t):
        return torch.sin(x[..., None] * torch.sin(t) - n[..., None] * t)

    o = _quad(*_gauss_legendre(), osc, dtype, device) / math.pi

    def decay(t):
        nt = n[..., None] * t
        # log(e^{nt} + (-1)^n e^{-nt}): cosh for even n, sinh for odd
        even = (n[..., None] % 2) == 0
        lcosh = torch.logaddexp(nt, -nt)
        lsinh = nt + torch.log1p(-torch.exp(-2.0 * torch.clamp_min(nt, 1e-300)))
        lsum = torch.where(even, lcosh, lsinh)
        expo = lsum - x[..., None] * torch.sinh(t)
        return torch.exp(expo)

    d = _quad(*_es_nodes(dtype), decay, dtype, device) / math.pi
    return o - d


def _i_quad(n, x, dtype, device):
    # I_n(x) = e^x * (1/pi) int_0^pi e^{x (cos t - 1)} cos(n t) dt
    # (DLMF 10.32.1, exponentially scaled).  Spectral trapezoid.
    def integrand(t):
        return torch.exp(x[..., None] * (torch.cos(t) - 1.0)) * torch.cos(
            n[..., None] * t
        )

    scaled = _quad(_TH, _TW, integrand, dtype, device) / math.pi
    return scaled * torch.exp(x)


def _i_asym(n, x):
    # I_n(x) ~ e^x / sqrt(2 pi x) * sum_k (-1)^k a_k(mu) / (8x)^k
    mu = 4.0 * n * n
    term = torch.ones_like(x)
    s = torch.ones_like(x)
    for j in range(1, 14):
        term = term * (mu - (2 * j - 1) ** 2) / (j * 8.0 * x)
        s = s + (-1.0) ** j * term
    # log-space combine: e^x alone overflows ~40 ulps before I_n itself does
    return torch.exp(x - 0.5 * torch.log(2.0 * math.pi * x) + torch.log(torch.clamp_min(s, 1e-300)))


def _k_quad(n, x, dtype, device):
    # K_n(x) = e^{-x} int_0^inf e^{-x (cosh t - 1)} cosh(n t) dt
    # (DLMF 10.32.9, scaled); exp-sinh nodes cluster near 0, matching the
    # 1/sqrt(x)-wide peak at large x; log-space per node avoids inf*0.
    def integrand(t):
        nt = n[..., None] * t
        lcosh = torch.logaddexp(nt, -nt) - math.log(2.0)
        expo = lcosh - x[..., None] * (torch.cosh(t) - 1.0)
        return torch.exp(expo)

    return _quad(*_es_nodes(dtype), integrand, dtype, device) * torch.exp(-x)


def bessel_first_kind(v, z):
    """Bessel function of the first kind J_v(z), integer order.

    ref: ``bessel_first_kind.hpp`` (boost cyl_bessel_j).
    """
    z = _f(z)
    n, z = torch.broadcast_tensors(torch.as_tensor(v, dtype=z.dtype, device=z.device), z)
    na = torch.abs(n)
    xa = torch.abs(z)
    # J_{-n}(x) = (-1)^n J_n(x);  J_n(-x) = (-1)^n J_n(x)
    sgn = torch.where((n < 0) & (na % 2 == 1), -1.0, 1.0)
    sgn = sgn * torch.where((z < 0) & (na % 2 == 1), -1.0, 1.0)
    xcut = torch.clamp_min(2.0 * na * na, 500.0)
    xser = torch.sqrt(4.0 * (na + 1.0))  # series while terms decrease
    # keep each unused branch's argument in its numerically safe range
    js = _jn_series(na, torch.minimum(xa, xser), -1.0)
    jq = _j_quad(na, torch.minimum(xa, xcut), z.dtype, z.device)
    ja, _ = _jy_asym(na, torch.clamp_min(xa, 1.0))
    out = torch.where(xa < xser, js, torch.where(xa > xcut, ja, jq))
    return sgn * out


def bessel_second_kind(v, z):
    """Bessel function of the second kind Y_v(z), integer order; z > 0.

    ref: ``bessel_second_kind.hpp`` (boost cyl_neumann).  Invalid z <= 0
    returns nan (the reference throws; XLA cannot).
    """
    z = _f(z)
    n, z = torch.broadcast_tensors(torch.as_tensor(v, dtype=z.dtype, device=z.device), z)
    na = torch.abs(n)
    sgn = torch.where((n < 0) & (na % 2 == 1), -1.0, 1.0)
    xcut = torch.clamp_min(2.0 * na * na, 500.0)
    xsafe = torch.clamp_min(z, 1e-300)
    xq = torch.minimum(xsafe, xcut)
    yq = _y_quad(na, xq, z.dtype, z.device)
    _, ya = _jy_asym(na, torch.clamp_min(xsafe, 1.0))
    out = sgn * torch.where(xsafe > xcut, ya, yq)
    return torch.where(z > 0, out, torch.nan)


def modified_bessel_first_kind(v, z):
    """Modified Bessel function I_v(z), integer order.

    ref: ``modified_bessel_first_kind.hpp`` (boost cyl_bessel_i).
    """
    z = _f(z)
    n, z = torch.broadcast_tensors(torch.as_tensor(v, dtype=z.dtype, device=z.device), z)
    na = torch.abs(n)  # I_{-n} = I_n
    xa = torch.abs(z)
    sgn = torch.where((z < 0) & (na % 2 == 1), -1.0, 1.0)  # I_n(-x)=(-1)^n I_n
    xcut = 700.0
    xser = torch.sqrt(4.0 * (na + 1.0))
    iser = _jn_series(na, torch.minimum(xa, xser), 1.0)
    iq = _i_quad(na, torch.clamp_max(xa, xcut), z.dtype, z.device)
    ia = _i_asym(na, torch.clamp_min(xa, 1.0))
    out = torch.where(xa < xser, iser, torch.where(xa > xcut, ia, iq))
    return sgn * out


def modified_bessel_second_kind(v, z):
    """Modified Bessel function K_v(z), integer order; z > 0.

    ref: ``modified_bessel_second_kind.hpp`` (boost cyl_bessel_k).
    """
    z = _f(z)
    n, z = torch.broadcast_tensors(torch.as_tensor(v, dtype=z.dtype, device=z.device), z)
    na = torch.abs(n)  # K_{-n} = K_n
    xsafe = torch.clamp_min(z, 1e-300)
    out = _k_quad(na, xsafe, z.dtype, z.device)
    return torch.where(z > 0, out, torch.nan)
