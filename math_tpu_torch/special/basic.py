"""Core scalar special functions under their Stan Math names.

Counterpart: ``math_tpu/special/basic.py``.  References cite the files in
``stan/math/prim/scal/fun/`` whose behavior each function reproduces; the
gradients come from autograd, but for ``gamma_p`` and ``gamma_q`` (values
and partials from ``special/hyper.py``) and ``inc_beta``
(``special/incbeta.py``).

Arguments may be tensors, numpy arrays or Python numbers.  Non-floating
arguments take the dtype of the floating tensors among the arguments (like
JAX's strongly-typed arrays), else float64, and the device of the first
tensor.
"""

from __future__ import annotations

import math

import numpy as np
import torch

LOG_TWO = math.log(2.0)
LOG_PI = math.log(math.pi)
LOG_TWO_PI = math.log(2.0 * math.pi)
LOG_SQRT_TWO_PI = 0.5 * math.log(2.0 * math.pi)
SQRT_TWO = math.sqrt(2.0)


def _f(*args):
    """The arguments as floating tensors on one device (see the module
    docstring); a floating tensor is returned as it is."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    device = tensors[0].device if tensors else torch.device("cpu")
    floats = [a.dtype for a in tensors if a.is_floating_point()]
    dt = floats[0] if floats else torch.float64
    for d in floats[1:]:
        dt = torch.promote_types(dt, d)
    out = []
    for a in args:
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            out.append(a)
        elif isinstance(a, torch.Tensor):
            out.append(a.to(dt))
        else:
            arr = np.asarray(a)
            out.append(torch.as_tensor(arr, dtype=dt if arr.dtype.kind != "f" or floats else None, device=device))
    return out if len(out) > 1 else out[0]


def _softplus(x):
    """log(1 + exp(x)) exactly (``torch.nn.functional.softplus`` returns x
    past its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


# --- simple algebraic helpers (ref: inv.hpp, square.hpp, ...) ---------------


def inv(x):
    return 1.0 / _f(x)


def inv_sqrt(x):
    return torch.rsqrt(_f(x))


def inv_square(x):
    return 1.0 / torch.square(_f(x))


def square(x):
    return torch.square(_f(x))


def cbrt(x):
    x = _f(x)
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def hypot(x, y):
    return torch.hypot(*_f(x, y))


def expm1(x):
    return torch.expm1(_f(x))


def fma(x, y, z):
    return x * y + z


def logaddexp(x, y):
    return torch.logaddexp(*_f(x, y))


# --- logit / log1p family (ref: inv_logit.hpp, log1m.hpp, log1p_exp.hpp) ----


def inv_logit(x):
    """Logistic sigmoid (ref: ``prim/scal/fun/inv_logit.hpp``)."""
    return torch.sigmoid(_f(x))


def logit(x):
    x = _f(x)
    return torch.log(x) - torch.log1p(-x)


def log_inv_logit(x):
    """log(sigmoid(x)) = -softplus(-x) (ref: ``log_inv_logit.hpp``)."""
    return -_softplus(-_f(x))


def log1m_inv_logit(x):
    """log(1 - sigmoid(x)) = -softplus(x) (ref: ``log1m_inv_logit.hpp``)."""
    return -_softplus(_f(x))


def log1m(x):
    """log(1 - x) (ref: ``log1m.hpp``)."""
    return torch.log1p(-_f(x))


def log1p_exp(x):
    """log(1 + exp(x)), stable softplus (ref: ``log1p_exp.hpp``)."""
    return _softplus(_f(x))


def log1m_exp(x):
    """log(1 - exp(x)) for x < 0, stable both near 0 and -inf; NaN for x >= 0.

    Ref: ``log1m_exp.hpp`` -- switchover at -log(2) between
    ``log(-expm1(x))`` and ``log1p(-exp(x))``.
    """
    x = _f(x)
    # Clamp the argument fed to each branch so the unselected branch never
    # produces nan (which would poison gradients through torch.where).
    hi_side = x > -LOG_TWO
    safe_hi = torch.where(hi_side, x, -LOG_TWO)
    safe_lo = torch.where(hi_side, -LOG_TWO, x)
    out = torch.where(hi_side, torch.log(-torch.expm1(safe_hi)), torch.log1p(-torch.exp(safe_lo)))
    return torch.where(x < 0, out, math.nan)


def log_diff_exp(a, b):
    """log(exp(a) - exp(b)) for a > b (ref: ``log_diff_exp.hpp``)."""
    a, b = _f(a, b)
    return a + log1m_exp(torch.clamp_max(b - a, 0.0) + 0.0 * a)


def log_sum_exp(x, y=None, axis=None):
    """Ref: ``log_sum_exp.hpp``; binary or reduction form (``axis=None``:
    over every element)."""
    if y is not None:
        return torch.logaddexp(*_f(x, y))
    x = _f(x)
    return torch.logsumexp(x.reshape(-1), 0) if axis is None else torch.logsumexp(x, axis)


def log_mix(theta, lp1, lp2):
    """log(theta*exp(lp1) + (1-theta)*exp(lp2)) (ref: ``log_mix.hpp``)."""
    theta, lp1, lp2 = _f(theta, lp1, lp2)
    return torch.logaddexp(torch.log(theta) + lp1, torch.log1p(-theta) + lp2)


def log1m_p(lp):
    """log(1 - exp(lp)) alias used by ccdf code paths."""
    return log1m_exp(lp)


def multiply_log(a, b):
    """a * log(b) with 0*log(0) = 0 (ref: ``multiply_log.hpp``)."""
    return torch.special.xlogy(*_f(a, b))


lmultiply = multiply_log


def binary_log_loss(y, y_hat):
    """-(y log y_hat + (1-y) log(1-y_hat)) (ref: ``binary_log_loss.hpp``)."""
    y, y_hat = _f(y, y_hat)
    return -(torch.special.xlogy(y, y_hat) + torch.special.xlog1py(1.0 - y, -y_hat))


# --- gamma / beta family ----------------------------------------------------


def lgamma(x):
    return torch.lgamma(_f(x))


def digamma(x):
    return torch.digamma(_f(x))


def trigamma(x):
    return torch.polygamma(1, _f(x))


def lbeta(a, b):
    """log Beta(a, b) (ref: ``lbeta.hpp``), composed from ``lgamma``."""
    a, b = _f(a, b)
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def lchoose(n, k):
    """log binomial coefficient (ref: ``binomial_coefficient_log.hpp``)."""
    n, k = _f(n, k)
    return torch.lgamma(n + 1.0) - torch.lgamma(k + 1.0) - torch.lgamma(n - k + 1.0)


def lmgamma(p, x):
    """log multivariate gamma (ref: ``lmgamma.hpp``):
    ``p (p - 1) / 4 log(pi) + sum_{j<p} lgamma(x - j / 2)``.  Written out:
    ``torch.special.multigammaln`` (arguments reversed) checks its domain on
    the host and raises where this gives NaN."""
    x = _f(x)
    j = torch.arange(p, dtype=x.dtype, device=x.device)
    return p * (p - 1) / 4.0 * LOG_PI + torch.lgamma(x[..., None] - 0.5 * j).sum(-1)


def log_falling_factorial(x, n):
    """log(x * (x-1) * ... * (x-n+1)) (ref: ``log_falling_factorial.hpp``)."""
    x, n = _f(x, n)
    return torch.lgamma(x + 1.0) - torch.lgamma(x - n + 1.0)


def log_rising_factorial(x, n):
    """log(x * (x+1) * ... * (x+n-1)) (ref: ``log_rising_factorial.hpp``)."""
    x, n = _f(x, n)
    return torch.lgamma(x + n) - torch.lgamma(x)


def inc_beta(a, b, x):
    """Regularized incomplete beta I_x(a, b) (ref: ``inc_beta.hpp``);
    ``special/incbeta.py``'s, differentiable in a, b and x."""
    from math_tpu_torch.special.incbeta import inc_beta as _inc_beta

    return _inc_beta(a, b, x)


def _dgamma_dz(a, z):
    """d P(a, z) / dz = z^(a-1) e^-z / Gamma(a)."""
    return torch.exp(-z + (a - 1.0) * torch.log(z) - torch.lgamma(a))


def _elementwise_vmap(fn, info, in_dims, *args):
    """The ``vmap`` rule of an elementwise ``autograd.Function`` whose forward
    runs a convergence loop (a host check that a batched tensor cannot take):
    the vmapped axis leads every operand, one call for the batch."""
    v = info.batch_size
    args = [t.expand((v,) + tuple(t.shape)) if d is None else t.movedim(d, 0) for t, d in zip(args, in_dims)]
    return fn(*torch.broadcast_tensors(*args)), 0


class _GammaP(torch.autograd.Function):
    """P(a, z): the value XLA's ``igamma`` computes (``hyper.igamma_values``),
    the partials from ``grad_reg_lower_inc_gamma`` (itself differentiable when
    a graph is built: second order, the reference's fvar<fvar<var>>
    instantiation).  ``jvp``: the same partials times the tangents, from the
    saved inputs, so a reverse pass over it differentiates them again."""

    @staticmethod
    def forward(a, z):
        from math_tpu_torch.special.hyper import igamma_values

        return igamma_values(a, z)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)

    @staticmethod
    def backward(ctx, grad):
        a, z = ctx.saved_tensors
        need_a, need_z = ctx.needs_input_grad
        return _gamma_partials(a, z, grad, need_a, need_z, 1.0)

    @staticmethod
    def jvp(ctx, ta, tz):
        a, z = ctx.saved_tensors
        return _gamma_tangent(a, z, ta, tz, 1.0)

    @staticmethod
    def vmap(info, in_dims, a, z):
        return _elementwise_vmap(_GammaP.apply, info, in_dims, a, z)


class _GammaQ(torch.autograd.Function):
    """Q(a, z): XLA's ``igammac`` (``hyper.igamma_values``), partials from
    ``grad_reg_inc_gamma``; ``jvp`` and ``vmap`` as ``_GammaP``'s."""

    @staticmethod
    def forward(a, z):
        from math_tpu_torch.special.hyper import igamma_values

        return igamma_values(a, z, upper=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)

    @staticmethod
    def backward(ctx, grad):
        a, z = ctx.saved_tensors
        need_a, need_z = ctx.needs_input_grad
        return _gamma_partials(a, z, grad, need_a, need_z, -1.0)

    @staticmethod
    def jvp(ctx, ta, tz):
        a, z = ctx.saved_tensors
        return _gamma_tangent(a, z, ta, tz, -1.0)

    @staticmethod
    def vmap(info, in_dims, a, z):
        return _elementwise_vmap(_GammaQ.apply, info, in_dims, a, z)


def _gamma_da(a, z, sign):
    from math_tpu_torch.special.hyper import grad_reg_inc_gamma, grad_reg_lower_inc_gamma

    return grad_reg_lower_inc_gamma(a, z) if sign > 0 else grad_reg_inc_gamma(a, z)


def _gamma_partials(a, z, grad, need_a, need_z, sign):
    """Cotangents of P (``sign`` 1) or Q (-1) for ``grad``."""
    da = grad * _gamma_da(a, z, sign) if need_a else None
    dz = sign * grad * _dgamma_dz(a, z) if need_z else None
    return da, dz


def _gamma_tangent(a, z, ta, tz, sign):
    """Tangent of P (``sign`` 1) or Q (-1) for the input tangents."""
    out = torch.zeros_like(a)
    if ta is not None:
        out = out + ta * _gamma_da(a, z, sign)
    if tz is not None:
        out = out + sign * tz * _dgamma_dz(a, z)
    return out


def gamma_p(a, z):
    """Regularized lower incomplete gamma P(a, z) (ref: ``gamma_p.hpp``)."""
    a, z = torch.broadcast_tensors(*_f(a, z))
    return _GammaP.apply(a, z)


def gamma_q(a, z):
    """Regularized upper incomplete gamma Q(a, z) (ref: ``gamma_q.hpp``);
    second-order-capable partials via ``grad_reg_inc_gamma`` (see gamma_p)."""
    a, z = torch.broadcast_tensors(*_f(a, z))
    return _GammaQ.apply(a, z)


# --- normal CDF family (ref: Phi.hpp, inv_Phi.hpp, Phi_approx.hpp) ----------


def Phi(x):
    return torch.special.ndtr(_f(x))


def log_Phi(x):
    return torch.special.log_ndtr(_f(x))


def inv_Phi(p):
    return torch.special.ndtri(_f(p))


def Phi_approx(x):
    """Logistic approximation to Phi (ref: ``Phi_approx.hpp``)."""
    x = _f(x)
    return torch.sigmoid(0.07056 * x * x * x + 1.5976 * x)


def erf(x):
    return torch.special.erf(_f(x))


def erfc(x):
    return torch.special.erfc(_f(x))


def inv_erfc(p):
    return -torch.special.ndtri(0.5 * _f(p)) / SQRT_TWO


# --- Bessel (ref: log_modified_bessel_first_kind.hpp) -----------------------


def log_i0(z):
    """log I0(z), stable via the exponentially scaled i0e."""
    z = _f(z)
    return torch.log(torch.special.i0e(z)) + torch.abs(z)


def log_i1(z):
    z = _f(z)
    return torch.log(torch.special.i1e(z)) + torch.abs(z)


def log_modified_bessel_first_kind(v, z):
    """log I_v(z) by its series for every v.

    Ref: ``log_modified_bessel_first_kind.hpp``.  log I_v(z) = v log(z/2) +
    log sum_k (z^2/4)^k / (k! Gamma(v+k+1)), 64 terms; adequate for the
    moderate z used by von Mises-style densities.
    """
    v, z = _f(v, z)
    k = torch.arange(64, dtype=z.dtype, device=z.device)
    logz2 = torch.log(torch.clamp_min(z, 1e-300) / 2.0)
    terms = 2.0 * k * logz2[..., None] - torch.lgamma(k + 1.0) - torch.lgamma(v[..., None] + k + 1.0)
    return v * logz2 + torch.logsumexp(terms, -1)


# --- gamma-ratio / combinatorial values (ref: beta.hpp, choose.hpp,
# --- falling_factorial.hpp, rising_factorial.hpp) ---------------------------


def beta(a, b):
    """Beta function B(a, b) (ref: beta.hpp)."""
    return torch.exp(lbeta(a, b))


def choose(n, k):
    """Exact binomial coefficient for integer args (ref: choose.hpp)."""
    return torch.round(torch.exp(lchoose(n, k)))


def falling_factorial(x, n):
    """x (x-1) ... (x-n+1) = Gamma(x+1)/Gamma(x-n+1) for x > n-1
    (ref: falling_factorial.hpp)."""
    return torch.exp(log_falling_factorial(x, n))


def rising_factorial(x, n):
    """x (x+1) ... (x+n-1) = Gamma(x+n)/Gamma(x) for x > 0
    (ref: rising_factorial.hpp)."""
    return torch.exp(log_rising_factorial(x, n))


# --- link-ish scalars (ref: inv_cloglog.hpp, log_inv_logit_diff.hpp,
# --- step.hpp, int_step.hpp, sign.hpp) --------------------------------------


def inv_cloglog(x):
    """1 - exp(-exp(x)) (ref: inv_cloglog.hpp); -expm1 form is stable for
    small exp(x)."""
    return -torch.expm1(-torch.exp(_f(x)))


def log_inv_logit_diff(x, y):
    """log(inv_logit(x) - inv_logit(y)), x > y (ref: log_inv_logit_diff.hpp:
    x - log1p_exp(x) + log1m_exp(y - x) - log1p_exp(y))."""
    x, y = _f(x, y)
    return x - log1p_exp(x) + log1m_exp(y - x) - log1p_exp(y)


def step(y):
    """0 if y < 0 else 1 (ref: step.hpp), in the dtype of ``y``."""
    y = torch.as_tensor(y)
    return (~(y < 0)).to(y.dtype)


def int_step(y):
    """1 if y > 0 else 0 (ref: int_step.hpp), as an integer tensor."""
    return (torch.as_tensor(y) > 0).to(torch.int64)


def sign(x):
    """-1 / 0 / 1 (ref: sign.hpp)."""
    return torch.sign(torch.as_tensor(x))
