"""Regularized incomplete beta with derivatives in ALL arguments.

Counterpart: ``math_tpu/special/incbeta.py``.  Reference: ``inc_beta.hpp`` +
``inc_beta_dda/ddb/ddz.hpp`` (hand-derived hypergeometric series for the a/b
partials, on top of ``grad_2F1``).

The value is the Lentz-Thompson-Barnett evaluation of the continued fraction
of DLMF 8.17.23 that XLA's ``betainc`` runs (the JAX package's value), with
the symmetry swap of DLMF 8.17.4 when ``x >= (a+1)/(a+b+2)``, the same edge
cases and the same convergence test (``|delta - 1| < eps/2``, at most 200
iterations in float32 and 600 in float64), met by every element at some
iteration, not necessarily the same one.  Convergence of the batch is
tested once every ``_CHECK_EVERY`` iterations: one host synchronisation per
check, none per iteration.

The a-partial is

  dI_x/da = [ int_0^x t^{a-1}(1-t)^{b-1} ln t dt  -  I_x B(a,b)(psi(a)-psi(a+b)) ] / B(a,b)

(and symmetrically for b with ln(1-t), psi(b)); the integral is fixed-order
tanh-sinh quadrature mapped to [0, x], evaluated in log space (a float32
node near 0 neither underflows to a NaN nor overflows).  The x-partial is
closed form.  ``log_inc_beta`` (the port's own) returns log I with the
prefactor in log space and the same partials divided by I.
``_IncBeta.backward`` computes only the partials autograd asks
for (``ctx.needs_input_grad``); with no graph being built it sums the nodes
in chunks of rows (memory bounded by ``_CHUNK_NODE_EVALS``), and when a graph
is built (a Hessian) it computes the partials with differentiable operations
that call ``inc_beta`` itself, so every order works.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from math_tpu_torch.special.basic import _f

__all__ = ["inc_beta", "inc_beta_dda", "inc_beta_ddb", "inc_beta_ddz", "grad_2F1", "grad_F32", "log_inc_beta"]

_CHECK_EVERY = 8
# Node evaluations a chunk of the no-graph quadrature holds at once (256 MiB
# a float32 temporary: few chunks, few launches, bounded memory).
_CHUNK_NODE_EVALS = 1 << 26
# Lentz iterations run by ``inc_beta``'s value, summed over its calls (the
# counts are Python ints: reading them costs no synchronisation).
LENTZ = {"calls": 0, "iterations": 0}


def reset_counts():
    LENTZ["calls"] = LENTZ["iterations"] = 0


def _ts_nodes(levels=6, dtype=np.float64):
    h = 0.5**levels
    k = np.arange(-int(np.ceil(5.0 / h)), int(np.ceil(5.0 / h)) + 1)
    t = k * h
    u = 0.5 * np.pi * np.sinh(t)
    x = np.tanh(u)  # in (-1, 1)
    w = h * 0.5 * np.pi * np.cosh(t) / np.cosh(u) ** 2
    keep = (np.abs(x) < 1.0) & (w > 1e-300)
    # map to (0,1): s = (x+1)/2, weight/2
    return ((x[keep] + 1.0) / 2.0), (w[keep] / 2.0)


_S, _W = _ts_nodes()
# log S and log W from the float64 tables: log t = log x + log S stays finite
# in float32 where t = x S itself would underflow to 0.
_LOG_S, _LOG_W = np.log(_S), np.log(_W)
_NODES = {}


def _nodes(dtype, device):
    """``(S, log S, log W, -S)`` as tensors of ``dtype`` on ``device``, made once."""
    key = (dtype, str(device))
    if key not in _NODES:
        _NODES[key] = tuple(torch.as_tensor(v, dtype=dtype, device=device) for v in (_S, _LOG_S, _LOG_W, -_S))
    return _NODES[key]


# --- the value: XLA's continued fraction -------------------------------------


def _numerators(its, a, b, x):
    """Partial numerators ``its`` of DLMF 8.17.23 (the first is one), a
    tensor each; those of one parity computed together over a leading axis
    of the iterations (a few launches for a block instead of ~8 an
    iteration), with the arithmetic of one numerator at a time."""
    out = {}
    for it in its:
        if it == 1:
            out[it] = torch.ones_like(x)
        elif it == 2:  # m = 0
            out[it] = -(a + b) * x / (a + 1.0)
    even = [it for it in its if it % 2 == 0 and it > 2]
    odd = [it for it in its if it % 2 == 1 and it > 1]
    opts = {"dtype": x.dtype, "device": x.device}
    if even:
        m = torch.tensor([(it - 1) // 2 for it in even], **opts).reshape((-1,) + (1,) * x.ndim)
        t = a + 2.0 * m
        num = -(a + m) * (a + b + m) * x / (t * (t + 1.0))
        out.update(zip(even, num))
    if odd:
        m = torch.tensor([(it - 1) // 2 for it in odd], **opts).reshape((-1,) + (1,) * x.ndim)
        t = a + 2.0 * m
        num = m * (b - m) * x / ((t - 1.0) * t)
        out.update(zip(odd, num))
    return [out[it] for it in its]


def _continued_fraction(a, b, x):
    """Lentz-Thompson-Barnett over every element at once (XLA's
    ``lentz_thompson_barnett_algorithm``): the partial denominators are 0,
    then 1; ``small`` and the threshold are eps/2.  The loop ends once every
    element has met ``|delta - 1| < eps/2`` at some iteration (XLA's loop
    runs on until every element meets it in one and the same iteration: in
    float32 an element whose delta flickers by an ulp about 1 keeps the whole
    batch at the 200-iteration cap).  Profiler range ``inc_beta.lentz``."""
    with torch.profiler.record_function("inc_beta.lentz"):
        return _lentz(a, b, x)


def _lentz(a, b, x):
    eps_half = torch.finfo(x.dtype).eps / 2.0
    num_iterations = 200 if x.dtype == torch.float32 else 600
    h = torch.full_like(x, eps_half)  # the denominator 0 is below ``small``
    one = torch.ones_like(x)
    c_prev, d_prev = h, torch.zeros_like(x)
    done = torch.zeros_like(x, dtype=torch.bool)
    it = 1
    while it < num_iterations:
        for num in _numerators(range(it, min(it + _CHECK_EVERY, num_iterations)), a, b, x):
            c = torch.addcdiv(one, num, c_prev)
            c = torch.where(c.abs() < eps_half, eps_half, c)
            d = torch.addcmul(one, num, d_prev)
            d = torch.where(d.abs() < eps_half, eps_half, d).reciprocal()
            delta = c * d
            h = h * delta
            done = done | ((delta - 1.0).abs() < eps_half)
            c_prev, d_prev = c, d
            it += 1
        if bool(done.all()):
            break
    LENTZ["calls"] += 1
    LENTZ["iterations"] += it - 1
    return h


def _edge_cases(a, b, x):
    """XLA's masks of the results that are 0, 1 or NaN whatever the fraction."""
    inf = math.inf
    a_is_zero = (a == 0) | (b == inf)
    b_is_zero = (b == 0) | (a == inf)
    x_is_zero, x_is_one = x == 0, x == 1
    is_nan = torch.isnan(a) | torch.isnan(b) | torch.isnan(x)
    result_is_zero = (b_is_zero & ~x_is_one) | (a_is_zero & x_is_zero)
    result_is_one = (a_is_zero & ~x_is_zero) | (b_is_zero & x_is_one)
    result_is_nan = (a < 0) | (b < 0) | (x < 0) | (x > 1) | (a_is_zero & b_is_zero) | is_nan
    return result_is_zero, result_is_one, result_is_nan


def _swapped(a, b, x):
    """``(fast, a, b, x)``: the fraction converges fast for ``x < (a+1)/(a+b+2)``;
    elsewhere it runs on ``(b, a, 1 - x)`` (DLMF 8.17.4)."""
    fast = x < (a + 1.0) / (a + b + 2.0)
    return fast, torch.where(fast, a, b), torch.where(fast, b, a), torch.where(fast, x, 1.0 - x)


def _betainc(a, b, x):
    """I_x(a, b) as XLA's ``regularized_incomplete_beta_impl`` computes it,
    on tensors of one shape and dtype (no autograd)."""
    result_is_zero, result_is_one, result_is_nan = _edge_cases(a, b, x)
    fast, a, b, x = _swapped(a, b, x)
    cf = _continued_fraction(a, b, x)
    very_small = torch.finfo(x.dtype).tiny * 2.0
    lbeta_small_a = torch.lgamma(b) - torch.lgamma(a + b)
    lbeta_ab = torch.lgamma(a) + lbeta_small_a
    factor = torch.where(a < very_small, torch.exp(torch.log1p(-x) * b - lbeta_small_a),
                         torch.exp(torch.log(x) * a + torch.log1p(-x) * b - lbeta_ab) / a)
    result = cf * factor
    result = torch.where(fast, result, 1.0 - result)
    result = torch.where(result_is_zero, 0.0, result)
    result = torch.where(result_is_one, 1.0, result)
    return torch.where(result_is_nan, math.nan, result)


def _log_betainc(a, b, x):
    """log I_x(a, b) from the same continued fraction, with the prefactor in
    log space: where the fraction runs unswapped, log I = log cf + log
    factor, which stays finite where I itself underflows (a far tail: in
    float32 below ~1e-38); elsewhere log(1 - q)."""
    result_is_zero, result_is_one, result_is_nan = _edge_cases(a, b, x)
    fast, a, b, x = _swapped(a, b, x)
    cf = _continued_fraction(a, b, x)
    very_small = torch.finfo(x.dtype).tiny * 2.0
    lbeta_small_a = torch.lgamma(b) - torch.lgamma(a + b)
    lbeta_ab = torch.lgamma(a) + lbeta_small_a
    log_factor = torch.where(a < very_small, torch.log1p(-x) * b - lbeta_small_a,
                             torch.log(x) * a + torch.log1p(-x) * b - lbeta_ab - torch.log(a))
    log_q = torch.log(cf) + log_factor
    result = torch.where(fast, log_q, torch.log1p(-torch.exp(torch.clamp_max(log_q, 0.0))))
    result = torch.where(result_is_zero, -math.inf, result)
    result = torch.where(result_is_one, 0.0, result)
    return torch.where(result_is_nan, math.nan, result)


# --- the partials -----------------------------------------------------------


def _beta_integrals(a, b, x, shift, want_a, want_b):
    """``exp(shift) (int_0^x t^(a-1) (1-t)^(b-1) ln t dt, the same with
    ln(1-t))`` (each None unless wanted) by tanh-sinh over (rows, nodes);
    differentiable.  The scale ``exp(shift)`` (1 / B(a, b), or 1 / (B(a, b)
    I)) goes inside the exponent, where it neither overflows nor
    underflows."""
    _, log_s, log_w, neg_s = _nodes(x.dtype, x.device)
    pos = x > 0
    xs = torch.where(pos, x, 1.0)
    log_x = torch.log(xs)
    # log(1 - t) at t = x s, t at most 1 - eps/2
    log1m_t = torch.log1p(torch.clamp(xs[..., None] * neg_s, min=-1.0 + torch.finfo(x.dtype).eps / 2.0))
    # log of the weighted integrand: a log x + shift per row, log w per node,
    # (a - 1) log s + (b - 1) log(1 - t) per (row, node)
    base = (a * log_x + shift)[..., None] + log_w
    expo = torch.addcmul(torch.addcmul(base, (a - 1.0)[..., None], log_s), (b - 1.0)[..., None], log1m_t)
    weighted = torch.exp(expo)
    out = [None, None]
    if want_a:  # sum_j w_j (log x + log s_j)
        out[0] = torch.where(pos, weighted.sum(-1) * log_x + weighted @ log_s, 0.0)
    if want_b:
        out[1] = torch.where(pos, (weighted * log1m_t).sum(-1), 0.0)
    return out


def _integrals_in_chunks(a, b, x, shift, want_a, want_b):
    """``_beta_integrals`` without a graph, a chunk of rows at a time."""
    shape = x.shape
    flat = [t.reshape(-1) for t in (a, b, x, shift)]
    n = flat[0].numel()
    step = max(1, _CHUNK_NODE_EVALS // _S.size)
    if n <= step:
        outs = _beta_integrals(*flat, want_a, want_b)
    else:
        outs = [torch.empty_like(flat[0]) if w else None for w in (want_a, want_b)]
        for start in range(0, n, step):
            parts = _beta_integrals(*(t[start:start + step] for t in flat), want_a, want_b)
            for o, p in zip(outs, parts):
                if o is not None:
                    o[start:start + step] = p
    return [None if o is None else o.reshape(shape) for o in outs]


def _lbeta(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def _partials(a, b, x, p, need, chunked, log=False):
    """``[dI/da, dI/db, dI/dx]`` (None where not needed); with ``log`` (``p``
    then log I) the partials of log I: each divided by I inside its
    exponent."""
    need_a, need_b, need_x = need
    scale = -_lbeta(a, b) - (p if log else 0.0)
    out = [None, None, None]
    if need_x:
        lo = max(1e-300, torch.finfo(x.dtype).tiny)
        xs = torch.clamp(x, lo, 1.0 - torch.finfo(x.dtype).eps / 2.0)
        out[2] = torch.exp((a - 1.0) * torch.log(xs) + (b - 1.0) * torch.log1p(-xs) + scale)
    if need_a or need_b:
        scale = torch.broadcast_to(scale, x.shape)
        with torch.profiler.record_function("inc_beta.quadrature"):
            integrals = (_integrals_in_chunks if chunked else _beta_integrals)(a, b, x, scale, need_a, need_b)
        dig_ab = torch.digamma(a + b)
        for i, (own, integral) in enumerate(zip((a, b), integrals)):
            if integral is not None:
                out[i] = integral - (1.0 if log else p) * (torch.digamma(own) - dig_ab)
    return out


class _IncBeta(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, x):
        p = _betainc(a, b, x)
        ctx.save_for_backward(a, b, x, p)
        return p

    @staticmethod
    def backward(ctx, grad):
        a, b, x, p = ctx.saved_tensors
        need = ctx.needs_input_grad
        if torch.is_grad_enabled():
            # a graph is being built: differentiable partials, the value
            # through this Function again (one level of it per order)
            parts = _partials(a, b, x, _IncBeta.apply(a, b, x), need, chunked=False)
        else:
            with torch.no_grad():
                parts = _partials(a, b, x, p, need, chunked=True)
        return tuple(None if d is None else grad * d for d in parts)


class _LogIncBeta(torch.autograd.Function):
    """log I_x(a, b) (``_log_betainc``) with the partials of ``_IncBeta``
    divided by I, the same two modes."""

    @staticmethod
    def forward(ctx, a, b, x):
        log_p = _log_betainc(a, b, x)
        ctx.save_for_backward(a, b, x, log_p)
        return log_p

    @staticmethod
    def backward(ctx, grad):
        a, b, x, log_p = ctx.saved_tensors
        need = ctx.needs_input_grad
        if torch.is_grad_enabled():
            parts = _partials(a, b, x, _LogIncBeta.apply(a, b, x), need, chunked=False, log=True)
        else:
            with torch.no_grad():
                parts = _partials(a, b, x, log_p, need, chunked=True, log=True)
        return tuple(None if d is None else grad * d for d in parts)


def inc_beta(a, b, x):
    """I_x(a, b), differentiable in a, b, and x."""
    a, b, x = _f(a, b, x)
    a, b, x = torch.broadcast_tensors(a, b, x)
    return _IncBeta.apply(a, b, x)


def log_inc_beta(a, b, x):
    """log I_x(a, b), differentiable in a, b, and x: finite where I
    underflows (the far lower tail).  Not in the JAX package; the port's
    ``neg_binomial_2_lccdf`` is built on it."""
    a, b, x = _f(a, b, x)
    a, b, x = torch.broadcast_tensors(a, b, x)
    return _LogIncBeta.apply(a, b, x)


def _partial(i, a, b, x):
    """d inc_beta / d (argument i), summed over the broadcast (``jax.grad`` of
    the sum); differentiable again when an argument carries a graph."""
    args = list(_f(a, b, x))
    graph = any(t.requires_grad for t in args)
    if not args[i].requires_grad:
        args[i] = args[i].detach().requires_grad_(True)
    with torch.enable_grad():
        out = inc_beta(*args)
        (g,) = torch.autograd.grad(out.sum(), args[i], create_graph=graph)
    return g


def inc_beta_dda(a, b, x):
    """dI_x(a,b)/da (ref: inc_beta_dda.hpp)."""
    return _partial(0, a, b, x)


def inc_beta_ddb(a, b, x):
    """dI_x(a,b)/db (ref: inc_beta_ddb.hpp)."""
    return _partial(1, a, b, x)


def inc_beta_ddz(a, b, x):
    """dI_x(a,b)/dx (ref: inc_beta_ddz.hpp)."""
    return _partial(2, a, b, x)


def grad_2F1(a1, a2, b1, z, max_terms=300):
    """(d/da1, d/db1) of the Gauss hypergeometric 2F1(a1, a2; b1; z).

    Reference: ``grad_2F1.hpp`` (term-by-term differentiated series,
    |z| < 1).  A Python loop over ``max_terms`` terms, the JAX package's
    ``lax.scan`` step for step.
    """
    a1, a2, b1, z = _f(a1, a2, b1, z)
    term = torch.ones_like(z)
    g_a1, g_b1 = torch.zeros_like(z), torch.zeros_like(z)
    acc_a1, acc_b1 = torch.zeros_like(z), torch.zeros_like(z)
    for k in range(max_terms):
        ratio = (a1 + k) * (a2 + k) / ((b1 + k) * (1.0 + k))
        # d term/d a1 = term * (H_{a1,k}) where H accumulates 1/(a1+j)
        g_a1 = (g_a1 + term / (a1 + k)) * ratio * z
        g_b1 = (g_b1 - term / (b1 + k)) * ratio * z
        term = term * ratio * z
        acc_a1 = acc_a1 + g_a1
        acc_b1 = acc_b1 + g_b1
    return acc_a1, acc_b1


def grad_F32(a1, a2, a3, b1, b2, z, max_terms=300):
    """Gradients of 3F2 wrt all six arguments (ref: grad_F32.hpp); a Python
    loop over ``max_terms`` terms, as ``grad_2F1``."""
    a1, a2, a3, b1, b2, z = _f(a1, a2, a3, b1, b2, z)
    term = torch.ones_like(z)
    gs = [torch.zeros_like(z)] * 5
    accs = [torch.zeros_like(z)] * 5
    for k in range(max_terms):
        ratio = (a1 + k) * (a2 + k) * (a3 + k) / ((b1 + k) * (b2 + k) * (1.0 + k))
        gs = [
            (gs[0] + term / (a1 + k)) * ratio * z,
            (gs[1] + term / (a2 + k)) * ratio * z,
            (gs[2] + term / (a3 + k)) * ratio * z,
            (gs[3] - term / (b1 + k)) * ratio * z,
            (gs[4] - term / (b2 + k)) * ratio * z,
        ]
        term = term * ratio * z
        accs = [a + g for a, g in zip(accs, gs)]
    return tuple(accs)
