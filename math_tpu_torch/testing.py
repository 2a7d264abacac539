"""Finite-difference AD test harness.

Counterpart: ``math_tpu/testing.py``, the analog of the reference's v3.0.0 AD
testing framework (``test/unit/math/test_ad.hpp``): where the reference
instantiates a function at 5 scalar types (``var``, ``fvar<double>``,
``fvar<var>``, ...) and compares against finite differences of the
``double`` version, here ``torch.func``'s transforms, ``grad`` (reverse),
``jacfwd`` (forward), ``jacfwd(grad)`` (mixed, the Hessian) and ``vmap``, are
compared against central finite differences of the plain function, in
float64 on the CPU.  The JAX harness also compares each value and gradient
with its ``jax.jit`` twin; the port has no tracing compiler on this path, so
that check has no counterpart.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
from torch.func import grad, jacfwd, jacrev, vmap


def expect_near_rel(a, b, tol=1e-8, msg=""):
    """Relative comparison handling inf/nan/near-zero.

    Mirrors ``test/unit/math/expect_near_rel.hpp``: exact match required for
    non-finite values; relative tolerance scaled by max(|a|,|b|,1) otherwise.
    """
    a = _np(a)
    b = _np(b)
    assert a.shape == b.shape, f"{msg}: shape {a.shape} != {b.shape}"
    nfa, nfb = ~np.isfinite(a), ~np.isfinite(b)
    if nfa.any() or nfb.any():
        assert np.array_equal(nfa, nfb), f"{msg}: non-finite mismatch {a} vs {b}"
        assert np.array_equal(a[nfa], b[nfb]), f"{msg}: {a} vs {b}"
    fa, fb = a[~nfa], b[~nfb]
    scale = np.maximum(np.maximum(np.abs(fa), np.abs(fb)), 1.0)
    err = np.abs(fa - fb) / scale
    assert (err <= tol).all(), f"{msg}: max rel err {err.max():.3e} > {tol:.1e}\n a={fa}\n b={fb}"


def _np(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def _t64(x, device=None):
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)


def finite_diff_gradient(f, x, h=None):
    """Central finite-difference gradient of scalar f at 1-D x (``f`` takes a
    float64 tensor, on the device of ``x`` where it is a tensor, on the CPU
    for a host array), as a numpy array.

    Reference behavior: ``prim/mat/functor/finite_diff_gradient_auto.hpp``
    (stepsize scaled per coordinate).
    """
    device = x.device if isinstance(x, torch.Tensor) else None
    x = _np(x)
    g = np.zeros_like(x)
    for i in range(x.size):
        hi = h if h is not None else 1e-6 * max(1.0, abs(x.flat[i]))
        xp, xm = x.copy(), x.copy()
        xp.flat[i] += hi
        xm.flat[i] -= hi
        fp, fm = float(f(_t64(xp, device))), float(f(_t64(xm, device)))
        g.flat[i] = (fp - fm) / (2 * hi)
    return g


def _flatten_f(f, args):
    """View f(*args) as g(x) with x the concatenation of all float args."""
    flats = [np.atleast_1d(np.asarray(a, dtype=np.float64)) for a in args]
    sizes = [a.size for a in flats]
    shapes = [np.shape(a) for a in args]

    def g(x):
        parts = torch.split(x, sizes)
        rebuilt = [p.reshape(s) if s else p[0] for p, s in zip(parts, shapes)]
        return f(*rebuilt)

    x0 = np.concatenate([a.ravel() for a in flats])
    return g, x0


def expect_ad(f, *args, tol=1e-5, hessian=False, hess_tol=1e-4):
    """Check value/gradient(/hessian) consistency of ``f`` at ``args``.

    - reverse grad == forward jacfwd == central finite differences
    - vmap(f) at the same point == f
    - optionally: the Hessian forward over reverse (``jacfwd(grad)``, the
      reference's fvar<var>) == reverse over reverse (``jacrev(grad)``) ==
      finite differences of the AD gradient

    All float args are treated as differentiable (the Stan harness likewise
    sweeps every argument through ``var``).
    """
    g, x0 = _flatten_f(f, args)
    x0t = _t64(x0)

    v_plain = g(x0t)
    if not np.isfinite(_np(v_plain)).all():
        return  # gradient comparisons undefined off support

    g_rev = grad(g)(x0t)
    g_fwd = jacfwd(g)(x0t)
    expect_near_rel(g_rev, g_fwd, 1e-10, "rev vs fwd grad")

    g_fd = finite_diff_gradient(g, x0)
    expect_near_rel(g_rev, g_fd, tol, "grad vs finite diff")

    vb = vmap(g)(torch.stack([x0t, x0t]))
    expect_near_rel(vb, np.asarray([_np(v_plain), _np(v_plain)]), 1e-12, "vmap value")

    if hessian:
        # fwd-over-rev, the reference's fvar<var> instantiation
        # (test_ad.hpp:113-130 compares Hessians against finite differences)
        h_ad = jacfwd(grad(g))(x0t)
        # rev-over-rev must agree (the fvar<fvar<var>> analog is covered by
        # the two independent composition orders agreeing)
        h_rr = jacrev(grad(g))(x0t)
        expect_near_rel(h_ad, h_rr, 1e-8, "fwd-over-rev vs rev-over-rev")
        gg = grad(g)
        cols = []
        for i in range(x0.size):
            hi = 1e-6 * max(1.0, abs(x0.flat[i]))
            xp, xm = x0.copy(), x0.copy()
            xp.flat[i] += hi
            xm.flat[i] -= hi
            cols.append((_np(gg(_t64(xp))) - _np(gg(_t64(xm)))) / (2 * hi))
        expect_near_rel(h_ad, np.stack(cols, axis=-1), hess_tol, "hessian vs finite diff")


def expect_ad_vectorized(f, *args, tol=1e-5):
    """Sweep scalar/vector/broadcast shape combinations of the arguments.

    Analog of ``expect_ad_vectorized`` / the prob-test generator's argument
    instantiation sweep (``test/prob/generate_tests.cpp``): each float
    argument is instantiated as {scalar, length-3 vector} (all combinations)
    and the summed result must be consistent with the all-scalar evaluation
    summed over the broadcast; gradients are fd-checked at one mixed combo.
    """
    base = [np.asarray(a, dtype=np.float64) for a in args]

    def lift(a, kind):
        return np.full(3, a) if kind == 1 else a

    scalar_val = float(f(*map(_t64, base)))
    for kinds in itertools.product([0, 1], repeat=len(base)):
        if not any(kinds):
            continue
        got = float(f(*[_t64(lift(a, k)) for a, k in zip(base, kinds)]))
        expect_near_rel(got, 3.0 * scalar_val, 1e-10, f"broadcast {kinds}")
    mixed = [lift(a, i % 2) for i, a in enumerate(base)]
    expect_ad(f, *mixed, tol=tol)


def expect_all_throw_or_invalid(f, *args):
    """Invalid input must yield -inf or nan.

    Analog of the reference's exception-consistency check
    (``test_ad.hpp expect_all_throw``): as in the JAX package, a density on
    the device does not throw, so the contract is that invalid inputs poison
    the result instead.
    """
    g, x0 = _flatten_f(f, args)
    v = _np(g(_t64(x0)))
    assert not np.isfinite(v).all(), f"expected non-finite value, got {v}"
