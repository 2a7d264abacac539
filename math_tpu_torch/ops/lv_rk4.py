"""The Lotka-Volterra RK4 solve, its reverse-mode derivative, and both in dual
numbers, as hand-written kernels.

Counterpart: no Pallas kernel.  The JAX package's Lotka-Volterra model
(``math_tpu/models/lotka_volterra.py:70``) integrates with
``ode_rk4_fixed(dz_dt, z0, 0, ts, theta, steps_per_interval=24)``, a
``lax.scan`` (``math_tpu/ops/ode.py:408-433``) that XLA compiles into one
program; ``jax.grad``, ``jax.jvp`` and ``jax.hessian`` differentiate the scan.
Written eagerly in PyTorch the same solve is 480 RK4 steps of a 2-state
system, tens of thousands of tiny launches a gradient call.
``csrc/lv_rk4.cu`` runs it (the forwards one thread a chain, the adjoints a
warp a chain):

- ``lv_rk4_forward``: the solve; it also stores the state at the start of
  every step, ``(T*S, C, 2)``, for the adjoint.
- ``lv_rk4_adjoint``: the exact gradient of the discrete map (what autograd
  through the loop computes) from those states, with no recompute of the
  solve, a warp a chain: the cotangent's recursion is affine, so 32 lanes
  take a segment of steps each and a scan joins them.
- ``lv_rk4_dual_forward`` / ``lv_rk4_dual_adjoint``: the same kernels on
  (primal, tangent) pairs.  The dual forward gives ``ys`` and its tangent
  (and the dual states); the dual adjoint's tangent is the derivative of the
  gradient along the tangents of ``z0``, ``theta`` and ``gbar``.

The kernel's note says what bounds each kernel and what the design does
about it.  Which derivative order takes which kernel (``_LvRk4`` and the
Functions below it):

- a value: the forward; a first-order gradient (a sampler's, ``torch.func.grad``
  / ``jacrev``): the forward, then the adjoint called directly from the
  backward rule;
- first-order forward mode (``jvp``, ``jacfwd``): the dual forward, one launch
  for every tangent of a vmapped batch;
- a second order (``functional.hessian``, a Hessian-vector product,
  ``laplace_sample``'s double backward): the adjoint runs as
  ``_LvRk4Adjoint``, whose ``jvp`` and ``backward`` are one dual forward and
  one dual adjoint (``_LvRk4Hvp``); reverse over forward is the backward of
  ``_LvRk4Dual``, the same pair;
- a third or higher order: a rule whose result is differentiated again
  (``ops/_forward.py``) takes the differentiable plain version
  ``lv_rk4_plain``, as B1's second order takes its plain partials
  (pallas_glm.py:220-237), each call counted.  Forward over forward takes
  it from the start: ``torch.func`` drops the outer tangent of a Function's
  ``jvp`` rule.

Rules: on a CUDA tensor ``lv_rk4`` launches the kernels (float32 or float64)
or raises; it takes the plain version only for tensors on the CPU.
``LAUNCHES`` counts kernel launches, ``PLAIN_CALLS`` calls of the plain
version.  ``lv_rk4_states_reference`` / ``lv_rk4_dual_states_reference``
and ``lv_rk4_adjoint_states_reference`` / ``lv_rk4_dual_adjoint_reference``
are the four kernels' arithmetic written in PyTorch (the adjoints swept
serially), for the tests; ``lv_rk4_adjoint_scan_reference`` is the adjoint
in the kernel's order (segments joined by a scan);
``lv_rk4_adjoint_reference`` is the sweep that recomputes each interval's
states from ``ys``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from math_tpu_torch.ops import _build, ode
from math_tpu_torch.ops._forward import differentiated_again, forward_levels
from math_tpu_torch.utils.batch import plain_tensor

KERNEL = "lv_rk4"
FORWARD, ADJOINT = "lv_rk4_forward", "lv_rk4_adjoint"
DUAL_FORWARD, DUAL_ADJOINT = "lv_rk4_dual_forward", "lv_rk4_dual_adjoint"
LAUNCHES = {FORWARD: 0, ADJOINT: 0, DUAL_FORWARD: 0, DUAL_ADJOINT: 0}
PLAIN_CALLS = {"lv_rk4_plain": 0}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def reset_counts():
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def lv_rhs(t, z, theta):
    """``dz/dt = (alpha u - beta u v, -gamma v + delta u v)`` for ``z (C, 2)``,
    ``theta (C, 4)`` (ref: math_tpu/models/lotka_volterra.py:24-29)."""
    u, v = z.unbind(-1)
    alpha, beta, gamma, delta = theta.unbind(-1)
    return torch.stack([alpha * u - beta * u * v, -gamma * v + delta * u * v], -1)


def lv_rk4_plain(z0, t0, ts, theta, steps_per_interval):
    """Plain version: ``ode.ode_rk4_fixed(lv_rhs, ...)``, differentiable by
    autograd to any order; ``(C, T, 2)``."""
    PLAIN_CALLS["lv_rk4_plain"] += 1
    return ode.ode_rk4_fixed(lv_rhs, z0, t0, ts, theta, steps_per_interval)


def _step_sizes(t0, ts, dtype, steps):
    """Per interval ``(h, h/2, h/6)`` in the working dtype, as the plain
    version computes them on the host."""
    t0n, tsn = ode._host_times(ts, t0, dtype)
    nd = tsn.dtype.type
    starts = np.concatenate([[t0n], tsn[:-1]]).astype(nd)
    out = []
    for t_next, t in zip(tsn, starts):
        h = (t_next - t) / nd(steps)
        out.append((float(h), float(nd(0.5) * h), float(h / nd(6.0))))
    return out


# The references below run on the two components (u, v) and theta's four
# columns apart, with the same operations as ``lv_rhs`` and ``ode_rk4_fixed``
# in the same order (so the same results bit for bit), on tensors or on
# ``_DualRef`` pairs: the dual kernels' arithmetic, PyTorch's forward-mode
# rules written out, which the CPU tests run in place of ``torch.func.jvp``
# of the primal references (several times faster over 480 steps).


class _DualRef:
    """A (primal, tangent) pair of tensors with PyTorch's forward-mode rules:
    the tangent of ``x y`` is ``x' y + x y'``, a constant factor scales it."""

    __slots__ = ("p", "t")

    def __init__(self, p, t):
        self.p, self.t = p, t

    def __add__(self, o):
        return _DualRef(self.p + o.p, self.t + o.t)

    def __sub__(self, o):
        return _DualRef(self.p - o.p, self.t - o.t)

    def __neg__(self):
        return _DualRef(-self.p, -self.t)

    def __mul__(self, o):
        if isinstance(o, _DualRef):
            return _DualRef(self.p * o.p, self.t * o.p + self.p * o.t)
        return _DualRef(self.p * o, self.t * o)

    def __rmul__(self, c):
        return _DualRef(c * self.p, c * self.t)


def _duals(p, t):
    return tuple(_DualRef(a, b) for a, b in zip(p.unbind(-1), t.unbind(-1)))


def _stack(xs, dim):
    """``torch.stack`` of tensors, or of pairs into ``(primal, tangent)``."""
    if isinstance(xs[0], _DualRef):
        return torch.stack([x.p for x in xs], dim), torch.stack([x.t for x in xs], dim)
    return torch.stack(xs, dim)


def _rhs_reference(th, u, v):
    a, b, g, d = th
    return a * u - b * u * v, -g * v + d * u * v


def _rk4_step_reference(th, h, hh, h6, u, v):
    k1u, k1v = _rhs_reference(th, u, v)
    k2u, k2v = _rhs_reference(th, u + hh * k1u, v + hh * k1v)
    k3u, k3v = _rhs_reference(th, u + hh * k2u, v + hh * k2v)
    k4u, k4v = _rhs_reference(th, u + h * k3u, v + h * k3v)
    return u + h6 * (k1u + 2 * k2u + 2 * k3u + k4u), v + h6 * (k1v + 2 * k2v + 2 * k3v + k4v)


def _stage_adjoint_reference(th, u, v, ku, kv):
    """``(J_y(s)^T kbar, J_theta(s)^T kbar)`` of ``lv_rhs`` at stage input
    ``s = (u, v)`` for ``kbar = (ku, kv)``."""
    a, b, g, d = th
    uv = u * v
    return ((a - b * v) * ku + d * v * kv, -b * u * ku + (-g + d * u) * kv), (u * ku, -uv * ku, -v * kv, uv * kv)


def _plus(x, y, c=None):
    """``x + y`` (or ``x + c y``) part by part."""
    return tuple(a + b for a, b in zip(x, y)) if c is None else tuple(a + c * b for a, b in zip(x, y))


def _step_adjoint_reference(th, h, hh, h6, u, v, lam, tbar):
    """``(lambda, thetabar)`` after the adjoint of the step that starts at
    ``(u, v)``, in the adjoint kernel's order; ``lambda`` a pair,
    ``thetabar`` four columns."""
    k1 = _rhs_reference(th, u, v)
    s2 = (u + hh * k1[0], v + hh * k1[1])
    k2 = _rhs_reference(th, *s2)
    s3 = (u + hh * k2[0], v + hh * k2[1])
    k3 = _rhs_reference(th, *s3)
    s4 = (u + h * k3[0], v + h * k3[1])
    k14 = (h6 * lam[0], h6 * lam[1])
    k3b = (2 * k14[0], 2 * k14[1])
    k2b, k1b = k3b, k14
    sb, tb = _stage_adjoint_reference(th, *s4, *k14)
    ybar, tbar, k3b = _plus(lam, sb), _plus(tbar, tb), _plus(k3b, sb, h)
    sb, tb = _stage_adjoint_reference(th, *s3, *k3b)
    ybar, tbar, k2b = _plus(ybar, sb), _plus(tbar, tb), _plus(k2b, sb, hh)
    sb, tb = _stage_adjoint_reference(th, *s2, *k2b)
    ybar, tbar, k1b = _plus(ybar, sb), _plus(tbar, tb), _plus(k1b, sb, hh)
    sb, tb = _stage_adjoint_reference(th, u, v, *k1b)
    return _plus(ybar, sb), _plus(tbar, tb)


def _solve_reference(th, u, v, sizes, steps):
    """``(ys, states)``: the state after each interval and at the start of
    every step, as lists of pairs."""
    states, ys = [], []
    for h, hh, h6 in sizes:
        for _ in range(steps):
            states.append((u, v))
            u, v = _rk4_step_reference(th, h, hh, h6, u, v)
        ys.append((u, v))
    return ys, states


def _sweep_reference(th, sizes, g_of, states_of, zero):
    """The adjoint kernel's sweep: intervals in reverse, ``lambda += gbar[:,
    k]`` where interval k ends (``g_of(k)``), then the steps of interval k in
    reverse from their states (``states_of(k, h, hh, h6)``)."""
    lam, tbar = (zero, zero), (zero,) * 4
    for k, (h, hh, h6) in reversed(list(enumerate(sizes))):
        lam = _plus(lam, g_of(k))
        for u, v in reversed(states_of(k, h, hh, h6)):
            lam, tbar = _step_adjoint_reference(th, h, hh, h6, u, v, lam, tbar)
    return lam, tbar


def lv_rk4_states_reference(z0, t0, ts, theta, steps_per_interval):
    """``(ys (C, T, 2), states (T*S, C, 2))``: the stored-state forward in
    PyTorch, the state at the start of every step beside the solve (``ys``
    equal to ``ode_rk4_fixed``'s bit for bit).  For the tests."""
    sizes = _step_sizes(t0, ts, z0.dtype, steps_per_interval)
    ys, states = _solve_reference(theta.unbind(-1), *z0.unbind(-1), sizes, steps_per_interval)
    return (torch.stack([torch.stack([y[0] for y in ys], 1), torch.stack([y[1] for y in ys], 1)], -1),
            torch.stack([torch.stack([x[0] for x in states]), torch.stack([x[1] for x in states])], -1))


def lv_rk4_dual_states_reference(z0, t0, ts, theta, steps_per_interval, tz0, ttheta):
    """``(ys, ys', states)``: the dual forward kernel's arithmetic in PyTorch,
    the dual states ``(T*S, C, 2, 2)`` (each component ``(primal,
    tangent)``).  For the tests."""
    sizes = _step_sizes(t0, ts, z0.dtype, steps_per_interval)
    ys, states = _solve_reference(_duals(theta, ttheta), *_duals(z0, tz0), sizes, steps_per_interval)
    (yu, tyu), (yv, tyv) = _stack([y[0] for y in ys], 1), _stack([y[1] for y in ys], 1)
    (su, tsu), (sv, tsv) = _stack([x[0] for x in states], 0), _stack([x[1] for x in states], 0)
    return (torch.stack([yu, yv], -1), torch.stack([tyu, tyv], -1),
            torch.stack([torch.stack([su, tsu], -1), torch.stack([sv, tsv], -1)], -2))


def lv_rk4_adjoint_states_reference(t0, ts, theta, steps_per_interval, states, gbar):
    """``(z0bar, thetabar)``: the adjoint kernel's step adjoint in PyTorch,
    swept serially from the stored states ``(T*S, C, 2)`` (intervals in
    reverse, the RK4 step's adjoint per stage).  For the tests."""
    s = steps_per_interval
    u, v = states.unbind(-1)
    lam, tbar = _sweep_reference(theta.unbind(-1), _step_sizes(t0, ts, gbar.dtype, s), lambda k: gbar[:, k].unbind(-1),
                                 lambda k, *_: [(u[j], v[j]) for j in range(k * s, (k + 1) * s)], torch.zeros_like(gbar[:, 0, 0]))
    return torch.stack(lam, -1), torch.stack(tbar, -1)


def lv_rk4_dual_adjoint_reference(t0, ts, theta, steps_per_interval, ttheta, states, gbar, tgbar):
    """``(z0bar, thetabar, z0bar', thetabar')``: the dual adjoint kernel's
    step adjoint in PyTorch, swept serially from the dual states ``(T*S, C,
    2, 2)``.  For the tests."""
    s = steps_per_interval
    u, v = (_DualRef(*x.unbind(-1)) for x in states.unbind(-2))
    zero = torch.zeros_like(gbar[:, 0, 0])
    lam, tbar = _sweep_reference(_duals(theta, ttheta), _step_sizes(t0, ts, gbar.dtype, s),
                                 lambda k: _duals(gbar[:, k], tgbar[:, k]),
                                 lambda k, *_: [(_DualRef(u.p[j], u.t[j]), _DualRef(v.p[j], v.t[j])) for j in range(k * s, (k + 1) * s)],
                                 _DualRef(zero, zero))
    (lp, lt), (tp, tt) = _stack(lam, -1), _stack(tbar, -1)
    return lp, tp, lt, tt


def lv_rk4_adjoint_scan_reference(t0, ts, theta, steps_per_interval, states, gbar, lanes=32):
    """``(z0bar, thetabar)`` in the adjoint kernel's order: the T*S steps in
    ``lanes`` segments of ``ceil(T*S / lanes)``, each composed into an affine
    map of the cotangent (the step adjoint applied to the map's two columns
    and to its offset), the maps joined by a suffix scan in the kernel's
    shuffle order, each segment swept again from the cotangent entering it,
    thetabar summed over the segments.  For the tests."""
    th, s = theta.unbind(-1), steps_per_interval
    sizes = _step_sizes(t0, ts, gbar.dtype, s)
    n = len(sizes) * s
    seg = -(-n // lanes)
    u, v = states.unbind(-1)
    zero = torch.zeros_like(gbar[:, 0, 0])
    one = torch.ones_like(zero)

    def step(j, lam, tbar, gather=True):
        k, r = divmod(j, s)
        if gather and r == s - 1:
            lam = _plus(lam, gbar[:, k].unbind(-1))
        return _step_adjoint_reference(th, *sizes[k], u[j], v[j], lam, tbar)

    maps, nothing = [], (zero,) * 4
    for lane in range(lanes):  # phase 1: (column 0, column 1, offset) of each segment's map
        c0, c1, q = (one, zero), (zero, one), (zero, zero)
        for j in reversed(range(min(n, lane * seg), min(n, lane * seg + seg))):
            c0, c1, q = step(j, c0, nothing, False)[0], step(j, c1, nothing, False)[0], step(j, q, nothing)[0]
        maps.append((c0, c1, q))

    def apply(c0, c1, x):
        return tuple(a * x[0] + b * x[1] for a, b in zip(c0, c1))

    d = 1
    while d < lanes:  # G_L = F_L o F_(L+d) where L + d is a lane
        maps = [(apply(f[0], f[1], g[0]), apply(f[0], f[1], g[1]), _plus(apply(f[0], f[1], g[2]), f[2])) if lane + d < lanes else f
                for lane, (f, g) in enumerate(zip(maps, maps[d:] + maps[:d]))]
        d *= 2
    lam0, tbar = None, (zero,) * 4
    for lane in range(lanes):  # phase 3
        lam, tb = (maps[lane + 1][2] if lane + 1 < lanes else (zero, zero)), (zero,) * 4
        for j in reversed(range(min(n, lane * seg), min(n, lane * seg + seg))):
            lam, tb = step(j, lam, tb)
        lam0 = lam if lane == 0 else lam0
        tbar = _plus(tbar, tb)
    return torch.stack(lam0, -1), torch.stack(tbar, -1)


def lv_rk4_adjoint_reference(z0, t0, ts, theta, steps_per_interval, ys, gbar):
    """``(z0bar, thetabar)`` by the same step adjoint swept serially, each
    interval's states recomputed from its start (``ys[:, i-1]`` or ``z0``).
    For the tests."""
    th = theta.unbind(-1)

    def states_of(k, h, hh, h6):
        return _solve_reference(th, *(z0 if k == 0 else ys[:, k - 1]).unbind(-1), [(h, hh, h6)], steps_per_interval)[1]

    lam, tbar = _sweep_reference(th, _step_sizes(t0, ts, z0.dtype, steps_per_interval), lambda k: gbar[:, k].unbind(-1),
                                 states_of, torch.zeros_like(z0[:, 0]))
    return torch.stack(lam, -1), torch.stack(tbar, -1)


_lib = None
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "lv_rk4_forward": [_P] * 3 + [_I] * 3 + [_P] * 4,
    "lv_rk4_adjoint": [_P] * 2 + [_I] * 3 + [_P] * 6,
    "lv_rk4_dual_forward": [_P] * 5 + [_I] * 3 + [_P] * 5,
    "lv_rk4_dual_adjoint": [_P] * 3 + [_I] * 3 + [_P] * 9,
}
_PROBE_ARGTYPES = [_I] * 3 + [_P] * 3


def _library():
    global _lib
    if _lib is None:
        lib = _build.load_library(KERNEL)
        for name, argtypes in _ARGTYPES.items():
            for suffix in _SUFFIX.values():
                fn = getattr(lib, f"{name}_{suffix}")
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
        lib.op_latency_probe.restype = ctypes.c_int
        lib.op_latency_probe.argtypes = _PROBE_ARGTYPES
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=64)
def _device_steps_cached(t0, raw, dtype, steps, device):
    tsn = np.frombuffer(raw, dtype=ode.np_dtype(dtype))
    hs = torch.tensor(_step_sizes(t0, tsn, dtype, steps), dtype=dtype, device=device)
    return plain_tensor(hs)


def _device_steps(t0, ts, dtype, steps, device):
    """``(T, 3)`` step sizes ``(h, h/2, h/6)`` of each interval on the
    device, the plain version's host values; kept (a sampler meets the same
    grid every call)."""
    t0n, tsn = ode._host_times(ts, t0, dtype)
    return _device_steps_cached(float(t0n), tsn.tobytes(), dtype, int(steps), str(device))


def _check(theta, steps):
    if theta.device.type != "cuda":
        raise ValueError(f"lv_rk4 kernels: CUDA tensors only; got {theta.device}")
    if theta.dtype not in _SUFFIX:
        raise TypeError(f"lv_rk4 kernels: float32 or float64; got {theta.dtype}")
    if theta.ndim != 2 or theta.shape[1] != 4 or not theta.is_contiguous():
        raise ValueError(f"lv_rk4 kernels: expected a contiguous theta (C, 4); got {tuple(theta.shape)}")
    if theta.shape[0] < 1 or int(steps) < 1:
        raise ValueError(f"lv_rk4 kernels: need C >= 1 and steps >= 1; got {theta.shape[0]}, {steps}")


def _check_like(name, a, shape, like):
    if a.shape != shape or a.dtype != like.dtype or a.device != like.device or not a.is_contiguous():
        raise ValueError(f"lv_rk4 kernels: {name} must be a contiguous {shape} {like.dtype} on {like.device}; got "
                         f"{tuple(a.shape)} {a.dtype} on {a.device}")


def _stamps_ptr(stamps, device):
    if stamps is None:
        return None
    if stamps.shape != (4,) or stamps.dtype != torch.int64 or stamps.device != device:
        raise ValueError(f"lv_rk4 kernels: stamps must be a (4,) int64 tensor on {device}")
    return stamps.data_ptr()


def _launch(name, dtype, device, *args):
    with torch.cuda.device(device):
        err = getattr(_library(), f"{name}_{_SUFFIX[dtype]}")(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def lv_rk4_forward(z0, t0, ts, theta, steps_per_interval, stamps=None):
    """``(ys (C, T, 2), states (T*S, C, 2))`` by the forward kernel (CUDA
    tensors only): the solve and the state at the start of every step.  With
    ``stamps``, a ``(4,)`` int64 tensor on the device, chain 0 writes its
    ``clock64()`` where its steps start and end, then ``%globaltimer`` (ns)
    at the same points (for measurement)."""
    _check(theta, steps_per_interval)
    _check_like("z0", z0, (theta.shape[0], 2), theta)
    steps = int(steps_per_interval)
    hs = _device_steps(t0, ts, z0.dtype, steps, z0.device)
    c, nt = z0.shape[0], hs.shape[0]
    ys = torch.empty((c, nt, 2), dtype=z0.dtype, device=z0.device)
    states = torch.empty((nt * steps, c, 2), dtype=z0.dtype, device=z0.device)
    _launch(FORWARD, z0.dtype, z0.device, z0.data_ptr(), theta.data_ptr(), hs.data_ptr(), c, nt, steps,
            ys.data_ptr(), states.data_ptr(), _stamps_ptr(stamps, z0.device))
    return ys, states


def lv_rk4_adjoint(t0, ts, theta, steps_per_interval, states, gbar, stamps=None):
    """``(z0bar (C, 2), thetabar (C, 4))`` by the adjoint kernel for the
    cotangent ``gbar (C, T, 2)`` of ``ys``, from the forward's ``states``
    (CUDA tensors only); ``stamps`` as in ``lv_rk4_forward``."""
    steps = int(steps_per_interval)
    c = theta.shape[0]
    _check(theta, steps)
    hs = _device_steps(t0, ts, theta.dtype, steps, theta.device)
    nt = hs.shape[0]
    _check_like("gbar", gbar, (c, nt, 2), theta)
    _check_like("states", states, (nt * steps, c, 2), theta)
    z0bar = torch.empty((c, 2), dtype=theta.dtype, device=theta.device)
    tbar = torch.empty_like(theta)
    _launch(ADJOINT, theta.dtype, theta.device, theta.data_ptr(), hs.data_ptr(), c, nt, steps, states.data_ptr(),
            gbar.data_ptr(), z0bar.data_ptr(), tbar.data_ptr(), _stamps_ptr(stamps, theta.device))
    return z0bar, tbar


def lv_rk4_dual_forward(z0, t0, ts, theta, steps_per_interval, tz0, ttheta, stamps=None, keep_states=False):
    """``(ys, ys')`` by the dual forward kernel for the tangents ``tz0 (C,
    2)``, ``ttheta (C, 4)``; with ``keep_states`` also the dual states ``(T*S,
    C, 2, 2)``, each component ``(primal, tangent)``.  The primal equals
    ``lv_rk4_forward``'s bit for bit."""
    _check(theta, steps_per_interval)
    _check_like("z0", z0, (theta.shape[0], 2), theta)
    _check_like("tz0", tz0, tuple(z0.shape), z0)
    _check_like("ttheta", ttheta, tuple(theta.shape), theta)
    steps = int(steps_per_interval)
    hs = _device_steps(t0, ts, z0.dtype, steps, z0.device)
    c, nt = z0.shape[0], hs.shape[0]
    ys = torch.empty((c, nt, 2), dtype=z0.dtype, device=z0.device)
    tys = torch.empty_like(ys)
    states = torch.empty((nt * steps, c, 2, 2), dtype=z0.dtype, device=z0.device) if keep_states else None
    _launch(DUAL_FORWARD, z0.dtype, z0.device, z0.data_ptr(), tz0.data_ptr(), theta.data_ptr(), ttheta.data_ptr(),
            hs.data_ptr(), c, nt, steps, ys.data_ptr(), tys.data_ptr(), None if states is None else states.data_ptr(),
            _stamps_ptr(stamps, z0.device))
    return (ys, tys, states) if keep_states else (ys, tys)


def lv_rk4_dual_adjoint(t0, ts, theta, steps_per_interval, ttheta, states, gbar, tgbar, stamps=None):
    """``(z0bar, thetabar, z0bar', thetabar')`` by the dual adjoint kernel
    from the dual forward's ``states``, with the tangents ``ttheta`` of
    ``theta`` and ``tgbar`` of ``gbar``: the primal is ``lv_rk4_adjoint``'s,
    the tangent the derivative of the gradient along the dual forward's
    tangents, ``ttheta`` and ``tgbar``."""
    steps = int(steps_per_interval)
    c = theta.shape[0]
    _check(theta, steps)
    _check_like("ttheta", ttheta, tuple(theta.shape), theta)
    hs = _device_steps(t0, ts, theta.dtype, steps, theta.device)
    nt = hs.shape[0]
    _check_like("gbar", gbar, (c, nt, 2), theta)
    _check_like("tgbar", tgbar, (c, nt, 2), theta)
    _check_like("states", states, (nt * steps, c, 2, 2), theta)
    z0bar = torch.empty((c, 2), dtype=theta.dtype, device=theta.device)
    tz0bar = torch.empty_like(z0bar)
    tbar, ttbar = torch.empty_like(theta), torch.empty_like(theta)
    _launch(DUAL_ADJOINT, theta.dtype, theta.device, theta.data_ptr(), ttheta.data_ptr(), hs.data_ptr(), c, nt, steps,
            states.data_ptr(), gbar.data_ptr(), tgbar.data_ptr(), z0bar.data_ptr(), tz0bar.data_ptr(),
            tbar.data_ptr(), ttbar.data_ptr(), _stamps_ptr(stamps, theta.device))
    return z0bar, tbar, tz0bar, ttbar


def op_latency_cycles(op, dtype, n=4096, device="cuda"):
    """Cycles of one of ``n`` dependent operations of kind ``op`` ("add",
    "mul", "fma") in ``dtype`` on one thread of the card (``clock64()``): the
    latency that bounds a serial chain (for measurement)."""
    cycles = torch.zeros(1, dtype=torch.int64, device=device)
    sink = torch.zeros(1, dtype=dtype, device=device)
    with torch.cuda.device(cycles.device):
        err = _library().op_latency_probe(("add", "mul", "fma").index(op), int(dtype == torch.float64), int(n),
                                          cycles.data_ptr(), sink.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"op_latency_probe launch failed: CUDA error {err}")
    return float(cycles.item()) / n


# --- the Functions: first order, forward mode, second order ----------------


def _plain_vjp(z0, theta, gbar, t0, ts, steps):
    """``(z0bar, thetabar)`` through the differentiable plain version."""
    _, pullback = torch.func.vjp(lambda z, th: lv_rk4_plain(z, t0, ts, th, steps), z0, theta)
    return pullback(gbar)


def _plain_jvp(z0, theta, tz0, ttheta, t0, ts, steps):
    """``(ys, ys')`` through the differentiable plain version."""
    return torch.func.jvp(lambda z, th: lv_rk4_plain(z, t0, ts, th, steps), (z0, theta), (tz0, ttheta))


def _or_zeros(t, like):
    return torch.zeros_like(like) if t is None else t


def _fold_lanes(t, d, v, lane=0):
    """``t`` with the vmapped axis ``d`` (None: broadcast to ``v``) folded
    into its lane axis ``lane`` (batch-major), contiguous."""
    t = t.expand((v,) + tuple(t.shape)) if d is None else t.movedim(d, 0)
    t = t.movedim(0, lane)
    return t.flatten(lane, lane + 1).contiguous()


def _unfold(t, v, lane=0):
    return t.unflatten(lane, (v, -1))


def _vmap_lanes(fn, info, in_dims, tensors, lanes, out_lanes):
    """The ``vmap`` rule of every Function here: fold the vmapped axis of each
    of ``tensors`` (lane axis ``lanes[i]``) into its lanes, one call of
    ``fn`` for the batch, and unfold the outputs (lane axes ``out_lanes``)."""
    v = info.batch_size
    folded = [_fold_lanes(t, d, v, lane) for t, d, lane in zip(tensors, in_dims, lanes)]
    outs = fn(*folded)
    return tuple(_unfold(o, v, lane) for o, lane in zip(outs, out_lanes)), tuple(out_lanes)


class _LvRk4(torch.autograd.Function):
    """The forward kernel forward (its states kept as a second output, not
    differentiable), the adjoint kernel backward.

    - First-order reverse (a sampler's gradient, ``torch.func.grad`` /
      ``jacrev``): one forward and one adjoint launch.
    - A backward whose result will be differentiated again (``create_graph``,
      ``functional.hessian``, ``laplace_sample``; ``ops/_forward.py``) runs the
      adjoint as ``_LvRk4Adjoint``, whose rules are the dual kernels.
    - Forward mode (``jvp``): the dual forward (``_LvRk4Dual``, whose
      backward is the second order of reverse over forward).  Forward over
      forward never reaches this Function (``_kernel_route``).
    - ``vmap`` folds a vmapped ``z0`` / ``theta`` axis into the chain lanes:
      one launch for the whole batch.

    ``z0`` and ``theta`` must be contiguous (``lv_rk4`` lays them out)."""

    @staticmethod
    def forward(z0, theta, t0, ts, steps):
        return lv_rk4_forward(z0, t0, ts, theta, steps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        z0, theta, t0, ts, steps = inputs
        ctx.mark_non_differentiable(output[1])
        ctx.set_materialize_grads(False)
        ctx.t0, ctx.ts, ctx.steps = t0, ts, steps
        ctx.save_for_backward(z0, theta, output[1])
        ctx.save_for_forward(z0, theta)

    @staticmethod
    def backward(ctx, gbar, _):
        z0, theta, states = ctx.saved_tensors
        if gbar is None:
            return None, None, None, None, None
        if differentiated_again(z0, theta):
            z0bar, tbar = _LvRk4Adjoint.apply(z0, theta, gbar.contiguous(), states, ctx.t0, ctx.ts, ctx.steps)
        else:
            z0bar, tbar = lv_rk4_adjoint(ctx.t0, ctx.ts, theta, ctx.steps, states, gbar.contiguous())
        return z0bar, tbar, None, None, None

    @staticmethod
    def jvp(ctx, tz0, ttheta, *_):
        z0, theta = ctx.saved_tensors
        tz0, ttheta = _or_zeros(tz0, z0), _or_zeros(ttheta, theta)
        return _LvRk4Dual.apply(z0, theta, tz0, ttheta, ctx.t0, ctx.ts, ctx.steps)[1], None

    @staticmethod
    def vmap(info, in_dims, z0, theta, t0, ts, steps):
        return _vmap_lanes(lambda z, th: _LvRk4.apply(z, th, t0, ts, steps), info, in_dims[:2], (z0, theta), (0, 0),
                           (0, 1))


class _LvRk4Dual(torch.autograd.Function):
    """``(ys, ys')`` by the dual forward for tangents ``tz0``, ``ttheta``: the
    ``jvp`` of ``_LvRk4``.

    - ``backward`` (reverse over forward): the vjp of ``(ys(p), J(p) t)`` for
      cotangents ``(a, b)`` is ``p: J^T a + H_b t`` and ``t: J^T b``, with
      ``H_b`` the Hessian of ``<b, ys>``: the tangent and the primal of one
      dual adjoint with ``gbar = b`` and its tangent ``a`` (``_LvRk4Hvp``); a
      third order takes the plain version.
    - ``vmap`` folds every vmapped axis (``jacfwd``'s basis tangents) into the
      lanes: one launch for the batch."""

    @staticmethod
    def forward(z0, theta, tz0, ttheta, t0, ts, steps):
        return lv_rk4_dual_forward(z0, t0, ts, theta, steps, tz0.contiguous(), ttheta.contiguous())

    @staticmethod
    def setup_context(ctx, inputs, output):
        z0, theta, tz0, ttheta, t0, ts, steps = inputs
        ctx.t0, ctx.ts, ctx.steps = t0, ts, steps
        ctx.save_for_backward(z0, theta, tz0, ttheta)

    @staticmethod
    def backward(ctx, a, b):
        z0, theta, tz0, ttheta = ctx.saved_tensors
        if differentiated_again(z0, theta, tz0, ttheta):
            _, pullback = torch.func.vjp(lambda *p: _plain_jvp(*p, ctx.t0, ctx.ts, ctx.steps), z0, theta, tz0, ttheta)
            return pullback((a, b)) + (None, None, None)
        z0bar, tbar, hz, hth, _ = _LvRk4Hvp.apply(z0, theta, b.contiguous(), tz0, ttheta, a, ctx.t0, ctx.ts, ctx.steps)
        return hz, hth, z0bar, tbar, None, None, None

    @staticmethod
    def vmap(info, in_dims, z0, theta, tz0, ttheta, t0, ts, steps):
        return _vmap_lanes(lambda *a: _LvRk4Dual.apply(*a, t0, ts, steps), info, in_dims[:4], (z0, theta, tz0, ttheta),
                           (0, 0, 0, 0), (0, 0))


class _LvRk4Hvp(torch.autograd.Function):
    """``(z0bar, thetabar, z0bar', thetabar', ys')`` by one dual forward (the
    dual states for tangents ``tz0``, ``ttheta``) and one dual adjoint (with
    ``gbar`` and its tangent ``tgbar``): the second-order rules of
    ``_LvRk4Adjoint``, each a rule whose result is not differentiated again.
    ``vmap`` folds every vmapped axis into the lanes."""

    @staticmethod
    def forward(z0, theta, gbar, tz0, ttheta, tgbar, t0, ts, steps):
        ttheta = ttheta.contiguous()
        _, tys, states = lv_rk4_dual_forward(z0, t0, ts, theta, steps, tz0.contiguous(), ttheta, keep_states=True)
        return lv_rk4_dual_adjoint(t0, ts, theta, steps, ttheta, states, gbar, tgbar.contiguous()) + (tys,)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(*output)

    @staticmethod
    def vmap(info, in_dims, z0, theta, gbar, tz0, ttheta, tgbar, t0, ts, steps):
        return _vmap_lanes(lambda *a: _LvRk4Hvp.apply(*a, t0, ts, steps), info, in_dims[:6],
                           (z0, theta, gbar, tz0, ttheta, tgbar), (0,) * 6, (0,) * 5)


class _LvRk4Adjoint(torch.autograd.Function):
    """``(z0bar, thetabar)`` of ``_LvRk4`` by the adjoint kernel from its
    states, where that gradient will be differentiated again.

    - ``jvp`` (``functional.hessian`` = ``jacfwd`` over ``grad``, a
      Hessian-vector product): the dual adjoint with tangents on ``z0``,
      ``theta`` and ``gbar`` (``_LvRk4Hvp``).
    - ``backward`` (``laplace_sample``'s double backward): the Hessian of
      ``phi(p) = <gbar, ys(p)>`` is symmetric, so for a cotangent ``u`` of
      ``(z0bar, thetabar)`` the cotangent of ``(z0, theta)`` is ``H u``, the
      dual adjoint with tangent ``u`` and none on ``gbar``; the cotangent of
      ``gbar`` is ``J u``, the tangent of ``ys`` from the same dual forward.
    - A rule whose result is differentiated again (a third order) takes the
      plain version.
    - ``vmap`` folds a vmapped axis of any input into the lanes."""

    @staticmethod
    def forward(z0, theta, gbar, states, t0, ts, steps):
        return lv_rk4_adjoint(t0, ts, theta, steps, states, gbar)

    @staticmethod
    def setup_context(ctx, inputs, output):
        z0, theta, gbar, _, t0, ts, steps = inputs
        ctx.t0, ctx.ts, ctx.steps = t0, ts, steps
        ctx.save_for_backward(z0, theta, gbar)
        ctx.save_for_forward(z0, theta, gbar)

    @staticmethod
    def backward(ctx, uz, uth):
        z0, theta, gbar = ctx.saved_tensors
        uz, uth = _or_zeros(uz, z0), _or_zeros(uth, theta)
        if differentiated_again(z0, theta, gbar):
            _, pullback = torch.func.vjp(lambda z, th, g: _plain_vjp(z, th, g, ctx.t0, ctx.ts, ctx.steps), z0, theta, gbar)
            hz, hth, jg = pullback((uz, uth))
        else:
            _, _, hz, hth, jg = _LvRk4Hvp.apply(z0, theta, gbar, uz, uth, torch.zeros_like(gbar), ctx.t0, ctx.ts, ctx.steps)
        return hz, hth, jg, None, None, None, None

    @staticmethod
    def jvp(ctx, tz0, ttheta, tgbar, *_):
        z0, theta, gbar = ctx.saved_tensors
        tz0, ttheta, tgbar = _or_zeros(tz0, z0), _or_zeros(ttheta, theta), _or_zeros(tgbar, gbar)
        if differentiated_again(z0, theta, gbar):
            return torch.func.jvp(lambda z, th, g: _plain_vjp(z, th, g, ctx.t0, ctx.ts, ctx.steps), (z0, theta, gbar),
                                  (tz0, ttheta, tgbar))[1]
        return _LvRk4Hvp.apply(z0, theta, gbar, tz0, ttheta, tgbar, ctx.t0, ctx.ts, ctx.steps)[2:4]

    @staticmethod
    def vmap(info, in_dims, z0, theta, gbar, states, t0, ts, steps):
        return _vmap_lanes(lambda *a: _LvRk4Adjoint.apply(*a, t0, ts, steps), info, in_dims[:4],
                           (z0, theta, gbar, states), (0, 0, 0, 1), (0, 0))


def _kernel_route(z0, t0, ts, theta, steps_per_interval):
    """``lv_rk4`` on the kernels, through ``_LvRk4``."""
    if forward_levels() > 1:  # forward over forward: torch.func drops the outer tangent of a Function's rule
        return lv_rk4_plain(z0, t0, ts, theta, steps_per_interval)
    return _LvRk4.apply(z0.contiguous(), theta.contiguous(), t0, ts, int(steps_per_interval))[0]


def lv_rk4(z0, t0, ts, theta, steps_per_interval):
    """``ode_rk4_fixed(lv_rhs, z0, t0, ts, theta, steps_per_interval)`` for
    ``z0 (C, 2)``, ``theta (C, 4)``: the kernels on CUDA tensors, the plain
    version on CPU tensors; ``(C, T, 2)``."""
    if not isinstance(z0, torch.Tensor) or not isinstance(theta, torch.Tensor):
        raise TypeError("lv_rk4: z0 and theta must be tensors")
    if z0.device.type == "cpu" and theta.device.type == "cpu":
        return lv_rk4_plain(z0, t0, ts, theta, steps_per_interval)
    if z0.device.type != "cuda":
        raise ValueError(f"lv_rk4: no kernel for device {z0.device}")
    return _kernel_route(z0, t0, ts, theta, steps_per_interval)
