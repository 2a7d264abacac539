"""The Lotka-Volterra RK4 solve and its reverse-mode derivative as one
hand-written kernel pair.

Counterpart: no Pallas kernel.  The JAX package's Lotka-Volterra model
(``math_tpu/models/lotka_volterra.py:70``) integrates with
``ode_rk4_fixed(dz_dt, z0, 0, ts, theta, steps_per_interval=24)``, a
``lax.scan`` (``math_tpu/ops/ode.py:408-433``) that XLA compiles into one
program; ``jax.grad`` differentiates the scan.  Written eagerly in PyTorch the
same solve is 480 RK4 steps of a 2-state system, tens of thousands of tiny
launches a gradient call.  ``csrc/lv_rk4.cu`` runs it as two launches, one
thread a chain: ``lv_rk4_forward`` (the solve) and ``lv_rk4_adjoint`` (the
exact gradient of the discrete map, what autograd through the loop
computes).  The kernel's note says what bounds it.

Rules: on a CUDA tensor ``lv_rk4`` launches the kernels (float32 or float64)
or raises; it takes the plain version ``lv_rk4_plain`` (``ode_rk4_fixed``
through autograd) only for tensors on the CPU.  ``LAUNCHES`` counts kernel
launches, ``PLAIN_CALLS`` calls of the plain version.  On the card a
first-order gradient is the kernel pair's alone; forward mode and a second
order take the plain version for their derivative (``_LvRk4``), each such
call counted.  ``lv_rk4_adjoint_reference`` is the adjoint sweep written in
PyTorch in the kernel's order, for the tests.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from math_tpu_torch.ops import _build, ode
from math_tpu_torch.ops._forward import differentiated_again
from math_tpu_torch.utils.batch import plain_tensor

KERNEL = "lv_rk4"
FORWARD, ADJOINT = "lv_rk4_forward", "lv_rk4_adjoint"
LAUNCHES = {FORWARD: 0, ADJOINT: 0}
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
    """Per interval ``(h, h/2, h/6)`` in the working dtype, as the kernel
    computes them."""
    t0n, tsn = ode._host_times(ts, t0, dtype)
    nd = tsn.dtype.type
    starts = np.concatenate([[t0n], tsn[:-1]]).astype(nd)
    out = []
    for t_next, t in zip(tsn, starts):
        h = (t_next - t) / nd(steps)
        out.append((float(h), float(nd(0.5) * h), float(h / nd(6.0))))
    return out


def _rk4_step_reference(theta, h, hh, h6, z):
    k1 = lv_rhs(None, z, theta)
    k2 = lv_rhs(None, z + hh * k1, theta)
    k3 = lv_rhs(None, z + hh * k2, theta)
    k4 = lv_rhs(None, z + h * k3, theta)
    return z + h6 * (k1 + 2 * k2 + 2 * k3 + k4)


def _stage_adjoint_reference(theta, s, kbar):
    """``(J_y(s)^T kbar, J_theta(s)^T kbar)`` of ``lv_rhs`` at stage input ``s``."""
    a, b, g, d = theta.unbind(-1)
    u, v = s.unbind(-1)
    ku, kv = kbar.unbind(-1)
    sbar = torch.stack([(a - b * v) * ku + d * v * kv, -b * u * ku + (-g + d * u) * kv], -1)
    uv = u * v
    tbar = torch.stack([u * ku, -uv * ku, -v * kv, uv * kv], -1)
    return sbar, tbar


def lv_rk4_adjoint_reference(z0, t0, ts, theta, steps_per_interval, ys, gbar):
    """``(z0bar, thetabar)``: the kernel's adjoint sweep in PyTorch, in its
    order (intervals in reverse, each interval's states recomputed from its
    start, the RK4 step's adjoint per stage).  For the tests."""
    lam = torch.zeros_like(z0)
    tbar = torch.zeros_like(theta)
    for k, (h, hh, h6) in reversed(list(enumerate(_step_sizes(t0, ts, z0.dtype, steps_per_interval)))):
        lam = lam + gbar[:, k]
        z = z0 if k == 0 else ys[:, k - 1]
        states = []
        for _ in range(steps_per_interval):
            states.append(z)
            z = _rk4_step_reference(theta, h, hh, h6, z)
        for s1 in reversed(states):
            k1 = lv_rhs(None, s1, theta)
            s2 = s1 + hh * k1
            k2 = lv_rhs(None, s2, theta)
            s3 = s1 + hh * k2
            k3 = lv_rhs(None, s3, theta)
            s4 = s1 + h * k3
            k14 = h6 * lam
            k3b = 2 * k14
            k2b, k1b = k3b, k14
            ybar = lam
            sb, tb = _stage_adjoint_reference(theta, s4, k14)
            ybar, tbar, k3b = ybar + sb, tbar + tb, k3b + h * sb
            sb, tb = _stage_adjoint_reference(theta, s3, k3b)
            ybar, tbar, k2b = ybar + sb, tbar + tb, k2b + hh * sb
            sb, tb = _stage_adjoint_reference(theta, s2, k2b)
            ybar, tbar, k1b = ybar + sb, tbar + tb, k1b + hh * sb
            sb, tb = _stage_adjoint_reference(theta, s1, k1b)
            lam, tbar = ybar + sb, tbar + tb
    return lam, tbar


_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load_library(KERNEL)
        for suffix in _SUFFIX.values():
            fwd = getattr(lib, f"lv_rk4_forward_{suffix}")
            fwd.restype = ctypes.c_int
            fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_double] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
            adj = getattr(lib, f"lv_rk4_adjoint_{suffix}")
            adj.restype = ctypes.c_int
            adj.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_double] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 7
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=64)
def _device_times_cached(raw, dtype, device):
    return plain_tensor(torch.tensor(np.frombuffer(raw, dtype=ode.np_dtype(dtype)).copy(), device=device))


def _device_times(t0, ts, dtype, device):
    """``(t0 as a float of the working dtype, ts (T,) on the device)``; the
    copy of ``ts`` is kept (a sampler meets the same grid every call)."""
    t0n, tsn = ode._host_times(ts, t0, dtype)
    return float(t0n), _device_times_cached(tsn.tobytes(), dtype, str(device))


def _check(z0, theta, steps):
    if z0.device.type != "cuda" or theta.device != z0.device:
        raise ValueError(f"lv_rk4 kernels: z0 and theta must be CUDA tensors on one device; got {z0.device}, {theta.device}")
    if z0.dtype not in _SUFFIX or theta.dtype != z0.dtype:
        raise TypeError(f"lv_rk4 kernels: float32 or float64, one dtype; got {z0.dtype}, {theta.dtype}")
    if z0.ndim != 2 or z0.shape[1] != 2 or theta.shape != (z0.shape[0], 4):
        raise ValueError(f"lv_rk4 kernels: expected z0 (C, 2), theta (C, 4); got {tuple(z0.shape)}, {tuple(theta.shape)}")
    if not (z0.is_contiguous() and theta.is_contiguous()):
        raise ValueError("lv_rk4 kernels: z0 and theta must be contiguous")
    if z0.shape[0] < 1 or int(steps) < 1:
        raise ValueError(f"lv_rk4 kernels: need C >= 1 and steps >= 1; got {z0.shape[0]}, {steps}")


def _stamps_ptr(stamps, device):
    if stamps is None:
        return None
    if stamps.shape != (4,) or stamps.dtype != torch.int64 or stamps.device != device:
        raise ValueError(f"lv_rk4 kernels: stamps must be a (4,) int64 tensor on {device}")
    return stamps.data_ptr()


def lv_rk4_forward(z0, t0, ts, theta, steps_per_interval, stamps=None):
    """``ys (C, T, 2)`` by the forward kernel (CUDA tensors only).  With
    ``stamps``, a ``(4,)`` int64 tensor on the device, chain 0 writes its
    ``clock64()`` where its steps start and end, then ``%globaltimer`` (ns)
    at the same points (for measurement)."""
    _check(z0, theta, steps_per_interval)
    t0f, tsd = _device_times(t0, ts, z0.dtype, z0.device)
    c, nt = z0.shape[0], tsd.shape[0]
    lib = _library()
    with torch.cuda.device(z0.device):
        ys = torch.empty((c, nt, 2), dtype=z0.dtype, device=z0.device)
        err = getattr(lib, f"lv_rk4_forward_{_SUFFIX[z0.dtype]}")(
            z0.data_ptr(), theta.data_ptr(), tsd.data_ptr(), t0f, c, nt, int(steps_per_interval), ys.data_ptr(),
            _stamps_ptr(stamps, z0.device), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"lv_rk4_forward kernel launch failed: CUDA error {err}")
    LAUNCHES[FORWARD] += 1
    return ys


def lv_rk4_adjoint(z0, t0, ts, theta, steps_per_interval, ys, gbar, stamps=None):
    """``(z0bar (C, 2), thetabar (C, 4))`` by the adjoint kernel, for the
    cotangent ``gbar (C, T, 2)`` of ``ys`` (CUDA tensors only); ``stamps`` as
    in ``lv_rk4_forward``."""
    _check(z0, theta, steps_per_interval)
    t0f, tsd = _device_times(t0, ts, z0.dtype, z0.device)
    c, nt, steps = z0.shape[0], tsd.shape[0], int(steps_per_interval)
    for name, a in (("ys", ys), ("gbar", gbar)):
        if a.shape != (c, nt, 2) or a.dtype != z0.dtype or a.device != z0.device or not a.is_contiguous():
            raise ValueError(f"lv_rk4_adjoint: {name} must be a contiguous ({c}, {nt}, 2) {z0.dtype} on {z0.device}")
    lib = _library()
    with torch.cuda.device(z0.device):
        states = torch.empty((steps, c, 2), dtype=z0.dtype, device=z0.device)
        z0bar = torch.empty_like(z0)
        tbar = torch.empty_like(theta)
        err = getattr(lib, f"lv_rk4_adjoint_{_SUFFIX[z0.dtype]}")(
            z0.data_ptr(), theta.data_ptr(), tsd.data_ptr(), t0f, c, nt, steps, ys.data_ptr(), gbar.data_ptr(),
            states.data_ptr(), z0bar.data_ptr(), tbar.data_ptr(), _stamps_ptr(stamps, z0.device),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"lv_rk4_adjoint kernel launch failed: CUDA error {err}")
    LAUNCHES[ADJOINT] += 1
    return z0bar, tbar


def _plain_vjp(z0, theta, t0, ts, steps, gbar):
    """``(z0bar, thetabar)`` through the differentiable plain version."""
    _, pullback = torch.func.vjp(lambda z, th: lv_rk4_plain(z, t0, ts, th, steps), z0, theta)
    return pullback(gbar)


class _LvRk4(torch.autograd.Function):
    """The forward kernel forward, the adjoint kernel backward.

    - First-order reverse (a sampler's gradient, ``torch.func.grad`` /
      ``jacrev``): one forward and one adjoint launch, no plain call.
    - A backward whose result will be differentiated again (``create_graph``,
      ``functional.hessian``, ``laplace_sample``; ``ops/_forward.py``) and
      forward mode (``jvp``) take the differentiable plain version
      ``lv_rk4_plain``, as B1's second order takes its plain partials
      (pallas_glm.py:220-237): the kernel pair computes first-order reverse
      only (a forward-sensitivity kernel: ROADMAP B8).
    - ``vmap`` folds a vmapped ``z0`` / ``theta`` axis into the chain lanes:
      one launch for the whole batch.

    ``z0`` and ``theta`` must be contiguous (``lv_rk4`` lays them out)."""

    @staticmethod
    def forward(z0, theta, t0, ts, steps):
        return lv_rk4_forward(z0, t0, ts, theta, steps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        z0, theta, t0, ts, steps = inputs
        ctx.t0, ctx.ts, ctx.steps = t0, ts, steps
        ctx.save_for_backward(z0, theta, output)
        ctx.save_for_forward(z0, theta)

    @staticmethod
    def backward(ctx, gbar):
        z0, theta, ys = ctx.saved_tensors
        if differentiated_again(z0, theta):
            z0bar, tbar = _plain_vjp(z0, theta, ctx.t0, ctx.ts, ctx.steps, gbar)
        else:
            z0bar, tbar = lv_rk4_adjoint(z0, ctx.t0, ctx.ts, theta, ctx.steps, ys, gbar.contiguous())
        return z0bar, tbar, None, None, None

    @staticmethod
    def jvp(ctx, tz0, ttheta, *_):
        z0, theta = ctx.saved_tensors
        tz0 = torch.zeros_like(z0) if tz0 is None else tz0
        ttheta = torch.zeros_like(theta) if ttheta is None else ttheta
        return torch.func.jvp(lambda z, th: lv_rk4_plain(z, ctx.t0, ctx.ts, th, ctx.steps), (z0, theta), (tz0, ttheta))[1]

    @staticmethod
    def vmap(info, in_dims, z0, theta, t0, ts, steps):
        v = info.batch_size
        z0, theta = (_fold_lanes(t, d, v) for t, d in zip((z0, theta), in_dims[:2]))
        ys = _LvRk4.apply(z0, theta, t0, ts, steps)
        return ys.reshape((v, -1) + tuple(ys.shape[1:])), 0


def _fold_lanes(t, d, v):
    """``(C, k)`` with the vmapped axis ``d`` (None: broadcast to ``v``)
    folded into the lanes: ``(v*C, k)``, contiguous."""
    t = t.expand((v,) + tuple(t.shape)) if d is None else t.movedim(d, 0)
    return t.reshape((-1,) + tuple(t.shape[2:])).contiguous()


def lv_rk4(z0, t0, ts, theta, steps_per_interval):
    """``ode_rk4_fixed(lv_rhs, z0, t0, ts, theta, steps_per_interval)`` for
    ``z0 (C, 2)``, ``theta (C, 4)``: the kernel pair on CUDA tensors, the
    plain version on CPU tensors; ``(C, T, 2)``."""
    if not isinstance(z0, torch.Tensor) or not isinstance(theta, torch.Tensor):
        raise TypeError("lv_rk4: z0 and theta must be tensors")
    if z0.device.type == "cpu" and theta.device.type == "cpu":
        return lv_rk4_plain(z0, t0, ts, theta, steps_per_interval)
    if z0.device.type != "cuda":
        raise ValueError(f"lv_rk4: no kernel for device {z0.device}")
    return _LvRk4.apply(z0.contiguous(), theta.contiguous(), t0, ts, int(steps_per_interval))
