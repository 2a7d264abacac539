"""Fused GLM log-prob + parameter gradients for a batch of chains.

Counterpart: ``math_tpu/ops/pallas_glm.py`` (its ``_glm_kernel``, the four
family cores, the AD wiring and the four ``*_glm_lp[dm]f_chains``
dispatchers).  The kernel is ``math_tpu_torch/csrc/glm_fused.cu``: one pass
over ``x`` gives, per chain,

    logp = sum lp(eta, y, extra),  ga = sum theta',  gb = x^T theta',
    ge = sum dlp/dextra            with eta = x @ beta + alpha,

so the design matrix is read once for the value and every parameter gradient.
Only the eta-dependent part of the density lives in the kernel; terms in
``(y, extra)`` alone are added outside in plain PyTorch.  All functions here
compute the ``propto=True`` form, as the JAX dispatchers do.

Rules: on a CUDA tensor ``glm_fused_parts`` launches the kernel or raises; it
takes the plain version ``glm_fused_parts_reference`` only for tensors that lie
on the CPU.  There are no dispatch thresholds: those of the JAX package were
measured on another chip and are not carried over.  ``LAUNCHES`` counts kernel
launches per family and ``PLAIN_CALLS`` calls of the plain version, so a run
can show which one it went through.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from math_tpu_torch.ops import _build

FAMILIES = ("bernoulli_logit", "poisson_log", "normal_id", "neg_binomial_2_log")
HAS_EXTRA = {
    "bernoulli_logit": False,
    "poisson_log": False,
    "normal_id": True,
    "neg_binomial_2_log": True,
}
_FAMILY_CODE = {f: i for i, f in enumerate(FAMILIES)}

LAUNCHES = {f: 0 for f in FAMILIES}
PLAIN_CALLS = {f: 0 for f in FAMILIES}

MAX_SMEM_BYTES = 232_448  # dynamic shared memory one block may use on sm_90


def reset_counts():
    for f in FAMILIES:
        LAUNCHES[f] = 0
        PLAIN_CALLS[f] = 0


# ---------------------------------------------------------------------------
# Family cores on (N, C) tiles, y as (N, 1), extra as (1, C)
# (ref: pallas_glm.py:62-101)
# ---------------------------------------------------------------------------


def _softplus(t):
    # not F.softplus: its threshold=20 switch differs from the exact form
    return torch.logaddexp(torch.zeros_like(t), t)


def _core(family, eta, y, extra):
    """(lp, theta' = dlp/deta, dlp/dextra or None)."""
    if family == "bernoulli_logit":
        sign = 2.0 * y - 1.0
        return -_softplus(-sign * eta), y - torch.sigmoid(eta), None
    if family == "poisson_log":
        mu = torch.exp(eta)
        return y * eta - mu, y - mu, None
    if family == "normal_id":
        inv_sigma = 1.0 / extra
        z = (y - eta) * inv_sigma
        return -0.5 * torch.square(z), z * inv_sigma, torch.square(z) * inv_sigma
    if family == "neg_binomial_2_log":
        log_phi = torch.log(extra)
        lse = torch.logaddexp(eta, log_phi)  # log(mu + phi), overflow-safe
        lp = y * eta - (y + extra) * lse
        thetap = y - (y + extra) * torch.sigmoid(eta - log_phi)
        return lp, thetap, -lse - (y + extra) * torch.exp(-lse)
    raise ValueError(f"unknown GLM family {family!r}")


def glm_fused_parts_reference(family, y, x, alpha, beta, extra=None):
    """Plain PyTorch version of the kernel (ref: ``_xla_parts``,
    pallas_glm.py:246-260): ``(logp (C,), ga (C,), gb (K, C), ge (C,) or
    None)`` in the dtype of ``x``, on its device.  Differentiable."""
    PLAIN_CALLS[family] += 1
    eta = x @ beta + alpha[None, :]
    e2 = extra[None, :] if HAS_EXTRA[family] else None
    lp, thetap, dextra = _core(family, eta, y[:, None], e2)
    ge = dextra.sum(0) if HAS_EXTRA[family] else None
    return lp.sum(0), thetap.sum(0), x.mT @ thetap, ge


# ---------------------------------------------------------------------------
# The kernel's wrapper
# ---------------------------------------------------------------------------

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load_library("glm_fused")
        lib.glm_fused_launch.restype = ctypes.c_int
        lib.glm_fused_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        )
        lib.glm_fused_smem_bytes.restype = ctypes.c_longlong
        lib.glm_fused_smem_bytes.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def _check(name, t, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"glm_fused_parts: {name} must be a torch.Tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"glm_fused_parts: {name} is on {t.device}, x is on {device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"glm_fused_parts: {name} has shape {tuple(t.shape)}, expected {shape}")


def row_blocks_for(n, c, device):
    """Blocks along the rows: about two blocks per SM over all chain tiles."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    chain_tiles = (c + 63) // 64
    n_tiles = (n + 63) // 64
    return max(1, min(n_tiles, (2 * sms + chain_tiles - 1) // chain_tiles))


def glm_fused_parts(family, y, x, alpha, beta, extra=None):
    """``(logp (C,), ga (C,), gb (K, C), ge (C,) or None)`` for ``y (N,)``,
    ``x (N, K)``, ``alpha (C,)``, ``beta (K, C)``, ``extra (C,)``.

    CUDA tensors go to the hand-written kernel (float32, contiguous, else this
    raises); CPU tensors go to ``glm_fused_parts_reference``.
    """
    if family not in _FAMILY_CODE:
        raise ValueError(f"unknown GLM family {family!r}")
    if not isinstance(x, torch.Tensor) or x.ndim != 2:
        raise ValueError("glm_fused_parts: x must be a 2-D torch.Tensor (N, K)")
    n, k = x.shape
    if beta.ndim != 2:
        raise ValueError("glm_fused_parts: beta must be 2-D (K, C)")
    c = beta.shape[1]
    has_extra = HAS_EXTRA[family]
    operands = [("y", y, (n,)), ("alpha", alpha, (c,)), ("beta", beta, (k, c))]
    if has_extra:
        operands.append(("extra", extra, (c,)))
    for name, t, shape in operands:
        _check(name, t, shape, x.device)

    if x.device.type == "cpu":
        return glm_fused_parts_reference(family, y, x, alpha, beta, extra)
    if x.device.type != "cuda":
        raise ValueError(f"glm_fused_parts: no kernel for device {x.device}")

    for name, t, _ in [("x", x, None)] + operands:
        if t.dtype != torch.float32:
            raise TypeError(f"glm_fused_parts: {name} is {t.dtype}; the CUDA kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"glm_fused_parts: {name} must be contiguous")
    if n < 1 or c < 1 or k < 1:
        raise ValueError(f"glm_fused_parts: need N, K, C >= 1; got {n}, {k}, {c}")

    lib = _library()
    if lib.glm_fused_smem_bytes(k) > MAX_SMEM_BYTES:
        raise ValueError(f"glm_fused_parts: K={k} columns need more shared memory than a block has")
    rb = row_blocks_for(n, c, x.device)
    with torch.cuda.device(x.device):
        partials = torch.empty((rb, k + 3, c), dtype=torch.float32, device=x.device)
        out = torch.empty((k + 3, c), dtype=torch.float32, device=x.device)
        err = lib.glm_fused_launch(
            _FAMILY_CODE[family], y.data_ptr(), x.data_ptr(), alpha.data_ptr(), beta.data_ptr(),
            extra.data_ptr() if has_extra else None, partials.data_ptr(), out.data_ptr(),
            n, k, c, rb, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"glm_fused kernel launch failed for {family}: CUDA error {err}")
    LAUNCHES[family] += 1
    return out[0], out[1], out[3:], (out[2] if has_extra else None)


# ---------------------------------------------------------------------------
# AD wiring (ref: pallas_glm.py:219-391)
# ---------------------------------------------------------------------------


def _dy_rows(family, eta, thetap, y, extra):
    """d logp_c / d y_n rows (N, C) for the float-data families
    (ref: pallas_glm.py:263-274)."""
    if family == "bernoulli_logit":
        sign = 2.0 * y[:, None] - 1.0
        return 2.0 * eta * torch.sigmoid(-sign * eta)
    if family == "poisson_log":
        return eta
    if family == "normal_id":
        return -thetap
    return eta - torch.logaddexp(eta, torch.log(extra)[None, :])


class GlmFused(torch.autograd.Function):
    """``logp (C,)`` of one family's eta-part; first-order gradients for
    ``alpha``, ``beta``, ``extra`` are read off the partials the forward pass
    saved (the transpose of the linear JVP rule, pallas_glm.py:343-358).  The
    data-side cotangents for ``x`` and ``y`` are computed in plain PyTorch,
    and only when asked for.  There is no backward kernel, as in the JAX
    package.  Differentiating the backward again is not supported yet and
    raises (it never returns silent zeros).
    """

    @staticmethod
    def forward(ctx, family, y, x, alpha, beta, extra):
        alpha = alpha.contiguous()
        beta = beta.contiguous()
        if extra is not None:
            extra = extra.contiguous()
        logp, ga, gb, ge = glm_fused_parts(family, y, x, alpha, beta, extra)
        ctx.family = family
        ctx.save_for_backward(y, x, alpha, beta, extra, ga, gb, ge)
        return logp

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        y, x, alpha, beta, extra, ga, gb, ge = ctx.saved_tensors
        family = ctx.family
        need_y, need_x = ctx.needs_input_grad[1], ctx.needs_input_grad[2]
        gy = gx = None
        if need_y or need_x:
            eta = x @ beta + alpha[None, :]
            e2 = extra[None, :] if HAS_EXTRA[family] else None
            _, thetap, _ = _core(family, eta, y[:, None], e2)
            if need_x:
                gx = (thetap * g[None, :]) @ beta.mT
            if need_y:
                gy = _dy_rows(family, eta, thetap, y, extra) @ g
        g_alpha = g * ga if ctx.needs_input_grad[3] else None
        g_beta = g[None, :] * gb if ctx.needs_input_grad[4] else None
        g_extra = g * ge if (ge is not None and ctx.needs_input_grad[5]) else None
        return None, gy, gx, g_alpha, g_beta, g_extra


# ---------------------------------------------------------------------------
# Dispatchers (ref: pallas_glm.py:831-865, with the ``*_glm_fused`` functions
# of :394-417 folded in): alpha (C,), beta (K, C) -> logp (C,), propto=True.
# The JAX ones choose between the kernel and vmapped XLA by thresholds and take
# an ``interpret`` flag; here the device of the tensors decides alone.
# ---------------------------------------------------------------------------


def bernoulli_logit_glm_lpmf_chains(y, x, alpha, beta):
    """y (N,), x (N, K), alpha (C,), beta (K, C) -> logp (C,)."""
    return GlmFused.apply("bernoulli_logit", y, x, alpha, beta, None)


def poisson_log_glm_lpmf_chains(y, x, alpha, beta):
    return GlmFused.apply("poisson_log", y, x, alpha, beta, None)


def normal_id_glm_lpdf_chains(y, x, alpha, beta, sigma):
    """Core kernel plus the -N log sigma term (plain PyTorch; its
    sigma-gradient comes from autograd).  ref: pallas_glm.py:400-406."""
    n = y.shape[0]
    return GlmFused.apply("normal_id", y, x, alpha, beta, sigma) - n * torch.log(sigma)


def neg_binomial_2_log_glm_lpmf_chains(y, x, alpha, beta, phi):
    """Eta-core kernel plus the (y, phi)-only terms lgamma(y+phi) -
    lgamma(phi) + phi log phi (plain PyTorch over the (N, C) y-phi grid; no x
    read).  ref: pallas_glm.py:409-417."""
    n = y.shape[0]
    core = GlmFused.apply("neg_binomial_2_log", y, x, alpha, beta, phi)
    data = torch.lgamma(y[:, None] + phi[None, :]).sum(0)
    return core + data - n * torch.lgamma(phi) + n * phi * torch.log(phi)
