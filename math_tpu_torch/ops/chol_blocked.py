"""Blocked Cholesky around a hand-written diagonal-block kernel.

Counterpart: ``math_tpu/ops/chol_pallas.py`` (its ``_chol_inv_kernel``, the
blocked glue, the AD wiring and the two public functions, here without the
``_pallas`` suffix).  The kernel is ``math_tpu_torch/csrc/chol_inv_block.cu``:
for a batch ``d (Cb, B, B)`` of SPD blocks it gives the upper factor ``U``
(``d = U^T U``) and ``W = U^-1``, one thread block per matrix.  Everything
between the diagonal blocks is plain float32 matrix products (TF32 off):

    L_jj   = U_j^T                      U_j, W_j = chol_inv_block(A_jj - L_j,<j L_j,<j^T)
    L_>j,j = (A_>j,j - L_>j,<j L_j,<j^T) W_j

and every triangular solve with ``L`` is block substitution with the saved
``W_j`` (``L_jj^-1 = W_j^T``), so the factorization, the solve and their
adjoints launch the kernel ``ceil(n / B)`` times per forward pass and never in
a first-order backward pass.

Rules: on a CUDA tensor ``chol_inv_block_parts`` launches the kernel or raises;
it takes the plain version ``chol_inv_block_reference`` only for a tensor that
lies on the CPU.  The public functions go through the blocked path on every
device, so the CPU tests cover the glue and the hand-written adjoints; only the
innermost call chooses kernel or plain version.  ``LAUNCHES`` counts kernel
launches and ``PLAIN_CALLS`` calls of the plain version.

Differentiation: reverse mode of ``cholesky_blocked`` and
``cholesky_solve_logdiag`` is the closed-form transpose of the Murray tangent
(arXiv:1602.07527) over the saved ``(L, W_j)``; when its result is
differentiated again (a second order, ``ops/_forward.py``) the backward pass
re-derives ``L`` from ``a`` through ``chol_inv_block`` (``_chol_parts_fn``) and
is built from differentiable operations, so any order of differentiation works.
The gradient convention matches ``torch.linalg.cholesky`` through any symmetric
construction of ``a`` (the cotangent itself is the un-symmetrized transpose).

Not carried over from the JAX module: ``_chunked_blocks`` (one thread block
per matrix needs no chunks), ``_masked_diag`` (an answer to a TPU scatter;
``torch.diagonal`` is a view) and the ``custom_transpose`` fallback.  Forward
mode: each ``autograd.Function`` has the reference's tangent rule as its
``jvp`` (over the saved block inverses, no second factorization) and a
``vmap`` rule that folds the vmapped axis into the kernel's batch of blocks,
as the reference's merging batch rule does (chol_pallas.py:163-199).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch._C._functorch import is_functorch_wrapped_tensor

from math_tpu_torch.config import get_config
from math_tpu_torch.ops import _build
from math_tpu_torch.ops._forward import differentiated_again

KERNEL = "chol_inv_block"
LAUNCHES = {KERNEL: 0}
PLAIN_CALLS = {KERNEL: 0}

MAX_SMEM_BYTES = 232_448  # dynamic shared memory one block may use on sm_90
PANEL = 16  # the kernel's panel width, ``P`` in csrc/chol_inv_block.cu
STAMPS = ("start", "loaded", "factored", "inverted", "stored")


def block_kernel_stages(b, p=PANEL):
    """Barrier-separated stages of the block kernel for a (b, b) matrix: the
    load; per factor panel the diagonal block, then (but for the last) the
    panel's row block and the trailing update; the diagonal inverses; two per
    off-diagonal row panel of W.  Was ``2 b`` dependent steps column by column."""
    n = -(-b // p)
    return 1 + n + 2 * (n - 1) + 1 + 2 * (n - 1)


def reset_counts():
    LAUNCHES[KERNEL] = 0
    PLAIN_CALLS[KERNEL] = 0


def _T(x):
    return x.mT


# ---------------------------------------------------------------------------
# The block function: plain version, kernel wrapper, autograd
# ---------------------------------------------------------------------------


def chol_inv_block_reference(d):
    """Plain PyTorch version of the kernel (what the body of
    ``_chol_inv_kernel`` does, chol_pallas.py:46-126): ``(U, W)`` for
    ``d (Cb, B, B)`` of any float dtype, every one of the ``2 B`` steps applied
    to the whole batch at once.  A pivot that is not positive gives NaN for
    that matrix (``U`` from the pivot's row on, ``W`` everywhere)."""
    PLAIN_CALLS[KERNEL] += 1
    cb, B, _ = d.shape
    lane = torch.arange(B, device=d.device)
    nan = torch.full((), float("nan"), dtype=d.dtype, device=d.device)
    m = d.clone()
    u = torch.zeros_like(d)
    w = torch.zeros_like(d)
    for k in range(B):
        row = m[:, k, :]  # row k of the symmetric residual
        p2 = row[:, k : k + 1]
        pivot = torch.where(p2 > 0, torch.sqrt(torch.where(p2 > 0, p2, 1.0)), nan)
        urow = torch.where(lane >= k, row / pivot, 0.0)
        u[:, k, :] = urow
        m = m - urow[:, :, None] * urow[:, None, :]
    for k in reversed(range(B)):
        urow = u[:, k, :]
        tail = torch.where(lane > k, urow, 0.0)
        # rows of W below k are final, rows <= k still zero
        acc = (tail[:, None, :] @ w)[:, 0, :]
        ek = (lane == k).to(d.dtype)
        w[:, k, :] = (ek - acc) / urow[:, k : k + 1]
    return u, w


_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load_library(KERNEL)
        lib.chol_inv_block_launch_stamped.restype = ctypes.c_int
        lib.chol_inv_block_launch_stamped.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        lib.chol_inv_block_smem_bytes.restype = ctypes.c_longlong
        lib.chol_inv_block_smem_bytes.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def chol_inv_block_parts(d):
    """``(U, W)`` for ``d (Cb, B, B)``: upper factor (``d = U^T U``) and its
    inverse.  A CUDA tensor goes to the hand-written kernel (float32,
    contiguous, else this raises); a CPU tensor goes to
    ``chol_inv_block_reference``.  Not differentiable: see ``chol_inv_block``.
    """
    return _block_parts(d, stamps=False)[:2]


def chol_inv_block_stamped(d):
    """``(U, W, stamps)`` for a CUDA ``d``: the kernel with ``clock64()`` read
    by thread 0 of each block at the five points of ``STAMPS``, ``stamps (Cb,
    5)`` int64, to split its time between the phases (for measurement)."""
    if not isinstance(d, torch.Tensor) or d.device.type != "cuda":
        raise ValueError("chol_inv_block_stamped: the stamps are the CUDA kernel's; d must be a CUDA tensor")
    return _block_parts(d, stamps=True)


def _block_parts(d, stamps):
    if not isinstance(d, torch.Tensor) or d.ndim != 3 or d.shape[-1] != d.shape[-2]:
        raise ValueError("chol_inv_block_parts: d must be a torch.Tensor of shape (Cb, B, B)")
    if d.device.type == "cpu":
        return chol_inv_block_reference(d)
    if d.device.type != "cuda":
        raise ValueError(f"chol_inv_block_parts: no kernel for device {d.device}")
    if d.dtype != torch.float32:
        raise TypeError(f"chol_inv_block_parts: d is {d.dtype}; the CUDA kernel takes float32")
    if not d.is_contiguous():
        raise ValueError("chol_inv_block_parts: d must be contiguous")
    cb, B, _ = d.shape
    if cb < 1 or B < 1:
        raise ValueError(f"chol_inv_block_parts: need Cb, B >= 1; got {cb}, {B}")
    lib = _library()
    if lib.chol_inv_block_smem_bytes(B) > MAX_SMEM_BYTES:
        raise ValueError(f"chol_inv_block_parts: two ({B}, {B}) float32 matrices do not fit a block's shared memory")
    with torch.cuda.device(d.device):
        u = torch.empty_like(d)
        w = torch.empty_like(d)
        st = torch.zeros((cb, len(STAMPS)), dtype=torch.int64, device=d.device) if stamps else None
        err = lib.chol_inv_block_launch_stamped(
            d.data_ptr(), u.data_ptr(), w.data_ptr(), None if st is None else st.data_ptr(), cb, B,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"chol_inv_block kernel launch failed: CUDA error {err}")
    LAUNCHES[KERNEL] += 1
    return u, w, st


def _phi(x):
    """Lower triangle with halved diagonal (Murray's Phi), batched."""
    return torch.tril(x) - 0.5 * torch.diag_embed(torch.diagonal(x, dim1=-2, dim2=-1))


def _psi_upper(x):
    """Upper triangle with halved diagonal (the upper-factor analog of
    Murray's Phi), batched."""
    return torch.triu(x) - 0.5 * torch.diag_embed(torch.diagonal(x, dim1=-2, dim2=-1))


def _fold(t, d, v):
    """``t`` with its vmapped axis ``d`` (None: broadcast to ``v``) first."""
    return t.expand((v,) + tuple(t.shape)) if d is None else t.movedim(d, 0)


class _CholInvBlock(torch.autograd.Function):
    """Reverse mode is the transpose of the linear rule ``dU = Psi(W^T dd W)
    U``, ``dW = -W dU W`` (chol_pallas.py:255-265), forward mode (``jvp``) the
    rule itself.  ``U`` and ``W`` are saved as outputs, so a second
    differentiation reaches ``d`` through this node again.  ``vmap`` folds
    the vmapped axis into the batch of blocks: one launch (the reference's
    ``_chol_inv_batcher``, chol_pallas.py:163-199)."""

    @staticmethod
    def forward(d):
        return chol_inv_block_parts(d)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*output)
        ctx.save_for_forward(*output)

    @staticmethod
    def backward(ctx, ubar, wbar):
        u, w = ctx.saved_tensors
        ubar = ubar - _T(w) @ wbar @ _T(w)
        return w @ _psi_upper(ubar @ _T(u)) @ _T(w)

    @staticmethod
    def jvp(ctx, dd):
        u, w = ctx.saved_tensors
        du = _psi_upper(_T(w) @ dd @ w) @ u
        return du, -w @ du @ w

    @staticmethod
    def vmap(info, in_dims, d):
        d = _fold(d, in_dims[0], info.batch_size)
        shape = d.shape
        u, w = _CholInvBlock.apply(d.reshape((-1,) + shape[-2:]).contiguous())
        return (u.reshape(shape), w.reshape(shape)), (0, 0)


def chol_inv_block(d):
    """``(U, W)``: upper Cholesky factor of SPD block(s) ``d`` (``d = U^T U``)
    and ``W = U^-1``; ``d`` is ``(..., B, B)`` and all leading axes run in one
    kernel launch.  Differentiable to any order."""
    shape = d.shape
    u, w = _CholInvBlock.apply(d.reshape((-1,) + shape[-2:]).contiguous())
    return u.reshape(shape), w.reshape(shape)


# ---------------------------------------------------------------------------
# The glue between the blocks (any device; plain matrix products)
# ---------------------------------------------------------------------------


def _pad_spd(a, n, npad):
    """Zero-pad trailing dims to the block grid, identity on the tail diag."""
    if npad:
        a = F.pad(a, (0, npad, 0, npad))
        tail = torch.arange(n, n + npad, device=a.device)
        a[..., tail, tail] = 1.0
    return a


def _block_grid(n, block_size):
    """(B, npad): a matrix smaller than one block is one block of its own
    size; a larger one is padded up to a multiple of the block size."""
    B = max(1, min(block_size, n))
    return B, -(-n // B) * B - n


def _flatten_pad(a, n, npad):
    """(..., n, n) -> ((C, N, N), batch shape), identity-padded to the block grid."""
    a = _pad_spd(a, n, npad)
    return a.reshape((-1,) + a.shape[-2:]), a.shape[:-2]


def _flatten_pad_zero(x, npad, cols_only=False):
    """Flatten like ``_flatten_pad`` but zero-pad the tail (the cotangent of
    the identity padding is dropped).  ``cols_only``: trailing dims are
    (n, m), pad the rows only."""
    if npad:
        x = F.pad(x, (0, 0 if cols_only else npad, 0, npad))
    return x.reshape((-1,) + x.shape[-2:])


def _unflatten_unpad(x, batch_shape, n):
    return x.reshape(tuple(batch_shape) + x.shape[-2:])[..., :n, :n]


def _chol_blocked_impl(flat, B):
    """Blocked factorization on a flat (C, N, N) padded batch; returns
    ``(L, [W_j])`` where ``W_j = U_j^-1`` is block j's upper-triangular inverse
    (saved so that the adjoint's triangular solves are pure products).  Builds
    ``L`` in place, so it is not differentiable by autograd: the public
    functions carry the closed-form adjoints."""
    nb = flat.shape[-1] // B
    L = torch.zeros_like(flat)
    Ws = []
    for j in range(nb):
        s = j * B
        prior = L[:, s : s + B, :s]
        d = flat[:, s : s + B, s : s + B]
        d = torch.baddbmm(d, prior, _T(prior), alpha=-1.0) if s else d.contiguous()
        U, W = chol_inv_block_parts(d)
        Ws.append(W)
        L[:, s : s + B, s : s + B] = _T(U)
        if j + 1 < nb:
            off = flat[:, s + B :, s : s + B]
            if s:
                off = torch.baddbmm(off, L[:, s + B :, :s], _T(prior), alpha=-1.0)
            # off @ L_jj^-T == off @ W, written straight into L's panel
            torch.bmm(off, W, out=L[:, s + B :, s : s + B])
    return L, Ws


def _lower_solve_blocks(L, Ws, b, B):
    """y with L y = b by block forward substitution; L_jj^-1 = W_j^T.
    ``b`` is (C, N, M).  Each block is written into the rows of one
    allocation: the forward's path (plain tensors)."""
    y = torch.empty(b.shape, dtype=b.dtype, device=b.device)
    for j in range(len(Ws)):
        s = j * B
        rhs = b[:, s : s + B, :]
        if s:
            rhs = torch.baddbmm(rhs, L[:, s : s + B, :s], y[:, :s, :], alpha=-1.0)
        torch.bmm(_T(Ws[j]), rhs, out=y[:, s : s + B, :])
    return y


def _in_transform(*ts):
    """Whether a tensor is wrapped by a ``torch.func`` transform: ``vmap``
    has no rule for ``out=`` nor for an in-place write of a batched value
    into a plain tensor, so the backward's first-order path writes out of
    place there (one more copy of each block) and in place otherwise."""
    return any(t is not None and is_functorch_wrapped_tensor(t) for t in ts)


def _upper_solve_blocks(L, Ws, b, B):
    """y with L^T y = b by block back substitution; (L^T)_jj^-1 = W_j.
    ``b`` is (C, N, M)."""
    wrapped = _in_transform(L, b, *Ws)
    y = torch.empty_like(b) if wrapped else torch.empty(b.shape, dtype=b.dtype, device=b.device)
    N = L.shape[-1]
    for j in reversed(range(len(Ws))):
        s = j * B
        rhs = b[:, s : s + B, :]
        if s + B < N:
            rhs = torch.baddbmm(rhs, _T(L[:, s + B :, s : s + B]), y[:, s + B :, :], alpha=-1.0)
        if wrapped:
            y[:, s : s + B, :] = torch.bmm(Ws[j], rhs)
        else:
            torch.bmm(Ws[j], rhs, out=y[:, s : s + B, :])
    return y


def _two_sided_upper_solve(L, Ws, C, B):
    """``L^-T C L^-1`` as two block back substitutions.  The transpose between
    them is made once, as one contiguous copy: substituting into a transposed
    view would read it with a stride of N at every block."""
    X = _upper_solve_blocks(L, Ws, C, B)  # L^-T C
    return _T(_upper_solve_blocks(L, Ws, _T(X).contiguous(), B))  # (L^-T X^T)^T


def _chb_tan_transpose(L, Ws, lbar, B):
    """``A_bar = L^-T Phi(L^T L_bar) L^-1``: the exact transpose of the tangent
    ``dL = L Phi(L^-1 dA L^-T)`` (chol_pallas.py:407-422), Murray's level-3
    adjoint without the symmetrization.  Strict-upper content of ``L_bar``
    cannot reach the output."""
    return _two_sided_upper_solve(L, Ws, _phi(_T(L) @ lbar), B)


def _csl_tan_transpose(L, Ws, y, ybar, sbar, B, need_b=True):
    """Exact transpose of the joint tangent of ``(y = L^-1 b, s = sum log
    L_ii)`` (chol_pallas.py:503-527):

        b_bar = L^-T y_bar
        A_bar = L^-T (-Phi(y_bar y^T) + 1/2 s_bar I) L^-1

    Returns ``(A_bar, b_bar or None)``: the first-order backward pass."""
    bbar = _upper_solve_blocks(L, Ws, ybar, B) if need_b else None
    C = torch.tril(torch.bmm(-ybar, _T(y)))
    if _in_transform(C, sbar):
        C = C + torch.diag_embed(0.5 * (sbar[:, None] - torch.diagonal(C, dim1=-2, dim2=-1)))
    else:
        C.diagonal(dim1=-2, dim2=-1).mul_(0.5).add_(0.5 * sbar[:, None])
    return _two_sided_upper_solve(L, Ws, C, B), bbar


def _tri_adjoint(Ld, C):
    """``L^-T C L^-1`` from differentiable triangular solves (the path of a
    second or higher differentiation)."""
    X = torch.linalg.solve_triangular(_T(Ld), C, upper=True)
    return torch.linalg.solve_triangular(Ld, X, upper=False, left=False)


# ---------------------------------------------------------------------------
# Public functions with their adjoints
# ---------------------------------------------------------------------------


def _chol_parts_fn(a, block_size):
    """``(L, [W_j])`` of ``_chol_blocked_impl`` (the padded flat factor and
    the block inverses) composed of ``chol_inv_block`` and out-of-place
    products, so every transform differentiates them through
    ``_CholInvBlock``'s rules: one launch a block, as the forward.  The path
    of a rule whose result is differentiated again (``ops/_forward.py``)."""
    n = a.shape[-1]
    B, npad = _block_grid(n, block_size)
    flat, _ = _flatten_pad(a, n, npad)
    cols, Ws = [], []  # block column j: (C, N - jB, B), its rows from jB down
    for j in range(flat.shape[-1] // B):
        s = j * B
        panel = flat[:, s:, s : s + B]
        if s:
            left = torch.cat([c[:, s - i * B :, :] for i, c in enumerate(cols)], dim=-1)  # L[s:, :s]
            panel = panel - left @ _T(left[:, :B, :])
        u, w = chol_inv_block(panel[:, :B, :])
        Ws.append(w)
        cols.append(torch.cat([_T(u), panel[:, B:, :] @ w], dim=-2))
    return torch.cat([F.pad(c, (0, 0, i * B, 0)) for i, c in enumerate(cols)], dim=-1), Ws


def _cholesky_fn(a, block_size):
    """The blocked factor of ``a (..., n, n)`` from ``_chol_parts_fn``."""
    return _unflatten_unpad(_chol_parts_fn(a, block_size)[0], a.shape[:-2], a.shape[-1])


def _lower_solve_fn(L, Ws, b, B):
    """``_lower_solve_blocks`` out of place (no ``out=``, no preallocated
    rows), so that ``vmap`` and every transform can go through it: the forward
    mode's solves, where a tangent carries a vmapped axis."""
    ys = []
    for j, w in enumerate(Ws):
        s = j * B
        rhs = b[..., s : s + B, :]
        if s:
            rhs = rhs - L[..., s : s + B, :s] @ torch.cat(ys, dim=-2)
        ys.append(_T(w) @ rhs)
    return torch.cat(ys, dim=-2)


def _two_sided_lower_solve(L, Ws, da, B):
    """``M = L^-1 dA L^-T`` by two block forward substitutions."""
    return _T(_lower_solve_fn(L, Ws, _T(_lower_solve_fn(L, Ws, da, B)), B))


def _flat_rows(t, v, p):
    """A flat ``(v * P, ...)`` tensor of the folded call as ``(v, P, ...)``."""
    return t.reshape((v, p) + tuple(t.shape[1:]))


class _CholeskyBlocked(torch.autograd.Function):
    """``(L, L_flat, *W_j)``: the factor and, not differentiable, the padded
    flat factor and the block inverses the forward computed.

    - Reverse mode: the closed-form transpose ``_chb_tan_transpose`` over the
      saved ``(L, W_j)``; under a second order, differentiable triangular
      solves (any order).
    - Forward mode: ``dL = L Phi(L^-1 dA L^-T)`` (``_chb_tan_fun``,
      chol_pallas.py:394-407), both solves as block substitutions over the
      saved ``W_j`` (no second factorization).
    - ``vmap``: the vmapped axis joins the leading (chain) axes of one call."""

    @staticmethod
    def forward(a, block_size):
        n = a.shape[-1]
        B, npad = _block_grid(n, block_size)
        flat, batch_shape = _flatten_pad(a, n, npad)
        L, Ws = _chol_blocked_impl(flat, B)
        return (_unflatten_unpad(L, batch_shape, n).contiguous(), L, *Ws)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, block_size = inputs
        n = a.shape[-1]
        B, npad = _block_grid(n, block_size)
        ctx.mark_non_differentiable(*output[1:])
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(a, *output[1:])
        ctx.save_for_forward(a, *output[1:])
        ctx.grid = (n, B, npad, a.shape[:-2], block_size)

    @staticmethod
    def backward(ctx, lbar, *_):
        a, L, *Ws = ctx.saved_tensors
        n, B, npad, batch_shape, block_size = ctx.grid
        if lbar is None:
            return None, None
        if differentiated_again(a):  # a second order: differentiable triangular solves
            Ld = _cholesky_fn(a, block_size)
            return _tri_adjoint(Ld, _phi(_T(Ld) @ lbar)), None
        abar = _chb_tan_transpose(L, Ws, _flatten_pad_zero(lbar, npad), B)
        return _unflatten_unpad(abar, batch_shape, n), None

    @staticmethod
    def jvp(ctx, da, _):
        a, L, *Ws = ctx.saved_tensors
        n, B, npad, batch_shape, block_size = ctx.grid
        if differentiated_again(a):  # the coefficients must carry their derivative in a
            L, Ws = _chol_parts_fn(a, block_size)
        dL = L @ _phi(_two_sided_lower_solve(L, Ws, _flatten_pad_zero(da, npad), B))
        return (_unflatten_unpad(dL, batch_shape, n),) + (None,) * (1 + len(Ws))

    @staticmethod
    def vmap(info, in_dims, a, block_size):
        v = info.batch_size
        a = _fold(a, in_dims[0], v)
        outs = _CholeskyBlocked.apply(a, block_size)
        p = outs[1].shape[0] // v
        return (outs[0],) + tuple(_flat_rows(t, v, p) for t in outs[1:]), (0,) * len(outs)


class _CholeskySolveLogdiag(torch.autograd.Function):
    """``(y, s, L_flat, y_flat, *W_j)`` with ``y = L^-1 b``, ``s = sum log
    L_ii``; the last ones (not differentiable) are what the rules below read.

    - Reverse mode: ``_csl_tan_transpose`` over the saved ``(L, W_j, y)``;
      under a second order, differentiable triangular solves.
    - Forward mode: with ``M = L^-1 dA L^-T``, ``dy = L^-1 db - Phi(M) y`` and
      ``ds = tr(M) / 2`` (``_csl_tan_fun``, chol_pallas.py:483), the solves
      over the saved ``W_j``.
    - ``vmap``: the vmapped axis joins the leading axes of one call."""

    @staticmethod
    def forward(a, b, block_size):
        n = a.shape[-1]
        B, npad = _block_grid(n, block_size)
        flat, batch_shape = _flatten_pad(a, n, npad)
        L, Ws = _chol_blocked_impl(flat, B)
        y = _lower_solve_blocks(L, Ws, _flatten_pad_zero(b, npad, cols_only=True), B)
        # the padded tail has unit diagonal: its logarithm adds exactly 0
        s = torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
        y_out = y.reshape(tuple(batch_shape) + y.shape[-2:])[..., :n, :].contiguous()
        return (y_out, s.reshape(tuple(batch_shape)), L, y, *Ws)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, b, block_size = inputs
        n = a.shape[-1]
        B, npad = _block_grid(n, block_size)
        ctx.mark_non_differentiable(*output[2:])
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(a, b, *output[2:])
        ctx.save_for_forward(a, b, *output[2:])
        ctx.grid = (n, B, npad, a.shape[:-2], block_size)

    @staticmethod
    def backward(ctx, ybar, sbar, *_):
        a, b, L, y, *Ws = ctx.saved_tensors
        n, B, npad, batch_shape, block_size = ctx.grid
        if ybar is None and sbar is None:
            return None, None, None
        if ybar is None:
            ybar = torch.zeros(tuple(batch_shape) + (n, b.shape[-1]), dtype=a.dtype, device=a.device)
        if sbar is None:
            sbar = torch.zeros(tuple(batch_shape), dtype=a.dtype, device=a.device)
        need_b = ctx.needs_input_grad[1]
        if differentiated_again(a, b):  # a second order: differentiable triangular solves
            Ld = _cholesky_fn(a, block_size)
            yd = torch.linalg.solve_triangular(Ld, b, upper=False)
            eye = torch.eye(n, dtype=a.dtype, device=a.device)
            abar = _tri_adjoint(Ld, -_phi(ybar @ _T(yd)) + 0.5 * sbar[..., None, None] * eye)
            bbar = torch.linalg.solve_triangular(_T(Ld), ybar, upper=True) if need_b else None
            return abar, bbar, None
        abar, bbar = _csl_tan_transpose(
            L, Ws, y, _flatten_pad_zero(ybar, npad, cols_only=True), sbar.reshape(-1), B, need_b
        )
        if need_b:
            bbar = bbar.reshape(tuple(batch_shape) + bbar.shape[-2:])[..., :n, :]
        return _unflatten_unpad(abar, batch_shape, n), bbar, None

    @staticmethod
    def jvp(ctx, da, db, _):
        a, b, L, y, *Ws = ctx.saved_tensors
        n, B, npad, batch_shape, block_size = ctx.grid
        if differentiated_again(a, b):  # the coefficients must carry their derivative in a, b
            L, Ws = _chol_parts_fn(a, block_size)
            y = _lower_solve_fn(L, Ws, _flatten_pad_zero(b, npad, cols_only=True), B)
        dy = ds = None
        if db is not None:
            dy = _lower_solve_fn(L, Ws, _flatten_pad_zero(db, npad, cols_only=True), B)
        if da is not None:
            M = _two_sided_lower_solve(L, Ws, _flatten_pad_zero(da, npad), B)
            dy = -_phi(M) @ y if dy is None else dy - _phi(M) @ y
            ds = 0.5 * torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
        else:
            ds = torch.zeros(L.shape[:1], dtype=L.dtype, device=L.device)
        dy = dy.reshape(tuple(batch_shape) + dy.shape[-2:])[..., :n, :]
        return (dy, ds.reshape(tuple(batch_shape))) + (None,) * (2 + len(Ws))

    @staticmethod
    def vmap(info, in_dims, a, b, block_size):
        v = info.batch_size
        a, b = _fold(a, in_dims[0], v), _fold(b, in_dims[1], v)
        outs = _CholeskySolveLogdiag.apply(a, b, block_size)
        p = outs[2].shape[0] // v
        return outs[:2] + tuple(_flat_rows(t, v, p) for t in outs[2:]), (0,) * len(outs)


def _block_size(block_size):
    return get_config().cholesky_block_size if block_size is None else int(block_size)


def cholesky_blocked(a, block_size=None):
    """Lower Cholesky factor of ``a (..., n, n)`` through the diagonal-block
    kernel and float32 matrix products; all leading axes (the chains) go into
    each kernel launch.  ``block_size`` defaults to
    ``get_config().cholesky_block_size``.  A matrix that is not positive
    definite gives NaN, never finite garbage.  ref: chol_pallas.py:570."""
    return _CholeskyBlocked.apply(a, _block_size(block_size))[0]


def cholesky_solve_logdiag(a, b, block_size=None):
    """``(L^-1 b, sum log L_ii)`` with ``L = chol(a)``, in one blocked
    factorization: the kernel's block inverses are reused for the solve and
    for every triangular solve of the joint adjoint.  This is the whole O(n^3)
    part of a multi-normal / marginal-GP log density.  ``a`` is
    ``(..., n, n)``; ``b`` is ``(..., n)`` or ``(..., n, m)`` and may lack the
    leading axes of ``a`` (chains that share one data vector): it is broadcast
    and its cotangent summed back.  ref: chol_pallas.py:554."""
    # a vector: (n,), or the JAX rule b.ndim == a.ndim - 1 with a's leading axes
    vec = b.ndim == 1 or (b.ndim == a.ndim - 1 and tuple(b.shape) == tuple(a.shape[:-1]))
    if vec:
        b = b[..., None]
    b = b.expand(tuple(a.shape[:-2]) + tuple(b.shape[-2:]))
    y, s = _CholeskySolveLogdiag.apply(a, b, _block_size(block_size))[:2]
    return (y[..., 0] if vec else y), s
