"""Cholesky-based dispatchers (counterpart: ``math_tpu/ops/cholesky.py``,
the names without ``_tpu``).

``spd_solve_logdiag`` and ``cholesky_decompose`` always go through the blocked
factorization of ``ops/chol_blocked.py``, at every size and on every device:
only its innermost diagonal-block function chooses between the hand-written
kernel (a CUDA tensor) and its plain version (a CPU tensor).  There is no size
threshold; the JAX package's threshold and its scan formulations
(``cholesky_blocked``, ``_chol_unblocked``, ``_tri_inv_unblocked``) answer a
compile pathology of another compiler and have no twin.

The ``*_reference`` functions are whole-function references by
``torch.linalg``, for tests and timing only; the port never calls them.

The JAX package's names ``cholesky_decompose_tpu``,
``mdivide_left_tri_low_tpu`` and ``spd_solve_logdiag_tpu`` are aliases of the
functions above: they take the reference's ``threshold`` and ignore it.
``mdivide_left_tri_low_blocked`` is the reference's blocked forward
substitution.
"""

from __future__ import annotations

import torch

from math_tpu_torch.ops.chol_blocked import cholesky_blocked, cholesky_solve_logdiag


def mdivide_left_tri_low(L, b):
    """``L^-1 b`` for lower-triangular ``L (..., n, n)``; ``b`` is ``(..., n)``
    or ``(..., n, m)`` (ref: mdivide_left_tri_low.hpp).  Holds no hand-written
    kernel in either package."""
    vec = b.ndim == L.ndim - 1
    if vec:
        b = b[..., None]
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return y[..., 0] if vec else y


def spd_solve_logdiag(a, b, block_size=None):
    """``(chol(a)^-1 b, sum log diag chol(a))``: the O(n^3) core of a
    multi-normal / marginal-GP log density, from one blocked factorization
    whose block inverses are reused for the solve and the joint adjoint.
    ``b`` may lack the leading (chain) axes of ``a``.
    ref: multi_normal_lpdf.hpp's LDLT reuse."""
    return cholesky_solve_logdiag(a, b, block_size=block_size)


def cholesky_decompose(a, block_size=None):
    """Lower Cholesky factor of ``a (..., n, n)`` (ref:
    cholesky_decompose.hpp); NaN for a matrix that is not positive definite."""
    return cholesky_blocked(a, block_size=block_size)


def mdivide_left_tri_low_blocked(L, b, block_size: int = 256):
    """``L^-1 b`` for lower-triangular ``L`` by blocked forward substitution
    (ref: mdivide_left_tri_low.hpp; the JAX package's function of this name):
    block j solves ``L_jj y_j = b_j - L_j,<j y_<j``; operands padded to whole
    blocks with a unit diagonal.  Differentiable through autograd."""
    vec = b.ndim == L.ndim - 1
    if vec:
        b = b[..., None]
    n = L.shape[-1]
    nb = max(1, -(-n // block_size))
    npad = nb * block_size - n
    if npad:
        unit_tail = torch.cat([torch.zeros(n, dtype=L.dtype, device=L.device), torch.ones(npad, dtype=L.dtype, device=L.device)])
        L = torch.nn.functional.pad(L, (0, npad, 0, npad)) + torch.diag(unit_tail)
        b = torch.nn.functional.pad(b, (0, 0, 0, npad))
    ys = []
    for j in range(nb):
        s = j * block_size
        rhs = b[..., s:s + block_size, :]
        if ys:
            rhs = rhs - L[..., s:s + block_size, :s] @ torch.cat(ys, dim=-2)
        ys.append(torch.linalg.solve_triangular(L[..., s:s + block_size, s:s + block_size], rhs, upper=False))
    y = torch.cat(ys, dim=-2)[..., :n, :]
    return y[..., 0] if vec else y


def cholesky_decompose_tpu(a, threshold=None, block_size=None):
    """``cholesky_decompose`` under the JAX package's name (no threshold here)."""
    return cholesky_decompose(a, block_size=block_size)


def mdivide_left_tri_low_tpu(L, b, threshold=None, block_size=None):
    """``mdivide_left_tri_low`` under the JAX package's name (no threshold here)."""
    return mdivide_left_tri_low(L, b)


def spd_solve_logdiag_tpu(a, b, threshold=None, block_size=None):
    """``spd_solve_logdiag`` under the JAX package's name (no threshold here)."""
    return spd_solve_logdiag(a, b, block_size=block_size)


def spd_solve_logdiag_reference(a, b):
    """``spd_solve_logdiag`` by ``torch.linalg`` (``b`` broadcast the same
    way); raises on a matrix that is not positive definite."""
    vec = b.ndim == 1 or (b.ndim == a.ndim - 1 and tuple(b.shape) == tuple(a.shape[:-1]))
    if vec:
        b = b[..., None]
    b = b.expand(tuple(a.shape[:-2]) + tuple(b.shape[-2:]))
    L = torch.linalg.cholesky(a)
    y = torch.linalg.solve_triangular(L, b, upper=False)
    s = torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    return (y[..., 0] if vec else y), s


def cholesky_decompose_reference(a):
    """``cholesky_decompose`` by ``torch.linalg.cholesky``."""
    return torch.linalg.cholesky(a)
