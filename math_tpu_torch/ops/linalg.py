"""Linear algebra under Stan Math names.

Counterpart: ``math_tpu/ops/linalg.py`` (reference: ``prim/mat/fun/``).
Every factorization (``cholesky_decompose``, the ``*_spd`` and ``ldlt``
functions, ``inverse_spd``, ``chol2inv``'s callers) goes through
``ops.cholesky.cholesky_decompose``: the blocked path, with the hand-written
block kernel on a CUDA tensor and its plain version on a CPU tensor, at every
size.  A matrix that is not positive definite gives NaN there, as
``jnp.linalg.cholesky`` does; ``torch.linalg.cholesky`` would raise.  The rest
are ``torch.linalg`` / ``torch.matmul`` calls, as the JAX versions are
``jnp.linalg`` calls outside any Pallas kernel.  Leading (chain) axes are
carried through wherever the JAX function broadcasts.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from math_tpu_torch.ops import cholesky as _cholesky

__all__ = ["cholesky_decompose", "mdivide_left", "mdivide_right", "mdivide_left_tri_low",
    "mdivide_right_tri_low", "mdivide_left_spd", "mdivide_left_ldlt", "ldlt_factor", "log_determinant",
    "log_determinant_spd", "log_determinant_ldlt", "masked_diagonal", "determinant", "inverse",
    "inverse_spd", "quad_form", "quad_form_sym", "quad_form_diag", "trace_quad_form",
    "trace_inv_quad_form_ldlt", "trace_gen_quad_form", "multiply_lower_tri_self_transpose", "tcrossprod",
    "crossprod", "matrix_exp", "scale_matrix_exp_multiply", "matrix_exp_multiply", "matrix_power",
    "eigenvalues_sym", "eigenvectors_sym", "singular_values", "qr_Q", "qr_R", "qr_thin_Q", "qr_thin_R",
    "csr_matrix_times_vector", "dot_self", "columns_dot_self", "rows_dot_self", "distance",
    "squared_distance", "mdivide_left_tri", "mdivide_right_tri", "mdivide_right_ldlt", "mdivide_right_spd",
    "trace_gen_inv_quad_form_ldlt", "chol2inv", "matrix_exp_2x2", "csr_extract_w", "csr_extract_v",
    "csr_extract_u", "csr_to_dense_matrix", "csr_u_to_z", "autocorrelation", "autocovariance",
    "cumulative_sum", "sort_indices_asc", "sort_indices_desc", "rank", "softmax", "log_softmax",
]



def _t(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _solve_tri(a, b, lower):
    """``a^-1 b`` for triangular ``a``; ``b`` may be a vector (``(..., n)``
    with ``a``'s leading axes, or ``(n,)``), as ``jax.scipy.linalg.solve_triangular``."""
    vec = b.ndim == a.ndim - 1
    x = torch.linalg.solve_triangular(a, b[..., None] if vec else b, upper=not lower)
    return x[..., 0] if vec else x


def _cho_solve(L, b):
    """``A^-1 b`` from ``A``'s lower Cholesky factor (``jax.scipy.linalg.cho_solve``)."""
    return _solve_tri(L.mT, _solve_tri(L, b, True), False)


def cholesky_decompose(a):
    """Lower Cholesky factor (ref: cholesky_decompose.hpp); NaN for a matrix
    that is not positive definite."""
    return _cholesky.cholesky_decompose(_t(a))


def mdivide_left(a, b):
    """A \\ b (ref: mdivide_left.hpp)."""
    a, b = _t(a), _t(b)
    return torch.linalg.solve(a, b)


def mdivide_right(b, a):
    """b / A  i.e. b A^-1 (ref: mdivide_right.hpp)."""
    return torch.linalg.solve(_t(a).mT, _t(b).mT).mT


def mdivide_left_tri_low(L, b):
    """L \\ b with L lower-triangular (ref: mdivide_left_tri_low.hpp)."""
    return _cholesky.mdivide_left_tri_low(_t(L), _t(b))


def mdivide_right_tri_low(b, L):
    return _solve_tri(_t(L).mT, _t(b).mT, False).mT


def mdivide_left_spd(a, b):
    """SPD solve via Cholesky (ref: mdivide_left_spd.hpp)."""
    return _cho_solve(cholesky_decompose(a), _t(b))


def mdivide_left_ldlt(ldlt, b):
    """Solve using a cached factorization (ref: LDLT_factor usage)."""
    return _cho_solve(ldlt[0], _t(b))


def ldlt_factor(a):
    """Cached SPD factorization handle (ref: LDLT_factor.hpp): the lower
    Cholesky factor, reused across solves and log-determinants as the
    reference caches its LDLT (``rev/mat/fun/LDLT_factor.hpp``)."""
    return (cholesky_decompose(a), True)


def log_determinant(a):
    """log |det A| (ref: log_determinant.hpp)."""
    return torch.linalg.slogdet(_t(a))[1]


def log_determinant_spd(a):
    """log det of SPD matrix via Cholesky (ref: log_determinant_spd.hpp)."""
    L = cholesky_decompose(a)
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)


def log_determinant_ldlt(ldlt):
    L, _ = ldlt
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)


def masked_diagonal(m):
    """Diagonal of (..., n, n) as a masked row-sum, value-identical to
    ``torch.diagonal`` (the JAX package's answer to a TPU scatter; kept for
    the name)."""
    m = _t(m)
    return torch.sum(m * torch.eye(m.shape[-1], dtype=m.dtype, device=m.device), dim=-1)


def determinant(a):
    return torch.linalg.det(_t(a))


def inverse(a):
    return torch.linalg.inv(_t(a))


def _eye_like(L):
    return torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand(L.shape)


def inverse_spd(a):
    return chol2inv(cholesky_decompose(a))


def quad_form(a, b):
    """b^T A b (ref: quad_form.hpp)."""
    a, b = _t(a), _t(b)
    if b.ndim == 1:
        return b @ a @ b
    return b.mT @ a @ b


def quad_form_sym(a, b):
    a, b = _t(a), _t(b)
    a = 0.5 * (a + a.mT)
    if b.ndim == 1:
        return b @ a @ b
    out = b.mT @ a @ b
    return 0.5 * (out + out.mT)


def quad_form_diag(a, v):
    """diag(v) A diag(v) (ref: quad_form_diag.hpp)."""
    a, v = _t(a), _t(v)
    return a * v[..., :, None] * v[..., None, :]


def trace_quad_form(a, b):
    """tr(B^T A B) (ref: trace_quad_form.hpp)."""
    a, b = _t(a), _t(b)
    return torch.einsum("...ij,...ik,...kj->...", b, a, b)


def trace_inv_quad_form_ldlt(ldlt, b):
    """tr(B^T A^-1 B) with cached factor (ref: trace_inv_quad_form_ldlt.hpp)."""
    return torch.sum(torch.square(_solve_tri(ldlt[0], _t(b), True)))


def trace_gen_quad_form(d, a, b):
    """tr(D B^T A B) (ref: trace_gen_quad_form.hpp)."""
    return torch.einsum("...ij,...ki,...kl,...lj->...", _t(d), _t(b), _t(a), _t(b))


def multiply_lower_tri_self_transpose(L):
    """L L^T (ref: multiply_lower_tri_self_transpose.hpp)."""
    L = torch.tril(_t(L))
    return L @ L.mT


def tcrossprod(a):
    a = _t(a)
    return a @ a.mT


def crossprod(a):
    a = _t(a)
    return a.mT @ a


def matrix_exp(a):
    """Matrix exponential (ref: matrix_exp.hpp, Pade + scaling/squaring)."""
    return torch.linalg.matrix_exp(_t(a))


def _l1(m):
    return torch.max(torch.sum(torch.abs(m), dim=-2))


def _expm_action_core(t, a, b, s, m_max=55):
    """s substeps of a truncated-Taylor exp((t/s) A) action on B.

    The Al-Mohy/Higham action recipe (ref:
    ``prim/mat/fun/matrix_exp_action_handler.hpp``): shift by the trace
    mean, split t into s substeps so each truncated Taylor series
    converges fast, and never form exp(A).  At most ``m_max`` terms a
    substep; the series stops after the first term whose 1-norm falls below
    2 eps of the sum's (the JAX package runs all ``m_max`` and freezes the
    sum from there: the same result).
    """
    n = a.shape[-1]
    mu = torch.diagonal(a, dim1=-2, dim2=-1).sum(-1) / n
    a_sh = a - mu * torch.eye(n, dtype=a.dtype, device=a.device)
    eta = torch.exp(t * mu / s)
    tol = 2.0 * torch.finfo(a.dtype).eps
    out = b
    for _ in range(s):
        term, acc = out, out
        for k in range(1, m_max + 1):
            new = (t / s) * (a_sh @ term) / k
            done = bool(_l1(new) <= tol * _l1(acc))
            acc = acc + new
            term = new
            if done:
                break
        out = eta * acc
    return out


# per-substep taylor radius: conservative theta for m_max=55 double
# precision terms (Al-Mohy/Higham table); the reference's handler tunes
# (m*, s) jointly, here m is fixed and only s adapts.
_EXPM_ACTION_THETA = 4.5


def scale_matrix_exp_multiply(t, a, b, max_norm=None):
    """exp(t A) B without forming exp(t A) (ref:
    scale_matrix_exp_multiply.hpp + matrix_exp_action_handler.hpp).

    The substep count s comes from ||t A||_1 of the values at hand (every
    tensor is concrete here: the JAX package's traced-argument branches,
    ``max_norm=`` and the dense fallback, have nothing to decide;
    ``max_norm`` stays in the signature and is not read).
    """
    a, b = _t(a), _t(b)
    dt = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dt), b.to(dt)
    t = torch.as_tensor(t, dtype=dt, device=a.device)
    norm = float(_l1((t * a).detach()))
    if not math.isfinite(norm):
        return torch.full(b.shape, math.nan, dtype=dt, device=b.device)
    s = max(1, int(math.ceil(norm / _EXPM_ACTION_THETA)))
    return _expm_action_core(t, a, b, s)


def matrix_exp_multiply(a, b, max_norm=None):
    """exp(A) B via the action algorithm (ref: matrix_exp_multiply.hpp,
    which delegates to matrix_exp_action_handler.hpp)."""
    return scale_matrix_exp_multiply(1.0, a, b, max_norm=max_norm)


def matrix_power(a, n):
    return torch.linalg.matrix_power(_t(a), n)


def eigenvalues_sym(a):
    return torch.linalg.eigvalsh(_t(a))


def eigenvectors_sym(a):
    return torch.linalg.eigh(_t(a))[1]


def singular_values(a):
    return torch.linalg.svdvals(_t(a))


def qr_Q(a):
    return torch.linalg.qr(_t(a), mode="reduced")[0]


def qr_R(a):
    return torch.linalg.qr(_t(a), mode="reduced")[1]


def qr_thin_Q(a):
    return torch.linalg.qr(_t(a), mode="reduced")[0]


def qr_thin_R(a):
    return torch.linalg.qr(_t(a), mode="reduced")[1]


def _csr_rows(u, nnz, device):
    """0-based row of each of ``nnz`` stored values from 1-based row-start
    pointers ``u``."""
    u0 = torch.as_tensor(np.asarray(u), dtype=torch.long, device=device) - 1
    return torch.searchsorted(u0, torch.arange(nnz, device=device), right=True) - 1


def csr_matrix_times_vector(m, n, w, v, u, b):
    """Sparse (CSR) matrix-vector product (ref: csr_matrix_times_vector.hpp).

    Args match Stan: m rows, n cols, w values, v 1-based column indices,
    u 1-based row-start pointers, b dense vector.  The products summed per
    row by ``index_add`` (off every sampler path here)."""
    w, b = _t(w), _t(b)
    v0 = torch.as_tensor(np.asarray(v), dtype=torch.long, device=w.device) - 1
    rows = _csr_rows(u, w.shape[0], w.device)
    prod = w * b[v0]
    return torch.zeros(m, dtype=prod.dtype, device=prod.device).index_add(0, rows, prod)


def dot_self(x):
    return torch.sum(torch.square(_t(x)), dim=-1)


def columns_dot_self(x):
    return torch.sum(torch.square(_t(x)), dim=-2)


def rows_dot_self(x):
    return torch.sum(torch.square(_t(x)), dim=-1)


def distance(a, b):
    return torch.sqrt(torch.sum(torch.square(_t(a) - _t(b)), dim=-1))


def squared_distance(a, b):
    return torch.sum(torch.square(_t(a) - _t(b)), dim=-1)


# --- triangular/factorized solve variants (ref: mdivide_left_tri.hpp,
# --- mdivide_right_tri.hpp, mdivide_right_ldlt.hpp, mdivide_right_spd.hpp) --


def mdivide_left_tri(a, b=None, lower: bool = True):
    """Triangular solve A \\ b; b=None inverts A (ref: mdivide_left_tri.hpp,
    which is templated on the Eigen view; ``lower`` replaces the template
    arg)."""
    a = _t(a)
    return _solve_tri(a, _eye_like(a) if b is None else _t(b), lower)


def mdivide_right_tri(b, a, lower: bool = True):
    """b A^-1 with triangular A (ref: mdivide_right_tri.hpp)."""
    return _solve_tri(_t(a).mT, _t(b).mT, not lower).mT


def mdivide_right_ldlt(b, ldlt):
    """b A^-1 from a cached factorization (ref: mdivide_right_ldlt.hpp)."""
    return _cho_solve(ldlt[0], _t(b).mT).mT


def mdivide_right_spd(b, a):
    """b A^-1 with SPD A (ref: mdivide_right_spd.hpp)."""
    return mdivide_right_ldlt(b, ldlt_factor(a))


def trace_gen_inv_quad_form_ldlt(d, ldlt, b):
    """trace(D B^T A^-1 B) (ref: trace_gen_inv_quad_form_ldlt.hpp)."""
    b = _t(b)
    sol = _cho_solve(ldlt[0], b)
    return torch.diagonal(_t(d) @ b.mT @ sol, dim1=-2, dim2=-1).sum(-1)


def chol2inv(L):
    """Inverse of A from its Cholesky factor L (ref: chol2inv.hpp)."""
    L = _t(L)
    return _cho_solve(L, _eye_like(L))


def matrix_exp_2x2(a):
    """Closed-form 2x2 matrix exponential (ref: matrix_exp_2x2.hpp).

    For A = [[a, b], [c, d]], (delta/2)^2 = (a-d)^2/4 + bc; branchless over
    its sign (cosh/sinh against cos/sin, sinhc -> 1 as s -> 0).
    """
    a = _t(a)
    a11, a12 = a[..., 0, 0], a[..., 0, 1]
    a21, a22 = a[..., 1, 0], a[..., 1, 1]
    half_tr = 0.5 * (a11 + a22)
    det_like = 0.25 * (a11 - a22) ** 2 + a12 * a21  # (delta/2)^2
    s = torch.sqrt(torch.abs(det_like))
    s_safe = torch.clamp_min(s, 1e-30)
    pos = det_like >= 0
    c = torch.where(pos, torch.cosh(s), torch.cos(s))
    sc = torch.where(pos, torch.sinh(s) / s_safe, torch.sin(s) / s_safe)
    sc = torch.where(s < 1e-8, torch.ones_like(sc), sc)
    e = torch.exp(half_tr)
    m11 = e * (c + 0.5 * (a11 - a22) * sc)
    m22 = e * (c - 0.5 * (a11 - a22) * sc)
    m12 = e * a12 * sc
    m21 = e * a21 * sc
    return torch.stack([torch.stack([m11, m12], dim=-1), torch.stack([m21, m22], dim=-1)], dim=-2)


# --- CSR accessors (ref: csr_extract_{u,v,w}.hpp, csr_to_dense_matrix.hpp,
# --- csr_u_to_z.hpp); the dense nnz = m*n layout of the JAX package. --------


def csr_extract_w(a):
    """Values of the dense matrix in CSR (row-major) order."""
    a = _t(a)
    return a.reshape(*a.shape[:-2], -1)


def csr_extract_v(a):
    """1-based column indices, row-major (ref: csr_extract_v.hpp)."""
    m, n = a.shape[-2], a.shape[-1]
    return torch.arange(1, n + 1, dtype=torch.int32).repeat(m)


def csr_extract_u(a):
    """1-based row start pointers (ref: csr_extract_u.hpp)."""
    m, n = a.shape[-2], a.shape[-1]
    return torch.arange(0, m + 1, dtype=torch.int32) * n + 1


def csr_to_dense_matrix(m, n, w, v, u):
    """Rebuild the dense matrix from CSR components (ref:
    csr_to_dense_matrix.hpp)."""
    w = _t(w)
    v0 = torch.as_tensor(np.asarray(v), dtype=torch.long, device=w.device) - 1
    rows = _csr_rows(u, w.shape[0], w.device)
    return torch.zeros((m, n), dtype=w.dtype, device=w.device).index_put((rows, v0), w, accumulate=True)


def csr_u_to_z(u, i):
    """Number of non-zeros in row i (1-based) (ref: csr_u_to_z.hpp)."""
    u = torch.as_tensor(np.asarray(u), dtype=torch.int32)
    return u[i] - u[i - 1]


# --- sequence statistics (ref: autocorrelation.hpp, autocovariance.hpp,
# --- cumulative_sum.hpp, sort_indices_*.hpp, rank.hpp) ----------------------


def autocorrelation(y):
    """Autocorrelations at lags 0..N-1 via FFT (ref: autocorrelation.hpp:
    centered zero-padded FFT, lag-k term / (N - k), normalized by lag 0)."""
    y = _t(y)
    n = y.shape[-1]
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    yc = y - torch.mean(y, dim=-1, keepdim=True)
    f = torch.fft.rfft(yc, nfft, dim=-1)
    ac = torch.fft.irfft(f * torch.conj(f), nfft, dim=-1)[..., :n]
    ac = ac / (n - torch.arange(n, dtype=y.dtype, device=y.device))
    return ac / ac[..., :1]


def autocovariance(y):
    """Autocovariances at lags 0..N-1 (ref: autocovariance.hpp: the
    autocorrelation scaled by the population variance)."""
    y = _t(y)
    return autocorrelation(y) * torch.var(y, dim=-1, keepdim=True, correction=0)


def cumulative_sum(x):
    """Running sum (ref: cumulative_sum.hpp)."""
    return torch.cumsum(_t(x), dim=-1)


def sort_indices_asc(x):
    """1-based ascending sort permutation (ref: sort_indices_asc.hpp)."""
    return torch.argsort(_t(x), dim=-1, stable=True) + 1


def sort_indices_desc(x):
    """1-based descending sort permutation (ref: sort_indices_desc.hpp)."""
    return torch.argsort(-_t(x), dim=-1, stable=True) + 1


def rank(x, s):
    """Number of components strictly smaller than x[s] (1-based s)
    (ref: rank.hpp)."""
    x = _t(x)
    return torch.sum(x < x[..., s - 1])


# --- softmax family (ref: softmax.hpp, log_softmax.hpp) ---------------------


def softmax(x):
    """exp(x) / sum(exp(x)) along the last axis (ref: softmax.hpp)."""
    return torch.softmax(_t(x), dim=-1)


def log_softmax(x):
    """x - log_sum_exp(x) along the last axis (ref: log_softmax.hpp)."""
    return torch.log_softmax(_t(x), dim=-1)
