"""Matrix-valued constraint transforms.

Counterpart: ``math_tpu/transforms/matrix.py`` (reference:
``prim/mat/fun/{cholesky_corr,cholesky_factor,corr_matrix,
cov_matrix}_constrain.hpp`` and ``read_corr_L.hpp``).  The reference's
sequential row/column loops are exclusive-cumprod formulations: for both the
row-major (cholesky_corr) and the C-vine column-major (corr_matrix)
orderings, the "remaining length" term is

    W[r, c] = prod_{l < c} (1 - Z[r, l]^2)   (Z strictly lower triangular)

so L = Z * sqrt(W) off-diagonal and diag(L) = sqrt(W[r, r]).

Leading axes of ``x`` (chains) are carried through; the ``_lp`` variants sum
the log absolute Jacobian determinant over every axis after the first
``batch_ndims`` (0: the scalar the JAX function returns; 1: one value per
chain).  Triangles are written out of place (``_fill``: ``index_put`` of
unique indices into a fresh zero tensor), so no tensor autograd has saved is
written into, and the backward adds nothing twice.  Every factorization (the
``free`` functions) goes through ``ops.cholesky.cholesky_decompose``, the
blocked path with the hand-written block kernel on a CUDA tensor; a matrix
that is not positive definite gives NaN there.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from math_tpu_torch.ops.cholesky import cholesky_decompose
from math_tpu_torch.special import LOG_TWO, log1m
from math_tpu_torch.utils.batch import plain_tensor, sum_event


def _tril_rowmajor(k: int):
    """Strict-lower-triangle indices in row-major order (Stan cholesky_corr)."""
    return np.tril_indices(k, -1)


def _tril_colmajor(k: int):
    """Strict-lower-triangle indices in column-major order (Stan C-vine CPCs)."""
    r, c = np.triu_indices(k, 1)
    return c, r


@functools.lru_cache(maxsize=256)
def _const(values, dtype, device):
    """A tuple of host constants (indices, weights, masks) as a tensor on
    ``device``, made once (``plain_tensor``: kept out of any transform)."""
    return plain_tensor(torch.as_tensor(values, dtype=dtype, device=device))


def _flat(rows, cols, n, device):
    """Flat indices ``rows * n + cols`` of an ``(m, n)`` matrix."""
    return _const(tuple((np.asarray(rows) * n + np.asarray(cols)).tolist()), torch.long, device)


def _pick(x, positions):
    """``x[..., positions]`` for host integer ``positions``."""
    return x.index_select(-1, _const(tuple(np.asarray(positions).tolist()), torch.long, x.device))


def _mask(mask, device):
    return _const(tuple(map(tuple, mask.tolist())), torch.bool, device)


def _fill(vals, rows, cols, m, n):
    """``(..., len(rows)) -> (..., m, n)``: ``vals`` at ``(rows, cols)``,
    zeros elsewhere (the JAX package's ``.at[..., rows, cols].set``)."""
    moved = vals.movedim(-1, 0)
    out = moved.new_zeros((m * n,) + tuple(moved.shape[1:])).index_put((_flat(rows, cols, n, vals.device),), moved)
    return out.movedim(0, -1).reshape(tuple(vals.shape[:-1]) + (m, n))


def _gather(a, rows, cols):
    """``a[..., rows, cols]`` for ``a (..., m, n)``."""
    return a.reshape(tuple(a.shape[:-2]) + (-1,)).index_select(-1, _flat(rows, cols, a.shape[-1], a.device))


def _excl_cumprod(a):
    """Exclusive cumprod along the last axis: out[..., j] = prod_{l<j} a[..., l]."""
    return torch.cat([torch.ones_like(a[..., :1]), torch.cumprod(a[..., :-1], dim=-1)], dim=-1)


def _corr_chol_from_z(zmat):
    """L from a strictly-lower matrix of partial correlations z."""
    k = zmat.shape[-1]
    a = 1.0 - torch.square(zmat)  # == 1 off the strict lower triangle (z=0 there)
    w = _excl_cumprod(a)
    low = torch.where(_mask(np.tri(k, k, -1, dtype=bool), zmat.device), zmat * torch.sqrt(w), 0.0)
    diag = torch.sqrt(torch.diagonal(w, dim1=-2, dim2=-1))
    return low + torch.diag_embed(diag), w


def _remaining_z(L):
    """z = L / sqrt(W), W[r, c] = 1 - sum_{l<c} L[r, l]^2 (the inverse of
    ``_corr_chol_from_z``)."""
    s = torch.cat([torch.zeros_like(L[..., :1]), torch.cumsum(torch.square(L[..., :-1]), dim=-1)], dim=-1)
    return L / torch.sqrt(torch.clamp_min(1.0 - s, 1e-300))


# --- cholesky_corr (ref: cholesky_corr_constrain.hpp) -----------------------


def cholesky_corr_constrain(x, k: int):
    rows, cols = _tril_rowmajor(k)
    return _corr_chol_from_z(_fill(torch.tanh(x), rows, cols, k, k))[0]


def cholesky_corr_constrain_lp(x, k: int, *, batch_ndims=0):
    z = torch.tanh(x)
    rows, cols = _tril_rowmajor(k)
    L, w = _corr_chol_from_z(_fill(z, rows, cols, k, k))
    # corr_constrain jacobian: sum log(1 - z^2)
    lp = sum_event(log1m(torch.square(z)), batch_ndims)
    # cholesky part (ref: cholesky_corr_constrain.hpp:70-73): for each row i,
    # columns j = 1..i-1 contribute 0.5*log(1 - sum_sqs) = 0.5*log W[i, j].
    jj, ii = np.meshgrid(np.arange(k), np.arange(k))
    mask = _mask((jj >= 1) & (jj < ii), x.device)
    lp = lp + 0.5 * sum_event(torch.where(mask, torch.log(torch.clamp_min(w, 1e-300)), 0.0), batch_ndims)
    return L, lp


def cholesky_corr_free(L, k: int):
    """Invert: W[r,c] = 1 - sum_{l<c} L[r,l]^2, z = L/sqrt(W) (strict lower)."""
    rows, cols = _tril_rowmajor(k)
    return torch.atanh(_gather(_remaining_z(torch.as_tensor(L)), rows, cols))


# --- corr_matrix via C-vine CPCs (ref: corr_matrix_constrain, read_corr_L) --


def _read_corr_L(cpc_vec, k: int):
    rows, cols = _tril_colmajor(k)
    return _corr_chol_from_z(_fill(cpc_vec, rows, cols, k, k))


def _cpc_weights(k, like):
    """read_corr_L's Jacobian weight of each CPC (ref: read_corr_L.hpp:95-102):
    the CPC in 0-indexed column c gets (K - c - 2); columns 0..K-3 only."""
    _, cols = _tril_colmajor(k)
    return _const(tuple(np.maximum(k - cols - 2, 0).tolist()), like.dtype, like.device)


def corr_matrix_constrain(x, k: int):
    L, _ = _read_corr_L(torch.tanh(x), k)
    return L @ L.mT


def corr_matrix_constrain_lp(x, k: int, *, batch_ndims=0):
    z = torch.tanh(x)
    # corr_constrain jacobian per CPC
    lz = log1m(torch.square(z))
    lp = sum_event(lz, batch_ndims)
    L, _ = _read_corr_L(z, k)
    lp = lp + 0.5 * sum_event(_cpc_weights(k, z) * lz, batch_ndims)
    return L @ L.mT, lp


def corr_matrix_free(y, k: int):
    rows, cols = _tril_colmajor(k)
    return torch.atanh(_gather(_remaining_z(cholesky_decompose(torch.as_tensor(y))), rows, cols))


# --- cov_matrix: y = L L^T, L lower-tri w/ exp diag (ref: cov_matrix_*) -----


def _with_exp_diag(x, rows, cols, m, n):
    """``(L, d)``: the free vector ``x`` laid out at ``(rows, cols)`` of an
    ``(m, n)`` matrix, its diagonal entries ``d`` exponentiated."""
    on = rows == cols
    d = _pick(x, np.flatnonzero(on))
    vals = torch.cat([_pick(x, np.flatnonzero(~on)), torch.exp(d)], dim=-1)
    order = np.concatenate([np.flatnonzero(~on), np.flatnonzero(on)])
    return _fill(vals, rows[order], cols[order], m, n), d


def _free_log_diag(L, rows, cols):
    """``L[..., rows, cols]`` with the diagonal entries replaced by their
    logarithms (the inverse of ``_with_exp_diag``)."""
    on = rows == cols
    order = np.concatenate([np.flatnonzero(~on), np.flatnonzero(on)])
    vals = torch.cat([_gather(L, rows[~on], cols[~on]), torch.log(_gather(L, rows[on], cols[on]))], dim=-1)
    return _pick(vals, np.argsort(order))


def _cov_chol(x, k: int):
    rows, cols = np.tril_indices(k)  # row-major incl. diagonal
    return _with_exp_diag(x, rows, cols, k, k)


def cov_matrix_constrain(x, k: int):
    L, _ = _cov_chol(x, k)
    return L @ L.mT


def cov_matrix_constrain_lp(x, k: int, *, batch_ndims=0):
    """lp += K log 2 + sum_k (K - k + 1) log L_kk  (ref: cov_matrix_constrain.hpp:89-92)."""
    L, d = _cov_chol(x, k)
    wts = _const(tuple(range(k + 1, 1, -1)), L.dtype, L.device)  # K-k+1, k 0-indexed
    return L @ L.mT, k * LOG_TWO + sum_event(wts * d, batch_ndims)


def cov_matrix_free(y, k: int):
    rows, cols = np.tril_indices(k)
    return _free_log_diag(cholesky_decompose(torch.as_tensor(y)), rows, cols)


# --- read_corr/read_cov builders (ref: read_corr_L.hpp, read_cov_L.hpp,
# --- read_corr_matrix.hpp, read_cov_matrix.hpp) -----------------------------


def read_corr_L(cpcs, k: int):
    """Cholesky factor of a correlation matrix from canonical partial
    correlations (C-vine, column-major order).  ref: ``read_corr_L.hpp``."""
    return _read_corr_L(torch.as_tensor(cpcs), k)[0]


def read_corr_matrix(cpcs, k: int):
    """Correlation matrix from CPCs (ref: ``read_corr_matrix.hpp``)."""
    L = read_corr_L(cpcs, k)
    return L @ L.mT


def read_cov_L(cpcs, sds, k: int | None = None):
    """Covariance Cholesky factor = diag(sds) @ read_corr_L (ref:
    ``read_cov_L.hpp``)."""
    sds = torch.as_tensor(sds)
    k = sds.shape[-1] if k is None else k
    return sds[..., :, None] * read_corr_L(cpcs, k)


def read_cov_matrix(cpcs, sds):
    """Covariance matrix from CPCs + standard deviations (ref:
    ``read_cov_matrix.hpp``)."""
    L = read_cov_L(cpcs, sds)
    return L @ L.mT


def factor_U(U, k: int):
    """Upper-tri Cholesky of a correlation matrix -> atanh-CPCs (ref:
    ``factor_U.hpp``).  Row-major over the upper triangle == the C-vine
    column-major lower ordering used by ``read_corr_L``."""
    rows, cols = _tril_colmajor(k)
    z = _gather(_remaining_z(torch.as_tensor(U).mT), rows, cols)
    return torch.atanh(torch.clamp(z, -1 + 1e-15, 1 - 1e-15))


def factor_cov_matrix(y, k: int | None = None):
    """Factor a covariance matrix into (atanh-CPCs, log-sds) (ref:
    ``factor_cov_matrix.hpp``; tuple return replaces output params)."""
    y = torch.as_tensor(y)
    k = y.shape[-1] if k is None else k
    sds = torch.sqrt(torch.diagonal(y, dim1=-2, dim2=-1))
    corr = y / (sds[..., :, None] * sds[..., None, :])
    return corr_matrix_free(corr, k), torch.log(sds)


def make_nu(eta, k: int):
    """Beta-variate degrees of freedom for the LKJ onion construction
    (ref: ``make_nu.hpp``): row i (0-based) of the CPC triangle gets
    nu = 2 * (eta + (k - 2)/2 - i/2), repeated k-1-i times."""
    eta = eta if isinstance(eta, torch.Tensor) and eta.is_floating_point() else torch.as_tensor(eta, dtype=torch.float64)
    rows = np.repeat(np.arange(k - 1), np.arange(k - 1, 0, -1))
    return 2.0 * (eta + 0.5 * (k - 2.0) - 0.5 * torch.as_tensor(rows, dtype=eta.dtype, device=eta.device))


# --- cov_matrix via LKJ parameterization: CPCs + sds (ref:
# --- cov_matrix_constrain_lkj.hpp, cov_matrix_free_lkj.hpp) -----------------


def cov_matrix_constrain_lkj(x, k: int):
    """x = [(k choose 2) unconstrained CPCs, k unconstrained log-sds]."""
    kc2 = (k * (k - 1)) // 2
    return read_cov_matrix(torch.tanh(x[..., :kc2]), torch.exp(x[..., kc2:]))


def cov_matrix_constrain_lkj_lp(x, k: int, *, batch_ndims=0):
    kc2 = (k * (k - 1)) // 2
    z = torch.tanh(x[..., :kc2])
    logsds = x[..., kc2:]
    lz = log1m(torch.square(z))
    sum_logsds = sum_event(logsds, batch_ndims)
    # corr_constrain (tanh) jacobian + positive_constrain jacobian
    lp = sum_event(lz, batch_ndims) + sum_logsds
    # read_corr_L jacobian (column-weighted) + read_cov_L adjustment
    lp = lp + 0.5 * sum_event(_cpc_weights(k, z) * lz, batch_ndims)
    lp = lp + (sum_logsds + LOG_TWO) * k
    return read_cov_matrix(z, torch.exp(logsds)), lp


def cov_matrix_free_lkj(y, k: int | None = None):
    """Invert cov_matrix_constrain_lkj (ref: ``cov_matrix_free_lkj.hpp``)."""
    cpcs, logsds = factor_cov_matrix(y, k)
    return torch.cat([cpcs, logsds], dim=-1)


# --- cholesky_factor: M x N lower trapezoid, positive diag (ref: same) ------


def _chol_factor_idx(m: int, n: int):
    rows, cols = np.tril_indices(m)
    keep = cols < n
    return rows[keep], cols[keep]


def cholesky_factor_constrain(x, m: int, n: int):
    rows, cols = _chol_factor_idx(m, n)
    return _with_exp_diag(x, rows, cols, m, n)[0]


def cholesky_factor_constrain_lp(x, m: int, n: int, *, batch_ndims=0):
    """lp += sum of diagonal free params (ref: cholesky_factor_constrain.hpp)."""
    rows, cols = _chol_factor_idx(m, n)
    L, d = _with_exp_diag(x, rows, cols, m, n)
    return L, sum_event(d, batch_ndims)


def cholesky_factor_free(L, m: int, n: int):
    rows, cols = _chol_factor_idx(m, n)
    return _free_log_diag(torch.as_tensor(L), rows, cols)
