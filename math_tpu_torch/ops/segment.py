"""Segment (grouped-index) gathers and sums as one-hot products.

Counterpart: ``math_tpu/ops/segment.py``.  Hierarchical models index group
effects by an integer array (``a[county]``), and their gradients add back
per group (``segment_sum(dmu, county)``).  Here both are one product with
the one-hot membership matrix ``M (N, S)``: the gather is ``M @ values``, its
backward the transposed product.

Why the product and not ``index_select`` / ``index_add_``: the backward of an
indexed gather on CUDA adds with atomics, so float32 sums change from run to
run, and a resumed sampler run would no longer equal the uninterrupted one
(``infer/resume.py``).  A dense product (cuBLAS on the card, TF32 off) sums in
a fixed order, so the same inputs give the same bits every run.  The JAX
package computes the same product outside any Pallas kernel, so it stays a
library product here.  At the radon model's sizes (N = 919 rows, S = 85
groups) it is a few hundred MFLOP a gradient call at 2048 chains.

Chain axes: ``batch_ndims`` leading axes of ``values`` are carried through,
as the densities' ``batch_ndims`` are: ``(C, S)`` gathers to ``(C, N)``,
``(C, S, K)`` to ``(C, N, K)``.
"""

from __future__ import annotations

import torch


def onehot_matrix(idx, num_segments, dtype=torch.float32):
    """(N, num_segments) one-hot membership matrix for integer indices, on
    the device of ``idx`` (a tensor) or the CPU."""
    idx = torch.as_tensor(idx)
    seg = torch.arange(num_segments, dtype=idx.dtype, device=idx.device)
    return (idx[:, None] == seg[None, :]).to(dtype)


def _onehot_like(values, idx, num_segments):
    return onehot_matrix(torch.as_tensor(idx, device=values.device), num_segments, values.dtype)


def segment_gather(values, idx, num_segments, *, batch_ndims=0):
    """``values[..., idx, ...]`` as a one-hot product: (S,) or (S, K) ->
    (N,) or (N, K) after the ``batch_ndims`` leading axes."""
    M = _onehot_like(values, idx, num_segments)
    if values.ndim - batch_ndims == 1:
        return values @ M.T
    return M @ values


def segment_sum(values, idx, num_segments, *, batch_ndims=0):
    """Sum of the rows of ``values`` per segment as a one-hot product: (N,)
    or (N, K) -> (S,) or (S, K) after the ``batch_ndims`` leading axes."""
    M = _onehot_like(values, idx, num_segments)
    if values.ndim - batch_ndims == 1:
        return values @ M
    return M.T @ values
