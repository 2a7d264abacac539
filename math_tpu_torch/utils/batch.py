"""The chain-batched convention in one place: a density or a log-Jacobian sums
over every axis after the first ``batch_ndims`` (the chain axes)."""

from __future__ import annotations


def sum_event(x, batch_ndims=0):
    """Sum over every axis after the first ``batch_ndims``; a tensor that has
    only batch axes (one scalar per chain) is returned as it is."""
    if x.ndim <= batch_ndims:
        return x
    return x.flatten(batch_ndims).sum(-1)
