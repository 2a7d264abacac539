"""PyTorch port: ``ops/segment.py`` and ``models/radon.py`` against
``math_tpu`` (CPU, float64).

The segment ops with and without a leading chain axis equal the reference's
one-hot products to 1e-12; radon's synthetic data equals the reference's for
the same seed; ``logp`` and its gradient at 8 seeded points equal
``math_tpu.models.radon.make(85)``'s under ``jax.value_and_grad`` to 1e-10,
with the data passed as arrays to both.  The gradient is taken twice and must be equal bit for bit: the one-hot
products have no atomics.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from math_tpu.models import radon as jradon
from math_tpu.ops import segment as jsegment

from math_tpu_torch.models import radon as tradon
from math_tpu_torch.ops import segment as tsegment
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)

TOL = 1e-12
S, N, C, K = 7, 23, 3, 4


def _idx(seed=0):
    return np.random.default_rng(seed).integers(0, S, N).astype(np.int32)


def test_onehot_matrix_matches_reference():
    idx = _idx()
    got = tsegment.onehot_matrix(torch.tensor(idx), S, torch.float64)
    want = jsegment.onehot_matrix(jnp.asarray(idx), S, jnp.float64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(S,), (S, K)])
def test_segment_gather_matches_reference(shape):
    rng = np.random.default_rng(1)
    idx, v = _idx(), rng.normal(size=shape)
    got = tsegment.segment_gather(torch.tensor(v), torch.tensor(idx), S)
    want = jsegment.segment_gather(jnp.asarray(v), jnp.asarray(idx), S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got.numpy(), v[idx])


@pytest.mark.parametrize("shape", [(N,), (N, K)])
def test_segment_sum_matches_reference(shape):
    rng = np.random.default_rng(2)
    idx, v = _idx(), rng.normal(size=shape)
    got = tsegment.segment_sum(torch.tensor(v), torch.tensor(idx), S)
    want = jsegment.segment_sum(jnp.asarray(v), jnp.asarray(idx), S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("op,rows", [("segment_gather", S), ("segment_sum", N)])
@pytest.mark.parametrize("trail", [(), (K,)])
def test_segment_ops_with_a_chain_axis(op, rows, trail):
    """``(C, rows, ...)`` values with ``batch_ndims=1``: each chain's slice
    equals the reference's op on that slice."""
    rng = np.random.default_rng(3)
    idx, v = _idx(), rng.normal(size=(C, rows) + trail)
    got = getattr(tsegment, op)(torch.tensor(v), torch.tensor(idx), S, batch_ndims=1)
    for c in range(C):
        want = getattr(jsegment, op)(jnp.asarray(v[c]), jnp.asarray(idx), S)
        np.testing.assert_allclose(got[c].numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_data_matches_reference(seed):
    for dtype in (np.float64, np.float32):
        got = tradon.synthetic_data(85, 919, seed=seed, dtype=dtype)
        want = jradon.synthetic_data(85, 919, seed=seed, dtype=dtype)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_radon_logp_and_grad_match_reference():
    county, x, y = jradon.synthetic_data(85, 919)
    jm, tm = jradon.make(85), tradon.make(85)
    assert tm.dim == jm.dim == 175
    z = np.random.default_rng(4).normal(size=(8, jm.dim)) * 0.5
    jargs = (jnp.asarray(county), jnp.asarray(x), jnp.asarray(y))
    jlp, jg = jax.vmap(jax.value_and_grad(lambda q: jm.logp(q, *jargs)))(jnp.asarray(z))
    targs = (torch.tensor(county), torch.tensor(x), torch.tensor(y))
    lp, g = tm.logp_and_grad(torch.tensor(z), *targs)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-10, atol=1e-10)
    lp2, g2 = tm.logp_and_grad(torch.tensor(z), *targs)
    assert torch.equal(lp, lp2) and torch.equal(g, g2)


def test_radon_chain_axis_is_independent():
    """A batch of chains gives each chain's own log density: the chains of
    ``(C, dim)`` equal the single points ``(dim,)`` evaluated one by one."""
    county, x, y = tradon.synthetic_data(85, 919)
    tm = tradon.make(85)
    targs = (torch.tensor(county), torch.tensor(x), torch.tensor(y))
    z = torch.tensor(np.random.default_rng(5).normal(size=(3, tm.dim)))
    batch = tm.logp(z, *targs)
    for c in range(3):
        np.testing.assert_allclose(float(tm.logp(z[c], *targs)), float(batch[c]), rtol=1e-13)
