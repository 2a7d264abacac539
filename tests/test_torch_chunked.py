"""PyTorch port: ``run_pooled_chains_chunked`` and the auto-sized tree-depth
cap, against ``math_tpu`` (CPU, float64).

- Chunked equals monolithic to the bit at a fixed cap, for chunk sizes that
  do and do not divide ``num_warmup``: the one generator is carried across the
  chunks, never re-seeded.
- Auto-depth (twins of ``tests/test_autodepth.py``): ``sample_nuts``'s
  sampling cap is ``choose_depth_cap`` of the second half of its warmup
  depths, the posterior on the correlated 4-dim normal agrees with a
  ``math_tpu.infer.sample_nuts`` run within 4 Monte-Carlo standard errors, and
  the saturation warning fires when the ceiling is too low, for
  ``sample_nuts`` and for the chunked sampler (which counts each sampling chunk
  against the cap it ran at).
"""

import functools
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from math_tpu.infer import adapt as jadapt
from math_tpu.infer import sample as jsample

from math_tpu_torch.diagnostics import convergence as tconv
from math_tpu_torch.infer import adapt as tadapt
from math_tpu_torch.infer import run_pooled_chains, run_pooled_chains_chunked, sample_nuts
from math_tpu_torch.models import eight_schools as tes
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)

PREC_CHOL = np.array([[1.0, 0.0, 0.0, 0.0], [0.5, 1.0, 0.0, 0.0], [0.0, 0.5, 1.0, 0.0], [0.0, 0.0, 0.5, 1.0]])
COV = np.linalg.inv(PREC_CHOL @ PREC_CHOL.T)


def corr_normal_logp(z):
    """The mildly correlated 4-dim normal of tests/test_autodepth.py, chain-batched."""
    v = z @ torch.as_tensor(PREC_CHOL, dtype=z.dtype)
    return -0.5 * (v * v).sum(-1)


def _j_corr_normal_logp(z):
    v = jnp.asarray(PREC_CHOL).T @ z
    return -0.5 * jnp.sum(v * v)


def _z0(chains, dim, seed):
    return (2.0 * torch.rand((chains, dim), generator=torch.Generator().manual_seed(seed), dtype=torch.float64) - 1.0) * 2.0


FIXED = dict(num_warmup=100, num_samples=30, max_depth=5, device="cpu")


@functools.lru_cache(maxsize=1)
def _monolithic():
    tm = tes.make()
    return run_pooled_chains(torch.Generator().manual_seed(2), _z0(6, tm.dim, 1), tm.logp, **FIXED)


@pytest.mark.parametrize("warmup_chunk, sample_chunk", [(50, 15), (40, 25), (23, 17)])
def test_chunked_equals_monolithic_to_the_bit(warmup_chunk, sample_chunk):
    """100 warmup steps in chunks of 50 (dividing) or 40 and 23 (not); 30
    draws in chunks that do and do not divide them."""
    tm = tes.make()
    mono = _monolithic()
    chunked = run_pooled_chains_chunked(torch.Generator().manual_seed(2), _z0(6, tm.dim, 1), tm.logp,
                                        warmup_chunk=warmup_chunk, sample_chunk=sample_chunk, **FIXED)
    for name in ("position", "accept_prob", "diverging", "tree_depth", "n_leapfrog", "energy", "step_size", "inv_mass"):
        assert torch.equal(getattr(chunked, name), getattr(mono, name)), name
    assert chunked.n_grad_calls == mono.n_grad_calls and chunked.max_depth == mono.max_depth == 5
    assert len(chunked.chunk_caps) == -(-100 // warmup_chunk) + -(-30 // sample_chunk)
    assert set(chunked.chunk_caps) == {5}


def test_chunked_mesh_is_not_ported():
    """(The name is from before ``mesh=`` was ported.)  Over a mesh of one
    rank (a group of one in this process) the chunked driver gives the
    one-device run's draws bit for bit: an all-reduce or an all-gather over
    one rank is the identity.  Meshes of several ranks:
    ``tests/test_torch_parallel.py``."""
    import torch.distributed as dist

    from math_tpu_torch.parallel import chain_mesh

    tm = tes.make()
    made = not dist.is_initialized()
    mesh = chain_mesh(axis="chain", device="cpu")
    try:
        kw = dict(num_warmup=30, num_samples=20, max_depth=5, warmup_chunk=7, sample_chunk=6, device="cpu")
        want = run_pooled_chains_chunked(torch.Generator().manual_seed(4), _z0(4, tm.dim, 0), tm.logp, **kw)
        got = run_pooled_chains_chunked(torch.Generator().manual_seed(4), _z0(4, tm.dim, 0), tm.logp, mesh=mesh, **kw)
        for f in ("position", "n_leapfrog", "step_size", "inv_mass"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    finally:
        if made:
            dist.destroy_process_group()


def test_chunked_auto_depth_on_eight_schools():
    """Twin of tests/test_autodepth.py::test_pooled_chunked_auto_depth: the cap
    shrinks from the ceiling, each warmup chunk after the first runs at the cap
    chosen from the tail of the one before, the posterior stays right."""
    tm = tes.make()
    res = run_pooled_chains_chunked(torch.Generator().manual_seed(3), _z0(16, tm.dim, 3), tm.logp, num_warmup=200,
                                    num_samples=200, max_depth=10, auto_depth=True, warmup_chunk=60, sample_chunk=100,
                                    device="cpu")
    assert 2 <= res.max_depth < 10
    assert res.chunk_caps[0] == 6  # warmup_start_cap
    assert len(res.chunk_caps) == 4 + 2 and res.chunk_caps[-1] == res.max_depth
    mu = float(tm.transform_draws(res.position)["mu"].mean())
    assert abs(mu - 4.4) < 1.5
    assert tadapt.treedepth_saturation(res.tree_depth.numpy(), res.max_depth) < 0.2


def test_sample_nuts_auto_depth_cap_and_posterior():
    """Twin of test_sample_nuts_auto_depth_shrinks_cap_and_recovers_posterior:
    the cap is choose_depth_cap of the second half of the warmup depths
    (recorded in ``warmup_tree_depth``); the draws agree with a math_tpu run."""
    res = sample_nuts(corr_normal_logp, torch.Generator().manual_seed(0), 4, num_warmup=200, num_samples=200,
                      num_chains=8, max_depth=10, auto_depth=True, device="cpu", dtype=torch.float64)
    assert res.warmup_tree_depth.shape == (8, 200)
    assert res.max_depth == jadapt.choose_depth_cap(res.warmup_tree_depth[:, 100:].numpy(), 10) < 10
    assert int(res.stats.tree_depth.max()) <= res.max_depth
    pos = res.position.numpy()
    assert np.abs(pos.reshape(-1, 4).mean(0)).max() < 0.2
    assert np.allclose(pos.reshape(-1, 4).var(0), np.diag(COV), rtol=0.3)
    want = np.asarray(jsample.sample_nuts(_j_corr_normal_logp, jax.random.PRNGKey(0), 4, num_warmup=200,
                                          num_samples=200, num_chains=8, max_depth=10, auto_depth=True).position)
    se = np.sqrt(pos.reshape(-1, 4).var(0) / tconv.ess(pos) + want.reshape(-1, 4).var(0) / tconv.ess(want))
    assert np.all(np.abs(pos.mean((0, 1)) - want.mean((0, 1))) < 4.0 * se)


def _too_deep(z):
    """A 16-dim normal that needs trees deeper than 2 (tests/test_autodepth.py)."""
    return -0.5 * (z * z).sum(-1) - 0.5 * ((z[:, :8] - z[:, 8:]) ** 2).sum(-1)


def test_low_ceiling_warns_on_saturation():
    with pytest.warns(UserWarning, match="truncated"):
        sample_nuts(_too_deep, torch.Generator().manual_seed(0), 16, num_warmup=100, num_samples=60, num_chains=4,
                    max_depth=2, auto_depth=True, device="cpu", dtype=torch.float64)
    with pytest.warns(UserWarning, match="truncated"):
        res = run_pooled_chains_chunked(torch.Generator().manual_seed(0), _z0(4, 16, 0), _too_deep, num_warmup=100,
                                        num_samples=60, max_depth=2, auto_depth=True, warmup_chunk=50,
                                        sample_chunk=30, device="cpu")
    assert res.max_depth == 2 and set(res.chunk_caps) == {2}


def test_no_warning_when_the_cap_holds():
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*tree-depth cap.*")
        sample_nuts(corr_normal_logp, torch.Generator().manual_seed(1), 4, num_warmup=100, num_samples=50,
                    num_chains=4, max_depth=10, auto_depth=True, device="cpu", dtype=torch.float64)
