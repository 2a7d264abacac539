"""PyTorch port: ``infer/smc.py`` against ``math_tpu`` (CPU, float64).

Deterministic pieces exactly: ``systematic_resample`` gives the reference's
indices for the same ``u0`` (the reference's ``jax.random.uniform`` replaced
by that number), including the clamp at ``n - 1`` where the float cumsum tops
out below the last stratified point; ``_rel_ess`` and ``_next_temperature``
equal the reference's to 1e-12 on seeded log-likelihoods.  The sampler is
held statistically with the reference tests' limits
(``tests/test_advi_smc.py:104-139``: Gaussian moments and log evidence,
eight-schools ``mu``), and by its invariants: ``smc_tempered`` equals
``smc_tempered_stagewise`` particle for particle, ``particle_batch=32``
equals the unbatched run bit for bit, and ``axis_name`` at world size 1
equals the local run drawn from the same two streams.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from math_tpu_torch.infer import ChainNoise, smc_tempered, smc_tempered_stagewise
from math_tpu_torch.models import eight_schools
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)

jsmc = importlib.import_module("math_tpu.infer.smc")
tsmc = importlib.import_module("math_tpu_torch.infer.smc")

F64 = dict(dtype=torch.float64, device="cpu")


class _FixedU0(ChainNoise):
    """A noise source whose uniform draw is a given number."""

    def __init__(self, u0):
        super().__init__(None, "cpu", torch.float64)
        self.u0 = u0

    def uniform(self, shape, site=None):
        return torch.full(shape, self.u0, dtype=self.dtype)


def _resample_both(log_w, u0, monkeypatch):
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape=(), dtype=None: jnp.full(shape, u0, dtype))
    want = np.asarray(jsmc.systematic_resample(jax.random.PRNGKey(0), jnp.asarray(log_w)))
    monkeypatch.undo()
    got = tsmc.systematic_resample(_FixedU0(u0), torch.tensor(log_w)).numpy()
    return got, want


@pytest.mark.parametrize("u0", [0.0, 0.137, 0.5, 0.999])
def test_systematic_resample_matches_reference(u0, monkeypatch):
    log_w = np.random.default_rng(0).normal(size=37) * 2.0
    got, want = _resample_both(log_w, u0, monkeypatch)
    np.testing.assert_array_equal(got, want)


def test_systematic_resample_clamps_at_the_last_particle(monkeypatch):
    """Ten weights of 0.1: their float64 cumsum ends at 1 - 2 ulp, below the
    last point (u0 + 9) / 10 for the largest u0 < 1, so searchsorted says 10;
    both clamp it to 9."""
    log_w = np.log(np.full(10, 0.1))
    u0 = float(np.nextafter(1.0, 0.0))
    w = torch.exp(torch.tensor(log_w) - torch.logsumexp(torch.tensor(log_w), 0))
    pts = (u0 + torch.arange(10, dtype=torch.float64)) / 10
    assert int(torch.searchsorted(torch.cumsum(w, 0), pts)[-1]) == 10
    got, want = _resample_both(log_w, u0, monkeypatch)
    np.testing.assert_array_equal(got, want)
    assert got.max() == 9


def test_systematic_resample_unbiased():
    lw = torch.log(torch.tensor([0.1, 0.2, 0.3, 0.4], dtype=torch.float64))
    gen = torch.Generator().manual_seed(0)
    counts = np.zeros(4)
    for _ in range(200):
        counts += np.bincount(tsmc.systematic_resample(gen, lw).numpy(), minlength=4)
    np.testing.assert_allclose(counts / counts.sum(), [0.1, 0.2, 0.3, 0.4], atol=0.02)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rel_ess_and_next_temperature_match_reference(seed):
    rng = np.random.default_rng(seed)
    log_like = rng.normal(size=256) * 10.0 ** rng.uniform(0, 3)
    log_like[::17] = -np.inf  # a particle outside the support
    np.testing.assert_allclose(
        float(tsmc._rel_ess(torch.tensor(log_like) * 0.01)), float(jsmc._rel_ess(jnp.asarray(log_like) * 0.01)),
        rtol=1e-12,
    )
    for t, target in ((0.0, 0.5), (0.3, 0.3), (0.97, 0.5)):
        got = float(tsmc._next_temperature(torch.tensor(t, dtype=torch.float64), torch.tensor(log_like), target))
        want = float(jsmc._next_temperature(jnp.asarray(t), jnp.asarray(log_like), target))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)


def test_smc_gaussian_moments_and_evidence():
    mu = torch.tensor([1.5, -0.5], dtype=torch.float64)

    def ld(z, *args):
        return -0.5 * torch.sum(torch.square(z - mu) / 0.25, -1)

    res = smc_tempered(ld, torch.Generator().manual_seed(0), 2, num_particles=2048, mutation_steps=3, **F64)
    p = res.particles.numpy()
    np.testing.assert_allclose(p.mean(0), mu.numpy(), atol=0.08)
    np.testing.assert_allclose(p.var(0), [0.25, 0.25], rtol=0.3)
    # log Z of exp(ld) against the N(0, I) reference: log(0.25)
    assert abs(float(res.log_evidence) - np.log(0.25)) < 0.15, res.log_evidence
    assert res.num_stages >= 2


def test_smc_eight_schools():
    model = eight_schools.make()
    res = smc_tempered(
        model.logp, torch.Generator().manual_seed(1), model.dim, num_particles=2048, mutation_steps=5, init_scale=2.0, **F64
    )
    mu = model.constrain(res.particles)["mu"].numpy()
    assert abs(mu.mean() - 4.4) < 1.0, mu.mean()


def test_smc_stagewise_bit_identical():
    model = eight_schools.make()
    kw = dict(num_particles=256, mutation_steps=2, max_depth=4, init_scale=2.0, **F64)
    ref = smc_tempered(model.logp, torch.Generator().manual_seed(3), model.dim, **kw)
    ladder = []
    got = smc_tempered_stagewise(
        model.logp, torch.Generator().manual_seed(3), model.dim, progress_fn=lambda s, t, lz: ladder.append((s, t)), **kw
    )
    assert torch.equal(ref.particles, got.particles)
    assert float(ref.log_evidence) == float(got.log_evidence)
    assert ref.num_stages == got.num_stages == len(ladder)
    assert [t for _, t in ladder] == list(ref.temperatures) == list(got.temperatures)
    assert ladder[-1][1] == 1.0  # the adaptive ladder reached the posterior


def test_smc_particle_batch_matches_unbatched():
    """``particle_batch`` chunks the log-density calls, not the sampler: the
    same generator gives the same particles, bit for bit."""
    model = eight_schools.make()
    kw = dict(num_particles=128, mutation_steps=2, max_depth=4, init_scale=2.0, **F64)
    a = smc_tempered(model.logp, torch.Generator().manual_seed(5), model.dim, **kw)
    b = smc_tempered(model.logp, torch.Generator().manual_seed(5), model.dim, particle_batch=32, **kw)
    assert torch.equal(a.particles, b.particles)
    assert float(a.log_evidence) == float(b.log_evidence)
    with pytest.raises(ValueError, match="not divisible"):
        smc_tempered(model.logp, torch.Generator().manual_seed(5), model.dim, particle_batch=48, **kw)


def test_smc_nan_log_likelihood_is_minus_inf():
    """A particle whose log density is NaN gets zero weight (it becomes -inf
    before the bisection) instead of poisoning the evidence."""

    def ld(z, *args):
        lp = -0.5 * torch.sum(torch.square(z - 1.0), -1)
        return torch.where(z[:, 0] > 3.0, torch.nan, lp)

    res = smc_tempered(ld, torch.Generator().manual_seed(6), 2, num_particles=512, mutation_steps=1, init_scale=2.0, **F64)
    assert np.isfinite(float(res.log_evidence)) and res.temperatures[-1] == 1.0


def test_axis_name_is_not_ported():
    """(The name is from before ``axis_name`` was ported.)  At world size 1
    (a group of one in this process) ``axis_name`` gives the local run's
    particles bit for bit when the local run draws from the same two streams
    (``_sharded_noise``: resampling from the caller's generator, the rest
    from the rank's); ``ancestor_exchange`` over one rank is ``z[idx]``.  The
    runs over several ranks: ``tests/test_torch_smc_sharded.py``."""
    import torch.distributed as dist

    from math_tpu_torch.parallel import chain_mesh

    made = not dist.is_initialized()
    chain_mesh(axis="p", device="cpu")
    try:
        ld = lambda z: -0.5 * torch.square(z - 1.0).sum(-1) / 0.25  # noqa: E731
        kw = dict(num_particles=64, mutation_steps=2, **F64)
        got = smc_tempered(ld, torch.Generator().manual_seed(5), 2, axis_name="p", **kw)
        want = smc_tempered(ld, tsmc._sharded_noise(torch.Generator().manual_seed(5), 0, "cpu", torch.float64), 2, **kw)
        assert torch.equal(got.particles, want.particles)
        assert float(got.log_evidence) == float(want.log_evidence) and got.num_stages == want.num_stages
        z, idx = torch.randn(8, 2, dtype=torch.float64), torch.tensor([0, 0, 3, 5, 5, 6, 7, 7])
        assert torch.equal(tsmc.ancestor_exchange(z, idx, "p"), z[idx])
    finally:
        if made:
            dist.destroy_process_group()
