"""PyTorch port: SMC with particles sharded over ranks (``smc_tempered(axis_name=...)``,
``ancestor_exchange``) against ``math_tpu`` (CPU, gloo).

Four gloo ranks, started once for the module (``test_torch_parallel.start_ranks``:
one process a rank, one OpenMP thread each, a group timeout and a join
timeout), run both scenarios and write numpy arrays:

- ``ancestor_exchange`` at R = 4, 32 particles a rank, heavily skewed
  weights (the inputs of the reference's tests/test_smc_sharded.py:61-85):
  the indices come from the reference's ``systematic_resample``, passed to
  the ranks as numpy; the result equals ``z_global[idx]`` exactly, and the
  collective counters show no all-gather, one all-reduce (every offset's
  demand) and one rotation for each distinct needed offset
  (tests/test_smc_sharded.py:88-106 checks the lowered program instead);
- the reference's sharded SMC on a 2-D Gaussian (tests/test_smc_sharded.py:18-58)
  at 64 particles a rank (256 in all, the reference 2,048): mean, variance
  and log evidence within the reference test's tolerances, the ranks'
  particles different, the scalars the same on every rank.
"""

import os

import numpy as np
import pytest
import torch

from math_tpu_torch.infer import smc as tsmc
from math_tpu_torch.parallel import chain_mesh
from math_tpu_torch.utils import _collectives as coll
from test_torch_parallel import join_group, join_ranks, leave_group, start_ranks
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)

WORLD, N_LOCAL, DIM = 4, 32, 3
MU = np.array([1.5, -0.5])
SMC_LOCAL = 64


def exchange_inputs():
    """``z_global (R * 32, 3)`` and skewed log weights (ref: test_smc_sharded.py:64-69)."""
    rng = np.random.default_rng(0)
    return rng.normal(size=(WORLD * N_LOCAL, DIM)), rng.normal(size=WORLD * N_LOCAL) * 4.0


def gaussian_ld(z):
    return -0.5 * torch.sum(torch.square(z - torch.tensor(MU, dtype=z.dtype)) / 0.25, -1)


def _rank_main(rank, world, port, out_dir, idx_path):
    rank, world = int(rank), int(world)
    join_group(rank, world, int(port))
    chain_mesh(world, axis="particle", device="cpu")
    z_glob, _ = exchange_inputs()
    idx = torch.tensor(np.load(idx_path))
    coll.reset_counts()
    got = tsmc.ancestor_exchange(torch.tensor(z_glob[rank * N_LOCAL:(rank + 1) * N_LOCAL]),
                                 idx[rank * N_LOCAL:(rank + 1) * N_LOCAL], "particle")
    counts = dict(coll.COUNTS)
    res = tsmc.smc_tempered(gaussian_ld, torch.Generator().manual_seed(0), 2, num_particles=SMC_LOCAL,
                            mutation_steps=3, axis_name="particle", dtype=torch.float64, device="cpu")
    leave_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), exchange=got.numpy(),
             counts=np.array([counts["all_reduce"], counts["all_gather"], counts["rotate"]]),
             particles=res.particles.numpy(), logz=res.log_evidence.numpy(), eps=res.final_step_size.numpy(),
             stages=np.array(res.num_stages), ladder=np.array(res.temperatures))


@pytest.fixture(scope="module")
def resample_idx():
    """The reference's systematic-resample indices for the skewed weights."""
    import jax
    import jax.numpy as jnp

    from math_tpu.infer.smc import systematic_resample

    _, log_w = exchange_inputs()
    return np.asarray(systematic_resample(jax.random.PRNGKey(3), jnp.asarray(log_w))).astype(np.int64)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, resample_idx):
    out = tmp_path_factory.mktemp("ranks")
    idx_path = str(out / "idx.npy")
    np.save(idx_path, resample_idx)
    join_ranks(start_ranks("test_torch_smc_sharded", WORLD, str(out), idx_path))
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


def test_ancestor_exchange_matches_global_gather(ranks, resample_idx):
    z_glob, _ = exchange_inputs()
    got = np.concatenate([ranks[r]["exchange"] for r in range(WORLD)])
    np.testing.assert_array_equal(got, z_glob[resample_idx])
    # the weights are skewed enough that ancestry crosses ranks
    assert (resample_idx // N_LOCAL != np.repeat(np.arange(WORLD), N_LOCAL)).any()


def test_ancestor_exchange_rotates_blocks_not_allgather(ranks, resample_idx):
    src = resample_idx // N_LOCAL
    needed = {int((s - r) % WORLD) for r in range(WORLD) for s in src[r * N_LOCAL:(r + 1) * N_LOCAL]} - {0}
    for r in range(WORLD):
        all_reduce, all_gather, rotate = ranks[r]["counts"]
        assert all_gather == 0 and all_reduce == 1
        assert rotate == len(needed), (rotate, needed)


def test_sharded_smc_matches_target(ranks):
    p = np.concatenate([ranks[r]["particles"] for r in range(WORLD)])
    assert p.shape == (WORLD * SMC_LOCAL, 2)
    np.testing.assert_allclose(p.mean(0), MU, atol=0.1)
    np.testing.assert_allclose(p.var(0), [0.25, 0.25], rtol=0.35)
    assert abs(float(ranks[0]["logz"]) - np.log(0.25)) < 0.2
    assert ranks[0]["ladder"][-1] == 1.0
    # per-rank mutation streams: the ranks' particles differ
    assert not np.allclose(ranks[0]["particles"], ranks[-1]["particles"])


@pytest.mark.parametrize("field", ["logz", "eps", "stages", "ladder"])
def test_sharded_smc_scalars_are_replicated(ranks, field):
    for r in range(1, WORLD):
        np.testing.assert_array_equal(ranks[r][field], ranks[0][field])
