"""PyTorch port: ``infer/resume.py`` (``sample_nuts_checkpointed``) and
``io/checkpoint.py`` (CPU, float64): the twins of
``tests/test_runtime.py:74-122``, ``tests/test_fault_injection.py:105,200,220``
and ``tests/test_autodepth.py:146``.

Invariants bit for bit: a run interrupted after some chunks and resumed
equals the uninterrupted run; segmented warmup equals monolithic warmup; a
run killed inside warmup or inside a sampling chunk and started again
equals the uninterrupted run (the port checkpoints warmup segments too).
Guards: the init guard, truncated and inconsistent checkpoints raise, the
auto-sized depth cap persists across a resume.  Statistics: the posterior
mean of eight-schools ``mu`` against a ``math_tpu`` run of the same sampler
within 4 Monte-Carlo standard errors (ground rule 3: draws cannot be
bit-identical across frameworks).
"""

import os

import numpy as np
import pytest

import jax
import torch

from math_tpu.infer.resume import sample_nuts_checkpointed as jax_checkpointed
from math_tpu.models import eight_schools as jes

from math_tpu_torch.diagnostics import convergence as tconv
from math_tpu_torch.infer import sample_nuts_checkpointed
from math_tpu_torch.io.checkpoint import checkpoint_exists, load_checkpoint, save_checkpoint
from math_tpu_torch.models import eight_schools
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)

F64 = dict(dtype=torch.float64, device="cpu")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _gauss_logp(z):
    """A correlated Gaussian in 4 dimensions: short trees, cheap calls."""
    scale = torch.tensor([1.0, 2.0, 0.5, 1.5], dtype=z.dtype)
    return -0.5 * torch.sum(torch.square((z - 0.3 * z.roll(1, -1)) / scale), -1)


def _run(logp, seed, path, dim=10, **kw):
    return sample_nuts_checkpointed(logp, _gen(seed), dim, checkpoint_path=str(path), **F64, **kw)


def test_checkpoint_resume_bit_compatible(tmp_path):
    common = dict(num_warmup=30, num_chains=2, chunk_size=20, max_depth=5, dim=4)
    pos_a, div_a, info_a = _run(_gauss_logp, 0, tmp_path / "ckA", num_samples=60, **common)
    _run(_gauss_logp, 0, tmp_path / "ckB", num_samples=20, **common)
    pos_b, div_b, info_b = _run(_gauss_logp, 0, tmp_path / "ckB", num_samples=60, **common)
    assert pos_a.shape == (2, 60, 4)
    np.testing.assert_array_equal(pos_a, pos_b)
    np.testing.assert_array_equal(div_a, div_b)
    assert info_b["resumed"] and not info_a["resumed"]
    np.testing.assert_array_equal(info_a["step_size"], info_b["step_size"])


def test_segmented_warmup_bit_compatible(tmp_path):
    """``warmup_chunk_size`` splits warmup into segments but reproduces the
    monolithic warmup's draws exactly."""
    common = dict(num_warmup=30, num_samples=10, num_chains=2, chunk_size=10, max_depth=5, dim=4)
    pos_a, _, _ = _run(_gauss_logp, 3, tmp_path / "m", **common)
    pos_b, _, info = _run(_gauss_logp, 3, tmp_path / "s", warmup_chunk_size=12, **common)
    np.testing.assert_array_equal(pos_a, pos_b)
    assert info["checkpoints_written"] == 2 + 1  # after warmup steps 12 and 24, then one chunk


class _Killed(RuntimeError):
    pass


def _dies_in(logp, path, phase, after=5):
    """``logp`` that raises at its ``after``-th evaluation once a checkpoint
    of ``phase`` ("warmup" or "sample") is on disk, as a killed process
    stops in the middle of the next segment or chunk."""
    count, seen = [0], [None]

    def written():  # the phase of the checkpoint on disk, read again only when its file changes
        state = os.path.join(str(path), "state.pt")
        stamp = os.stat(state).st_mtime_ns if checkpoint_exists(str(path)) else None
        if stamp is not None and stamp != seen[0]:
            seen[0] = stamp
            return load_checkpoint(str(path))["phase"]
        return None

    def fn(z, *args):
        if count[0] or written() == phase:
            count[0] += 1
            if count[0] == after:
                raise _Killed()
        return logp(z, *args)

    return fn


@pytest.mark.parametrize("phase", ["warmup", "sample"])
def test_killed_run_restarts_bit_compatible(tmp_path, phase):
    """Killed inside warmup (after the first segment's checkpoint) or inside
    sampling, then started again with the same arguments: the draws equal
    the uninterrupted run's."""
    common = dict(num_warmup=30, num_samples=20, num_chains=2, chunk_size=10, warmup_chunk_size=10, max_depth=5, dim=4)
    pos_a, _, _ = _run(_gauss_logp, 7, tmp_path / "a", **common)
    with pytest.raises(_Killed):
        _run(_dies_in(_gauss_logp, tmp_path / "b", phase), 7, tmp_path / "b", **common)
    assert load_checkpoint(str(tmp_path / "b"))["phase"] == phase
    pos_b, _, info = _run(_gauss_logp, 7, tmp_path / "b", **common)
    assert info["resumed"]
    np.testing.assert_array_equal(pos_a, pos_b)


def test_checkpointed_sampler_init_guard(tmp_path):
    """An everywhere -inf log density: the init re-draws run out and the
    sampler raises before any transition."""
    with pytest.raises(ValueError, match="non-finite initial log density"):
        _run(lambda z: torch.full(z.shape[:1], -torch.inf, dtype=z.dtype) + 0.0 * z.sum(-1), 0, tmp_path / "ck",
             dim=4, num_warmup=10, num_samples=10, num_chains=4, init_radius=2.0)


def _quad_logp(z):
    return -0.5 * torch.sum(torch.square(z), -1)


def test_truncated_checkpoint_raises(tmp_path):
    path = tmp_path / "ck"
    common = dict(num_warmup=20, num_chains=2, chunk_size=20, max_depth=5, dim=3)
    _run(_quad_logp, 0, path, num_samples=20, **common)
    ck = load_checkpoint(str(path))
    ck.pop("draws")
    save_checkpoint(str(path), ck)
    with pytest.raises(ValueError, match="incomplete"):
        _run(_quad_logp, 0, path, num_samples=40, **common)


def test_inconsistent_checkpoint_counter_raises(tmp_path):
    path = tmp_path / "ck"
    common = dict(num_warmup=20, num_chains=2, chunk_size=20, max_depth=5, dim=3)
    _run(_quad_logp, 0, path, num_samples=20, **common)
    ck = load_checkpoint(str(path))
    ck["done"] = np.asarray(7)  # the draws hold 20
    save_checkpoint(str(path), ck)
    with pytest.raises(ValueError, match="corrupt"):
        _run(_quad_logp, 0, path, num_samples=40, **common)


def test_checkpoint_is_written_atomically(tmp_path):
    """The state file is replaced whole: no temporary file is left beside it,
    and the loaded values are the saved ones (numpy arrays come back as
    tensors)."""
    path = str(tmp_path / "ck")
    save_checkpoint(path, {"a": np.arange(3.0), "b": torch.ones(2), "n": 5})
    save_checkpoint(path, {"a": np.arange(4.0), "b": torch.zeros(2), "n": 6})
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ck"]
    assert [p.name for p in (tmp_path / "ck").iterdir()] == ["state.pt"]
    ck = load_checkpoint(path)
    assert torch.equal(ck["a"], torch.arange(4.0, dtype=torch.float64)) and ck["n"] == 6


def _mcse(draws):
    return draws.reshape(-1).std() / np.sqrt(tconv.ess(draws[..., None])[0])


def test_checkpointed_auto_depth_matches_a_jax_run(tmp_path):
    """The twin of ``test_autodepth.py::test_checkpointed_auto_depth`` (at a
    ceiling of 6, half the length, a quarter of the chains), its ``mu`` held against a
    ``math_tpu`` run of the same sampler within 4 Monte-Carlo standard
    errors."""
    model, jm = eight_schools.make(), jes.make()
    common = dict(num_warmup=100, num_samples=100, num_chains=2)
    pos, div, info = _run(model.logp, 0, tmp_path / "ck", chunk_size=50, warmup_chunk_size=50, max_depth=6,
                          auto_depth=True, **common)
    assert 2 <= info["max_depth_used"] < 6
    assert 0.0 <= info["treedepth_hit_rate"] < 0.2
    mu = model.constrain(torch.tensor(pos))["mu"].numpy()
    assert abs(float(np.mean(mu)) - 4.4) < 2.0
    jpos, _, _ = jax_checkpointed(jm.logp, jax.random.PRNGKey(1), jm.dim, checkpoint_path=str(tmp_path / "jax"),
                                  chunk_size=100, max_depth=5, **common)
    jmu = np.asarray(jm.constrain(np.asarray(jpos))["mu"])
    se = np.sqrt(_mcse(mu) ** 2 + _mcse(jmu) ** 2)
    assert abs(mu.mean() - jmu.mean()) < 4.0 * se, (mu.mean(), jmu.mean(), se)


def test_auto_depth_cap_persists_across_a_resume(tmp_path):
    """The cap chosen before the interruption is the cap the resumed call
    samples at: it is read from the checkpoint, not chosen again."""
    kw = dict(num_warmup=60, num_chains=2, chunk_size=10, warmup_chunk_size=30, max_depth=8, auto_depth=True, depth_probe=30,
              dim=4)
    _, _, first = _run(_gauss_logp, 2, tmp_path / "ck", num_samples=10, **kw)
    ck = load_checkpoint(str(tmp_path / "ck"))
    assert int(ck["max_depth_used"]) == first["max_depth_used"] < 8
    _, _, second = _run(_gauss_logp, 2, tmp_path / "ck", num_samples=20, **kw)
    assert second["resumed"] and second["max_depth_used"] == first["max_depth_used"]
