"""PyTorch port: ``io/stan_csv.py`` against ``math_tpu.io.stan_csv``: a file
written by the port from tensors is byte for byte the file the JAX package
writes for the same arrays, each package reads the other's file back
exactly, and the twins of ``tests/test_stan_csv.py`` (column-major names,
the adaptation block, a round trip of the port's sampler output)."""

import numpy as np
import torch

import math_tpu.io.stan_csv as jc
import math_tpu_torch.io as tio
import math_tpu_torch.io.stan_csv as tc
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)


def _fit():
    rng = np.random.default_rng(0)
    chains, draws = 3, 40
    cons = {"mu": rng.normal(size=(chains, draws)), "theta": rng.normal(size=(chains, draws, 4)),
            "Sigma": rng.normal(size=(chains, draws, 2, 2))}
    stats = {"lp": rng.normal(size=(chains, draws)), "tree_depth": rng.integers(1, 6, size=(chains, draws)),
             "diverging": np.zeros((chains, draws))}
    return cons, stats


def test_flat_names_column_major_like_stan():
    assert tc._flat_names("m", (2, 3)) == jc._flat_names("m", (2, 3)) == [
        "m.1.1", "m.2.1", "m.1.2", "m.2.2", "m.1.3", "m.2.3",
    ]
    assert tc._flat_names("s", ()) == ["s"] and tc._flat_names("v", (3,)) == ["v.1", "v.2", "v.3"]


def test_files_are_the_reference_byte_for_byte(tmp_path):
    cons, stats = _fit()
    kw = dict(step_size=np.array([0.37, 0.41, 0.5]), inv_mass=np.linspace(0.5, 2.0, 9), seed=7)
    want = jc.write_stan_csv(str(tmp_path / "jax"), cons, sampler_stats=stats, **kw)
    got = tio.write_stan_csv(str(tmp_path / "port"), {k: torch.tensor(v) for k, v in cons.items()},
                             sampler_stats={k: torch.tensor(v) for k, v in stats.items()},
                             step_size=torch.tensor(kw["step_size"]), inv_mass=torch.tensor(kw["inv_mass"]), seed=7)
    for g, w in zip(got, want):
        assert open(g, "rb").read() == open(w, "rb").read()
        names_j, mat_j = jc.read_stan_csv(g)  # each reads the other's file
        names_t, mat_t = tio.read_stan_csv(w)
        assert names_j == names_t
        np.testing.assert_array_equal(mat_j, mat_t)
    names, mat = tc.read_stan_csv(got[1])
    j = names.index("Sigma.1.1")
    assert names[j:j + 4] == ["Sigma.1.1", "Sigma.2.1", "Sigma.1.2", "Sigma.2.2"]
    np.testing.assert_allclose(mat[:, j:j + 4], cons["Sigma"][1].reshape(40, 4, order="F"), rtol=1e-6)
    np.testing.assert_allclose(mat[:, names.index("stepsize__")], 0.41)
    text = open(got[0]).read()
    assert "# Step size = 0.37" in text and "# Diagonal elements of inverse mass matrix:" in text


def test_end_to_end_from_the_port_sampler(tmp_path):
    from math_tpu_torch.infer import sample_nuts
    from math_tpu_torch.models import eight_schools

    m = eight_schools.make()
    res = sample_nuts(m.logp, torch.Generator().manual_seed(0), dim=m.dim, num_warmup=60, num_samples=40,
                      num_chains=2, device="cpu", dtype=torch.float64)
    cons = m.transform_draws(res.position)
    paths = tio.write_stan_csv(str(tmp_path / "fit"), cons,
                               sampler_stats={"accept_prob": res.stats.accept_prob, "tree_depth": res.stats.tree_depth},
                               step_size=res.step_size, inv_mass=res.inv_mass)
    names, mat = tio.read_stan_csv(paths[0])
    assert mat.shape[0] == 40
    np.testing.assert_allclose(mat[:, names.index("mu")], cons["mu"][0].numpy(), rtol=1e-6)
    assert (mat[:, names.index("tau")] > 0).all()
