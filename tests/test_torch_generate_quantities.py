"""PyTorch port: ``LogDensity.generate_quantities`` against
``math_tpu.model.LogDensity.generate_quantities`` (the case of
``tests/test_models.py``): deterministic quantities equal to 1e-12 on the
same draws, every draw in one chain-batched call, draw axes restored; with a
generator, a replay from the same state is equal, another seed differs, and
the replicates' moments are within 5 Monte-Carlo errors of the reference's.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from math_tpu.models import eight_schools as j8
from math_tpu_torch.models import eight_schools as t8
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)


def test_generated_quantities_are_the_reference():
    jm, tm = j8.make(), t8.make()
    pos = np.random.default_rng(0).normal(size=(3, 50, jm.dim))
    sigma = np.asarray(j8.SIGMA, np.float64)
    want = jm.generate_quantities(
        lambda p, s: {"mean_theta": jnp.mean(p["mu"] + p["tau"] * p["theta_tilde"]), "snr": p["tau"] / s[0]},
        jnp.asarray(pos), jnp.asarray(sigma))
    got = tm.generate_quantities(
        lambda p, s: {"mean_theta": (p["mu"][:, None] + p["tau"][:, None] * p["theta_tilde"]).mean(-1),
                      "snr": p["tau"] / s[0]},
        torch.tensor(pos), torch.tensor(sigma))
    assert tuple(got["mean_theta"].shape) == (3, 50)
    for k in ("mean_theta", "snr"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-12)

    def ppc_j(p, k, s):
        return p["mu"] + p["tau"] * p["theta_tilde"] + s * jax.random.normal(k, s.shape)

    def ppc_t(p, gen, s):
        th = p["mu"][:, None] + p["tau"][:, None] * p["theta_tilde"]
        return th + s * torch.randn(th.shape, generator=gen, dtype=th.dtype)

    pos_many = np.random.default_rng(1).normal(size=(4, 2000, jm.dim)) * 0.5
    y1 = tm.generate_quantities(ppc_t, torch.tensor(pos_many), torch.tensor(sigma), key=torch.Generator().manual_seed(3))
    y2 = tm.generate_quantities(ppc_t, torch.tensor(pos_many), torch.tensor(sigma), key=torch.Generator().manual_seed(3))
    y3 = tm.generate_quantities(ppc_t, torch.tensor(pos_many), torch.tensor(sigma), key=torch.Generator().manual_seed(4))
    assert tuple(y1.shape) == (4, 2000, 8)
    assert torch.equal(y1, y2) and float((y1 - y3).abs().max()) > 0
    yj = np.asarray(jm.generate_quantities(ppc_j, jnp.asarray(pos_many), jnp.asarray(sigma), key=jax.random.PRNGKey(3)))
    a, b = y1.numpy().reshape(-1, 8), yj.reshape(-1, 8)
    se = np.sqrt(a.var(0) / len(a) + b.var(0) / len(b))
    assert np.all(np.abs(a.mean(0) - b.mean(0)) < 5 * se)
    assert np.all(np.abs(a.std(0) / b.std(0) - 1) < 5 * np.sqrt(1 / (2 * len(a)) + 1 / (2 * len(b))))
