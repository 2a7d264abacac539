"""bernoulli_logit_glm logistic regression (BASELINE.md config 2).

Counterpart: ``math_tpu/models/glm_logistic.py``.  Synthetic 100k x 50 design
by default; the likelihood goes through the chain-batched fused GLM kernel
(``ops/glm_fused.py``), which reads the design matrix once per gradient
evaluation for all chains (ref semantics:
``bernoulli_logit_glm_lpmf.hpp:112-137``).
"""

from __future__ import annotations

import numpy as np

from math_tpu_torch import dists, transforms
from math_tpu_torch.model import make_log_density
from math_tpu_torch.ops.glm_fused import bernoulli_logit_glm_lpmf_chains


def synthetic_data(n=100_000, k=50, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, k)).astype(dtype)
    beta_true = (rng.normal(size=k) * 0.3).astype(dtype)
    alpha_true = np.float32(0.4)
    eta = X @ beta_true + alpha_true
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-eta))).astype(dtype)
    return X, y, beta_true, alpha_true


def make(k: int):
    """alpha ~ normal(0, 5); beta ~ normal(0, 2); y ~ bernoulli_logit_glm.

    Data flows through ``model.logp(theta, X, y)`` / the samplers'
    ``args=(X, y)`` as tensors on the sampler's device: ``X (N, k)``,
    ``y (N,)`` of 0/1 in the floating type of ``theta``.
    """

    def log_prob(p, X, y):
        alpha, beta = p["alpha"], p["beta"]  # (C,), (C, k)
        lp = dists.normal_lpdf(alpha, 0.0, 5.0, propto=True, batch_ndims=1)
        lp = lp + dists.normal_lpdf(beta, 0.0, 2.0, propto=True, batch_ndims=1)
        lp = lp + bernoulli_logit_glm_lpmf_chains(y, X, alpha, beta.T)
        return lp

    return make_log_density(
        {
            "alpha": transforms.Identity(shape=()),
            "beta": transforms.Identity(shape=(k,)),
        },
        log_prob,
    )
