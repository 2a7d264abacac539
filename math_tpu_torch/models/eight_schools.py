"""Eight-schools non-centered hierarchical normal (BASELINE.md config 1).

Counterpart: ``math_tpu/models/eight_schools.py``.  The canonical Stan
benchmark model, written for a leading chain axis:

    mu ~ normal(0, 5); tau ~ half-cauchy(0, 5)
    theta_tilde ~ std_normal();  theta = mu + tau * theta_tilde
    y ~ normal(theta, sigma)
"""

from __future__ import annotations

import numpy as np

from math_tpu_torch import dists, transforms
from math_tpu_torch.model import make_log_density

Y = np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
SIGMA = np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])


def make(y=None, sigma=None):
    y = Y if y is None else np.asarray(y)
    sigma = SIGMA if sigma is None else np.asarray(sigma)
    J = len(y)

    def log_prob(p):
        # mu (C,), tau (C,), theta_tilde (C, J); y and sigma stay numpy so
        # that propto drops their constant terms
        mu, tau, tt = p["mu"], p["tau"], p["theta_tilde"]
        lp = dists.normal_lpdf(mu, 0.0, 5.0, propto=True, batch_ndims=1)
        lp = lp + dists.cauchy_lpdf(tau, 0.0, 5.0, propto=True, batch_ndims=1)
        lp = lp + dists.std_normal_lpdf(tt, propto=True, batch_ndims=1)
        theta = mu[:, None] + tau[:, None] * tt
        lp = lp + dists.normal_lpdf(y, theta, sigma, propto=True, batch_ndims=1)
        return lp

    return make_log_density(
        {
            "mu": transforms.Identity(shape=()),
            "tau": transforms.LowerBound(shape=(), lb=0.0),
            "theta_tilde": transforms.Identity(shape=(J,)),
        },
        log_prob,
    )
