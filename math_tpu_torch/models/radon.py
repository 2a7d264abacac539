"""Radon varying-intercept / varying-slope hierarchical model (BASELINE.md
config 3), non-centered, written for a leading chain axis.

Counterpart: ``math_tpu/models/radon.py``.

    mu_a ~ normal(0, 10); mu_b ~ normal(0, 10)
    sigma_a, sigma_b, sigma_y ~ half-normal(0, 1)
    a_c = mu_a + sigma_a * za_c;  b_c = mu_b + sigma_b * zb_c
    y_i ~ normal(a_{county[i]} + b_{county[i]} * x_i, sigma_y)

Synthetic county-structured data stands in for the classic Minnesota radon
data set.  Pass ``county, x, y`` as tensors on the sampling device through
``args``, as the JAX bench passes arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from math_tpu_torch import dists, transforms
from math_tpu_torch.model import make_log_density
from math_tpu_torch.ops import segment


def synthetic_data(n_counties=85, n_obs=919, seed=0, dtype=np.float64):
    """``(county int32, x, y)`` as numpy, the same arrays as the JAX
    package's for the same seed."""
    rng = np.random.default_rng(seed)
    county = rng.integers(0, n_counties, n_obs)
    x = rng.integers(0, 2, n_obs).astype(dtype)  # floor indicator
    a_true = 1.5 + 0.3 * rng.normal(size=n_counties)
    b_true = -0.7 + 0.2 * rng.normal(size=n_counties)
    y = (a_true[county] + b_true[county] * x + 0.75 * rng.normal(size=n_obs)).astype(dtype)
    return county.astype(np.int32), x, y


def make(n_counties: int):
    def log_prob(p, county, x, y):
        # scalars (C,), za / zb (C, n_counties)
        mu_a, mu_b = p["mu_a"], p["mu_b"]
        sigma_a, sigma_b, sigma_y = p["sigma_a"], p["sigma_b"], p["sigma_y"]
        za, zb = p["za"], p["zb"]
        lp = dists.normal_lpdf(mu_a, 0.0, 10.0, propto=True, batch_ndims=1)
        lp = lp + dists.normal_lpdf(mu_b, 0.0, 10.0, propto=True, batch_ndims=1)
        lp = lp + dists.normal_lpdf(sigma_a, 0.0, 1.0, propto=True, batch_ndims=1)
        lp = lp + dists.normal_lpdf(sigma_b, 0.0, 1.0, propto=True, batch_ndims=1)
        lp = lp + dists.normal_lpdf(sigma_y, 0.0, 1.0, propto=True, batch_ndims=1)
        lp = lp + dists.std_normal_lpdf(za, propto=True, batch_ndims=1)
        lp = lp + dists.std_normal_lpdf(zb, propto=True, batch_ndims=1)
        a = mu_a[:, None] + sigma_a[:, None] * za
        b = mu_b[:, None] + sigma_b[:, None] * zb
        # a[county] + b[county] * x as one-hot products: sums in a fixed
        # order, no atomics in the backward (see ops/segment.py)
        M = segment.onehot_matrix(torch.as_tensor(county, device=a.device), n_counties, a.dtype)
        mu = a @ M.T + (b @ M.T) * x
        lp = lp + dists.normal_lpdf(y, mu, sigma_y[:, None], propto=True, batch_ndims=1)
        return lp

    return make_log_density(
        {
            "mu_a": transforms.Identity(shape=()),
            "mu_b": transforms.Identity(shape=()),
            "sigma_a": transforms.LowerBound(shape=(), lb=0.0),
            "sigma_b": transforms.LowerBound(shape=(), lb=0.0),
            "sigma_y": transforms.LowerBound(shape=(), lb=0.0),
            "za": transforms.Identity(shape=(n_counties,)),
            "zb": transforms.Identity(shape=(n_counties,)),
        },
        log_prob,
    )
