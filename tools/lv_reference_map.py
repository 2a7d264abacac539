#!/usr/bin/env python3
"""Posterior mode of BASELINE config 4 by the JAX reference, for reading the
port's Lotka-Volterra recovery.

    PYTHONPATH=. JAX_PLATFORMS=cpu python3 tools/lv_reference_map.py

Maximizes ``math_tpu.models.lotka_volterra.make(ts, solver="rk4")``'s log
density on ``synthetic_data(20)`` in float64 on the CPU (L-BFGS from four
starts around the generating values) and prints the mode, its distance to the
generating values in log space, and the Laplace standard deviations of the
unconstrained coordinates: how far the posterior sits from the values that
made the data, which ``chip_smoke.py``'s ``lv_path`` recovery limits must
allow.
"""

import json

import numpy as np
from scipy.optimize import minimize

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from math_tpu.models import lotka_volterra  # noqa: E402


def main():
    ts, y, theta, z0 = lotka_volterra.synthetic_data(20)
    model = lotka_volterra.make(ts, solver="rk4")

    def neg_logp(q):
        return -model.logp(q, jnp.asarray(y))

    value_and_grad = jax.jit(jax.value_and_grad(neg_logp))
    truth = np.concatenate([np.log(theta), np.log(z0), np.log([0.25, 0.25])])
    best = None
    for seed in range(4):
        start = truth + 0.1 * np.random.default_rng(seed).normal(size=8)
        r = minimize(lambda q: tuple(np.asarray(v) for v in value_and_grad(q)), start, jac=True, method="L-BFGS-B")
        if best is None or r.fun < best.fun:
            best = r
    sd = np.sqrt(np.diag(np.linalg.inv(np.asarray(jax.hessian(neg_logp)(jnp.asarray(best.x))))))
    print(json.dumps({
        "mode_theta": np.exp(best.x[:4]).tolist(), "mode_z0": np.exp(best.x[4:6]).tolist(),
        "mode_sigma": np.exp(best.x[6:]).tolist(),
        "abs_log_err_theta": np.abs(best.x[:4] - truth[:4]).tolist(),
        "abs_log_err_z0": np.abs(best.x[4:6] - truth[4:6]).tolist(),
        "laplace_sd_unconstrained": sd.tolist(),
    }))


if __name__ == "__main__":
    main()
