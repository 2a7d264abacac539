"""Lotka-Volterra ODE inverse problem (BASELINE.md config 4), written for a
leading chain axis.

Counterpart: ``math_tpu/models/lotka_volterra.py``.  Stan case-study
parameterization:

    theta = (alpha, beta, gamma, delta) > 0, lognormal-ish priors
    z0 > 0 initial populations
    y_obs[t, s] ~ lognormal(log z[t, s], sigma_s)

Solvers: ``"rk45"`` (adaptive DP5 with the continuous adjoint,
``ops/ode.py``, eager on either device) or ``"rk4"`` (the fixed grid of 24
steps an interval with the exact gradient of the discrete map: on the card
the kernel pair of ``ops/lv_rk4.py``, on the CPU its plain version).  Pass
``y_obs`` as a tensor on the sampling device through ``args``, as the JAX
bench passes an array.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from math_tpu_torch import dists, transforms
from math_tpu_torch.model import make_log_density
from math_tpu_torch.ops import lv_rk4
from math_tpu_torch.ops.ode import integrate_ode_rk45

# the right-hand side, ``(C, 2), (C, 4) -> (C, 2)`` (ref: lotka_volterra.py:24-29)
dz_dt = lv_rk4.lv_rhs

RK4_STEPS_PER_INTERVAL = 24


def synthetic_data(n_times=20, seed=0, dtype=np.float64):
    """``(ts, y_obs (n_times, 2), theta_true, z0_true)`` as numpy, the same
    arrays as the JAX package's for the same seed (ref: lotka_volterra.py:32-52)."""
    from scipy.integrate import solve_ivp

    theta_true = np.array([0.55, 0.028, 0.80, 0.024])
    z0_true = np.array([33.0, 6.0])
    ts = np.arange(1, n_times + 1, dtype=np.float64)
    sol = solve_ivp(
        lambda t, y: [
            theta_true[0] * y[0] - theta_true[1] * y[0] * y[1],
            -theta_true[2] * y[1] + theta_true[3] * y[0] * y[1],
        ],
        (0, float(ts[-1])),
        z0_true,
        t_eval=ts,
        rtol=1e-10,
        atol=1e-12,
    )
    z = sol.y.T
    rng = np.random.default_rng(seed)
    y = np.exp(np.log(z) + 0.25 * rng.normal(size=z.shape))
    return ts.astype(dtype), y.astype(dtype), theta_true, z0_true


def make(ts, rtol=1e-6, atol=1e-8, solver="rk45"):
    """``solver``: "rk45" (adaptive DP5 + continuous adjoint, the CVODES
    analog) or "rk4" (fixed grid, exact discretize-then-optimize gradients;
    the kernel pair on the card)."""
    if solver not in ("rk45", "rk4"):
        raise ValueError(f"solver must be 'rk45' or 'rk4'; got {solver!r}")
    ts = np.asarray(ts)

    def log_prob(p, y_obs):
        theta, z0, sigma = p["theta"], p["z0"], p["sigma"]  # (C, 4), (C, 2), (C, 2)
        lp = dists.normal_lpdf(torch.log(theta[:, 0::2]), -1.0, 0.5, propto=True, batch_ndims=1)
        lp = lp + dists.normal_lpdf(torch.log(theta[:, 1::2]), -3.5, 0.5, propto=True, batch_ndims=1)
        lp = lp + dists.lognormal_lpdf(z0, math.log(10.0), 1.0, propto=True, batch_ndims=1)
        lp = lp + dists.lognormal_lpdf(sigma, -1.0, 1.0, propto=True, batch_ndims=1)
        if solver == "rk4":
            z = lv_rk4.lv_rk4(z0, 0.0, ts, theta, RK4_STEPS_PER_INTERVAL)
        else:
            z = integrate_ode_rk45(dz_dt, z0, 0.0, ts, theta, rtol=rtol, atol=atol)
        z = torch.clamp_min(z, 1e-6)
        lp = lp + dists.lognormal_lpdf(y_obs, torch.log(z), sigma[:, None, :], propto=True, batch_ndims=1)
        return lp

    return make_log_density(
        {
            "theta": transforms.LowerBound(shape=(4,), lb=0.0),
            "z0": transforms.LowerBound(shape=(2,), lb=0.0),
            "sigma": transforms.LowerBound(shape=(2,), lb=0.0),
        },
        log_prob,
    )
