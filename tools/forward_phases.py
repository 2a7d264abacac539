#!/usr/bin/env python3
"""The ``forward_mode`` and ``stan_surface`` phases of ``chip_smoke.py`` alone on the GPU.

Run from the repository root on a machine with one GPU and nvcc:

    python3 tools/forward_phases.py

It builds the port's kernels and runs the two phases with the gates of
``chip_smoke.py``: forward mode (``torch.func.jvp``) through each kernel's
``autograd.Function`` at full width against its plain version in float64
(B1's four families, B2 and B3 at N = 100,000, D = 50, C = 256, K = 5; B4 at
(32, 128)), one launch a primal and ``vmap`` folded into one launch; the
Hessian of BASELINE config 2's density (``functional.hessian``, forward over
reverse) at its MAP against ``infer.optimize.hessian`` and float64; the
Hessian-vector product of the 2000-point marginal GP against float64; then
``integrate_1d`` on the card against ``scipy.integrate.quad`` and the Stan
names that reach B4 on CUDA tensors.  ``chip_smoke.py`` takes the MAP from
``postfit_glm`` and the GP point from a ``gp_path`` draw; here they are the
MAP of each density (``map_estimate``, float32 on the card).  Prints the
phases' JSON lines and each kernel's forward-mode entry.  Without a GPU it
exits 2 and prints no result.
"""

import json
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke  # noqa: E402
from math_tpu_torch.infer import map_estimate  # noqa: E402
from math_tpu_torch.models import glm_logistic  # noqa: E402


def main():
    chip_smoke.phase_device()
    chip_smoke.phase_build()
    x, y, _, _ = glm_logistic.synthetic_data(chip_smoke.N_MAIN, chip_smoke.K_MAIN)
    names = [f"glm_fused[{f}]" for f in chip_smoke.glm_fused.FAMILIES] + [
        "glm_ordered_logistic", "glm_categorical_logit", "chol_inv_block"]
    entries = [{"name": n, "launches": 0} for n in names]
    glm = glm_logistic.make(chip_smoke.K_MAIN)
    theta_map = chip_smoke.glm_map(glm, *(torch.tensor(a, dtype=torch.float32, device="cuda") for a in (x, y))).theta
    model, xt, yt = chip_smoke.gp_setup()
    gp_z = map_estimate(model.logp, model.dim, args=(xt, yt), jacobian=True, dtype=torch.float32, device="cuda").theta
    forward_s = chip_smoke.phase_forward_mode(x, y, theta_map, gp_z, entries)
    stan_s, _ = chip_smoke.phase_stan_surface()
    print(json.dumps({"forward_entries": entries, "seconds": forward_s + stan_s}), flush=True)


if __name__ == "__main__":
    main()
