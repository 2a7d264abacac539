#!/usr/bin/env python3
"""The main path and ``postfit_glm`` of ``chip_smoke.py`` alone on the GPU.

Run from the repository root on a machine with one GPU and nvcc:

    python3 tools/postfit_phases.py

It builds the port's kernels, runs ``main_path`` (256-chain NUTS on the
100,000 x 50 logistic GLM) and then ``postfit_glm`` on its draws exactly as
``chip_smoke.py`` does, with the same gates: B1 at 1 and 4 lanes against its
plain version, PSIS-LOO and WAIC over every draw (the vectorised PSIS held
against the per-observation loop on 2,000 observations), MAP, Laplace and
Pathfinder in float32 on the card against float64 and the NUTS draws,
posterior-predictive generated quantities and a Stan CSV round trip; it
prints their JSON lines and B1's entry.  Without a GPU it exits 2 and prints
no result.
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke  # noqa: E402
from math_tpu_torch.models import glm_logistic  # noqa: E402


def main():
    chip_smoke.phase_device()
    chip_smoke.phase_build()
    x, y, beta_true, _ = glm_logistic.synthetic_data(chip_smoke.N_MAIN, chip_smoke.K_MAIN)
    entries = chip_smoke.phase_kernels(x)
    res = chip_smoke.phase_main_path(x, y, beta_true, entries)
    chip_smoke.phase_postfit_glm(x, y, res.position, entries[0])
    print(json.dumps({"b1": entries[0]}), flush=True)


if __name__ == "__main__":
    main()
