#!/usr/bin/env python3
"""The univariate slice's two phases of ``chip_smoke.py`` alone on the GPU.

Run from the repository root on a machine with one GPU and nvcc:

    python3 tools/univariate_phases.py            # censored_nb_path, univariate_sweep
    python3 tools/univariate_phases.py --profile  # and profile_censored_nb with inc_beta's device shares

It builds the port's kernels, runs ``censored_nb_path`` (the top-coded
negative-binomial regression under 256-chain NUTS: B1's NB-2 family on the
exact rows, ``inc_beta`` on the card for the top-coded ones) and
``univariate_sweep`` exactly as ``chip_smoke.py`` does, with the same gates,
and prints their JSON lines; with ``--profile`` it also traces a few
sampling transitions of the path (``profile_censored_nb``) and the device
time inside ``inc_beta``'s Lentz loop and quadrature.  Without a GPU it exits
2 and prints no result.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke  # noqa: E402
from math_tpu_torch.models import glm_logistic  # noqa: E402


def main():
    chip_smoke.phase_device()
    chip_smoke.phase_build()
    x = glm_logistic.synthetic_data(chip_smoke.N_MAIN, chip_smoke.K_MAIN)[0]
    res, model, args, _, _ = chip_smoke.phase_censored_nb_path(x)
    if "--profile" in sys.argv[1:]:
        chip_smoke.profile_inc_beta_share(res, model, args)
    del res, model, args
    chip_smoke.phase_univariate_sweep()


if __name__ == "__main__":
    main()
