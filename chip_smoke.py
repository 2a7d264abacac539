#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on an NVIDIA GPU.

Run from the repository root with no arguments; needs one GPU, ``nvcc`` and
no network:

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises: the exit code is then
not 0 and no result line is printed):

1. ``device``   the GPU's name and power limit, torch/CUDA versions, TF32 off.
2. ``build``    compiles ``math_tpu_torch/csrc/*.cu`` from source with nvcc (one
   process per source, started together) and prints ``-Xptxas -v``'s
   registers, stack and spills of each kernel.
3. ``kernels``  every family of the fused GLM kernel (its tensor-core route,
   which the wrapper's tile plan picks at these shapes) against its plain
   PyTorch version (float64, on the GPU) at the main-path shape N=100,000,
   K=50, C=256 and at the ragged shape N=1537, K=7, C=5; the diagonal-block Cholesky kernel
   against its plain version at the GP path's shape (32 blocks of 128 x 128
   taken from the 2000-point kernel matrix: first diagonal block and a later
   Schur complement) and ragged (5 blocks of 37 x 37, one not positive
   definite); times of each kernel, of its plain version in float32, of the
   one PyTorch call (pair) that computes the same where there is one, and the
   least time the card could take for the work.
4. ``main_path`` with every launch count set to 0 just before and read just
   after: chain-batched NUTS with pooled warmup on the 100,000 x 50 logistic
   GLM, 256 chains, float32, through ``run_pooled_chains``; then value and
   gradient through the public dispatchers of the three other GLM families at
   the same width.  The bernoulli tensor-core kernel must have been launched
   exactly once per chain-batched gradient call of the sampler, the float32
   kernels and the plain version never.  Then ``postfit_glm``: the bernoulli
   kernel at 1 and 4 lanes against its plain version, and, with the counts
   set to 0 just before and read just after, what a user does after the fit
   on the main path's model and draws, float32 on the card: PSIS-LOO / WAIC
   over all 12,800 draws x 100,000 observations (the vectorised PSIS held
   against the per-observation loop on 2,000 observations), MAP
   (``jacobian=False``) against the float64 MAP on CPU tensors, Laplace
   (1,000 draws) and Pathfinder (4 paths) against the NUTS moments,
   posterior-predictive ``y_rep`` replayed from a seed, a Stan CSV round
   trip.  The kernel's launches must equal the phase's evaluations (plain
   version: the Laplace Hessian's one pass; no layout copy).
5. ``ordinal_path`` and ``categorical_path``, each with the counts set to 0
   just before its sampler and read just after: 256-chain NUTS (150 + 50,
   ``max_depth=6``, float32) through ``run_pooled_chains`` on an ordinal
   regression (ordered-logistic GLM, 100,000 x 50, K=5 categories, dim 54) and
   on a multinomial regression (categorical-logit GLM, same X, K=5 classes
   with class 1 as reference, dim 204), both written with the public API
   (``make_log_density``, transforms, densities).  The ordered (tensor-core)
   / categorical kernel must have been launched exactly once per gradient call,
   the tiled routes and the plain version never; divergences < 5%, finite draws, recovery of the generating
   parameters, and ``logp`` and gradient at 8 final positions against the
   float64 ``dists`` density.
6. ``gp_path``  again with the counts set to 0 just before and read just
   after: 32-chain NUTS on the 2000-point marginal GP (float32, jitter 1e-3,
   ``max_depth=3``, ``target_accept=0.75``) through ``run_pooled_chains``.  The
   block kernel must have been launched exactly ``ceil(n / B)`` times per
   gradient call and the plain version never; ``logp`` and its gradient at 8
   final positions are held against float64 ``torch.linalg``.  Then exact
   latent-field draws from 32 hyperparameter draws, and value and gradient of
   the latent model for 8 chains against float64.
   Then ``forward_mode``: each kernel's ``autograd.Function`` under
   ``torch.func.jvp`` at its path's width (B1's four families, B2, B3 at
   N=100,000, D=50, C=256, K=5; B4 at (32, 128)) against the ``jvp`` of its
   plain version in float64, the reverse comparison's gate carried to the
   tangent, with the counts set to 0 just before each: one launch and no
   plain call a primal; ``vmap`` of B1 over 2 x 128 lanes and of B4 over 2 x
   16 blocks, one launch each; ``functional.hessian`` (forward over
   reverse) of the main path's density at ``postfit_glm``'s MAP against
   ``optimize.hessian`` and float64 (one B1 launch); the Hessian-vector
   product of the GP density at a ``gp_path`` draw against float64 (whole
   factorizations on the block kernel).  And ``stan_surface``:
   ``integrate_1d`` with its gradient in theta on the three node sets
   against ``scipy.integrate.quad`` (float64 and float32 on the card), and
   six ``stan`` names that reach the block kernel on CUDA tensors against
   float64.  The two phases must take at most 30 s together.
7. ``eight_schools`` 64 chains on the GPU (a model without a kernel).

The slice of ``sample_nuts`` and the chunked sampler, each path with the counts
set to 0 just before it and read just after (its kernel launched once per
gradient call, no other kernel, no tiled route, no plain version and no
layout copy):

- ``sample_path``: ``sample_nuts`` (per-chain Stan warmup, ``auto_depth=True``)
  on the 100,000 x 50 logistic GLM, 256 chains, float32, 150 + 50 at a
  ceiling of 6: wall, gradient calls, ms per call, the chosen cap, tree
  depth, ESS / R-hat, recovery of ``beta_true`` within 0.05;
- ``chunked_path``: ``run_pooled_chains_chunked`` (chunks of 40) on the
  ordinal regression against ``run_pooled_chains`` from the same generator
  seed at the same cap, equal bit for bit; then with ``auto_depth=True``, its
  cap per chunk;
- ``dense_categorical``: ``sample_nuts(dense_mass=True)`` (a dense metric per
  chain) on the multinomial regression, 150 + 50 at ``max_depth=6``:
  gradient calls, tree depth, minimum bulk ESS and gradient calls per unit of
  it, beside the same of ``categorical_path`` (the pooled diagonal metric).

The ``kernels`` phase also holds the ordered and the categorical kernel
against their plain versions (float64) at the main-path shape and at ragged
shapes (N=1537, D=7, C=5, K=3 and 5; for the categorical kernel also C=13
with K=5, C=13 with K=7, which needs two column tiles and leaves columns of
the tile idle, and C=5 with K=64, one chain per tile).  The categorical
kernel's bound is counted for its route (three TF32 tensor-core products),
with the float32-FMA bound beside it, and ``products_library_ms`` times its
two products alone as float32 cuBLAS calls; so are kernel 1's four families
and the ordered kernel (their products as three TF32 products, the core on the
float32 units).  ``kernels_wide`` holds B1 / B2's tiled tensor-core route,
which takes the shapes ``glm_tc_kernel``'s layout cannot hold (D > 63, or K >
8 categories), against the plain version.  ``wide`` runs every input the dispatchers refused
before (the four families at D = 282 and 1024, the ordered GLM at D =
236, K = 5 and D = 1024, K = 12, the categorical at K = 65 and 200, D = 400 and
D = 212 at K = 41; an x 4 bytes off a 16-byte boundary, a transposed x, an
int64 y) through the public dispatchers, value and gradients against the
float64 plain version (every wide shape on a tiled tensor-core route; the
categorical shapes also at (7, 65), (320, 5), (700, 3), (330, 30) and (400, 12), and the four at N =
100,000 with C = 8; a ``torch.func.jvp`` through the pair at (50, 65)), and
times the wide shapes at N = 100,000, C = 256 beside their bounds and the
two products in float32 cuBLAS (one warm-up and the median of 3 calls
each).  The counts are set to 0 before its dispatcher calls; the tiled
routes' calls there are their launches in the ``kernels`` line's ninth and
tenth entries, ``glm_categorical_logit_tiled`` (its time, bounds and
products at (50, 65), the other three shapes beside) and
``glm_fused_tiled`` (B1 / B2: at bernoulli-logit, D = 282, the other nine
shapes beside).  ``kernels_chol`` prints the block
kernel's ``clock64`` stamps: how its time splits between factor and inverse.

BASELINE configs 3 and 5 as their benches drive them, after the paths above,
each with the counts set to 0 just before it and read just after:

- ``radon_path``: the radon model (85 counties, 919 observations) under
  ``run_pooled_chains_chunked``, 2048 chains, ``auto_depth`` at a ceiling of
  10, 200 warmup + 200 samples (the bench's 300 + 500 cut in length only):
  wall, gradient calls, ms per call, the cap and wall of every chunk, tree
  depth and the deepest lane's leapfrogs, ESS / R-hat on the five monitored
  coordinates, divergences and saturation; recovery of the generating means;
  ``logp`` and its gradient at the final positions equal bit for bit when
  computed twice (the segment products have no atomics); no hand kernel runs;
- ``advi_radon``: ADVI meanfield and fullrank on the same model (Stan's eta
  ladder, ``tol_rel_obj`` 0.01, 10,000 steps the cap), each against the NUTS
  draws: steps per second, steps run, ELBO, the eta chosen, z-scores and sd
  ratios on the monitored coordinates;
- ``resume_gp``: ``sample_nuts_checkpointed`` on the 2000-point marginal GP
  at the bench's settings (32 chains, depth 3, chunks of 30, warmup segments
  of 25), 50 + 60, straight and then interrupted after 30 samples and
  resumed: equal bit for bit, the native draw store read back, checkpoint
  time and size; the block kernel launched 16 times a gradient call;
- ``smc_gp``: ``smc_tempered_stagewise`` on the same model (64 particles in
  batches of 32, one mutation step of depth 3, ``target_rel_ess`` 0.3): the
  temperature ladder, log evidence, particle moments against ``gp_path``'s
  NUTS draws, peak memory; the block kernel launched 16 times a 32-row
  evaluation.

BASELINE config 4 as its bench drives it, with the counts set to 0 just
before it and read just after (``kernels_lv`` right after ``wide``, before
any sampler; the rest in the worker below):

- ``kernels_lv``: the Lotka-Volterra RK4 kernels (``csrc/lv_rk4.cu``; the
  forwards a thread a chain, the adjoints a warp a chain): the pair (the
  forward solve with its states kept, the exact adjoint from them, its 32
  segments of steps joined by a scan) against its plain version (autograd through
  ``ode_rk4_fixed``), and the dual pair (dual forward, dual adjoint) against
  ``torch.func.jvp`` of the plain version's value and vjp, at the path's
  shape (C = 512, T = 20, S = 24) in float32 against float64, the double
  instances against float64 (1e-10), the forward equal to the float32 plain
  version bit for bit and the dual forward's primal to the forward's, the
  states' layout, and ragged shapes (C = 5 and 129, T = 3, S = 1 and 7, one
  lane whose alpha overflows: the NaN / inf pattern must be the plain
  version's); for each of the four kernels its time (CUDA events over
  back-to-back calls, and its device time from the profiler), chain 0's
  serial time and cycles a step from its ``clock64`` / ``%globaltimer``
  stamps, and four bounds: operations, bytes, the dependent chain's latency
  (``op_latency_probe``: dependent add / multiply / FMA latency on the card)
  and the step loop's SASS instructions at one a cycle (``cuobjdump
  -sass``); the times of the plain version;
- ``lv_path``: ``make(ts, solver="rk4")`` on ``synthetic_data(20)`` under
  ``run_pooled_chains_chunked``, 512 chains, ``max_depth=7``, accept 0.85,
  chunks of 10 / 15, the bench's 150 + 150 cut to 100 + 100: the forward
  kernel launched once per log-density evaluation, the adjoint once per
  gradient call, the plain version never; wall, calls, tree depth, the
  deepest lane's leapfrogs, divergences, split R-hat and bulk ESS of log
  theta, calls per unit of minimum ESS, recovery of theta and z0 against
  the generating values and against the JAX package's posterior mode,
  ``logp`` and gradient at 8 final positions against the float64 plain
  model;
- ``lv_rk45``: the config's named method (adaptive DP5 with the continuous
  adjoint, eager) at the 512 final positions: 3 gradient calls in float32 and
  1 in float64, timed, the loop steps they take, ``logp`` and gradient
  against the RK4 model beside the reference's float64 audit;
- ``ode_family``: TR-BDF2 (van der Pol), the DAE (values and gradients) and
  the Newton / Powell root solvers (roots and implicit-function Jacobians) at
  64 lanes, float32 against float64 on the card.

Constrained matrix and simplex parameters, each path with the counts set to
0 just before it and read just after (``kernels_chol_small`` right after
``wide``, before any sampler; the two paths in the worker below):

- ``kernels_chol_small``: the block kernel at the shapes of per-chain
  covariance matrices, (Cb, B) = (256, 5) (LKJ(2) correlations scaled by
  lognormal sds) and (1024, 3) (Wishart draws), against its plain version in
  float64 (on the Wishart draws per matrix, in units of the float32
  roundoff times the condition number), timed beside the float32 plain
  version, ``torch.linalg.cholesky`` + ``solve_triangular`` and the bound;
  ragged B = 1, 3, 7, 17 with a block that is not positive definite (its NaN
  pattern the plain version's);
- ``constrained_prior``: 1024-chain ``run_pooled_chains`` (50 + 50, depth
  5) on a prior over one block of every constrained ``Transform`` class
  (``tools/constrained_models.py``): each constrained moment within 5
  Monte-Carlo errors (from the bulk ESS) of its closed form; the block kernel
  launched 7 times a gradient call, the plain version never;
- ``varying_slopes_path``: the LKJ varying-slopes regression of
  ``tools/constrained_models.py`` (100 groups of 20 rows, K = 5, dimension
  521) under 256-chain ``run_pooled_chains`` (100 + 100, depth 6, accept
  0.8): wall, calls, tree depth, divergences, split R-hat and bulk ESS of
  mu, log tau, Omega's off-diagonals and sigma, recovery of the generating
  values, ``logp`` and gradient at 8 final positions against the float64
  model on CPU tensors, a gradient repeatable bit for bit; the block kernel
  launched twice a gradient call (``multi_normal_lpdf`` and
  ``lkj_corr_lpdf``), the plain version never.

The univariate slice, in the worker below:

- ``censored_nb_path``: the top-coded negative-binomial regression of
  ``tools/univariate_models.py`` on the main path's 100,000 x 50 design
  (counts from NB2(exp(1.5 + X beta), 5), beta ~ normal(0, 0.1); the 5% of
  rows at y >= U recorded as "U or more") under 256-chain
  ``run_pooled_chains`` (60 + 60, depth 6, accept 0.8, float32): the
  exact rows through the NB-2 family of the fused GLM kernel (launched once a
  gradient call; plain version, layout copies and every other hand kernel 0),
  the top-coded rows through ``neg_binomial_2_lccdf`` (``inc_beta`` on the
  card).  Prints U and the top-coded share, wall, calls, ms a call, tree
  depth, divergences, split R-hat and bulk ESS of alpha, beta and log phi,
  calls per unit of minimum ESS, the Lentz iterations a call, recovery of
  the generating values, ``logp`` and gradient at 8 final positions against
  the float64 model on CPU tensors, and the NB-2 kernel's time at the path's
  row count; ``--profile`` adds ``profile_censored_nb`` and the device share
  of ``inc_beta``'s Lentz loop and quadrature;
- ``univariate_sweep``: every density and cdf of
  ``dists/{continuous,discrete,more}.py`` at one valid row a family,
  broadcast to (1024, 64) with a seeded jitter, and ``inc_beta``,
  ``gamma_p``, ``gamma_q``, ``owens_t`` and the four Bessel functions, in
  float32 on the card against float64 on CPU tensors (values and gradients
  in every float argument; ``inc_beta`` / ``gamma_p`` / ``gamma_q`` also
  against scipy in float64), and every ``_rng``: 250,000 draws from a CUDA
  generator, moments within 5 Monte-Carlo errors of the closed forms, the
  same draws again from the same seed.  Prints the worst error of each.

The worker: ``lv_path``, ``lv_second_order`` (``functional.hessian`` and
``laplace_sample``, 300 draws, at an ``lv_path`` draw in float32: the kernel
pair for every first-order gradient, the dual pair for forward mode and the
second order, no plain call, each launch counted and the seconds of each
printed; against the float64 plain model on CPU tensors), ``lv_rk45``, ``ode_family``, ``constrained_prior``,
``varying_slopes_path``, ``censored_nb_path`` and ``univariate_sweep`` run,
in that order and as described, in a second process of this script (``--worker``) that starts
after the kernel phases (``kernels``, ``kernels_chol``, ``wide``,
``kernels_lv`` and ``kernels_chol_small`` time the kernels on an idle card)
and runs beside the phases from ``main_path`` on; both are mostly host-bound
(one Python thread each, the card busy 8-26% of the time), so the script
takes about the longer of the two rather than their sum.  Its counts are
its own; it prints its phases' lines, which this process prints after its
own, and its launches join the kernel entries.  Phase times from
``main_path`` on are taken beside the worker.

When the main process's phases end, ``tools/sharded_phases.py`` runs beside
the worker in a process of its own (``parallel/`` over NCCL in a group of one, and two processes that
share the card over gloo; that script's docstring lists its phases and
gates); its B1 launches join the ``kernels`` line, and its phases must end
within ``SHARDED_BUDGET_S`` (the process's wall is reported beside them).

With ``--profile`` further phases trace a few sampling transitions of the
GLM, ordinal, multinomial, radon, LV, varying-slopes and censored NB paths
and a few gradient calls of the GP path with ``torch.profiler`` and print
the device time by kernel.

Without a GPU the sampler phases can be rehearsed on the CPU at a small size:
``drive_gp_sampler(n=48, chains=8, num_warmup=60, num_samples=40,
device="cpu", dtype=torch.float64)`` after ``update_config(cholesky_block_size=16)``;
``drive_ordinal_sampler(x, *ordinal_data(x), chains=16, num_warmup=100,
num_samples=50, max_depth=6, seed=0, device="cpu", dtype=torch.float64,
tol=0.3)`` with ``x = glm_logistic.synthetic_data(4000, 5)[0]``, and
``drive_categorical_sampler`` alike; ``check_radon(*drive_radon(chains=64,
device="cpu"))``, ``drive_resume_gp(n=48, chains=8, device="cpu",
dtype=torch.float64, sigma_tol=0.15)`` (block size 16, as above) and
``drive_smc_gp(positions, n=48, device="cpu", dtype=torch.float64)``;
``check_lv(*drive_lv(chains=16, device="cpu"))`` (an hour: the plain RK4
is ~0.4 s a gradient call on the CPU) and ``drive_ode_family(device="cpu")``;
``check_censored_nb(*drive_censored_nb(x, chains=8, num_warmup=60,
num_samples=60, device="cpu"))`` with the main path's ``x`` (~0.35 s a
gradient call on 8 chains: 20-40 min) and ``drive_univariate_sweep(device="cpu")``.

The last line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from math_tpu_torch import dists, functional, get_config, special, transforms, update_config
from math_tpu_torch.diagnostics import convergence
from math_tpu_torch.infer import (
    advi,
    run_pooled_chains,
    run_pooled_chains_chunked,
    sample_nuts,
    sample_nuts_checkpointed,
    smc_tempered_stagewise,
)
from math_tpu_torch.io import draw_store
from math_tpu_torch.model import make_log_density
from math_tpu_torch.models import eight_schools, glm_logistic, gp_regression, lotka_volterra, radon
from math_tpu_torch.ops import _build, chol_blocked, glm_fused, lv_rk4
from math_tpu_torch.ops import gp as gp_ops
from math_tpu_torch.ops.cholesky import spd_solve_logdiag_reference
from math_tpu_torch.ops import solve as solve_ops
from math_tpu_torch.ops.ode import integrate_dae, integrate_ode_bdf, integrate_ode_rk45
from math_tpu_torch.special import incbeta

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
import constrained_models  # noqa: E402  (tools/constrained_models.py: the two user models of the constrained phases)
import univariate_models  # noqa: E402  (tools/univariate_models.py: the censored NB regression and the sweep tables)

# Published peaks of one H100 SXM (NVIDIA's data sheet): float32 outside the
# tensor cores, TF32 on the tensor cores (dense), and HBM bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12

N_MAIN, K_MAIN, C_MAIN = 100_000, 50, 256
N_RAGGED, K_RAGGED, C_RAGGED = 1537, 7, 5

# Operations of one family core per eta element (each of + - * / max abs
# select exp log counted as one), for the bound; the two products are 4*K more.
CORE_OPS = {"bernoulli_logit": 18, "poisson_log": 5, "normal_id": 8, "neg_binomial_2_log": 24}
DISPATCHERS = {
    "bernoulli_logit": glm_fused.bernoulli_logit_glm_lpmf_chains,
    "poisson_log": glm_fused.poisson_log_glm_lpmf_chains,
    "normal_id": glm_fused.normal_id_glm_lpdf_chains,
    "neg_binomial_2_log": glm_fused.neg_binomial_2_log_glm_lpmf_chains,
}
REPLACES = "math_tpu/ops/pallas_glm.py:112"

# The ordinal and multinomial paths: K categories / classes at the main width.
K_CAT = 5
CUTS_TRUE = (-2.5, -0.8, 0.8, 2.5)
RAGGED_ORDERED = [(N_RAGGED, K_RAGGED, C_RAGGED, 3), (N_RAGGED, K_RAGGED, C_RAGGED, 5)]  # (n, d, c, k)
# More ragged shapes of the tensor-core GLM kernels (128 chains a block, two
# pairs of warpgroups of 64): C=200, the second column tile's second pair
# holding 8 chains, D=33 not a multiple of 8; N=20,000, several row tiles a
# block (the bulk-copy barrier's phases); the ordered kernel for every other
# K it is compiled for, and the widest D whose block fits at K=5 and K=8.
RAGGED_TC_FAMILY = [(4099, 33, 200), (20_000, K_RAGGED, C_RAGGED)]  # (n, d, c)
RAGGED_TC_ORDERED = [(4099, 33, 200, 5), (20_000, K_RAGGED, C_RAGGED, 5)] + [
    (N_RAGGED, K_RAGGED, C_RAGGED, k) for k in (2, 4, 6, 7, 8)] + [(N_RAGGED, 63, C_RAGGED, 5), (N_RAGGED, 56, C_RAGGED, 8)]
# C=13, K=5: 65 of a tile's 80 columns; C=13, K=7: two column tiles of 11
# chains, 77 of 80 columns; C=5, K=64: one chain per tile
RAGGED_CATEGORICAL = RAGGED_ORDERED + [(N_RAGGED, K_RAGGED, 13, 5), (N_RAGGED, K_RAGGED, 13, 7), (N_RAGGED, K_RAGGED, C_RAGGED, 64)]


def ordered_core_ops(k):
    """Operations the ordered-logistic function needs per (row, chain) beside
    its two products, counted as ``CORE_OPS`` from what any implementation
    must compute, not from the kernel: u1 and u2 (2), two softplus (12), lp
    with log1m_exp (10), w1 and w2 (8), theta' (1), the logp sum (1), and w2
    and -w1 added into gcuts (2).  The same for every K."""
    return 36


def categorical_core_ops(k):
    """Operations the categorical-logit function needs per (row, chain) beside
    its two products, counted from the function: alpha added to the K logits
    (K), one log-sum-exp (the maximum K-1, the K differences and their
    exponentials, their sum K-1, log and the maximum added back 2), lp (1),
    one softmax from the same exponentials (1/s and K products), theta' (K),
    the logp sum (1) and galpha (K adds)."""
    return 8 * k + 3


N_GP, C_GP, JITTER_GP = 2000, 32, 1e-3
CB_RAGGED, B_RAGGED = 5, 37


def require(cond, what):
    """A check of this script: raises (``assert`` would vanish under -O)."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


START = time.perf_counter()


def emit(phase, **fields):
    """One JSON line a phase; ``script_s``: seconds since the script started,
    so a log shows where the time limit goes."""
    print(json.dumps({"phase": phase, **fields, "script_s": time.perf_counter() - START}), flush=True)


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs one GPU", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    require(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 must stay off: the port's products are float32")
    require(get_config().device == "cuda", "the port's default device must be the GPU")
    emit(
        "device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        float32_matmul_precision=torch.get_float32_matmul_precision(),
        sms=torch.cuda.get_device_properties(0).multi_processor_count,
    )
    return smi


def kernel_name(mangled):
    """``name<args>`` of a mangled kernel: the last component of its
    (nested) name, then its integer, bool, float and double template
    arguments."""
    s, i = mangled, 2
    if not s.startswith("_Z"):
        return s
    nested = s[i] == "N"
    i += nested
    names = []
    while i < len(s) and s[i].isdigit():
        j = i
        while s[j].isdigit():
            j += 1
        names.append(s[j : j + int(s[i:j])])
        i = j + int(s[i:j])
        if not nested:
            break
    args = []
    if i < len(s) and s[i] == "I":
        i += 1
        while i < len(s) and s[i] != "E":
            if s[i] == "L":  # a literal: L<type><value>E
                j = s.index("E", i)
                args.append(("true" if s[i + 2 : j] == "1" else "false") if s[i + 1] == "b" else s[i + 2 : j])
                i = j + 1
            elif s[i] in "fd":
                args.append({"f": "float", "d": "double"}[s[i]])
                i += 1
            else:
                break
    return (names[-1] + (f"<{','.join(args)}>" if args else "")) if names else s


def ptxas_report(log):
    """``[kernel, registers, stack bytes, spill store bytes, spill load bytes]``
    for each kernel of one ``nvcc -Xptxas -v`` log."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = [kernel_name(m.group(1))]
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and entry is not None:
            entry += [int(m.group(1)), int(m.group(2)), int(m.group(3))]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            out.append([entry[0], int(m.group(1)), *entry[1:]])
            entry = None
    return out


def phase_build():
    t0 = time.perf_counter()
    names = ["glm_fused", "glm_categorical", "chol_inv_block", "lv_rk4"]
    started = {name: _build.start_build(name) for name in names}  # one nvcc per source, together
    for name in names:
        _build.finish_build(name, started[name])
    glm_fused._library()
    glm_fused._categorical_library()
    chol_blocked._library()
    lv_rk4._library()
    emit("build", sources=[f"math_tpu_torch/csrc/{n}.cu" for n in names],
         seconds=time.perf_counter() - t0, nvcc_seconds=dict(_build.BUILD_SECONDS),
         ptxas={n: ptxas_report(_build.BUILD_LOG.get(n, "")) for n in names})


def make_inputs(family, n, k, c, seed, scale, x=None):
    """Inputs of one family from a seed, as numpy (float32 values)."""
    rng = np.random.default_rng(seed)
    if x is None:
        x = rng.normal(size=(n, k)).astype(np.float32)
    alpha = (rng.normal(size=c) * scale).astype(np.float32)
    beta = (rng.normal(size=(k, c)) * scale).astype(np.float32)
    extra = None
    if family == "bernoulli_logit":
        y = rng.integers(0, 2, n)
    elif family == "poisson_log":
        y = rng.poisson(2.0, n)
    elif family == "normal_id":
        y = rng.normal(size=n)
        extra = 0.5 + rng.uniform(size=c)
    else:
        y = rng.poisson(3.0, n)
        extra = 1.0 + 3.0 * rng.uniform(size=c)
    extra = None if extra is None else extra.astype(np.float32)
    return y.astype(np.float32), x, alpha, beta, extra


def on_gpu(arrays, dtype):
    return [None if a is None else torch.tensor(a, dtype=dtype, device="cuda") for a in arrays]


def time_ms(fn, warmup, reps):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(family, arrays, grad_atol):
    """Kernel (float32) against the plain version in float64 on the same
    inputs.  logp: rtol=2e-5.  Gradients: rtol=3e-4 and ``grad_atol`` (float32
    sums taken in another order; the absolute error of such a sum grows with
    the number of rows, so the 1e-3 that holds at N~3000 is scaled with N)."""
    got = glm_fused.glm_fused_parts(family, *on_gpu(arrays, torch.float32))
    torch.cuda.synchronize()
    want = glm_fused.glm_fused_parts_reference(family, *on_gpu(arrays, torch.float64))
    plain32 = glm_fused.glm_fused_parts_reference(family, *on_gpu(arrays, torch.float32))
    names = ("logp", "ga", "gb", "ge")
    errs = hold_parts(family, got, want, names, grad_atol)
    return errs, {name: float((p.double() - w).abs().max()) for name, p, w in zip(names, plain32, want) if w is not None}


def hold_parts(label, got, want, names, grad_atol):
    """The gates of ``compare``: each part of the kernel's result float32,
    finite and of its float64 counterpart's shape (None where that is None);
    logp within rtol 2e-5, the gradients within rtol 3e-4 and ``grad_atol``.
    Returns the largest absolute error of each part."""
    errs = {}
    for name, g, w in zip(names, got, want):
        if w is None:
            require(g is None, f"{label}: {name} returned for a family without an extra parameter")
            continue
        require(g.shape == w.shape and g.dtype == torch.float32 and bool(torch.isfinite(g).all()), (label, name))
        rtol, atol = (2e-5, 0.0) if name == "logp" else (3e-4, grad_atol)
        err = (g.double() - w).abs()
        require(bool((err <= atol + rtol * w.abs()).all()), (
            f"{label} {name}: kernel disagrees with the plain version: max abs err {float(err.max())}, "
            f"max |want| {float(w.abs().max())}, rtol {rtol}, atol {atol}"
        ))
        errs[name] = float(err.max())
    return errs


def ragged_atol(n):
    """The gradient atol of ``compare`` at ``n`` rows: 1e-3 up to N=3000, then scaled with N."""
    return 1e-3 * max(1.0, n / 3000.0)


def through_tensor_cores(kernel, label, run):
    """``run()`` must launch the tensor-core kernel ``kernel`` once and nothing else."""
    before = (dict(glm_fused.LAUNCHES), dict(glm_fused.LAUNCHES_TILED))
    out = run()
    want = dict(before[0], **{kernel: before[0][kernel] + 1})
    require(glm_fused.LAUNCHES == want and glm_fused.LAUNCHES_TILED == before[1], f"{label}: not the tensor-core kernel alone")
    return out


def phase_kernels(x_main):
    entries = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for i, family in enumerate(glm_fused.FAMILIES):
        ragged = make_inputs(family, N_RAGGED, K_RAGGED, C_RAGGED, seed=100 + i, scale=0.2)
        ragged_errs, _ = compare(family, ragged, grad_atol=1e-3)
        ragged_tc = {}
        for j, (rn, rd, rc) in enumerate(RAGGED_TC_FAMILY):
            require(glm_fused.glm_tile_plan(rn, rd, rc, sms)["route"] == "tensor_cores", (family, rn, rd, rc))
            arrays = make_inputs(family, rn, rd, rc, seed=110 + 10 * i + j, scale=0.2)
            ragged_tc[f"n{rn}_d{rd}_c{rc}"], _ = through_tensor_cores(
                family, f"{family} n{rn} d{rd} c{rc}", lambda: compare(family, arrays, grad_atol=ragged_atol(rn)))
        main = make_inputs(family, N_MAIN, K_MAIN, C_MAIN, seed=200 + i, scale=0.1, x=x_main)
        grad_atol = 1e-3 * N_MAIN / 3000.0
        errs, plain_errs = compare(family, main, grad_atol=grad_atol)
        split_errs = products_split_err(family, main)

        t32 = on_gpu(main, torch.float32)
        # the design matrix (20 MB) stays in the 50 MB L2 between launches, as
        # it does between the gradient calls of the sampler
        ms = time_ms(lambda: glm_fused.glm_fused_parts(family, *t32), warmup=3, reps=20)
        plain_ms = time_ms(lambda: glm_fused.glm_fused_parts_reference(family, *t32), warmup=2, reps=5)
        n, k, c = N_MAIN, K_MAIN, C_MAIN
        flops = 4.0 * n * k * c + float(CORE_OPS[family]) * n * c
        nbytes = 4.0 * (n * k + n + 2 * k * c + 3 * c + (2 * c if glm_fused.HAS_EXTRA[family] else 0))
        bounds = tensor_core_bounds(n, k, c, CORE_OPS[family], flops, nbytes)
        x1 = torch.cat([t32[1], torch.ones_like(t32[1][:, :1])], dim=1)  # [x, 1], made once
        products_ms = time_ms(lambda: glm_products_library(t32[1], x1, t32[3]), warmup=2, reps=10)
        plan = glm_fused.glm_tile_plan(n, k, c, torch.cuda.get_device_properties(0).multi_processor_count)
        require(plan["route"] == "tensor_cores", f"{family}: the main shape must run on the tensor cores: {plan}")
        require(bounds["bound_ms"] <= ms, f"{family}: {ms} ms beats its bound {bounds['bound_ms']} ms: the count is wrong")
        del t32, x1
        entries.append({
            "name": f"glm_fused[{family}]",
            "route": "cuda",
            "source": "math_tpu_torch/csrc/glm_fused.cu",
            "replaces": REPLACES,
            "launches": None,  # filled from the main path's run
            "max_abs_err": max(errs.values()),
            "ms": ms,
            "kernel_ms": ms,
            "plain_ms": plain_ms,
            **bounds,
            "library_ms": None,  # no one PyTorch call computes this function
            "products_library_ms": products_ms,
            "tile_plan": plan,
            "shape": {"n": n, "k": k, "c": c},
            "abs_err": errs,
            "plain_f32_abs_err": plain_errs,
            "ragged_abs_err": {"n1537_d7_c5": ragged_errs, **ragged_tc},
            "products_split_abs_err": split_errs,
            "tolerance": {"logp_rtol": 2e-5, "grad_rtol": 3e-4, "grad_atol": grad_atol,
                          "ragged_grad_atol": "1e-3 * max(1, N / 3000)"},
            "tflops": flops / (ms * 1e-3) / 1e12,
            "tf32_tflops": 3.0 * 4.0 * n * k * c / (ms * 1e-3) / 1e12,
        })
    return entries


def tf32_round(a):
    """float32 -> TF32 as ``cvt.rna.tf32.f32`` (ties away from zero), on the int32 bits."""
    return ((a.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32x3_exact_sums(a, b):
    """``a @ b`` (float64 operands, rounded to float32 first) as three TF32
    products ``lo_a hi_b + hi_a lo_b + hi_a hi_b`` of the 3xTF32 split, summed
    in float64: the split's error alone, without the tensor core's sums."""
    def split(t):
        t = t.float()
        hi = tf32_round(t)
        return hi.double(), tf32_round(t - hi).double()
    ah, al = split(a)
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def products_split_err(family, arrays):
    """Where the tensor-core kernel's error comes from: the function in float64
    with one of its two products taken by the 3xTF32 split
    (``tf32x3_exact_sums``), against the float64 plain version.  ``eta``:
    eta = x @ beta split, the core and ``[x, 1]^T theta'`` exact; ``xt_theta``:
    eta and the core exact, ``[x, 1]^T theta'`` split.  A family whose
    theta' moves fast with eta (poisson: exp(eta); normal: 1 / sigma^2) carries
    product 1's error into its gradients."""
    y, x, alpha, beta, extra = on_gpu(arrays, torch.float64)
    e2 = extra[None, :] if extra is not None else None
    x1 = torch.cat([x, torch.ones_like(x[:, :1])], dim=1)

    def parts(eta, product2):
        lp, tp, de = glm_fused._core(family, eta, y[:, None], e2)
        g = product2(x1.mT, tp)
        return {"logp": lp.sum(0), "ga": g[-1], "gb": g[:-1], **({"ge": de.sum(0)} if de is not None else {})}

    exact = lambda a, b: a @ b  # noqa: E731
    want = parts(x @ beta + alpha, exact)
    got = {"eta": parts(tf32x3_exact_sums(x, beta) + alpha, exact),
           "xt_theta": parts(x @ beta + alpha, tf32x3_exact_sums)}
    return {where: {k: float((v - want[k]).abs().max()) for k, v in out.items()} for where, out in got.items()}


def tensor_core_bounds(n, d, c, core_ops, flops, nbytes):
    """The least time of a GLM kernel whose two products run as three TF32
    products on the tensor cores and whose core runs on the float32 units:
    ``max(3*4*N*D*C / 495e12, core_ops*N*C / 67e12, bytes / 3.35e12)``, with
    each term beside it and the bound of the same function by float32 FMAs."""
    t_tensor = 3.0 * 4.0 * n * d * c / PEAK_TF32_FLOPS * 1e3
    t_core = float(core_ops) * n * c / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    bound = max(t_tensor, t_core, t_bytes)
    return {"bound_ms": bound, "bound_by": "bytes" if t_bytes >= bound else "operations",
            "bound_tensor_ms": t_tensor, "bound_core_ms": t_core, "bound_bytes_ms": t_bytes,
            "bound_fp32_fma_ms": max(flops / PEAK_FP32_FLOPS * 1e3, t_bytes)}


def glm_products_library(x, x1, beta):
    """The two products of a GLM kernel alone, ``x @ beta`` and ``[x, 1]^T
    theta'`` (for the categorical kernel ``beta`` is the (D, C*K) matrix of
    its beta), with ``x1 = [x, 1]``, as float32 cuBLAS calls with TF32 off
    (timing only: a yardstick for the products, not for the function; the port
    never calls it).  eta stands in for theta'."""
    return x1.mT @ (x @ beta)


# The shapes glm_tc_kernel's layout cannot hold go to the tiled route: D > 63;
# for the ordered one also K > 8, and D 57-63 at K 6-8, whose block does not
# fit shared memory; K = 20 takes gcuts in two passes of sixteen cuts.  At N
# = 20,000 (157 row tiles) a block of launch 1 takes two or three row tiles
# and one of launch 2 many row chunks, its ring running on across them; C =
# 200 and 150 give a second column tile of 72 and of 22 chains (launch 1's
# second warpgroup with and without chains), D = 150 a second feature group
# of 22 features (launch 2's second warpgroup idle), and D = 150 and 40 a
# number of slices that the ring's three stages do not divide.
WIDE_FAMILY = [(4099, 96, 70), (20_000, 150, 200)]  # (n, k, c)
WIDE_ORDERED = [(4099, 70, 40, 5), (4099, 20, 40, 10), (4099, 63, 40, 8), (4099, 40, 40, 20), (20_000, 150, 150, 12),
                (20_000, 40, 200, 9)]  # (n, d, c, k)


def tiled_route_reach(n, d, c, sms):
    """What one call of B1 / B2's tiled route at ``(n, d, c)`` exercises,
    from its plan: the most row tiles a block of launch 1 takes, the most row
    chunks a block of launch 2 takes, column tiles, feature groups, whether
    the last column tile leaves launch 1's second warpgroup without chains
    and the last feature group launch 2's without features, and whether the
    ring's stages divide the slices of a row tile (the plan is the same for
    every K)."""
    plan = glm_fused.glm_tiled_plan(n, d, c, sms)
    row_tiles = -(-n // glm_fused.GLM_TILED_ROWS)
    last_chains = c - (plan["column_tiles"] - 1) * glm_fused.GLM_TILED_CHAINS
    last_features = d - (plan["feature_groups"] - 1) * glm_fused.GLM_TILED_FEATURES
    return {"tiles_a_block": -(-row_tiles // plan["row_blocks_value"]),
            "chunks_a_block": -(-4 * row_tiles // plan["row_blocks"]),
            "column_tiles": plan["column_tiles"], "feature_groups": plan["feature_groups"],
            "one_warpgroup_launch_1": last_chains <= 64, "one_warpgroup_launch_2": last_features <= 64,
            "ring_turns_within_tiles": plan["slices"] % glm_fused.GLM_TILED_STAGES != 0}


def phase_kernels_wide():
    """B1 / B2's tiled route (every family, and the ordered one) on shapes
    glm_tc_kernel does not take, against the plain version (float64) with the
    usual tolerances; the wrapper must have sent each there, by shape, one
    call each.  Together the shapes reach every branch ``tiled_route_reach``
    names."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    report, reach = {}, {}
    for w, (n, k, c) in enumerate(WIDE_FAMILY):
        require(glm_fused.glm_tile_plan(n, k, c, sms)["kernel"] == "tiled", "wide family shape: not the tiled route")
        reach[f"n{n}_d{k}_c{c}"] = tiled_route_reach(n, k, c, sms)
        for i, family in enumerate(glm_fused.FAMILIES):
            before = (dict(glm_fused.LAUNCHES), dict(glm_fused.LAUNCHES_TILED))
            errs, _ = compare(family, make_inputs(family, n, k, c, seed=610 + i + 10 * w, scale=0.1), grad_atol=ragged_atol(n))
            require(glm_fused.LAUNCHES == before[0]
                    and glm_fused.LAUNCHES_TILED == dict(before[1], **{family: before[1][family] + 1}),
                    f"wide {family} shape did not go through the tiled route alone")
            report[f"{family}_n{n}_k{k}_c{c}"] = errs
    for j, (n, d, c, kk) in enumerate(WIDE_ORDERED):
        require(glm_fused.glm_tile_plan(n, d, c, sms, kcat=kk)["kernel"] == "tiled", "wide ordered shape: not the tiled route")
        reach[f"n{n}_d{d}_c{c}_k{kk}"] = tiled_route_reach(n, d, c, sms)
        before = (dict(glm_fused.LAUNCHES), glm_fused.LAUNCHES_TILED[glm_fused.ORDERED])
        y, xw, *params = ordered_inputs(n, d, c, kk, seed=620 + j, scale=0.1)
        errs, _ = compare_parts("glm_ordered_logistic wide", glm_fused.ordered_logistic_glm_parts,
                                glm_fused.ordered_logistic_glm_parts_reference, y, [xw, *params], ("logp", "gbeta", "gcuts"),
                                ragged_atol(n))
        require(glm_fused.LAUNCHES == before[0] and glm_fused.LAUNCHES_TILED[glm_fused.ORDERED] == before[1] + 1,
                "wide ordered shape did not go through the tiled route alone")
        report[f"ordered_n{n}_d{d}_c{c}_k{kk}"] = errs
    for key in ("one_warpgroup_launch_1", "one_warpgroup_launch_2", "ring_turns_within_tiles"):
        require({r[key] for r in reach.values()} == {True, False}, f"kernels_wide: no shape with and without {key}")
    require(max(r["tiles_a_block"] for r in reach.values()) > 1 and max(r["column_tiles"] for r in reach.values()) > 1
            and max(r["feature_groups"] for r in reach.values()) > 1, f"kernels_wide: shapes reach too little: {reach}")
    emit("kernels_wide", abs_err=report, reach=reach)
    return report


def map_estimate_numpy(x, y):
    """An independent reference for the main path's posterior: the MAP
    estimate of the logistic GLM (alpha ~ normal(0, 5), beta ~ normal(0, 2)) by
    Newton's method in float64 numpy, and the Laplace standard deviations.
    At N >> K the posterior mean sits within a small fraction of a standard
    deviation of it."""
    xa = np.concatenate([np.ones((x.shape[0], 1)), x.astype(np.float64)], axis=1)
    y = y.astype(np.float64)
    prec = np.array([1.0 / 25.0] + [1.0 / 4.0] * x.shape[1])
    theta = np.zeros(xa.shape[1])
    for _ in range(50):
        p = 1.0 / (1.0 + np.exp(-(xa @ theta)))
        hess = (xa * (p * (1.0 - p))[:, None]).T @ xa + np.diag(prec)
        step = np.linalg.solve(hess, xa.T @ (y - p) - prec * theta)
        theta = theta + step
        if np.max(np.abs(step)) < 1e-12:
            break
    return theta, np.sqrt(np.diag(np.linalg.inv(hess)))


def drive_glm_sampler(x, y, beta_true, *, chains, num_warmup, num_samples, max_depth, seed, device="cuda",
                      dtype=torch.float32, beta_tol=0.05):
    """The main path: NUTS with pooled warmup on the logistic GLM."""
    k = x.shape[1]
    model = glm_logistic.make(k)
    gen = torch.Generator(device=device).manual_seed(seed)
    xt = torch.tensor(x, dtype=dtype, device=device)
    yt = torch.tensor(y, dtype=dtype, device=device)
    z0 = model.initial_positions(gen, chains, device=device, dtype=dtype)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_pooled_chains(
        gen, z0, model.logp, args=(xt, yt), num_warmup=num_warmup, num_samples=num_samples,
        max_depth=max_depth, target_accept=0.8, device=device,
    )
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pos = res.position.double().cpu().numpy()
    draws = model.transform_draws(res.position)
    require(res.position.shape == (chains, num_samples, k + 1), f"draws have shape {tuple(res.position.shape)}")
    require(np.isfinite(pos).all(), "non-finite draws")
    div_rate = float(res.diverging.double().mean())
    beta = draws["beta"].double().reshape(-1, k).cpu().numpy()
    beta_err = float(np.max(np.abs(beta.mean(0) - beta_true)))
    require(div_rate < 0.05, f"divergence rate {div_rate}")
    require(beta_err < beta_tol, f"max |mean(beta) - beta_true| = {beta_err}")
    theta_map, sd_map = map_estimate_numpy(x, y)
    map_err_sd = float(np.max(np.abs(pos.reshape(-1, k + 1).mean(0) - theta_map) / sd_map))
    require(map_err_sd < 0.25, f"posterior mean is {map_err_sd} Laplace sd from the float64 MAP estimate")
    report = {
        "chains": chains, "n": x.shape[0], "k": k, "dtype": str(dtype), "num_warmup": num_warmup,
        "num_samples": num_samples, "max_depth": max_depth, "wall_s": wall,
        "grad_calls": res.n_grad_calls, "grad_calls_per_s": res.n_grad_calls / wall,
        "chain_leapfrogs_per_s": res.n_grad_calls * chains / wall,
        "sampling_leapfrogs_counted": int(res.n_leapfrog.sum()),
        "divergence_rate": div_rate, "max_abs_beta_err": beta_err,
        "max_beta_err_in_posterior_sd": float(np.max(np.abs(beta.mean(0) - beta_true) / beta.std(0))),
        "max_abs_map_err_vs_true": float(np.max(np.abs(theta_map[1:] - beta_true))),
        "max_mean_err_vs_map_in_sd": map_err_sd,
        "posterior_sd_over_laplace_sd": [float(v) for v in np.percentile(pos.reshape(-1, k + 1).std(0) / sd_map, [0, 50, 100])],
        "step_size": float(res.step_size), "mean_tree_depth": float(res.tree_depth.double().mean()),
        "mean_accept": float(res.accept_prob.mean()),
        "min_ess_bulk_first6": float(np.min(convergence.ess_bulk(pos[..., :6]))),
        "max_split_rhat_first6": float(np.max(convergence.split_rhat(pos[..., :6]))),
    }
    return res, report


def drive_other_families(x_gpu):
    """Value and gradient through the public dispatchers of the three GLM
    families the sampler's model does not use, at the main path's width."""
    out = {}
    for i, family in enumerate(glm_fused.FAMILIES):
        if family == "bernoulli_logit":
            continue
        arrays = make_inputs(family, N_MAIN, K_MAIN, C_MAIN, seed=300 + i, scale=0.1, x=np.empty((0, 0), np.float32))
        y, _, *params = on_gpu(arrays, torch.float32)
        params = [p.requires_grad_(True) for p in params if p is not None]
        val = DISPATCHERS[family](y, x_gpu, *params)
        grads = torch.autograd.grad(val.sum(), params)
        out[family] = (arrays, val.detach(), grads)
    torch.cuda.synchronize()
    return out


def check_other_families(x_gpu, driven):
    """After the counts were read: the same through autograd of the plain
    version in float64 (value rtol=2e-5; gradients rtol=3e-4, atol scaled
    with N as in the kernels phase)."""
    grad_atol = 1e-3 * N_MAIN / 3000.0
    x64 = x_gpu.double()
    report = {}
    for family, (arrays, val, grads) in driven.items():
        y, _, *params = on_gpu(arrays, torch.float64)
        params = [p.requires_grad_(True) for p in params if p is not None]
        logp = plain_logp(family, y, x64, params)
        want_grads = torch.autograd.grad(logp.sum(), params)
        require(bool(((val.double() - logp.detach()).abs() <= 2e-5 * logp.detach().abs()).all()), family)
        worst = 0.0
        for g, w in zip(grads, want_grads):
            err = (g.double() - w).abs()
            require(bool((err <= grad_atol + 3e-4 * w.abs()).all()), (family, float(err.max())))
            worst = max(worst, float(err.max()))
        report[family] = {"max_abs_grad_err": worst}
    return report


def phase_main_path(x, y, beta_true, entries):
    x_gpu = torch.tensor(x, dtype=torch.float32, device="cuda")
    glm_fused.reset_counts()
    res, report = drive_glm_sampler(
        x, y, beta_true, chains=C_MAIN, num_warmup=150, num_samples=50, max_depth=6, seed=0
    )
    launches_sampler = dict(glm_fused.LAUNCHES)
    driven = drive_other_families(x_gpu)
    launches = dict(glm_fused.LAUNCHES)
    launches_tiled = dict(glm_fused.LAUNCHES_TILED)
    plain_calls = dict(glm_fused.PLAIN_CALLS)
    layout_copies = dict(glm_fused.LAYOUT_COPIES)

    require(launches_sampler["bernoulli_logit"] == res.n_grad_calls > 0, (launches_sampler, res.n_grad_calls))
    require(all(v == 0 for v in layout_copies.values()), f"the dispatchers copied x or y on the main path: {layout_copies}")
    require(not any(launches_tiled.values()), f"a tiled route ran on the main path: {launches_tiled}")
    require(all(v == 0 for v in plain_calls.values()), f"the plain version ran on the main path: {plain_calls}")
    for e in entries:
        family = e["name"][len("glm_fused["):-1]
        e["launches"] = launches[family]
        require(e["launches"] > 0, f"{e['name']} was not launched on the main path")
    others = check_other_families(x_gpu, driven)
    emit("main_path", **report, kernel_launches=launches, tiled_launches=launches_tiled, plain_calls=plain_calls,
         layout_copies=layout_copies, other_families=others)
    return res


def dev_us(event):
    """Device time of one profiler row in microseconds (the attribute was renamed between PyTorch versions)."""
    return getattr(event, "self_device_time_total", None) or getattr(event, "self_cuda_time_total", 0.0)


# profiler ranges (``record_function``) of the port: their device rows sum the
# kernels inside them and are not kernels themselves
PROFILER_RANGES = ("inc_beta.lentz", "inc_beta.quadrature")


def device_kernels(prof):
    """``(rows of the device kernels, their total time in microseconds)`` of a finished profile."""
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in PROFILER_RANGES]
    total_us = sum(dev_us(e) for e in kernels)
    require(total_us > 0, "the profiler saw no device time")
    return kernels, total_us


def phase_profile(res, model, args, label="profile", transitions=5):
    """Only with ``--profile``: where the time of a sampling transition goes.
    Continues a path's chains at their adapted step size and metric; times
    ``transitions`` transitions on the host clock, then traces as many with
    ``torch.profiler`` and sums the device time by kernel.  Returns
    ``(device kernel rows, their total microseconds, traced gradient calls)``."""
    from torch.profiler import ProfilerActivity, profile

    from math_tpu_torch.infer.nuts import ChainNoise, LogpGrad
    from math_tpu_torch.infer.pooled import sample_pooled

    fn = LogpGrad(model.logp, args)
    noise = ChainNoise(torch.Generator(device="cuda").manual_seed(7), "cuda", torch.float32)
    state = res.final_state

    def run(n):
        with torch.no_grad():
            out = sample_pooled(noise, state, fn, res.step_size, res.inv_mass, n, max_depth=res.max_depth)
        torch.cuda.synchronize()
        return out[0]

    state = run(2)
    calls0, t0 = fn.calls, time.perf_counter()
    state = run(transitions)
    wall = time.perf_counter() - t0
    calls = fn.calls - calls0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(transitions)
    calls_traced = fn.calls - calls0 - calls
    kernels, total_us = device_kernels(prof)
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    emit(
        label, transitions=transitions, wall_s_untraced=wall, grad_calls_untraced=calls,
        ms_per_grad_call_untraced=wall / calls * 1e3, grad_calls_traced=calls_traced,
        device_ms_traced=total_us / 1e3, device_ms_per_grad_call=total_us / 1e3 / calls_traced,
        device_launches_per_grad_call=sum(e.count for e in kernels) / calls_traced,
        device_busy_share=(total_us / 1e6 / calls_traced) / (wall / calls),
        top_kernels=[{"name": e.key[:80], "count": e.count, "device_ms": dev_us(e) / 1e3} for e in top],
    )
    return kernels, total_us, calls_traced


# ---------------------------------------------------------------------------
# The ordinal and multinomial paths: the ordered and categorical kernels and
# the samplers around them
# ---------------------------------------------------------------------------


def ordered_inputs(n, d, c, k, seed, scale, x=None):
    """y (int32), x, beta (D, C), cuts (K-1, C) from a seed, as numpy (float32 values)."""
    rng = np.random.default_rng(seed)
    if x is None:
        x = rng.normal(size=(n, d)).astype(np.float32)
    beta = (rng.normal(size=(d, c)) * scale).astype(np.float32)
    cuts = np.cumsum(0.3 + rng.uniform(size=(k - 1, c)), axis=0) - 0.5 * k
    y = rng.integers(1, k + 1, n).astype(np.int32)
    return y, x, beta, cuts.astype(np.float32)


def categorical_inputs(n, d, c, k, seed, scale, x=None):
    """y (int32), x, alpha (C, K), beta (C, D, K) from a seed, as numpy (float32 values)."""
    rng = np.random.default_rng(seed)
    if x is None:
        x = rng.normal(size=(n, d)).astype(np.float32)
    alpha = (rng.normal(size=(c, k)) * 0.3).astype(np.float32)
    beta = (rng.normal(size=(c, d, k)) * scale).astype(np.float32)
    y = rng.integers(1, k + 1, n).astype(np.int32)
    return y, x, alpha, beta


def with_y(y, floats, dtype):
    return [torch.as_tensor(y, dtype=torch.int32, device="cuda")] + on_gpu(floats, dtype)


def compare_parts(label, kernel, plain, y, floats, names, grad_atol):
    """Kernel (float32) against its plain version in float64 on the same
    inputs, with the tolerances of ``compare``: logp rtol=2e-5; gradients
    rtol=3e-4 and ``grad_atol``."""
    got = kernel(*with_y(y, floats, torch.float32))
    torch.cuda.synchronize()
    want = plain(*with_y(y, floats, torch.float64))
    plain32 = plain(*with_y(y, floats, torch.float32))
    errs = hold_parts(label, got, want, names, grad_atol)
    return errs, {name: float((p.double() - w).abs().max()) for name, p, w in zip(names, plain32, want)}


def phase_kernels_ordered_categorical(x_main):
    """The ordered and the categorical kernel against their plain versions at
    the ragged shapes and the main-path shape, and their times there."""
    n, d, c, k = N_MAIN, K_MAIN, C_MAIN, K_CAT
    grad_atol = 1e-3 * N_MAIN / 3000.0
    specs = [
        ("glm_ordered_logistic", "math_tpu_torch/csrc/glm_fused.cu", "math_tpu/ops/pallas_glm.py:459",
         ordered_inputs, RAGGED_ORDERED, glm_fused.ordered_logistic_glm_parts,
         glm_fused.ordered_logistic_glm_parts_reference, ("logp", "gbeta", "gcuts")),
        ("glm_categorical_logit", "math_tpu_torch/csrc/glm_categorical.cu", "math_tpu/ops/pallas_glm.py:650",
         categorical_inputs, RAGGED_CATEGORICAL, glm_fused.categorical_logit_glm_parts,
         glm_fused.categorical_logit_glm_parts_reference, ("logp", "galpha", "gbeta")),
    ]
    entries = []
    for i, (name, source, replaces, make, ragged_shapes, kernel, plain, names) in enumerate(specs):
        ragged = {}
        for j, (rn, rd, rc, rk) in enumerate(ragged_shapes):
            y, xr, *params = make(rn, rd, rc, rk, seed=500 + 10 * i + j, scale=0.2)
            ragged[f"n{rn}_d{rd}_c{rc}_k{rk}"], _ = compare_parts(f"{name} ragged", kernel, plain, y, [xr, *params], names, 1e-3)
        if name == "glm_ordered_logistic":
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            for j, (rn, rd, rc, rk) in enumerate(RAGGED_TC_ORDERED):
                require(glm_fused.glm_tile_plan(rn, rd, rc, sms, kcat=rk)["route"] == "tensor_cores", (name, rn, rd, rc, rk))
                y, xr, *params = make(rn, rd, rc, rk, seed=540 + j, scale=0.2)
                ragged[f"n{rn}_d{rd}_c{rc}_k{rk}"], _ = through_tensor_cores(
                    glm_fused.ORDERED, f"{name} n{rn} d{rd} c{rc} k{rk}",
                    lambda: compare_parts(f"{name} ragged", kernel, plain, y, [xr, *params], names, ragged_atol(rn)))
        y, _, *params = make(n, d, c, k, seed=520 + i, scale=0.1, x=x_main)
        errs, plain_errs = compare_parts(name, kernel, plain, y, [x_main, *params], names, grad_atol)

        t32 = with_y(y, [x_main, *params], torch.float32)
        # x (20 MB) stays in the 50 MB L2 between launches, as between the sampler's gradient calls
        ms = time_ms(lambda: kernel(*t32), warmup=3, reps=20)
        plain_ms = time_ms(lambda: plain(*t32), warmup=2, reps=5)
        extra = {}
        if name == "glm_ordered_logistic":
            flops = 4.0 * n * d * c + float(ordered_core_ops(k)) * n * c
            # y, x, beta, cuts read; logp, gbeta, gcuts written
            nbytes = 4.0 * (n + n * d + d * c + (k - 1) * c) + 4.0 * (c + d * c + (k - 1) * c)
            # the kernel's route: its products as three TF32 products on the
            # tensor cores, the core on the float32 units
            bounds = tensor_core_bounds(n, d, c, ordered_core_ops(k), flops, nbytes)
            t_ops = max(bounds["bound_tensor_ms"], bounds["bound_core_ms"])
            x1 = torch.cat([t32[1], torch.ones_like(t32[1][:, :1])], dim=1)  # [x, 1], made once
            plan = glm_fused.glm_tile_plan(n, d, c, torch.cuda.get_device_properties(0).multi_processor_count, kcat=k)
            require(plan["route"] == "tensor_cores", f"{name}: the main shape must run on the tensor cores: {plan}")
            extra = {
                **{key: v for key, v in bounds.items() if key not in ("bound_ms", "bound_by")},
                "products_library_ms": time_ms(lambda: glm_products_library(t32[1], x1, t32[2]), warmup=2, reps=10),
                "tile_plan": plan,
                "tf32_tflops": 3.0 * 4.0 * n * d * c / (ms * 1e-3) / 1e12,
            }
            del x1
        else:
            flops = 4.0 * n * d * c * k + float(categorical_core_ops(k)) * n * c
            # y, x, alpha, beta read; logp, galpha, gbeta written
            nbytes = 4.0 * (n + n * d + c * k + c * d * k) + 4.0 * (c + c * k + c * d * k)
            # the kernel's route: its products as three TF32 products on the
            # tensor cores (as many as a GLM of D*K columns), the core on the
            # float32 units
            bounds = tensor_core_bounds(n, d * k, c, categorical_core_ops(k), flops, nbytes)
            t_ops = max(bounds["bound_tensor_ms"], bounds["bound_core_ms"])
            bmat = t32[3].permute(1, 0, 2).reshape(d, c * k)  # (D, C*K), column c*K + k, made once
            x1 = torch.cat([t32[1], torch.ones_like(t32[1][:, :1])], dim=1)  # [x, 1], made once
            extra = {
                **{key: v for key, v in bounds.items() if key not in ("bound_ms", "bound_by")},
                "products_library_ms": time_ms(lambda: glm_products_library(t32[1], x1, bmat), warmup=2, reps=10),
                "tile_plan": glm_fused.categorical_tile_plan(n, d, c, k, torch.cuda.get_device_properties(0).multi_processor_count),
                "tf32_tflops": 3.0 * 4.0 * n * d * c * k / (ms * 1e-3) / 1e12,
            }
        del t32
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        require(max(t_ops, t_bytes) <= ms, f"{name}: {ms} ms beats its bound {max(t_ops, t_bytes)} ms: the count is wrong")
        entries.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": None,  # filled from its path's run
            "max_abs_err": max(errs.values()),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,  # no one PyTorch call computes this function with its gradients
            "shape": {"n": n, "d": d, "c": c, "k": k},
            "abs_err": errs,
            "plain_f32_abs_err": plain_errs,
            "ragged_abs_err": ragged,
            "tolerance": {"logp_rtol": 2e-5, "grad_rtol": 3e-4, "grad_atol": grad_atol,
                          "ragged_grad_atol": "1e-3 * max(1, N / 3000)"},
            "tflops": flops / (ms * 1e-3) / 1e12,
            **extra,
        })
    return entries


# The inputs the dispatchers once refused: shapes the first tensor-core
# kernels do not hold, which the tiled routes take (all four families at D = 282 and
# 1024; the ordered one at D = 236, K = 5 and D = 1024, K = 12; the
# categorical one at K = 65 and 200 with D = 50, D = 400 at K = 5 and D = 212
# at K = 41), and layouts the dispatchers lay out (x[1:] with an odd D, so 4
# bytes past a 16-byte boundary; a transposed x; an int64 y) at a shape of
# each tensor-core route.
C1_N, C1_C = 4099, 20  # ragged rows; 20 chains: a ragged second column tile
C1_FAMILY_D = (282, 1024)
C1_ORDERED = ((236, 5), (1024, 12))  # (d, k)
C1_CATEGORICAL = ((50, 65), (50, 200), (400, 5), (212, 41))  # (d, k)
# More shapes of the tiled categorical pair: a narrow x with K > 64 (one k8
# step of a slice), D = 320 (six row tiles of [gbeta; galpha] in an instance
# of seven), D = 700 (x too wide to come whole: the ring carries it, three
# groups), K = 30 and K = 12 (launch 1's other sweeps); and the four above at
# N = 100,000 with C = 8 (the float64 plain version's (C, N, K) logits take
# 1.3 GB at K = 200).
C1_CATEGORICAL_MORE = ((7, 65), (320, 5), (700, 3), (330, 30), (400, 12))  # (d, k)
C1_BIG_N, C1_BIG_C = 100_000, 8
C1_SHAPES = ([(f, d, None) for f in glm_fused.FAMILIES for d in C1_FAMILY_D] + [("ordered", d, k) for d, k in C1_ORDERED]
             + [("categorical", d, k) for d, k in C1_CATEGORICAL])  # (kind, d, k)
C1_LAYOUT_D, C1_LAYOUT_K = 33, 5
C1_LAYOUTS = ("misaligned_x", "transposed_x", "int64_y")


def glm_params(kind, d, c, k, seed, scale):
    """y (numpy) and the float parameters (numpy, float32 values) of one GLM
    kind: a family name, ``ordered`` or ``categorical``."""
    if kind == "ordered":
        y, _, beta, cuts = ordered_inputs(1, d, c, k, seed, scale, x=np.empty((0, d), np.float32))
        return y, [beta, cuts]
    if kind == "categorical":
        y, _, alpha, beta = categorical_inputs(1, d, c, k, seed, scale, x=np.empty((0, d), np.float32))
        return y, [alpha, beta]
    y, _, alpha, beta, extra = make_inputs(kind, 1, d, c, seed, scale, x=np.empty((0, d), np.float32))
    return y, [p for p in (alpha, beta, extra) if p is not None]


def glm_y(kind, n, k, seed):
    """n outcomes of one GLM kind from a seed (numpy)."""
    rng = np.random.default_rng(seed)
    if kind in ("ordered", "categorical"):
        return rng.integers(1, k + 1, n).astype(np.int32)
    return make_inputs(kind, n, 1, 1, seed, 0.1, x=np.empty((n, 1), np.float32))[0]


def plain_logp(kind, y, x, params):
    """The dispatcher's value by the plain version, differentiable (float64
    on the card: the reference of the ``wide`` phase)."""
    if kind == "ordered":
        return glm_fused.ordered_logistic_glm_parts_reference(y, x, *params)[0]
    if kind == "categorical":
        return glm_fused.categorical_logit_glm_parts_reference(y, x, *params)[0]
    extra = params[2] if len(params) > 2 else None
    logp = glm_fused.glm_fused_parts_reference(kind, y, x, params[0], params[1], extra)[0]
    n = y.shape[0]
    if kind == "normal_id":
        logp = logp - n * torch.log(extra)
    elif kind == "neg_binomial_2_log":
        logp = logp + torch.lgamma(y[:, None] + extra[None, :]).sum(0) - n * torch.lgamma(extra) + n * extra * torch.log(extra)
    return logp


def glm_dispatcher(kind):
    if kind == "ordered":
        return glm_fused.ordered_logistic_glm_lpmf_chains
    if kind == "categorical":
        return glm_fused.categorical_logit_glm_lpmf_chains
    return DISPATCHERS[kind]


def counter_key(kind):
    return {"ordered": glm_fused.ORDERED, "categorical": glm_fused.CATEGORICAL}.get(kind, kind)


def glm_plan(kind, n, d, c, k):
    """The wrapper's plan of one GLM kind at this shape (for the categorical
    one, ``kernel`` says which of its two tensor-core kernels)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if kind == "categorical":
        return glm_fused.categorical_route(n, d, c, k, sms)
    return glm_fused.glm_tile_plan(n, d, c, sms, kcat=k if kind == "ordered" else None)


def dispatch_against_float64(label, kind, y_np, x32, params_np, layout=None):
    """One call of the public dispatcher on the card (float32), value and
    gradients by autograd, against the float64 plain version on the same
    inputs: logp rtol 2e-5; gradients rtol 3e-4 and atol 1e-3 * max(1, N /
    3000) (``kernels_wide``'s tolerances).  The dispatcher must launch one
    kernel of the route its shape gets, copy ``x`` / ``y`` only for a
    ``layout`` input, and call no plain version."""
    n, d = x32.shape
    c = params_np[0].shape[-1] if kind not in ("categorical",) else params_np[0].shape[0]
    k = params_np[1].shape[0] + 1 if kind == "ordered" else (params_np[0].shape[1] if kind == "categorical" else None)
    key = counter_key(kind)
    plan = glm_plan(kind, n, d, c, k)
    route, tiled = plan["route"], plan.get("kernel") == "tiled"
    y = torch.as_tensor(y_np, device="cuda")
    if layout == "int64_y":
        y = y.to(torch.int64)  # an ordered / categorical kernel takes int32, a family's the type of x
    else:
        y = y.to(torch.int32) if kind in ("ordered", "categorical") else y.to(torch.float32)
    x = x32
    if layout == "misaligned_x":
        buf = torch.empty((n + 1, d), dtype=torch.float32, device="cuda")
        buf[1:] = x32
        x = buf[1:]
        require(x.data_ptr() % 16 != 0, f"{label}: x[1:] is aligned")
    elif layout == "transposed_x":
        x = x32.mT.contiguous().mT
        require(not x.is_contiguous(), f"{label}: x is contiguous")
    params = [torch.tensor(p, dtype=torch.float32, device="cuda").requires_grad_(True) for p in params_np]
    counts = lambda: tuple(dict(t) for t in (glm_fused.LAUNCHES, glm_fused.LAUNCHES_TILED, glm_fused.PLAIN_CALLS,  # noqa: E731
                                             glm_fused.LAYOUT_COPIES))
    before = counts()
    val = glm_dispatcher(kind)(y, x, *params)
    grads = torch.autograd.grad(val.sum(), params)
    torch.cuda.synchronize()
    after = counts()
    counter = 1 if tiled else 0  # which of LAUNCHES, LAUNCHES_TILED
    want = [dict(b, **({key: b[key] + 1} if i == counter else {})) for i, b in enumerate(before[:2])]
    require(list(after[:2]) == want, f"{label}: not one call of the {plan['kernel']} tensor-core kernel")
    require(after[2] == before[2], f"{label}: the plain version ran on a CUDA tensor")
    require(after[3] == dict(before[3], **{key: before[3][key] + (1 if layout else 0)}),
            f"{label}: layout copies {after[3]} against {before[3]}")
    p64 = [torch.tensor(p, dtype=torch.float64, device="cuda").requires_grad_(True) for p in params_np]
    y64 = torch.as_tensor(y_np, device="cuda")
    y64 = y64.to(torch.int32) if kind in ("ordered", "categorical") else y64.to(torch.float64)
    want = plain_logp(kind, y64, x32.double(), p64)
    want_grads = torch.autograd.grad(want.sum(), p64)
    grad_atol = 1e-3 * max(1.0, n / 3000.0)
    errs = {}
    for name, g, w, rtol, atol in [("logp", val.detach(), want.detach(), 2e-5, 0.0)] + [
            (f"grad{i}", g, w, 3e-4, grad_atol) for i, (g, w) in enumerate(zip(grads, want_grads))]:
        require(g.shape == w.shape and bool(torch.isfinite(g).all()), f"{label} {name}: shape or non-finite")
        err = (g.double() - w).abs()
        require(bool((err <= atol + rtol * w.abs()).all()), (
            f"{label} {name}: dispatcher disagrees with the float64 plain version: max abs err {float(err.max())}, "
            f"max |want| {float(w.abs().max())}, rtol {rtol}, atol {atol}"))
        errs[name] = float(err.max())
    return {"route": route, "kernel": plan["kernel"], "n": n, "d": d, "c": c, "k": k, "abs_err": errs}


def wide_bound(kind, n, d, c, k):
    """The least time of the function at a wide shape: its FP32-FMA
    operations at 67 TFLOP/s (the products 4*N*D*C, K times that for the
    categorical, and the core) or its bytes at 3.35 TB/s (inputs read once,
    outputs written once), whichever is larger."""
    if kind == "categorical":
        flops = 4.0 * n * d * c * k + float(categorical_core_ops(k)) * n * c
        nbytes = 4.0 * (n + n * d + c * k + c * d * k) + 4.0 * (c + c * k + c * d * k)
    elif kind == "ordered":
        flops = 4.0 * n * d * c + float(ordered_core_ops(k)) * n * c
        nbytes = 4.0 * (n + n * d + d * c + (k - 1) * c) + 4.0 * (c + d * c + (k - 1) * c)
    else:
        flops = 4.0 * n * d * c + float(CORE_OPS[kind]) * n * c
        nbytes = 4.0 * (n * d + n + 2 * d * c + 3 * c + (2 * c if glm_fused.HAS_EXTRA[kind] else 0))
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def glm_products_library_rows(x, x1, bmat, max_elems=2.5e8):
    """``glm_products_library`` over blocks of rows, so that eta of a wide
    categorical shape (N x C*K) is never whole in memory (timing only)."""
    rows = max(1, int(max_elems // bmat.shape[1]))
    out = None
    for r in range(0, x.shape[0], rows):
        p = glm_products_library(x[r : r + rows], x1[r : r + rows], bmat)
        out = p if out is None else out + p
    return out


def median_ms(fn, warmup, reps):
    """``(median, every rep)``: ``fn`` timed launch by launch with CUDA events
    after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = [time_ms(fn, warmup=0, reps=1) for _ in range(reps)]
    return float(np.median(times)), times


def time_wide(kind, d, k, x_main):
    """The tiled tensor-core route of one wide shape at N = 100,000, C = 256
    (B1 / B2's five launches a call, or the categorical pair's five): one
    warm-up and the median of 3 calls by CUDA events, beside its bound (three
    TF32 products, the core on the float32 units or the bytes; the FP32-FMA
    and bytes bounds beside it) and the two products alone in float32 cuBLAS,
    timed alike (timing only)."""
    n, c = N_MAIN, C_MAIN
    gen = torch.Generator(device="cuda").manual_seed(700 + d + (k or 0))
    x = x_main if d == x_main.shape[1] else torch.randn((n, d), generator=gen, device="cuda")
    y = torch.as_tensor(glm_y(kind, n, k, seed=710 + d), device="cuda")
    y = y.to(torch.int32) if kind in ("ordered", "categorical") else y.to(torch.float32)
    scale = min(0.1, 1.0 / math.sqrt(d))
    _, params = glm_params(kind, d, c, k, seed=720 + d, scale=scale)
    params = [torch.tensor(p, device="cuda") for p in params]
    if kind == "ordered":
        fn = lambda: glm_fused.ordered_logistic_glm_parts(y, x, *params)  # noqa: E731
        bmat, cols, core = params[0], d, ordered_core_ops(k)
    elif kind == "categorical":
        fn = lambda: glm_fused.categorical_logit_glm_parts(y, x, *params)  # noqa: E731
        bmat, cols, core = params[1].permute(1, 0, 2).reshape(d, c * k), d * k, categorical_core_ops(k)
    else:
        fn = lambda: glm_fused.glm_fused_parts(kind, y, x, *params[:2], params[2] if len(params) > 2 else None)  # noqa: E731
        bmat, cols, core = params[1], d, CORE_OPS[kind]
    x1 = torch.cat([x, torch.ones_like(x[:, :1])], dim=1)
    products = lambda: glm_products_library_rows(x, x1, bmat)  # noqa: E731
    bound = wide_bound(kind, n, d, c, k)
    plan = glm_plan(kind, n, d, c, k)
    require(plan["route"] == "tensor_cores" and plan["kernel"] == "tiled", f"{kind} d{d} k{k}: not the tiled route")
    ms, reps = median_ms(fn, warmup=1, reps=3)
    library_ms, library_reps = median_ms(products, warmup=1, reps=3)
    tc = tensor_core_bounds(n, cols, c, core, bound["flops"], bound["bytes"])
    del x1, bmat
    abs_err = None
    if kind != "categorical":
        # B1 / B2's timed call against float64: here a block of launch 1 takes a dozen row tiles, two column
        # tiles of 128 chains, up to eight feature groups of launch 2, each block many row chunks
        names = ("logp", "gbeta", "gcuts") if kind == "ordered" else ("logp", "ga", "gb", "ge")
        p64 = [p.double() for p in params]
        if kind == "ordered":
            want = glm_fused.ordered_logistic_glm_parts_reference(y, x.double(), *p64)
        else:
            want = glm_fused.glm_fused_parts_reference(kind, y.double(), x.double(), *p64[:2], p64[2] if len(p64) > 2 else None)
        abs_err = hold_parts(f"{kind} d{d} k{k} timed", fn(), want, names, ragged_atol(n))
        del want, p64
    require(tc["bound_ms"] <= ms, f"{kind} d{d} k{k}: {ms} ms beats its bound {tc['bound_ms']} ms")
    return {"kind": kind, "n": n, "d": d, "c": c, "k": k, "ms": ms, "reps_ms": reps, **bound,
            "bound_ms": tc["bound_ms"], "bound_by": tc["bound_by"], "bound_fp32_ms": bound["bound_ms"],
            "bound_tensor_ms": tc["bound_tensor_ms"], "bound_bytes_ms": tc["bound_bytes_ms"],
            "fp32_tflops": bound["flops"] / (ms * 1e-3) / 1e12, "tf32_tflops": 3.0 * 4.0 * n * cols * c / (ms * 1e-3) / 1e12,
            "products_library_ms": library_ms, "products_reps_ms": library_reps, "launches_per_call": plan["launches"],
            "plan": {key: v for key, v in plan.items() if isinstance(v, (int, bool))}, "abs_err": abs_err}


def categorical_jvp(d, k):
    """``torch.func.jvp`` through ``CategoricalGlmFused`` at a shape of the
    tiled pair (N = 4,099, C = 20), tangents on alpha and beta: one call of
    the pair and no plain call for the primal and its tangent; the tangent
    against the plain version's ``jvp`` in float64, each partial's gate
    (rtol 3e-4, ``grad_atol``) times its tangent."""
    n, c = C1_N, C1_C
    y, xn, *params = categorical_inputs(n, d, c, k, seed=930, scale=0.1)
    tans = [tangent_like(p, 931 + j, 0.1) for j, p in enumerate(params)]
    yt, x32, *p32 = with_y(y, [xn, *params], torch.float32)
    _, x64, *p64 = with_y(y, [xn, *params], torch.float64)
    t32, t64 = on_gpu(tans, torch.float32), on_gpu(tans, torch.float64)
    kernel = lambda a, b: glm_fused.CategoricalGlmFused.apply(yt, x32, a, b)[0]  # noqa: E731
    plain = lambda a, b: glm_fused.categorical_logit_glm_parts_reference(yt, x64, a, b)[0]  # noqa: E731
    (_, got), launches, plain_calls = count_launches(lambda: torch.func.jvp(kernel, tuple(p32), tuple(t32)))
    require(launches == {f"{glm_fused.CATEGORICAL}_tiled": 1} and not plain_calls,
            f"categorical jvp d{d} k{k}: launches {launches}, plain calls {plain_calls}")
    want = torch.func.jvp(plain, tuple(p64), tuple(t64))[1]
    grad_atol = ragged_atol(n)
    parts = glm_fused.categorical_logit_glm_parts_reference(yt, x64, *p64)[1:]
    bound = sum((t * (grad_atol + JVP_RTOL * g.abs())).abs().flatten(1).sum(1) for t, g in zip(t64, parts)) + grad_atol
    err = (got.double() - want).abs()
    require(bool(torch.isfinite(got).all()) and bool((err <= bound).all()),
            f"categorical jvp d{d} k{k}: max abs err {float(err.max())}, worst err / bound {float((err / bound).max())}")
    return {"d": d, "k": k, "n": n, "c": c, "launches": launches, "max_abs_err": float(err.max()),
            "max_err_over_bound": float((err / bound).max())}


def phase_wide(x_main):
    """The inputs the dispatchers once refused, through them on the card, each
    against the float64 plain version (N = 4,099, C = 20; the categorical
    shapes also at N = 100,000, C = 8, and (7, 65), (320, 5)), a ``jvp``
    through the tiled categorical pair; then the wide shapes timed at N =
    100,000, C = 256.  The counts are set to 0 just before the dispatcher
    calls and read just after (the tiled pair's launches of its entry)."""
    x_full = torch.tensor(x_main, device="cuda")
    checks, timings = {}, []
    glm_fused.reset_counts()
    cat_shapes = [(C1_N, C1_C, d, k) for d, k in C1_CATEGORICAL + C1_CATEGORICAL_MORE] + [
        (C1_BIG_N, C1_BIG_C, d, k) for d, k in C1_CATEGORICAL]
    cases = [(kind, C1_N, C1_C, d, k) for kind, d, k in C1_SHAPES if kind != "categorical"] + [
        ("categorical", n, c, d, k) for n, c, d, k in cat_shapes]
    for i, (kind, n, c, d, k) in enumerate(cases):
        rng = np.random.default_rng(800 + i)
        x = torch.tensor(rng.normal(size=(n, d)).astype(np.float32), device="cuda")
        y = glm_y(kind, n, k, seed=810 + i)
        _, params = glm_params(kind, d, c, k, seed=820 + i, scale=min(0.1, 1.0 / math.sqrt(d)))
        label = f"{kind}_d{d}" + (f"_k{k}" if k else "") + (f"_n{n}_c{c}" if (n, c) != (C1_N, C1_C) else "")
        checks[label] = dispatch_against_float64(label, kind, y, x, params)
        require(checks[label]["kernel"] == "tiled", f"{label}: a wide shape must take a tiled tensor-core route")
        del x
    glm_launches = sum(glm_fused.LAUNCHES_TILED[f] for f in glm_fused.FAMILIES + (glm_fused.ORDERED,))
    glm_cases = sum(kind != "categorical" for kind, *_ in cases)
    require(glm_launches == glm_cases, f"B1 / B2's tiled route: {glm_launches} calls for {glm_cases}")
    tiled_launches = glm_fused.LAUNCHES_TILED[glm_fused.CATEGORICAL]
    require(tiled_launches == len(cat_shapes), f"the tiled pair: {tiled_launches} calls for {len(cat_shapes)}")
    jvp = categorical_jvp(*C1_CATEGORICAL[0])  # its counts from 0 (count_launches): one call of the pair
    tiled_launches += jvp["launches"].get(f"{glm_fused.CATEGORICAL}_tiled", 0)
    for j, kind in enumerate(glm_fused.FAMILIES[:1] + ("ordered", "categorical")):
        k = C1_LAYOUT_K if kind != "bernoulli_logit" else None
        rng = np.random.default_rng(900 + j)
        x = torch.tensor(rng.normal(size=(C1_N, C1_LAYOUT_D)).astype(np.float32), device="cuda")
        y = glm_y(kind, C1_N, k, seed=910 + j)
        _, params = glm_params(kind, C1_LAYOUT_D, C1_C, k, seed=920 + j, scale=0.1)
        for layout in C1_LAYOUTS:
            label = f"{kind}_{layout}"
            checks[label] = dispatch_against_float64(label, kind, y, x, params, layout=layout)
            require(checks[label]["route"] == "tensor_cores" and checks[label]["kernel"] == "single",
                    f"{label}: the layout inputs must take the first tensor-core kernel")
    for kind, d, k in C1_SHAPES:
        timings.append(time_wide(kind, d, k, x_full))
        torch.cuda.empty_cache()
    tiled_checks = {lab: v for lab, v in checks.items() if v["kernel"] == "tiled" and lab.startswith("categorical")}
    tiled_entry = tiled_categorical_entry(x_full, tiled_launches, tiled_checks, jvp,
                                          [t for t in timings if t["kind"] == "categorical"])
    glm_checks = {lab: v for lab, v in checks.items() if v["kernel"] == "tiled" and not lab.startswith("categorical")}
    glm_entry = glm_tiled_entry(glm_launches, glm_checks, [t for t in timings if t["kind"] != "categorical"])
    emit("wide", inputs=checks, timed=timings, categorical_jvp=jvp, tiled_launches=tiled_launches,
         glm_tiled_launches=glm_launches,
         tolerance={"logp_rtol": 2e-5, "grad_rtol": 3e-4, "grad_atol": "1e-3 * max(1, N / 3000)"})
    return checks, timings, tiled_entry, glm_entry


def glm_tiled_entry(launches, checks, timed):
    """The ``kernels`` line's entry of B1 / B2's tiled route: its time, bounds
    and products at bernoulli-logit, D = 282, N = 100,000, C = 256, the plain
    version's time there (one call, on the same inputs as ``time_wide``'s),
    the other timed shapes beside, its launches (calls of the route, five
    launches each) from the ``wide`` dispatcher calls, and the largest error
    of those calls and of the timed ones against the float64 plain version."""
    main = next(t for t in timed if t["kind"] == "bernoulli_logit" and t["d"] == C1_FAMILY_D[0])
    n, d, c = main["n"], main["d"], main["c"]
    x = torch.randn((n, d), generator=torch.Generator(device="cuda").manual_seed(700 + d), device="cuda")
    y = torch.as_tensor(glm_y("bernoulli_logit", n, None, seed=710 + d), device="cuda").to(torch.float32)
    _, params = glm_params("bernoulli_logit", d, c, None, seed=720 + d, scale=min(0.1, 1.0 / math.sqrt(d)))
    alpha, beta = [torch.tensor(p, device="cuda") for p in params]
    plain_ms = time_ms(lambda: glm_fused.glm_fused_parts_reference("bernoulli_logit", y, x, alpha, beta), warmup=0, reps=1)
    del x, alpha, beta
    torch.cuda.empty_cache()
    return {
        "name": "glm_fused_tiled",
        "route": "cuda",
        "source": "math_tpu_torch/csrc/glm_fused.cu",
        "replaces": REPLACES,
        "also_replaces": "math_tpu/ops/pallas_glm.py:459",
        "launches": launches,
        "launches_per_call": main["launches_per_call"],
        "max_abs_err": max(max(v["abs_err"].values()) for v in list(checks.values()) + timed),
        "ms": main["ms"],
        "plain_ms": plain_ms,
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,  # no one PyTorch call computes this function with its gradients
        "shape": {"kind": main["kind"], "n": n, "d": d, "c": c},
        "bound_fp32_ms": main["bound_fp32_ms"],
        "products_library_ms": main["products_library_ms"],
        "timed": [{key: t[key] for key in ("kind", "d", "k", "ms", "reps_ms", "bound_ms", "bound_fp32_ms", "bound_bytes_ms",
                                           "products_library_ms", "products_reps_ms", "launches_per_call", "tf32_tflops",
                                           "plan", "abs_err")} for t in timed],
        "abs_err": {lab: v["abs_err"] for lab, v in checks.items()},
        "tolerance": {"logp_rtol": 2e-5, "grad_rtol": 3e-4, "grad_atol": "1e-3 * max(1, N / 3000)"},
    }


def tiled_categorical_entry(x_full, launches, checks, jvp, timed):
    """The ``kernels`` line's entry of the tiled categorical pair: its time,
    bounds and products at (D, K) = (50, 65), N = 100,000, C = 256, the
    plain version's time there (one call), the other timed shapes beside,
    its launches (calls of the pair) from the ``wide`` dispatcher calls, and
    the largest error of those calls against the float64 plain version."""
    main = next(t for t in timed if (t["d"], t["k"]) == C1_CATEGORICAL[0])
    n, d, c, k = main["n"], main["d"], main["c"], main["k"]
    y = torch.as_tensor(glm_y("categorical", n, k, seed=710 + d), device="cuda").to(torch.int32)
    _, params = glm_params("categorical", d, c, k, seed=720 + d, scale=min(0.1, 1.0 / math.sqrt(d)))
    params = [torch.tensor(p, device="cuda") for p in params]
    plain_ms = time_ms(lambda: glm_fused.categorical_logit_glm_parts_reference(y, x_full, *params), warmup=0, reps=1)
    del params
    torch.cuda.empty_cache()
    return {
        "name": "glm_categorical_logit_tiled",
        "route": "cuda",
        "source": "math_tpu_torch/csrc/glm_categorical.cu",
        "replaces": "math_tpu/ops/pallas_glm.py:650",
        "launches": launches,
        "launches_per_call": main["launches_per_call"],
        "max_abs_err": max(max(v["abs_err"].values()) for v in checks.values()),
        "ms": main["ms"],
        "plain_ms": plain_ms,
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,  # no one PyTorch call computes this function with its gradients
        "shape": {"n": n, "d": d, "c": c, "k": k},
        "bound_fp32_ms": main["bound_fp32_ms"],
        "products_library_ms": main["products_library_ms"],
        "timed": [{key: t[key] for key in ("d", "k", "ms", "reps_ms", "bound_ms", "bound_fp32_ms", "products_library_ms",
                                           "products_reps_ms", "launches_per_call", "tf32_tflops", "plan")} for t in timed],
        "abs_err": {lab: v["abs_err"] for lab, v in checks.items()},
        "jvp": jvp,
        "tolerance": {"logp_rtol": 2e-5, "grad_rtol": 3e-4, "grad_atol": "1e-3 * max(1, N / 3000)"},
    }


def ordinal_data(x, seed=1):
    """Outcomes of the ordinal regression for the design ``x``: ``beta_true ~
    0.3 normal``, ``y = 1 + #{cuts_true < x beta_true + logistic noise}``
    (K = 5).  Returns ``(y int32, beta_true, cuts_true)``."""
    rng = np.random.default_rng(seed)
    beta_true = (0.3 * rng.normal(size=x.shape[1])).astype(np.float32)
    latent = x.astype(np.float64) @ beta_true + rng.logistic(size=x.shape[0])
    y = 1 + np.sum(np.asarray(CUTS_TRUE)[None, :] < latent[:, None], axis=1)
    return y.astype(np.int32), beta_true, np.asarray(CUTS_TRUE, dtype=np.float32)


def categorical_data(x, k=K_CAT, seed=2):
    """Outcomes of the multinomial regression for the design ``x``: ``alpha_true``,
    ``beta_true`` ``0.3 normal`` with class 1 zero, ``y ~ categorical(softmax(x
    beta_true + alpha_true))``.  Returns ``(y int32, alpha_true (K,), beta_true (D, K))``."""
    rng = np.random.default_rng(seed)
    alpha_true = 0.3 * rng.normal(size=k)
    beta_true = 0.3 * rng.normal(size=(x.shape[1], k))
    alpha_true[0], beta_true[:, 0] = 0.0, 0.0
    eta = x.astype(np.float64) @ beta_true + alpha_true
    p = np.exp(eta - eta.max(1, keepdims=True))
    cdf = np.cumsum(p / p.sum(1, keepdims=True), axis=1)
    y = 1 + np.minimum(np.sum(rng.uniform(size=(x.shape[0], 1)) > cdf, axis=1), k - 1)
    return y.astype(np.int32), alpha_true.astype(np.float32), beta_true.astype(np.float32)


def make_ordinal(d, k=K_CAT, fused=True):
    """Ordinal regression: beta ~ normal(0, 2), cuts ~ normal(0, 5) (ordered),
    y ~ ordered_logistic_glm(x, beta, cuts).  ``fused``: the likelihood through
    the chain-batched dispatcher (the kernel on a GPU); else through the plain
    ``dists`` density (the float64 reference)."""

    def log_prob(p, X, y):
        beta, cuts = p["beta"], p["cuts"]  # (C, d), (C, k - 1)
        lp = dists.normal_lpdf(beta, 0.0, 2.0, propto=True, batch_ndims=1)
        lp = lp + dists.normal_lpdf(cuts, 0.0, 5.0, propto=True, batch_ndims=1)
        if fused:
            return lp + glm_fused.ordered_logistic_glm_lpmf_chains(y, X, beta.T, cuts.T)
        return lp + dists.ordered_logistic_glm_lpmf(y, X, beta, cuts, propto=True, batch_ndims=1)

    return make_log_density({"beta": transforms.Identity(shape=(d,)), "cuts": transforms.Ordered(shape=(k - 1,))}, log_prob)


def make_multinomial(d, k=K_CAT, fused=True):
    """Multinomial regression with class 1 as the reference class:
    alpha_raw ~ normal(0, 5), beta_raw ~ normal(0, 2), alpha = [0, alpha_raw],
    beta = [0 | beta_raw], y ~ categorical_logit_glm(x, alpha, beta)."""

    def log_prob(p, X, y):
        a_raw, b_raw = p["alpha_raw"], p["beta_raw"]  # (C, k - 1), (C, d, k - 1)
        lp = dists.normal_lpdf(a_raw, 0.0, 5.0, propto=True, batch_ndims=1)
        lp = lp + dists.normal_lpdf(b_raw, 0.0, 2.0, propto=True, batch_ndims=1)
        alpha, beta = F.pad(a_raw, (1, 0)), F.pad(b_raw, (1, 0))  # class 1's column is 0
        if fused:
            return lp + glm_fused.categorical_logit_glm_lpmf_chains(y, X, alpha, beta)
        return lp + dists.categorical_logit_glm_lpmf(y, X, alpha, beta, propto=True, batch_ndims=1)

    return make_log_density(
        {"alpha_raw": transforms.Identity(shape=(k - 1,)), "beta_raw": transforms.Identity(shape=(d, k - 1))}, log_prob
    )


def drive_model_sampler(model, x, y, truth, *, chains, num_warmup, num_samples, max_depth, seed, device, dtype, tol):
    """NUTS with pooled warmup on a GLM model of the design ``x`` and int32
    outcomes ``y``; ``truth`` maps parameter names to their generating values.
    Checks divergences < 5%, finite draws and ``max |posterior mean - truth| < tol``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    xt = torch.tensor(x, dtype=dtype, device=device)
    yt = torch.tensor(y, dtype=torch.int32, device=device)
    z0 = model.initial_positions(gen, chains, device=device, dtype=dtype)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_pooled_chains(
        gen, z0, model.logp, args=(xt, yt), num_warmup=num_warmup, num_samples=num_samples,
        max_depth=max_depth, target_accept=0.8, device=device,
    )
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(res.position.shape == (chains, num_samples, model.dim), f"draws have shape {tuple(res.position.shape)}")
    pos = res.position.double().cpu().numpy()
    require(np.isfinite(pos).all(), "non-finite draws")
    div_rate = float(res.diverging.double().mean())
    require(div_rate < 0.05, f"divergence rate {div_rate}")
    draws = model.transform_draws(res.position)
    errs = {}
    for name, want in truth.items():
        got = draws[name].double().reshape((-1,) + tuple(np.shape(want))).mean(0).cpu().numpy()
        errs[name] = float(np.max(np.abs(got - want)))
    require(max(errs.values()) < tol, f"max |posterior mean - generating value| = {errs}, limit {tol}")
    report = {
        "chains": chains, "n": x.shape[0], "d": x.shape[1], "dim": model.dim, "dtype": str(dtype),
        "num_warmup": num_warmup, "num_samples": num_samples, "max_depth": max_depth, "wall_s": wall,
        "grad_calls": res.n_grad_calls, "grad_calls_per_s": res.n_grad_calls / wall,
        "ms_per_grad_call": wall / res.n_grad_calls * 1e3, "chain_leapfrogs_per_s": res.n_grad_calls * chains / wall,
        "divergence_rate": div_rate, "max_abs_err_vs_truth": errs, "recovery_limit": tol,
        "step_size": float(res.step_size), "mean_tree_depth": float(res.tree_depth.double().mean()),
        "mean_accept": float(res.accept_prob.mean()),
        "ess_bulk_first6": [float(v) for v in convergence.ess_bulk(pos[..., :6])],
        "split_rhat_first6": [float(v) for v in convergence.split_rhat(pos[..., :6])],
        **ess_per_call(pos, res.n_grad_calls),
    }
    return res, report, model, (xt, yt), truth


def ess_per_call(pos, grad_calls):
    """Minimum bulk ESS over every coordinate of the draws (chains, n, dim), and
    the chain-batched gradient calls per unit of it."""
    min_ess = float(np.min(convergence.ess_bulk(pos)))
    return {"min_ess_bulk": min_ess, "grad_calls_per_min_ess": grad_calls / min_ess}


def drive_ordinal_sampler(x, y, beta_true, cuts_true, **kw):
    """The ordinal path: NUTS on ``make_ordinal`` (recovery limit ``tol``)."""
    return drive_model_sampler(make_ordinal(x.shape[1]), x, y, {"beta": beta_true, "cuts": cuts_true}, **kw)


def drive_categorical_sampler(x, y, alpha_true, beta_true, **kw):
    """The multinomial path: NUTS on ``make_multinomial`` (recovery limit ``tol``)."""
    truth = {"alpha_raw": alpha_true[1:], "beta_raw": beta_true[:, 1:]}
    return drive_model_sampler(make_multinomial(x.shape[1], alpha_true.shape[0]), x, y, truth, **kw)


def check_model_against_float64(model, reference, z, xt, yt, grad_atol):
    """``model.logp`` and its gradient at ``z`` on the card (float32, through
    the kernel) against autograd of the float64 plain ``dists`` density: logp
    rtol=2e-5; gradient rtol=3e-4 and ``grad_atol`` (as the kernels phase)."""
    lp, g = model.logp_and_grad(z, xt, yt)
    lp64, g64 = reference.logp_and_grad(z.double(), xt.double(), yt)
    lp_err, g_err = (lp.double() - lp64).abs(), (g.double() - g64).abs()
    require(bool(torch.isfinite(lp).all() and torch.isfinite(g).all()), "non-finite logp or gradient")
    require(bool((lp_err <= 2e-5 * lp64.abs()).all()), f"logp off by {float(lp_err.max())} (|logp| ~ {float(lp64.abs().max())})")
    require(bool((g_err <= grad_atol + 3e-4 * g64.abs()).all()), f"gradient off by {float(g_err.max())}")
    return {"logp_max_abs_err": float(lp_err.max()), "max_abs_logp": float(lp64.abs().max()),
            "grad_max_abs_err": float(g_err.max()), "max_abs_grad": float(g64.abs().max()), "grad_atol": grad_atol}


def map_estimate_torch(model, z0, xt, yt, steps=200):
    """An independent reference for a path's posterior: the MAP estimate of
    ``model`` (the float64 plain ``dists`` density) by L-BFGS from ``z0``,
    constrained.  At N >> dim the posterior mean sits close to it, and its
    distance from the generating values is what the data allow."""
    z = z0.detach().double().clone().requires_grad_(True)
    opt = torch.optim.LBFGS([z], lr=1, max_iter=steps, tolerance_grad=1e-9, tolerance_change=1e-14,
                            line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad()
        loss = -model.logp(z, xt.double(), yt).sum()
        loss.backward()
        return loss

    opt.step(closure)
    return {name: v[0] for name, v in model.constrain(z.detach()).items()}


def phase_glm_path(label, family, entry, drive, reference, x, data, tol):
    """One of the two new paths: the counts set to 0 just before the sampler
    and read just after; the kernel's launches must equal the gradient calls,
    no other kernel and no plain version may have run; then ``logp`` and
    gradient at 8 final positions against float64."""
    glm_fused.reset_counts()
    res, report, model, (xt, yt), truth = drive(
        x, *data, chains=C_MAIN, num_warmup=150, num_samples=50, max_depth=6, seed=0,
        device="cuda", dtype=torch.float32, tol=tol,
    )
    launches = dict(glm_fused.LAUNCHES)
    launches_tiled = dict(glm_fused.LAUNCHES_TILED)
    plain_calls = dict(glm_fused.PLAIN_CALLS)
    layout_copies = dict(glm_fused.LAYOUT_COPIES)
    require(launches[family] == res.n_grad_calls > 0, f"{launches[family]} launches for {res.n_grad_calls} gradient calls")
    require(all(v == 0 for v in layout_copies.values()), f"the dispatchers copied x or y on the {label}: {layout_copies}")
    require(all(v == 0 for f, v in launches.items() if f != family), f"another kernel ran: {launches}")
    require(not any(launches_tiled.values()), f"a tiled route ran on the {label}: {launches_tiled}")
    require(all(v == 0 for v in plain_calls.values()), f"the plain version ran on the {label}: {plain_calls}")
    entry["launches"] = launches[family]
    z_final = res.position[:8, -1, :].contiguous()
    check = check_model_against_float64(model, reference, z_final, xt, yt, 1e-3 * x.shape[0] / 3000.0)
    theta_map = map_estimate_torch(reference, res.position.mean((0, 1))[None], xt, yt)
    draws = model.transform_draws(res.position)
    map_report = {
        name: {"max_abs_map_err_vs_truth": float((v.cpu() - torch.as_tensor(truth[name], dtype=v.dtype)).abs().max()),
               "max_abs_mean_err_vs_map": float((draws[name].double().mean((0, 1)) - v).abs().max())}
        for name, v in theta_map.items()
    }
    emit(label, **report, kernel_launches=launches[family], tiled_launches=launches_tiled, plain_calls=plain_calls,
         layout_copies=layout_copies, vs_float64_at_8_final_positions=check,
         float64_map=map_report)
    return res, model, (xt, yt), report


# ---------------------------------------------------------------------------
# The slice of sample_nuts and the chunked sampler: per-chain adaptation on the
# GLM, chunked pooled warmup on the ordinal regression, the dense metric on the
# multinomial
# ---------------------------------------------------------------------------


def only_kernel(label, family, grad_calls):
    """After a path: ``family``'s tensor-core kernel launched once per gradient
    call and nothing else: no other kernel, no tiled route, no plain version,
    no layout copy."""
    launches = dict(glm_fused.LAUNCHES)
    require(launches[family] == grad_calls > 0, f"{label}: {launches[family]} launches for {grad_calls} gradient calls")
    require(all(v == 0 for f, v in launches.items() if f != family), f"{label}: another kernel ran: {launches}")
    for name, counts in (("tiled route", glm_fused.LAUNCHES_TILED), ("plain version", glm_fused.PLAIN_CALLS),
                         ("layout copy", glm_fused.LAYOUT_COPIES)):
        require(all(v == 0 for v in counts.values()), f"{label}: a {name} ran: {dict(counts)}")
    return launches[family]


def drive_sample_nuts(model, x, y, y_dtype, *, chains, num_warmup, num_samples, max_depth, seed, device="cuda",
                      dtype=torch.float32, **kw):
    """``sample_nuts`` as a user calls it, on ``model`` with data ``(x, y)``;
    returns ``(res, wall_s, (xt, yt))``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    xt = torch.tensor(x, dtype=dtype, device=device)
    yt = torch.tensor(y, dtype=y_dtype, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sample_nuts(model.logp, gen, model.dim, args=(xt, yt), num_chains=chains, num_warmup=num_warmup,
                      num_samples=num_samples, max_depth=max_depth, device=device, dtype=dtype, **kw)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(res.position.shape == (chains, num_samples, model.dim), f"draws have shape {tuple(res.position.shape)}")
    require(bool(torch.isfinite(res.position).all()), "non-finite draws")
    return res, wall, (xt, yt)


def sample_report(res, wall, chains, num_warmup, num_samples):
    pos = res.position.double().cpu().numpy()
    eps = res.step_size.double().cpu()
    return {
        "chains": chains, "num_warmup": num_warmup, "num_samples": num_samples, "wall_s": wall,
        "grad_calls": res.n_grad_calls, "ms_per_grad_call": wall / res.n_grad_calls * 1e3, "max_depth_used": res.max_depth,
        "mean_tree_depth": float(res.stats.tree_depth.double().mean()),
        "warmup_mean_tree_depth": float(res.warmup_tree_depth.double().mean()),
        # all lanes run a transition together: its cost is its deepest lane's tree
        "warmup_deepest_lane_depth": float(res.warmup_tree_depth.max(0).values.double().mean()),
        "mean_lane_leapfrogs_per_transition": float(res.stats.n_leapfrog.double().mean()),
        "deepest_lane_leapfrogs_per_transition": float(res.stats.n_leapfrog.max(0).values.double().mean()),
        "step_size_min_median_max": [float(eps.min()), float(eps.median()), float(eps.max())],
        "divergence_rate": float(res.stats.diverging.double().mean()),
        "ess_bulk_first6": [float(v) for v in convergence.ess_bulk(pos[..., :6])],
        "split_rhat_first6": [float(v) for v in convergence.split_rhat(pos[..., :6])],
        **ess_per_call(pos, res.n_grad_calls),
    }


def phase_sample_path(x, y, beta_true):
    """``sample_nuts`` (per-chain Stan warmup, ``auto_depth=True``) on the
    100,000 x 50 logistic GLM, 256 chains, float32, 150 + 50 at a ceiling of
    6; the counts set to 0 just before and read just after."""
    model = glm_logistic.make(x.shape[1])
    glm_fused.reset_counts()
    res, wall, _ = drive_sample_nuts(model, x, y, torch.float32, chains=C_MAIN, num_warmup=150, num_samples=50,
                                     max_depth=6, seed=0, auto_depth=True)
    launches = only_kernel("sample_path", "bernoulli_logit", res.n_grad_calls)
    report = sample_report(res, wall, C_MAIN, 150, 50)
    require(report["divergence_rate"] < 0.05, f"sample_path: divergence rate {report['divergence_rate']}")
    beta = model.transform_draws(res.position)["beta"].double().reshape(-1, x.shape[1]).cpu().numpy()
    beta_err = float(np.max(np.abs(beta.mean(0) - beta_true)))
    require(beta_err < 0.05, f"sample_path: max |mean(beta) - beta_true| = {beta_err}")
    emit("sample_path", **report, max_abs_beta_err=beta_err, kernel_launches=launches)


def phase_chunked_path(x, data):
    """``run_pooled_chains_chunked`` on the ordinal regression (256 chains,
    150 + 50, chunks of 40) against ``run_pooled_chains`` from the same
    generator seed at the same fixed cap: equal draws, bit for bit; then once
    with ``auto_depth=True``, its cap per chunk."""
    model = make_ordinal(x.shape[1])
    xt = torch.tensor(x, device="cuda")
    yt = torch.tensor(data[0], dtype=torch.int32, device="cuda")
    z0 = model.initial_positions(torch.Generator(device="cuda").manual_seed(5), C_MAIN, device="cuda")
    kw = dict(args=(xt, yt), num_warmup=150, num_samples=50, max_depth=6, device="cuda")
    glm_fused.reset_counts()
    runs, walls = {}, {}
    for name, fn, extra in (("monolithic", run_pooled_chains, {}),
                            ("chunked", run_pooled_chains_chunked, {"warmup_chunk": 40, "sample_chunk": 40}),
                            ("chunked_auto_depth", run_pooled_chains_chunked,
                             {"warmup_chunk": 40, "sample_chunk": 40, "auto_depth": True})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name] = fn(torch.Generator(device="cuda").manual_seed(6), z0, model.logp, **kw, **extra)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
    launches = only_kernel("chunked_path", glm_fused.ORDERED, sum(r.n_grad_calls for r in runs.values()))
    mono, chunked, auto = runs["monolithic"], runs["chunked"], runs["chunked_auto_depth"]
    diffs = {name: float((getattr(chunked, name).double() - getattr(mono, name).double()).abs().max())
             for name in ("position", "accept_prob", "energy", "tree_depth")}
    equal = all(torch.equal(getattr(chunked, name), getattr(mono, name))
                for name in ("position", "accept_prob", "diverging", "tree_depth", "n_leapfrog", "energy"))
    require(equal and chunked.n_grad_calls == mono.n_grad_calls,
            f"chunked_path: chunked and monolithic draws differ: largest differences {diffs}")
    for r in (mono, auto):
        require(bool(torch.isfinite(r.position).all()) and float(r.diverging.double().mean()) < 0.05,
                "chunked_path: non-finite draws or divergences")
    emit("chunked_path", chains=C_MAIN, num_warmup=150, num_samples=50, chunk=40, bitwise_equal=equal,
         largest_differences=diffs, wall_s=walls, grad_calls={k: r.n_grad_calls for k, r in runs.items()},
         ms_per_grad_call={k: walls[k] / r.n_grad_calls * 1e3 for k, r in runs.items()},
         auto_depth_caps_per_chunk=list(auto.chunk_caps), auto_depth_final_cap=auto.max_depth,
         auto_depth_mean_tree_depth=float(auto.tree_depth.double().mean()),
         auto_depth_saturation=float((auto.tree_depth >= auto.max_depth).double().mean()),
         ess_bulk_first6={k: [float(v) for v in convergence.ess_bulk(r.position.double().cpu().numpy()[..., :6])]
                          for k, r in runs.items()},
         kernel_launches=launches)


def phase_dense_categorical(x, data, diag_report):
    """``sample_nuts(dense_mass=True)`` (a dense metric per chain) on the
    multinomial regression (K = 5, dim 204), 256 chains, 150 + 50 at
    ``max_depth=6``: gradient calls, tree depth, minimum bulk ESS and calls per
    unit of it, beside the same of ``categorical_path`` (pooled diagonal
    metric)."""
    k = len(data[1])
    model = make_multinomial(x.shape[1], k)
    glm_fused.reset_counts()
    res, wall, _ = drive_sample_nuts(model, x, data[0], torch.int32, chains=C_MAIN, num_warmup=150, num_samples=50,
                                     max_depth=6, seed=0, dense_mass=True)
    launches = only_kernel("dense_categorical", glm_fused.CATEGORICAL, res.n_grad_calls)
    report = sample_report(res, wall, C_MAIN, 150, 50)
    require(res.inv_mass.shape == (C_MAIN, model.dim, model.dim), f"dense metric of shape {tuple(res.inv_mass.shape)}")
    draws = model.transform_draws(res.position)
    truth = {"alpha_raw": data[1][1:], "beta_raw": data[2][:, 1:]}
    errs = {name: float(np.max(np.abs(draws[name].double().reshape((-1,) + np.shape(v)).mean(0).cpu().numpy() - v)))
            for name, v in truth.items()}
    require(report["divergence_rate"] < 0.05, f"dense_categorical: divergence rate {report['divergence_rate']}")
    require(max(errs.values()) < 0.08, f"dense_categorical: max |posterior mean - generating value| = {errs}")
    keys = ("grad_calls", "mean_tree_depth", "min_ess_bulk", "grad_calls_per_min_ess", "wall_s")
    emit("dense_categorical", **report, max_abs_err_vs_truth=errs, kernel_launches=launches,
         pooled_diagonal_categorical_path={key: diag_report[key] for key in keys},
         calls_per_min_ess_dense_over_diagonal=report["grad_calls_per_min_ess"] / diag_report["grad_calls_per_min_ess"])


# ---------------------------------------------------------------------------
# The GP path: the diagonal-block Cholesky kernel and the sampler around it
# ---------------------------------------------------------------------------


def gp_hyper(c, seed):
    """``c`` posterior-typical hyperparameter settings (rho, alpha, sigma) of
    the synthetic GP data, from a seed."""
    rng = np.random.default_rng(seed)
    return (0.6 * (1 + 0.1 * rng.uniform(-1, 1, c)), 1.4 * (1 + 0.1 * rng.uniform(-1, 1, c)),
            0.3 * (1 + 0.05 * rng.uniform(-1, 1, c)))


def gp_blocks(x, B, block_index):
    """Blocks the GP path really meets, float32 ``(C_GP, B, B)``: the first
    diagonal block of ``K + (sigma^2 + jitter) I`` and the Schur complement the
    blocked factorization forms at ``block_index`` (computed in float64)."""
    rho, alpha, sigma = (torch.tensor(v, dtype=torch.float64, device="cuda") for v in gp_hyper(C_GP, seed=400))
    x64 = torch.tensor(x, dtype=torch.float64, device="cuda")
    k = gp_ops.add_diag(gp_ops.gp_exp_quad_cov(x64, alpha, rho), torch.square(sigma) + JITTER_GP)
    s = block_index * B
    panel = torch.linalg.cholesky(k[:, : s + B, : s + B])[:, s:, :s]
    schur = k[:, s : s + B, s : s + B] - panel @ panel.mT
    return k[:, :B, :B].float().contiguous(), schur.float().contiguous()


def compare_chol(d32, label):
    """Kernel (float32) against the plain version in float64 on the same
    blocks.  Tolerances: ``max |U - U64| <= 1e-4 max |U64|`` and the same for
    ``W`` (the factor's forward error grows with the block's condition number,
    a few thousand here, times the float32 unit roundoff); residuals
    ``max |U^T U - d| <= 2e-5 max |d|`` and ``max |U W - I| <= 1e-4``."""
    u, w = chol_blocked.chol_inv_block_parts(d32)
    torch.cuda.synchronize()
    u64, w64 = chol_blocked.chol_inv_block_reference(d32.double())
    up, wp = chol_blocked.chol_inv_block_reference(d32)
    B = d32.shape[-1]
    require(u.shape == d32.shape and w.shape == d32.shape and u.dtype == torch.float32, f"{label}: wrong shape or type")
    require(bool(torch.isfinite(u).all() and torch.isfinite(w).all()), f"{label}: non-finite factor of an SPD block")
    require(bool((u.tril(-1) == 0).all() and (w.tril(-1) == 0).all()), f"{label}: U or W is not upper-triangular")
    errs = {"U": float((u.double() - u64).abs().max()), "W": float((w.double() - w64).abs().max())}
    plain = {"U": float((up.double() - u64).abs().max()), "W": float((wp.double() - w64).abs().max())}
    scale = {"U": float(u64.abs().max()), "W": float(w64.abs().max())}
    for name in ("U", "W"):
        require(errs[name] <= 1e-4 * scale[name], f"{label} {name}: max abs err {errs[name]} against max |want| {scale[name]}")
    resid = float((u.double().mT @ u.double() - d32.double()).abs().max())
    inv_resid = float((u.double() @ w.double() - torch.eye(B, dtype=torch.float64, device="cuda")).abs().max())
    require(resid <= 2e-5 * float(d32.abs().max()), f"{label}: max |U^T U - d| = {resid}")
    require(inv_resid <= 1e-4, f"{label}: max |U W - I| = {inv_resid}")
    return {"abs_err": errs, "plain_f32_abs_err": plain, "max_abs_want": scale, "factor_residual": resid, "inverse_residual": inv_resid}


def compare_chol_ragged():
    """``Cb = 5`` blocks of an odd size, matrix 2 not positive definite from
    pivot 20 on: that one must be NaN exactly where the plain version is (``U``
    from row 20 on, ``W`` everywhere) and equal before; the others within
    ``1e-4 max |want|``."""
    rng = np.random.default_rng(401)
    a = rng.normal(size=(CB_RAGGED, B_RAGGED, B_RAGGED))
    d = a @ np.swapaxes(a, -1, -2) + B_RAGGED * np.eye(B_RAGGED)
    d[2, 20, 20] = -5.0
    d32 = torch.tensor(d, dtype=torch.float32, device="cuda")
    u, w = chol_blocked.chol_inv_block_parts(d32)
    torch.cuda.synchronize()
    u64, w64 = chol_blocked.chol_inv_block_reference(d32.double())
    good = [0, 1, 3, 4]
    worst = 0.0
    for got, want in ((u, u64), (w, w64)):
        require(bool((torch.isnan(got) == torch.isnan(want)).all()), "ragged: NaN pattern differs from the plain version")
        require(bool(torch.isfinite(got[good]).all()), "ragged: a positive definite block of the batch was poisoned")
        err = float((got.double() - want)[good].abs().max())
        require(err <= 1e-4 * float(want[good].abs().max()), f"ragged: max abs err {err}")
        worst = max(worst, err)
    tail = B_RAGGED - 20
    require(int(torch.isnan(u[2, 20:, 20:].triu()).sum()) == tail * (tail + 1) // 2, "ragged: U of the bad block is not NaN from its bad pivot on")
    require(bool(torch.isnan(w[2]).all()), "ragged: W of the bad block is not NaN")
    err_before = float((u[2, :20].double() - u64[2, :20]).abs().max())
    require(err_before <= 1e-4 * float(u64[2, :20].abs().max()), f"ragged: rows before the bad pivot are off by {err_before}")
    return {"cb": CB_RAGGED, "b": B_RAGGED, "bad_matrix": 2, "bad_pivot": 20, "max_abs_err": worst}


def chol_stamps(d, ms, reps=5):
    """How the block kernel's time splits, from ``clock64()`` stamps taken by
    thread 0 of each block (``chol_inv_block_stamped``): mean clocks of each
    phase over the blocks and ``reps`` launches, its share of the block's
    clocks, and that share of the kernel's measured ``ms`` in microseconds."""
    spans = []
    for _ in range(reps):
        _, _, st = chol_blocked.chol_inv_block_stamped(d)
        torch.cuda.synchronize()
        spans.append((st[:, 1:] - st[:, :-1]).double())
    mean = torch.cat(spans).mean(0)
    total = float(mean.sum())
    phases = ("load", "factor", "inverse", "store")
    return {
        "clocks": {p: float(v) for p, v in zip(phases, mean)},
        "share": {p: float(v) / total for p, v in zip(phases, mean)},
        "us": {p: float(v) / total * ms * 1e3 for p, v in zip(phases, mean)},
        "clocks_per_block": total,
        "panel": chol_blocked.PANEL,
    }


def library_chol_inv(d):
    """The same function by one PyTorch call pair (timing only)."""
    upper = torch.linalg.cholesky(d).mT
    eye = torch.eye(d.shape[-1], dtype=d.dtype, device=d.device).expand_as(d)
    return upper, torch.linalg.solve_triangular(upper, eye, upper=True)


def phase_kernels_chol(x_gp):
    B = get_config().cholesky_block_size
    first, schur = gp_blocks(x_gp, B, block_index=8)
    report_first = compare_chol(first, "first diagonal block")
    report_schur = compare_chol(schur, "Schur block 8")
    ragged = compare_chol_ragged()
    ms = time_ms(lambda: chol_blocked.chol_inv_block_parts(schur), warmup=3, reps=50)
    plain_ms = time_ms(lambda: chol_blocked.chol_inv_block_reference(schur), warmup=1, reps=3)
    library_ms = time_ms(lambda: library_chol_inv(schur), warmup=2, reps=10)
    stamps = chol_stamps(schur, ms)
    emit("kernels_chol", b=B, cb=schur.shape[0], ms=ms, stamps=stamps)
    cb = schur.shape[0]
    nbytes, flops = 3.0 * cb * B * B * 4, (4.0 / 3.0) * B**3 * cb
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return {
        "name": "chol_inv_block",
        "route": "cuda",
        "source": "math_tpu_torch/csrc/chol_inv_block.cu",
        "replaces": "math_tpu/ops/chol_pallas.py:46",
        "launches": None,  # filled from the GP path's run
        "max_abs_err": max(*report_first["abs_err"].values(), *report_schur["abs_err"].values()),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,  # torch.linalg.cholesky + solve_triangular(U, I); the port never calls it here
        "shape": {"cb": cb, "b": B},
        "barrier_stages": chol_blocked.block_kernel_stages(B),
        "us_per_stage": ms * 1e3 / chol_blocked.block_kernel_stages(B),
        "dependent_steps": 2 * B,  # the column-by-column kernel's count, for comparison
        "us_per_step": ms * 1e3 / (2 * B),
        "stamps": stamps,
        "first_block": report_first,
        "schur_block": report_schur,
        "ragged": ragged,
        "tolerance": {"factor_rel_to_max": 1e-4, "factor_residual_rel": 2e-5, "inverse_residual": 1e-4, "ragged_rel_to_max": 1e-4},
    }


def gp_reference_logp(z, x, y, jitter, sq_dists=None):
    """The GP log density written out independently of the port's model code:
    ``z (C, 3)`` unconstrained ``log (rho, alpha, sigma)`` (or ``(C, 3 + n)``
    with ``eta`` for the latent model), priors and Jacobian in closed form,
    squared distances by direct differences (or by ``sq_dists``), the
    factorization by ``torch.linalg``.  In the dtype of ``z``."""
    rho, alpha, sigma = torch.exp(z[:, 0]), torch.exp(z[:, 1]), torch.exp(z[:, 2])
    lp = z[:, :3].sum(-1) - 6.0 * torch.log(rho) - 5.0 / rho - 0.125 * torch.square(alpha) - 0.5 * torch.square(sigma)
    d2 = torch.square(x[:, None] - x[None, :]) if sq_dists is None else sq_dists(x)
    k = torch.square(alpha)[:, None, None] * torch.exp(-0.5 * d2 / torch.square(rho)[:, None, None])
    eye = torch.eye(x.shape[0], dtype=z.dtype, device=z.device)
    if z.shape[1] == 3:
        zz, slogdiag = spd_solve_logdiag_reference(k + (torch.square(sigma) + jitter)[:, None, None] * eye, y)
        return lp - 0.5 * torch.square(zz).sum(-1) - slogdiag
    eta = z[:, 3:]
    f = (torch.linalg.cholesky(k + jitter * eye) @ eta[..., None])[..., 0]
    resid = (y - f) / sigma[:, None]
    return lp - 0.5 * torch.square(eta).sum(-1) - 0.5 * torch.square(resid).sum(-1) - x.shape[0] * torch.log(sigma)


def value_and_grad(fn, z):
    z = z.detach().requires_grad_(True)
    lp = fn(z)
    (g,) = torch.autograd.grad(lp.sum(), z)
    return lp.detach(), g


def check_against_float64(label, model, z, x, y, jitter, floors):
    """``model.logp`` and its gradient on the card (float32, through the block
    kernel) against the float64 reference.  Beside it the float32
    ``torch.linalg`` path's own error on the same kernel matrix (squared
    distances by the port's expansion), and with distances by direct
    differences.  The kernel path's error may be at most 4x the former, or
    within the stated absolute floor."""
    lp, g = model.logp_and_grad(z, x, y)
    lp64, g64 = value_and_grad(lambda zz: gp_reference_logp(zz, x.double(), y.double(), jitter), z.double())
    lp32, g32 = value_and_grad(lambda zz: gp_reference_logp(zz, x, y, jitter, gp_ops.sq_dists), z)
    lp32d, g32d = value_and_grad(lambda zz: gp_reference_logp(zz, x, y, jitter), z)
    out = {}
    for name, got, lin, lin_direct, want in (("logp", lp, lp32, lp32d, lp64), ("grad", g, g32, g32d, g64)):
        err, lin_err = float((got.double() - want).abs().max()), float((lin.double() - want).abs().max())
        require(bool(torch.isfinite(got).all()), f"{label}: non-finite {name}")
        require(err <= max(4.0 * lin_err, floors[name]), f"{label} {name}: err {err} vs float64; torch.linalg float32 path {lin_err}; floor {floors[name]}")
        out[name] = {"max_abs_err": err, "torch_linalg_f32_max_abs_err": lin_err,
                     "torch_linalg_f32_direct_distances_max_abs_err": float((lin_direct.double() - want).abs().max()),
                     "max_abs_want": float(want.abs().max()), "floor": floors[name]}
    return out


def drive_gp_sampler(n=N_GP, *, chains=C_GP, num_warmup=60, num_samples=40, seed=0, device="cuda", dtype=torch.float32,
                     jitter=JITTER_GP, sigma_tol=0.03):
    """The GP main path: 32-chain NUTS with pooled warmup on the marginal GP."""
    x, y = gp_regression.synthetic_data(n, seed=0)
    model = gp_regression.make_marginal(n, jitter=jitter)
    gen = torch.Generator(device=device).manual_seed(seed)
    xt = torch.tensor(x, dtype=dtype, device=device)
    yt = torch.tensor(y, dtype=dtype, device=device)
    z0 = model.initial_positions(gen, chains, init_radius=0.5, device=device, dtype=dtype)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_pooled_chains(
        gen, z0, model.logp, args=(xt, yt), num_warmup=num_warmup, num_samples=num_samples,
        max_depth=3, target_accept=0.75, device=device,
    )
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(res.position.shape == (chains, num_samples, 3), f"draws have shape {tuple(res.position.shape)}")
    require(bool(torch.isfinite(res.position).all()), "non-finite draws")
    draws = model.transform_draws(res.position)
    hyper = np.stack([draws[k].double().cpu().numpy() for k in ("rho", "alpha", "sigma")], axis=-1)  # (C, S, 3)
    div_rate = float(res.diverging.double().mean())
    sigma_mean = float(hyper[..., 2].mean())
    require(div_rate < 0.05, f"divergence rate {div_rate}")
    require(abs(sigma_mean - 0.3) < sigma_tol, f"posterior mean of sigma is {sigma_mean}; the data were made with 0.3")
    report = {
        "chains": chains, "n": n, "dtype": str(dtype), "jitter": jitter, "num_warmup": num_warmup, "num_samples": num_samples,
        "max_depth": 3, "target_accept": 0.75, "block_size": get_config().cholesky_block_size, "wall_s": wall,
        "grad_calls": res.n_grad_calls, "grad_calls_per_s": res.n_grad_calls / wall,
        "ms_per_grad_call": wall / res.n_grad_calls * 1e3, "divergence_rate": div_rate,
        "step_size": float(res.step_size), "mean_tree_depth": float(res.tree_depth.double().mean()),
        "mean_accept": float(res.accept_prob.mean()),
        "posterior_mean": dict(zip(("rho", "alpha", "sigma"), (float(v) for v in hyper.reshape(-1, 3).mean(0)))),
        "posterior_sd": dict(zip(("rho", "alpha", "sigma"), (float(v) for v in hyper.reshape(-1, 3).std(0)))),
        "ess_bulk": dict(zip(("rho", "alpha", "sigma"), (float(v) for v in convergence.ess_bulk(hyper)))),
        "split_rhat": dict(zip(("rho", "alpha", "sigma"), (float(v) for v in convergence.split_rhat(hyper)))),
    }
    return res, report, model, (x, y, xt, yt), hyper


def drive_latent(hyper, x, y, xt, yt, *, draws=32, chains=8, device="cuda", dtype=torch.float32, jitter=JITTER_GP):
    """After the sampler: exact latent-field draws from ``draws`` of the
    hyperparameter draws, and one value-and-gradient of the latent model."""
    n = x.shape[0]
    gen = torch.Generator(device=device).manual_seed(11)
    picks = hyper[:, -1, :][:draws]  # the last draw of each chain
    fs = gp_regression.sample_latent_conditional(gen, picks, x, y, jitter=jitter, batch=16, device=device, dtype=dtype)
    require(fs.shape == (len(picks), n) and bool(torch.isfinite(fs).all()), "latent draws: wrong shape or non-finite")
    f_true = np.sin(2 * x) * np.exp(-0.2 * np.abs(x)) * 2.0
    fs_np = fs.double().cpu().numpy()
    dev = np.abs(fs_np.mean(0) - f_true)
    within = float(np.mean(dev < 3.0 * fs_np.std(0, ddof=1)))
    rmse = float(np.sqrt(np.mean(dev**2)))
    require(within >= 0.95 and rmse < 0.15, f"latent mean: {within} of the points within 3 posterior sd of the generating function, rmse {rmse}")
    latent = gp_regression.make(n, jitter=jitter)
    z = latent.initial_positions(gen, chains, init_radius=0.5, device=device, dtype=dtype)
    z[:, :3] = torch.log(torch.tensor(picks[:chains], dtype=dtype, device=device))
    return fs, {"latent_draws": len(picks), "share_within_3_sd": within, "rmse_vs_generating_function": rmse}, latent, z


def phase_gp_path(entry):
    B = get_config().cholesky_block_size
    nb = -(-N_GP // B)
    chol_blocked.reset_counts()
    glm_fused.reset_counts()
    res, report, model, (x, y, xt, yt), hyper = drive_gp_sampler()
    launches_sampler = chol_blocked.LAUNCHES["chol_inv_block"]
    require(launches_sampler == nb * res.n_grad_calls > 0,
            f"{launches_sampler} launches for {res.n_grad_calls} gradient calls of {nb} blocks each")
    _, latent_report, latent, z_latent = drive_latent(hyper, x, y, xt, yt)
    lp_latent, _ = latent.logp_and_grad(z_latent, xt, yt)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(lp_latent).all()), "latent GP: non-finite logp")
    launches = chol_blocked.LAUNCHES["chol_inv_block"]
    plain_calls = chol_blocked.PLAIN_CALLS["chol_inv_block"]
    require(plain_calls == 0, f"the plain version ran on the GP path: {plain_calls} calls")
    require(launches == launches_sampler + 5 * nb, f"{launches - launches_sampler} launches after the sampler, expected {5 * nb}")
    entry["launches"] = launches

    # after the counts were read: the independent float64 reference, and timings
    z_final = res.position[:8, -1, :].contiguous()
    marginal_check = check_against_float64("marginal GP", model, z_final, xt, yt, JITTER_GP, floors={"logp": 0.05, "grad": 0.5})
    latent_check = check_against_float64("latent GP", latent, z_latent, xt, yt, JITTER_GP, floors={"logp": 0.05, "grad": 0.5})

    z_all = res.position[:, -1, :].contiguous()
    blocked_ms = time_ms(lambda: model.logp_and_grad(z_all, xt, yt), warmup=2, reps=5)
    update_config(cholesky_block_size=64)  # timing only: the other block size that fits, for the choice recorded in config.py
    blocked_64_ms = time_ms(lambda: model.logp_and_grad(z_all, xt, yt), warmup=2, reps=5)
    update_config(cholesky_block_size=B)
    linalg = lambda zz: gp_reference_logp(zz, xt, yt, JITTER_GP, gp_ops.sq_dists)  # noqa: E731
    linalg_ms = time_ms(lambda: value_and_grad(linalg, z_all), warmup=2, reps=5)
    emit("gp_path", **report, kernel_launches=launches, launches_in_sampler=launches_sampler, blocks_per_factorization=nb,
         plain_calls=plain_calls, marginal_vs_float64=marginal_check, latent=latent_report, latent_vs_float64=latent_check,
         value_and_grad_ms={"blocked_kernel_path": blocked_ms, "blocked_kernel_path_block_64": blocked_64_ms,
                            "torch_linalg_f32": linalg_ms, "shape": [C_GP, N_GP, N_GP]})
    return res, model, xt, yt


def phase_profile_gp(res, model, xt, yt, calls=3):
    """Only with ``--profile``: device time of a gradient call of the GP path
    by kind of kernel: the block kernel, the matrix products of the glue, and
    the elementwise rest (kernel-matrix build and its adjoint, padding, masks)."""
    from torch.profiler import ProfilerActivity, profile

    z = res.position[:, -1, :].contiguous()
    model.logp_and_grad(z, xt, yt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        model.logp_and_grad(z, xt, yt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            model.logp_and_grad(z, xt, yt)
        torch.cuda.synchronize()
    kernels, total_us = device_kernels(prof)
    kinds = {"chol_inv_block_kernel": 0.0, "matrix_products": 0.0, "elementwise_and_copies": 0.0}
    for e in kernels:
        key = e.key.lower()
        if "chol_inv_block" in key:
            kinds["chol_inv_block_kernel"] += dev_us(e)
        elif any(tag in key for tag in ("gemm", "gemv", "cutlass", "cublas", "xmma")):
            kinds["matrix_products"] += dev_us(e)
        else:
            kinds["elementwise_and_copies"] += dev_us(e)
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    emit(
        "profile_gp", grad_calls=calls, wall_ms_per_grad_call_untraced=wall / calls * 1e3,
        device_ms_per_grad_call=total_us / 1e3 / calls, device_busy_share=(total_us / 1e6) / wall,
        device_launches_per_grad_call=sum(e.count for e in kernels) / calls,
        device_ms_per_grad_call_by_kind={k: v / 1e3 / calls for k, v in kinds.items()},
        share_by_kind={k: v / total_us for k, v in kinds.items()},
        top_kernels=[{"name": e.key[:80], "count": e.count, "device_ms": dev_us(e) / 1e3} for e in top],
    )


def phase_eight_schools():
    model = eight_schools.make()
    gen = torch.Generator(device="cuda").manual_seed(1)
    z0 = model.initial_positions(gen, 64)
    require(z0.device.type == "cuda" and z0.dtype == torch.float32, "initial positions must default to float32 on the GPU")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_pooled_chains(gen, z0, model.logp, num_warmup=200, num_samples=200, max_depth=8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(res.position.device.type == "cuda", "the draws left the GPU")
    draws = model.transform_draws(res.position)
    mu = float(draws["mu"].double().mean())
    require(bool(torch.isfinite(res.position).all()), "non-finite draws")
    require(abs(mu - 4.4) < 1.5, f"eight-schools mean(mu) = {mu}")
    emit("eight_schools", chains=64, num_warmup=200, num_samples=200, wall_s=wall, mean_mu=mu,
         mean_tau=float(draws["tau"].double().mean()), divergence_rate=float(res.diverging.double().mean()),
         grad_calls=res.n_grad_calls, grad_calls_per_s=res.n_grad_calls / wall)


# ---------------------------------------------------------------------------
# BASELINE configs 3 and 5 as their benches drive them: radon with NUTS and
# ADVI, the checkpointed sampler and tempered SMC on the marginal GP
# ---------------------------------------------------------------------------

N_COUNTIES, N_OBS, C_RADON = 85, 919, 2048
RADON_MONITORED = ("mu_a", "mu_b", "log_sigma_a", "log_sigma_b", "log_sigma_y")  # the first five coordinates
GP_COORDS = ("log_rho", "log_alpha", "log_sigma")


def radon_truth(seed=0):
    """Means of the generating county effects of ``radon.synthetic_data(85,
    919, seed)``: its draws repeated in its order (it does not return them)."""
    rng = np.random.default_rng(seed)
    rng.integers(0, N_COUNTIES, N_OBS)
    rng.integers(0, 2, N_OBS)
    a_true = 1.5 + 0.3 * rng.normal(size=N_COUNTIES)
    b_true = -0.7 + 0.2 * rng.normal(size=N_COUNTIES)
    return float(a_true.mean()), float(b_true.mean())


def radon_args(device="cuda", dtype=torch.float32):
    """The radon data as the sampler's ``args``: tensors on ``device``."""
    county, x, y = radon.synthetic_data(N_COUNTIES, N_OBS, dtype=np.float32 if dtype == torch.float32 else np.float64)
    return (torch.tensor(county, device=device), torch.tensor(x, dtype=dtype, device=device),
            torch.tensor(y, dtype=dtype, device=device))


def timed(fn, device):
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if device == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def drive_radon(*, chains=C_RADON, num_warmup=200, num_samples=200, max_depth=10, seed=1, device="cuda",
                dtype=torch.float32):
    """BASELINE config 3 as ``benches/bench_radon.py:24-66`` runs it, the
    length cut from 300 + 500 to 200 + 200: ``run_pooled_chains_chunked``
    with ``auto_depth`` (warmup chunks of 100, the sampling phase one chunk),
    ``target_accept=0.85``, inits uniform(-1, 1).  200 draws a chain, not
    fewer: ``log_sigma_b``'s draws are correlated over ~9 transitions, so its
    split R-hat is ~1.07 at 100 draws a chain and ~1.03 at 200, whatever the
    number of chains.  Returns ``(res, wall_s, model, args)``."""
    model = radon.make(N_COUNTIES)
    args = radon_args(device, dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    z0 = 2.0 * torch.rand((chains, model.dim), generator=gen, device=device, dtype=dtype) - 1.0
    res, wall = timed(lambda: run_pooled_chains_chunked(
        gen, z0, model.logp, args=args, num_warmup=num_warmup, num_samples=num_samples, max_depth=max_depth,
        auto_depth=True, target_accept=0.85, warmup_chunk=100, sample_chunk=num_samples, device=device,
    ), device)
    require(res.position.shape == (chains, num_samples, model.dim), f"radon: draws of shape {tuple(res.position.shape)}")
    return res, wall, model, args


def check_radon(res, wall, model, args):
    """The radon path's gates and report.  Limits: divergences < 5%
    (the other paths' gate); split R-hat < 1.05 on the five monitored
    coordinates (the usual convergence limit; 2048 chains make it strict);
    posterior means of ``mu_a`` / ``mu_b`` within 0.1 of the
    means of the generating county effects (the posterior sd of each is about
    0.03-0.05 here: 85 counties, county sds 0.3 / 0.2, and the data's own
    noise in the sample means of 85 effects).  ``logp`` and its gradient at
    the final positions, computed twice, must be equal bit for bit: no
    atomics on the path (the one-hot products of ``ops/segment.py``)."""
    pos = res.position.double().cpu().numpy()
    require(bool(np.isfinite(pos).all()), "radon: non-finite draws")
    div_rate = float(res.diverging.double().mean())
    require(div_rate < 0.05, f"radon: divergence rate {div_rate}")
    rhat = convergence.split_rhat(pos[..., :5])
    require(bool(np.all(rhat < 1.05)), f"radon: split R-hat {rhat} on {RADON_MONITORED}")
    draws = model.transform_draws(res.position)
    post = {k: float(draws[k].double().mean()) for k in ("mu_a", "mu_b")}
    truth = dict(zip(("mu_a", "mu_b"), radon_truth()))
    errs = {k: abs(post[k] - truth[k]) for k in post}
    require(max(errs.values()) < 0.1, f"radon: posterior means {post} against the generating means {truth}")
    z = res.position[:, -1, :].contiguous()
    lp1, g1 = model.logp_and_grad(z, *args)
    lp2, g2 = model.logp_and_grad(z, *args)
    repeatable = bool(torch.equal(lp1, lp2) and torch.equal(g1, g2))
    require(repeatable, "radon: logp or gradient differs between two evaluations at the same positions")
    cap = res.max_depth
    return {
        "chains": pos.shape[0], "num_samples": pos.shape[1], "dim": model.dim, "wall_s": wall,
        "grad_calls": res.n_grad_calls, "ms_per_grad_call": wall / res.n_grad_calls * 1e3,
        "chunk_caps": list(res.chunk_caps), "chunk_seconds": list(res.chunk_seconds), "max_depth_used": cap,
        "step_size": float(res.step_size), "mean_tree_depth": float(res.tree_depth.double().mean()),
        "mean_lane_leapfrogs_per_transition": float(res.n_leapfrog.double().mean()),
        "deepest_lane_leapfrogs_per_transition": float(res.n_leapfrog.max(0).values.double().mean()),
        "divergence_rate": div_rate, "saturation_rate": float((res.tree_depth >= cap).double().mean()),
        "ess_bulk": dict(zip(RADON_MONITORED, (float(v) for v in convergence.ess_bulk(pos[..., :5])))),
        "split_rhat": dict(zip(RADON_MONITORED, (float(v) for v in rhat))),
        "posterior_mean": post, "generating_mean": truth, "abs_err": errs, "logp_grad_bitwise_repeatable": repeatable,
    }


def phase_radon_path():
    chol_blocked.reset_counts()
    glm_fused.reset_counts()
    res, wall, model, args = drive_radon()
    report = check_radon(res, wall, model, args)
    ran = {**chol_blocked.LAUNCHES, **chol_blocked.PLAIN_CALLS, **glm_fused.LAUNCHES, **glm_fused.PLAIN_CALLS}
    require(not any(ran.values()), f"radon_path: a hand kernel or its plain version ran: {ran}")
    emit("radon_path", **report)
    return res, model, args


def drive_advi_radon(model, args, nuts_position, *, device="cuda", dtype=torch.float32):
    """ADVI meanfield and fullrank on the radon model as
    ``benches/bench_radon.py:77-127`` runs it (Stan's eta ladder and
    relative-ELBO stop, 10,000 steps the cap), each against the NUTS draws on
    the five monitored coordinates: ``|mean_ADVI - mean_NUTS| / sd_NUTS`` and
    the sd ratio.  Limits: a finite ELBO; both stop by the tolerance rule
    before the cap; z below 0.5 NUTS sd on all five coordinates
    for fullrank, on ``mu_a`` and ``mu_b`` for meanfield (mean-field is known
    to misplace the weakly identified scales: the bench records it)."""
    mon, num_steps = 5, 10000
    nuts = nuts_position[..., :mon].double().reshape(-1, mon).cpu().numpy()
    nuts_mean, nuts_sd = nuts.mean(0), nuts.std(0)
    out = {}
    for method in ("meanfield", "fullrank"):
        gen = torch.Generator(device=device).manual_seed(2)
        r, wall = timed(lambda: advi(model.logp, gen, model.dim, args=args, method=method, num_steps=num_steps,
                                     dtype=dtype, device=device), device)
        mu = r.mu.double().cpu().numpy()[:mon]
        cov_sd = torch.sqrt(torch.diagonal(r.L.double() @ r.L.double().T)).cpu().numpy()[:mon]
        z = np.abs(mu - nuts_mean) / nuts_sd
        elbo = float(r.final_elbo)
        require(math.isfinite(elbo), f"advi {method}: final ELBO {elbo}")
        require(r.converged and r.num_steps_run < num_steps, f"advi {method}: not converged in {r.num_steps_run} steps")
        gated = z if method == "fullrank" else z[:2]
        require(bool(np.all(gated < 0.5)), f"advi {method}: z-scores against NUTS {z}")
        out[method] = {
            "wall_s": wall, "steps_per_s": r.num_steps_run / wall, "converged": r.converged,
            "steps_run": r.num_steps_run, "final_elbo": elbo, "eta": r.learning_rate,
            "eta_trial_elbos": [list(t) for t in r.eta_trial_elbos],
            "mean_z_by_coord": dict(zip(RADON_MONITORED, (float(v) for v in z))),
            "sd_ratio_by_coord": dict(zip(RADON_MONITORED, (float(v) for v in cov_sd / nuts_sd))),
        }
    return out


def phase_advi_radon(model, args, nuts_position):
    emit("advi_radon", **drive_advi_radon(model, args, nuts_position))


def gp_setup(n=N_GP, device="cuda", dtype=torch.float32, jitter=JITTER_GP):
    x, y = gp_regression.synthetic_data(n, seed=0)
    model = gp_regression.make_marginal(n, jitter=jitter)
    return model, torch.tensor(x, dtype=dtype, device=device), torch.tensor(y, dtype=dtype, device=device)


def drive_resume_gp(*, n=N_GP, chains=C_GP, num_warmup=50, num_samples=60, first=30, device="cuda",
                    dtype=torch.float32, sigma_tol=0.03):
    """Config 5's headline leg as ``benches/bench_gp.py:128-134`` runs it
    (``sample_nuts_checkpointed``, 32 chains, depth 3, accept 0.75, chunks of
    30, warmup segments of 25, ``init_radius`` 0.5), the length cut, with a
    draw store: once straight through, then into a fresh directory to
    ``first`` samples and the same call again to ``num_samples`` (the protocol
    of ``tests/test_runtime.py:74``).  Limits: the two position arrays equal
    bit for bit, the second call resumed, the draw store read back equal to
    the returned draws, the native writer, mean sigma within ``sigma_tol`` =
    0.03 of the 0.3 the data were made with (``gp_path``'s limit)."""
    model, xt, yt = gp_setup(n, device, dtype)
    kw = dict(args=(xt, yt), num_warmup=num_warmup, num_chains=chains, chunk_size=30, warmup_chunk_size=25,
              max_depth=3, target_accept=0.75, init_radius=0.5, dtype=dtype, device=device)

    def run(path, samples):
        gen = torch.Generator(device=device).manual_seed(0)
        return sample_nuts_checkpointed(model.logp, gen, model.dim, checkpoint_path=os.path.join(path, "ck"),
                                        num_samples=samples, draw_store_path=os.path.join(path, "draws.mtds"), **kw)

    with tempfile.TemporaryDirectory() as tmp:
        straight_dir, resumed_dir = os.path.join(tmp, "straight"), os.path.join(tmp, "resumed")
        os.makedirs(straight_dir)
        os.makedirs(resumed_dir)
        (pos_a, div_a, info_a), wall_a = timed(lambda: run(straight_dir, num_samples), device)
        (_, _, info_b1), wall_b1 = timed(lambda: run(resumed_dir, first), device)
        (pos_b, div_b, info_b2), wall_b2 = timed(lambda: run(resumed_dir, num_samples), device)
        stored = draw_store.read_draws(os.path.join(resumed_dir, "draws.mtds"))
        ckpt_bytes = os.path.getsize(os.path.join(resumed_dir, "ck", "state.pt"))
    equal = bool(np.array_equal(pos_a, pos_b) and np.array_equal(div_a, div_b))
    require(equal, f"resume_gp: resumed draws differ from the straight run's by up to {np.abs(pos_a - pos_b).max()}")
    require(info_b2["resumed"] and not info_a["resumed"], "resume_gp: the second call did not resume")
    store_equal = bool(np.array_equal(stored, pos_b.transpose(1, 0, 2)))
    require(store_equal, f"resume_gp: the draw store holds {stored.shape} unequal to the returned draws")
    require(draw_store.native_available(), "resume_gp: the native draw store did not build")
    require(bool(np.isfinite(pos_a).all()), "resume_gp: non-finite draws")
    sigma = model.transform_draws(torch.tensor(pos_a))["sigma"].double().numpy()
    require(abs(sigma.mean() - 0.3) < sigma_tol, f"resume_gp: posterior mean of sigma is {sigma.mean()}")
    calls = info_a["n_grad_calls"] + info_b1["n_grad_calls"] + info_b2["n_grad_calls"]
    infos = (info_a, info_b1, info_b2)
    writes = sum(i["checkpoints_written"] for i in infos)
    return pos_a, calls, {
        "chains": chains, "n": n, "num_warmup": num_warmup, "num_samples": num_samples, "first_call_samples": first,
        "wall_s": {"straight": wall_a, "first": wall_b1, "resumed": wall_b2},
        "grad_calls": {"straight": info_a["n_grad_calls"], "first": info_b1["n_grad_calls"],
                       "resumed": info_b2["n_grad_calls"]},
        "ms_per_grad_call": (wall_a + wall_b1 + wall_b2) / calls * 1e3,
        "bitwise_equal": equal, "resumed": info_b2["resumed"], "draw_store_equal": store_equal,
        "draw_store_native": draw_store.native_available(), "checkpoints_written": writes,
        "checkpoint_write_ms": sum(i["checkpoint_seconds"] for i in infos) / writes * 1e3,
        "checkpoint_bytes": ckpt_bytes, "step_size": [float(v) for v in info_a["step_size"][:4]],
        "max_depth_used": info_a["max_depth_used"], "divergence_rate": float(div_a.mean()),
        "treedepth_hit_rate": info_a["treedepth_hit_rate"], "mean_sigma": float(sigma.mean()),
        "ess_bulk": dict(zip(GP_COORDS, (float(v) for v in convergence.ess_bulk(pos_a.astype(np.float64))))),
        "split_rhat": dict(zip(GP_COORDS, (float(v) for v in convergence.split_rhat(pos_a.astype(np.float64))))),
    }


def block_kernel_launches(label, evaluations, n=N_GP):
    """After a GP phase: the block kernel launched ``ceil(n / B)`` times per
    32-row log-density evaluation and the plain version never."""
    nb = -(-n // get_config().cholesky_block_size)
    launches, plain = chol_blocked.LAUNCHES["chol_inv_block"], chol_blocked.PLAIN_CALLS["chol_inv_block"]
    require(plain == 0, f"{label}: the plain version ran {plain} times")
    require(launches == nb * evaluations > 0, f"{label}: {launches} launches for {evaluations} evaluations of {nb} blocks")
    return launches


def phase_resume_gp():
    chol_blocked.reset_counts()
    pos, calls, report = drive_resume_gp()
    launches = block_kernel_launches("resume_gp", calls)
    emit("resume_gp", **report, kernel_launches=launches, plain_calls=chol_blocked.PLAIN_CALLS["chol_inv_block"])
    return launches


def drive_smc_gp(nuts_position, *, n=N_GP, particles=64, device="cuda", dtype=torch.float32):
    """Config 5's second leg as ``benches/bench_gp.py:233-237`` runs it
    (``smc_tempered_stagewise``, ``particle_batch`` 32, one mutation step of
    depth 3, ``target_rel_ess`` 0.3, seed 2), with 64 particles for the
    bench's 512.  Counts the 32-row log-density evaluations, with or without
    a gradient.  Limits: t reaches 1 within ``max_stages`` (100); a finite
    log evidence; each particle mean within 0.75 NUTS sd of the
    NUTS mean on the unconstrained coordinates (the bench's 0.3 is for 512
    particles; 64 correlated particles after one mutation step carry several
    times its Monte-Carlo error)."""
    model, xt, yt = gp_setup(n, device, dtype)
    evaluations = [0]

    def counted(z, *a):
        require(z.shape[0] == 32, f"smc_gp: an evaluation of {z.shape[0]} rows")
        evaluations[0] += 1
        return model.logp(z, *a)

    gen = torch.Generator(device=device).manual_seed(2)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    res, wall = timed(lambda: smc_tempered_stagewise(
        counted, gen, model.dim, args=(xt, yt), num_particles=particles, particle_batch=32, mutation_steps=1,
        max_depth=3, target_rel_ess=0.3, dtype=dtype, device=device,
    ), device)
    logz = float(res.log_evidence)
    require(res.temperatures and res.temperatures[-1] == 1.0, f"smc_gp: t ended at {res.temperatures[-1:]} after {res.num_stages} stages")
    require(math.isfinite(logz), f"smc_gp: log evidence {logz}")
    p = res.particles.double().cpu().numpy()
    nuts = nuts_position[..., :3].double().reshape(-1, 3).cpu().numpy()
    z = np.abs(p.mean(0) - nuts.mean(0)) / nuts.std(0)
    require(bool(np.all(z < 0.75)), f"smc_gp: particle means {p.mean(0)} against NUTS {nuts.mean(0)}: z {z}")
    cons = np.exp(p)
    return evaluations[0], {
        "particles": particles, "n": n, "stages": res.num_stages, "ladder_length": len(res.temperatures),
        "temperatures": list(res.temperatures), "wall_s": wall, "log_evidence": logz,
        "final_step_size": float(res.final_step_size), "evaluations_32_rows": evaluations[0],
        "ms_per_evaluation": wall / evaluations[0] * 1e3,
        "mean_z_vs_nuts": dict(zip(GP_COORDS, (float(v) for v in z))),
        "sd_ratio_vs_nuts": dict(zip(GP_COORDS, (float(v) for v in p.std(0) / nuts.std(0)))),
        "particle_mean": dict(zip(("rho", "alpha", "sigma"), (float(v) for v in cons.mean(0)))),
        "particle_sd": dict(zip(("rho", "alpha", "sigma"), (float(v) for v in cons.std(0)))),
        "nuts_mean": dict(zip(("rho", "alpha", "sigma"), (float(v) for v in np.exp(nuts).mean(0)))),
        "nuts_sd": dict(zip(("rho", "alpha", "sigma"), (float(v) for v in np.exp(nuts).std(0)))),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None,
    }


def phase_smc_gp(nuts_position):
    chol_blocked.reset_counts()
    evaluations, report = drive_smc_gp(nuts_position)
    launches = block_kernel_launches("smc_gp", evaluations)
    emit("smc_gp", **report, kernel_launches=launches, plain_calls=chol_blocked.PLAIN_CALLS["chol_inv_block"])
    return launches



# ---------------------------------------------------------------------------
# BASELINE config 4 as its bench drives it: Lotka-Volterra with the RK4 kernel
# pair under 512-chain chunked NUTS, and the config's adaptive DP5 method
# ---------------------------------------------------------------------------

LV_TIMES, LV_STEPS, C_LV = 20, lotka_volterra.RK4_STEPS_PER_INTERVAL, 512
LV_REPLACES = "no Pallas kernel: math_tpu/ops/ode.py:408 lax.scan under models/lotka_volterra.py:70"
# Operations of one RK4 step of the Lotka-Volterra system a chain, counted
# from the function (each + - * and negation one): four right-hand sides of 8,
# three stage inputs of 2 x 2, the update 2 x 7; its adjoint given the
# step's state: stages k1..k3 and s2..s4 again (3 x 8 + 3 x 4), h/6 lambda
# and its double (4), the four stage adjoints of 24 (J_y^T kbar 13, ybar 2,
# J_theta^T kbar and its sum 9), the cotangent updates 3 x 4.  In dual
# numbers a product of two duals is 4 operations, a constant times a dual
# 2, a sum or a negation 2: the dual forward's right-hand side is 6 products
# and 2 sums (28), the stage inputs 3 x 2 x 4, the update 2 x 14: 164; the
# dual adjoint's stages 3 x 28 + 3 x 2 x 4, h/6 lambda and its double 8, a
# stage adjoint 74 (J_y^T kbar: 8 products, 4 sums, 1 negation; ybar 2
# sums; J_theta^T kbar: 5 products, 4 sums), the cotangent updates 3 x 2 x
# 4: 436.
LV_OPS = {"forward": 58, "adjoint": 148, "dual_forward": 164, "dual_adjoint": 436}
# The dependent operations on each kernel's serial chain, read from
# csrc/lv_rk4.cu.  The forwards: a step of the chain's T*S (the forward's
# rounded products and sums from y to the next y: a right-hand side 2
# products and a sum deep, a stage input a product and a sum, the update a
# sum, a product and a sum, 4 x 3 + 3 x 2 + 3; the dual forward's tangent
# chain, a product of two duals a product and a sum).  The adjoints: a step
# of a lane's T*S/32, run twice (phase 1 composes the maps, whose offset's
# chain is the cotangent's; phase 3 runs the cotangent: h/6 lambda, each
# stage adjoint a product and an FMA, the FMA that updates the next stage's
# cotangent, the sum into lambda; in dual numbers a stage adjoint is 4
# deep), then once the scan of 5 levels (two FMAs an offset) and the 5
# additions of thetabar's sum over the lanes (LV_SCAN_OPS).
LV_CHAIN_OPS = {
    "forward": {"mul": 12, "add": 9},
    "adjoint": {"mul": 10, "fma": 14, "add": 2},
    "dual_forward": {"mul": 12, "add": 17},
    "dual_adjoint": {"mul": 10, "fma": 30, "add": 2},
}
LV_SCAN_OPS = {"adjoint": {"fma": 10, "add": 5}, "dual_adjoint": {"fma": 20, "add": 10}}
LV_LANES = 32  # the adjoints' lanes a chain
# State accesses a step in each kernel's step loop (the forward's store, the
# adjoint's cp.async copy, LDGSTS; a State of float, double or Dual<float>
# is one access, of Dual<double>, 32 bytes, two): the marker by which the
# SASS of the step loop is found and its steps counted.
LV_STEP_ACCESS = {"forward": "STG", "adjoint": "LDGSTS", "dual_forward": "STG", "dual_adjoint": "LDGSTS"}
# Recovery limits of lv_path on |log posterior mean - log generating value|,
# from a CPU rehearsal of drive_lv at 16 chains (float32, 100 + 100): theta
# 0.176-0.238, z0 0.084-0.135.  The distances are the data's: the JAX
# package's posterior mode sits as far from the generating values, so a
# limit must allow them.
LV_RECOVERY_LIMIT = {"theta": 0.3, "z0": 0.2}
# The sharper yardstick: the JAX package's posterior mode of the same data
# (tools/lv_reference_map.py, float64 L-BFGS on the CPU), and a limit on
# |log posterior mean - log mode|.  The same rehearsal's means sat 0.0005-
# 0.0139 (theta) and 0.0009-0.0072 (z0) from it, the gap of a skewed
# posterior's mean to its mode plus Monte Carlo error; 0.05 is ~3.5x that
# and a quarter of the generating values' distance, so a sampler drawn
# toward them fails it.
LV_REFERENCE_MODE = {
    "theta": np.array([0.6982800569947145, 0.035308056127418226, 0.6472203186939335, 0.01984523578060249]),
    "z0": np.array([30.354032420178935, 6.814392801765534]),
}
LV_MODE_LIMIT = 0.05
# The float64 audit of the reference (artifacts/lv_grid_audit_r4.json): the
# fixed grid against adaptive DP5 at posterior points.
LV_AUDIT = {"max_abs_dlogp": 0.001498, "max_rel_dgrad": 7.1e-05}


def lv_kernel_inputs(c, nt, seed, overflow=False):
    """``(z0 (c, 2), theta (c, 4), gbar (c, nt, 2))`` as numpy from a seed: the
    generating values of ``synthetic_data`` spread by 20% (where a sampler's
    chains are); ``overflow`` sets one lane's alpha to 1e30."""
    _, _, theta_true, z0_true = lotka_volterra.synthetic_data(LV_TIMES)
    rng = np.random.default_rng(seed)
    theta = theta_true * np.exp(0.2 * rng.normal(size=(c, 4)))
    z0 = z0_true * np.exp(0.2 * rng.normal(size=(c, 2)))
    if overflow:
        theta[c // 2, 0] = 1e30
    return z0, theta, rng.normal(size=(c, nt, 2))


def lv_plain_parts(z0, theta, gbar, ts, steps, dtype, device="cuda"):
    """``(ys, z0bar, thetabar)`` of the plain version (autograd through
    ``ode_rk4_fixed``) in ``dtype`` on ``device``."""
    z = torch.tensor(z0, dtype=dtype, device=device, requires_grad=True)
    th = torch.tensor(theta, dtype=dtype, device=device, requires_grad=True)
    ys = lv_rk4.lv_rk4_plain(z, 0.0, ts, th, steps)
    zb, tb = torch.autograd.grad(ys, (z, th), torch.tensor(gbar, dtype=dtype, device=device))
    return ys.detach(), zb, tb


def lv_kernel_parts(z0, theta, gbar, ts, steps, dtype):
    """``(ys, z0bar, thetabar, states)`` of the kernel pair in ``dtype``."""
    z, th, g = (torch.tensor(a, dtype=dtype, device="cuda") for a in (z0, theta, gbar))
    ys, states = lv_rk4.lv_rk4_forward(z, 0.0, ts, th, steps)
    zb, tb = lv_rk4.lv_rk4_adjoint(0.0, ts, th, steps, states, g.contiguous())
    return ys, zb, tb, states


def lv_tangents(c, nt, seed):
    """Tangents ``(tz0 (c, 2), ttheta (c, 4), tgbar (c, nt, 2))`` as numpy,
    scaled like their primals (z0 ~ 10, theta's entries as the generating
    values, gbar ~ 1)."""
    _, _, theta_true, z0_true = lotka_volterra.synthetic_data(LV_TIMES)
    rng = np.random.default_rng(seed)
    return 0.1 * z0_true * rng.normal(size=(c, 2)), 0.1 * theta_true * rng.normal(size=(c, 4)), rng.normal(size=(c, nt, 2))


def lv_plain_dual_parts(z0, theta, gbar, tangents, ts, steps, dtype, device="cuda"):
    """``(ys, ys', z0bar, thetabar, z0bar', thetabar')`` of the plain
    version: ``torch.func.jvp`` of ``(z0, theta, gbar) -> (ys, vjp of ys at
    gbar)`` through ``ode_rk4_fixed``, in ``dtype`` on ``device``."""
    z, th, g, tz, tth, tg = (torch.tensor(a, dtype=dtype, device=device) for a in (z0, theta, gbar, *tangents))

    def f(a, b, cot):
        ys, pullback = torch.func.vjp(lambda x, y: lv_rk4.lv_rk4_plain(x, 0.0, ts, y, steps), a, b)
        return (ys,) + pullback(cot)

    (ys, zb, tb), (tys, tzb, ttb) = torch.func.jvp(f, (z, th, g), (tz, tth, tg))
    return ys, tys, zb, tb, tzb, ttb


def lv_dual_parts(z0, theta, gbar, tangents, ts, steps, dtype):
    """``(ys, ys', z0bar, thetabar, z0bar', thetabar')`` of the dual kernels
    in ``dtype``: the dual forward (its states kept), then the dual adjoint."""
    z, th, g, tz, tth, tg = (torch.tensor(a, dtype=dtype, device="cuda") for a in (z0, theta, gbar, *tangents))
    ys, tys, states = lv_rk4.lv_rk4_dual_forward(z, 0.0, ts, th, steps, tz, tth, keep_states=True)
    zb, tb, tzb, ttb = lv_rk4.lv_rk4_dual_adjoint(0.0, ts, th, steps, tth, states, g, tg)
    return ys, tys, zb, tb, tzb, ttb


LV_PARTS = ("ys", "z0bar", "thetabar")
LV_DUAL_PARTS = ("ys", "ys_dot", "z0bar", "thetabar", "z0bar_dot", "thetabar_dot")


def normalized_err(got, want):
    """``max |got - want| / max |want|``, in float64."""
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def normalized_errs(got, want, names=LV_PARTS):
    """``normalized_err`` of each part."""
    return {name: normalized_err(g, w) for name, g, w in zip(names, got, want)}


def lv_ragged_checks():
    """Ragged shapes, each with one lane whose alpha overflows: the pair and
    the dual pair in float32 and float64 against the plain version of the
    same dtype (its ``torch.func.jvp`` for the dual pair).  The pattern of NaN
    and of inf in ``ys`` (and ``ys'``) must be the plain version's element by
    element, the non-finite pattern of the gradients the plain version's
    element by element (the pair) or lane by lane (the dual pair, whose
    formulas for the tangent of the gradient differ from autograd's); the
    finite lanes agree within the main shape's tolerances (float64 ones for
    the double instances)."""
    ts_all = lotka_volterra.synthetic_data(LV_TIMES)[0]
    out = {}
    for c in (5, 129):
        for steps in (1, 7):
            z0, theta, gbar = lv_kernel_inputs(c, 3, seed=300 + c + steps, overflow=True)
            tangents = lv_tangents(c, 3, seed=600 + c + steps)
            for dtype, tol in ((torch.float32, 2e-5), (torch.float64, 1e-12)):
                label = f"c{c}_s{steps}_{str(dtype)[6:]}"
                got = lv_kernel_parts(z0, theta, gbar, ts_all[:3], steps, dtype)[:3]
                want = lv_plain_parts(z0, theta, gbar, ts_all[:3], steps, dtype)
                dual = lv_dual_parts(z0, theta, gbar, tangents, ts_all[:3], steps, dtype)
                dual_want = lv_plain_dual_parts(z0, theta, gbar, tangents, ts_all[:3], steps, dtype)
                torch.cuda.synchronize()
                for name, g, w in (("ys", got[0], want[0]), ("dual ys", dual[0], want[0]), ("ys'", dual[1], dual_want[1])):
                    require(torch.equal(torch.isnan(g), torch.isnan(w)) and torch.equal(torch.isinf(g), torch.isinf(w)),
                            f"lv_rk4 {label}: NaN/inf pattern of {name}")
                for g, w, name in zip(got[1:], want[1:], ("z0bar", "thetabar")):
                    require(torch.equal(torch.isfinite(g), torch.isfinite(w)), f"lv_rk4 {label}: non-finite pattern of {name}")
                lanes = lambda parts: torch.stack([torch.isfinite(t).flatten(1).all(1) for t in parts[2:]])  # noqa: E731
                require(torch.equal(lanes(dual), lanes(dual_want)), f"lv_rk4 dual {label}: non-finite lanes of the gradient")
                fin = torch.isfinite(want[0]).all(dim=(1, 2)) & torch.isfinite(want[2]).all(dim=1)
                require(int(fin.sum()) == c - 1, f"lv_rk4 {label}: {int(fin.sum())} finite lanes of {c}")
                errs = normalized_errs([t[fin] for t in got], [t[fin] for t in want])
                dual_errs = normalized_errs([t[fin] for t in dual], [t[fin] for t in dual_want], LV_DUAL_PARTS)
                require(max(errs.values()) <= tol, f"lv_rk4 {label}: {errs} > {tol}")
                dual_tol = tol if dtype == torch.float64 else LV_DUAL_TOL32_RAGGED
                require(max(dual_errs.values()) <= dual_tol, f"lv_rk4 dual {label}: {dual_errs} > {dual_tol}")
                out[label] = {"normalized_err": errs, "dual_normalized_err": dual_errs,
                              "nonfinite_ys": int((~torch.isfinite(got[0])).sum()), "nan_ys": int(torch.isnan(got[0]).sum()),
                              "nonfinite_ys_dot": int((~torch.isfinite(dual[1])).sum())}
    return out


def lv_chain_stamps(launches, n_steps, reps=5):
    """Chain 0's serial work inside each kernel, from its stamps
    (``clock64()`` and ``%globaltimer`` where its steps start and end): the
    median over ``reps`` launches of the time (ms) and of the cycles a step.
    ``launches`` maps a name to a function of the stamps tensor."""
    out = {}
    for name, launch in launches.items():
        rows = []
        for _ in range(reps):
            st = torch.zeros(4, dtype=torch.int64, device="cuda")
            launch(st)
            rows.append(st.cpu().tolist())
        cycles = float(np.median([r[1] - r[0] for r in rows]))
        ns = float(np.median([r[3] - r[2] for r in rows]))
        require(cycles > 0 and ns > 0, f"lv_rk4 {name}: stamps {rows}")
        out[name] = {"chain_ms": ns / 1e6, "cycles_per_step": cycles / n_steps, "cycles": cycles, "ns": ns}
    return out


def sass_functions(text):
    """``{mangled name: [(address, instruction)]}`` of ``cuobjdump -sass``
    output, with each branch target resolved to an address."""
    funcs, cur, labels, pending = {}, None, {}, []
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            labels, pending = {}, []
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m and cur is not None:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            cur.append((addr, m.group(2), labels))
    out = {}
    for name, ins in funcs.items():
        resolved = []
        for addr, text_, labels_ in ins:
            tgt = None
            if re.search(r"\bBRA\b", text_):
                m = re.search(r"\(\s*(\.L_x_\d+)\s*\)", text_)
                if m:
                    tgt = labels_.get(m.group(1))
                else:
                    m = re.search(r"\b0x([0-9a-f]+)\b", text_)
                    tgt = int(m.group(1), 16) if m else None
            resolved.append((addr, text_, tgt))
        out[name] = resolved
    return out


def sass_step_loops(ins, access):
    """``[(instructions, accesses)]`` of every innermost loop of one kernel's
    SASS that holds an ``access`` instruction (the adjoints' two phases)."""
    loops = []
    for addr, text_, tgt in ins:
        if tgt is None or tgt > addr:
            continue
        body = [t for a, t, _ in ins if tgt <= a <= addr]
        n_access = sum(1 for t in body if re.match(r"(@!?U?P\w+\s+)?" + access + r"\b", t))
        if n_access:
            loops.append((tgt, addr, len(body), n_access))
    inner = [x for x in loops if not any(y is not x and x[0] <= y[0] and y[1] <= x[1] for y in loops)]
    return [(n, k) for _, _, n, k in inner]


def sass_step_loop(ins, access):
    """The step loop of one kernel's SASS: of its loops (a backward branch
    and its target) that hold an ``access`` instruction (the state store or
    load each step makes), the innermost, that is the shortest.
    ``(instructions in the loop, state accesses in it)``, or None."""
    best = None
    for addr, text_, tgt in ins:
        if tgt is None or tgt > addr:
            continue
        body = [t for a, t, _ in ins if tgt <= a <= addr]
        n_access = sum(1 for t in body if re.match(r"(@!?U?P\w+\s+)?" + access + r"\b", t))
        if n_access and (best is None or len(body) < best[0]):
            best = (len(body), n_access)
    return best


def lv_sass_steps(lib_path):
    """Instructions a step of each instance's step loop, from ``cuobjdump
    -sass`` of the built library: ``{instance: {dtype: {"instructions",
    "accesses", "per_step"}}}`` (a State of Dual<double> takes two accesses a
    step, every other one)."""
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib_path], check=True, capture_output=True, text=True).stdout
    funcs = sass_functions(text)
    out = {}
    for name, ins in funcs.items():
        m = re.search(r"lv_rk4_(forward|adjoint)_kernelI(N\w*?Dual)?I?([fd])E", name)
        if not m:
            continue
        dual, dtype = m.group(2) is not None, {"f": "float32", "d": "float64"}[m.group(3)]
        kind = ("dual_" if dual else "") + m.group(1)
        per_access = 2 if (dual and dtype == "float64") else 1
        if kind.endswith("adjoint"):  # its two phases' loops, a step of each
            loops = sass_step_loops(ins, LV_STEP_ACCESS[kind])
            require(len(loops) == 2, f"lv_rk4: {len(loops)} step loops in the SASS of {name}")
            out.setdefault(kind, {})[dtype] = {"loops": loops, "per_step": sum(n / (k / per_access) for n, k in loops)}
            continue
        loop = sass_step_loop(ins, LV_STEP_ACCESS[kind])
        require(loop is not None, f"lv_rk4: no step loop found in the SASS of {name}")
        steps = loop[1] / per_access
        out.setdefault(kind, {})[dtype] = {"instructions": loop[0], "accesses": loop[1], "steps_in_loop": steps,
                                           "per_step": loop[0] / steps}
    return out, len(text)
def lv_profiled_ms(calls, reps=20):
    """Device time (ms) a call of each of ``calls`` (a name to ``(function,
    predicate on the profiler's kernel name)``) from ``torch.profiler``: the
    kernel's own time, free of the host time between launches that CUDA
    events around back-to-back calls include."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, (fn, match) in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA and match(e.key)]
        us, n = sum(dev_us(e) for e in rows), sum(e.count for e in rows)
        require(us > 0 and n == reps, f"lv_rk4 {name}: the profiler saw {n} launches, {us} us")
        out[name] = us / 1e3 / reps
    return out


def lv_instance_bytes(kind, c, nt, n_steps, width):
    """Bytes each instance must move: its inputs read once, its outputs
    written once (the states an output of the forwards and an input of the
    adjoints; a dual array twice its primal)."""
    dual = 2 if kind.startswith("dual") else 1
    states = dual * 2 * c * n_steps
    if kind.endswith("forward"):
        n = dual * (2 * c + 4 * c + 2 * c * nt) + 3 * nt + states
    else:
        n = dual * (4 * c + 2 * c * nt + 2 * c + 4 * c) + 3 * nt + states
    return float(width * n)


# float32 tolerances of the dual pair, on the largest error over the largest
# float64 value of each output: 10x the float32 plain version's own error
# (``torch.func.jvp`` of its vjp against float64 on the CPU, rounded up) at
# the main shape (ys 1.0e-6, ys' 4.2e-6, z0bar 2.3e-6, thetabar 2.1e-6,
# z0bar' 2.1e-5, thetabar' 4.7e-6) and at the ragged shapes' finite lanes
# (worst 1.2e-6).
LV_DUAL_TOL32 = {"ys": 2e-5, "ys_dot": 5e-5, "z0bar": 5e-5, "thetabar": 5e-5, "z0bar_dot": 2.5e-4, "thetabar_dot": 5e-5}
LV_DUAL_TOL32_RAGGED = 2e-5


def phase_kernels_lv():
    """The LV kernels against their plain version on the card: the pair
    (forward with its states kept, adjoint) and the dual pair (dual forward,
    dual adjoint) at the main shape (C = 512, T = 20, S = 24) in float32
    against float64, the double instances against float64, the ragged
    shapes; each instance's time (CUDA events over back-to-back calls, and
    its device time from the profiler), chain 0's serial time and cycles a
    step, and four bounds: operations, bytes, the dependent chain's latency
    (``op_latency_probe``) and the step loop's instructions at one a cycle
    (``cuobjdump -sass``).  Returns the kernel entries of the pair and of the
    dual pair."""
    ts = lotka_volterra.synthetic_data(LV_TIMES)[0]
    c, nt, steps = C_LV, LV_TIMES, LV_STEPS
    n_steps = nt * steps
    z0, theta, gbar = lv_kernel_inputs(c, nt, seed=400)
    tangents = lv_tangents(c, nt, seed=401)
    want = lv_plain_parts(z0, theta, gbar, ts, steps, torch.float64)
    got32 = lv_kernel_parts(z0, theta, gbar, ts, steps, torch.float32)
    got64 = lv_kernel_parts(z0, theta, gbar, ts, steps, torch.float64)
    plain32 = lv_plain_parts(z0, theta, gbar, ts, steps, torch.float32)
    dual_want = lv_plain_dual_parts(z0, theta, gbar, tangents, ts, steps, torch.float64)
    dual32 = lv_dual_parts(z0, theta, gbar, tangents, ts, steps, torch.float32)
    dual64 = lv_dual_parts(z0, theta, gbar, tangents, ts, steps, torch.float64)
    plain_dual32 = lv_plain_dual_parts(z0, theta, gbar, tangents, ts, steps, torch.float32)
    torch.cuda.synchronize()
    # float32: 10x the float32 plain version's own error at this shape on the
    # CPU (1.5e-6 for ys, 3e-6 for the gradients, normalized by the largest value)
    tol32 = {"ys": 2e-5, "z0bar": 5e-5, "thetabar": 5e-5}
    errs32, errs64, plain_errs = (normalized_errs(g[:3], want) for g in (got32, got64, plain32))
    for name, tol in tol32.items():
        require(errs32[name] <= tol, f"lv_rk4 float32 {name}: normalized error {errs32[name]} > {tol}")
        require(errs64[name] <= 1e-10, f"lv_rk4 float64 {name}: normalized error {errs64[name]} > 1e-10")
    dual_errs32, dual_errs64, plain_dual_errs = (normalized_errs(g, dual_want, LV_DUAL_PARTS) for g in (dual32, dual64, plain_dual32))
    for name, tol in LV_DUAL_TOL32.items():
        require(dual_errs32[name] <= tol, f"lv_rk4 dual float32 {name}: normalized error {dual_errs32[name]} > {tol}")
        require(dual_errs64[name] <= 1e-10, f"lv_rk4 dual float64 {name}: normalized error {dual_errs64[name]} > 1e-10")
    forward_equal = bool(torch.equal(got32[0], plain32[0].float()))
    require(forward_equal, "lv_rk4: the float32 forward is not the plain version's bit for bit")
    for got, dual in ((got32, dual32), (got64, dual64)):
        ys, states = got[0], got[3]
        require(torch.equal(dual[0], ys), "lv_rk4: the dual forward's primal is not the forward's bit for bit")
        require(torch.equal(states[0], torch.tensor(z0, dtype=ys.dtype, device="cuda"))
                and torch.equal(states[steps::steps], ys[:, :-1].transpose(0, 1)), "lv_rk4: the states' layout")
    ragged = lv_ragged_checks()

    zt, tht, gt, tzt, ttht, tgt = (torch.tensor(a, dtype=torch.float32, device="cuda") for a in (z0, theta, gbar, *tangents))
    ys, states = lv_rk4.lv_rk4_forward(zt, 0.0, ts, tht, steps)
    _, _, dstates = lv_rk4.lv_rk4_dual_forward(zt, 0.0, ts, tht, steps, tzt, ttht, keep_states=True)
    launch = {
        "forward": lambda st=None: lv_rk4.lv_rk4_forward(zt, 0.0, ts, tht, steps, stamps=st),
        "adjoint": lambda st=None: lv_rk4.lv_rk4_adjoint(0.0, ts, tht, steps, states, gt, stamps=st),
        "dual_forward": lambda st=None: lv_rk4.lv_rk4_dual_forward(zt, 0.0, ts, tht, steps, tzt, ttht, stamps=st, keep_states=True),
        "dual_adjoint": lambda st=None: lv_rk4.lv_rk4_dual_adjoint(0.0, ts, tht, steps, ttht, dstates, gt, tgt, stamps=st),
    }
    events = {k: time_ms(fn, warmup=3, reps=50) for k, fn in launch.items()}
    ms = time_ms(lambda: lv_rk4.lv_rk4_adjoint(0.0, ts, tht, steps, lv_rk4.lv_rk4_forward(zt, 0.0, ts, tht, steps)[1], gt),
                 warmup=3, reps=50)
    dual_ms = time_ms(lambda: lv_rk4._LvRk4Hvp.apply(zt, tht, gt, tzt, ttht, tgt, 0.0, ts, steps), warmup=3, reps=50)
    kernel_of = {"forward": "lv_rk4_forward_kernel<", "adjoint": "lv_rk4_adjoint_kernel<"}
    device = lv_profiled_ms({k: (fn, lambda key, k=k: kernel_of[k.replace("dual_", "")] in key and ("Dual<float>" in key) ==
                                 k.startswith("dual") and ("double" not in key)) for k, fn in launch.items()})
    chain = lv_chain_stamps(launch, n_steps)
    plain_fwd_ms = time_ms(lambda: lv_rk4.lv_rk4_plain(zt, 0.0, ts, tht, steps), warmup=1, reps=3)
    plain_ms = time_ms(lambda: lv_plain_parts(z0, theta, gbar, ts, steps, torch.float32), warmup=1, reps=3)
    plain_dual_ms = time_ms(lambda: lv_plain_dual_parts(z0, theta, gbar, tangents, ts, steps, torch.float32), warmup=1, reps=1)
    latency = {str(dt)[6:]: {op: lv_rk4.op_latency_cycles(op, dt) for op in ("add", "mul", "fma")}
               for dt in (torch.float32, torch.float64)}
    sass, _ = lv_sass_steps(_build.library_path(lv_rk4.KERNEL))
    instances = {}
    lane_steps = -(-n_steps // LV_LANES)  # an adjoint lane's steps, run in each of its two phases
    for k in launch:
        ghz = chain[k]["cycles"] / chain[k]["ns"]
        serial = lane_steps if k.endswith("adjoint") else n_steps
        lat = lambda ops: sum(n * latency["float32"][op] for op, n in ops.items())  # noqa: E731
        lat_cycles = lat(LV_CHAIN_OPS[k])
        per_step = sass[k]["float32"]["per_step"]
        ops_ms = LV_OPS[k] * n_steps * c / PEAK_FP32_FLOPS * 1e3
        bytes_ms = lv_instance_bytes(k, c, nt, n_steps, 4) / PEAK_BYTES_PER_S * 1e3
        instances[k] = {
            "events_ms": events[k], "device_ms": device[k], "chain_ms": chain[k]["chain_ms"],
            "cycles_per_step": chain[k]["cycles_per_step"], "sm_clock_ghz_in_kernel": ghz,
            "operations_ms": ops_ms, "bytes_ms": bytes_ms,
            "serial_steps": serial, "latency_cycles_per_step": lat_cycles,
            "latency_bound_ms": (serial * lat_cycles + lat(LV_SCAN_OPS.get(k, {}))) / ghz / 1e6,
            "sass_instructions_per_step": per_step, "issue_bound_ms": serial * per_step / ghz / 1e6,
            "sass": sass[k],
        }
    pair, duals = ("forward", "adjoint"), ("dual_forward", "dual_adjoint")

    def bounds(kinds, nbytes):
        flops = float(sum(LV_OPS[k] for k in kinds)) * n_steps * c
        ops_ms, bytes_ms = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
        return {"bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "bytes_ms": bytes_ms, "operations_ms": ops_ms,
                "latency_bound_ms": sum(instances[k]["latency_bound_ms"] for k in kinds),
                "issue_bound_ms": sum(instances[k]["issue_bound_ms"] for k in kinds)}

    # the function's own bytes: z0, theta, ts and gbar read, ys and the gradient written (tangents double them)
    pair_bounds = bounds(pair, 4.0 * (c * 2 + c * 4 + nt + 2 * c * nt * 2 + c * 2 + c * 4))
    dual_bounds = bounds(duals, 4.0 * (2 * (c * 2 + c * 4 + c * nt * 2) + nt + 2 * c * nt * 2 + 2 * (c * 2 + c * 4)))
    require(pair_bounds["bound_ms"] <= ms and dual_bounds["bound_ms"] <= dual_ms, "lv_rk4: a kernel beats its bound: the count is wrong")
    common = {"route": "cuda", "source": "math_tpu_torch/csrc/lv_rk4.cu", "library_ms": None,  # no PyTorch call integrates an ODE
              "shape": {"c": c, "t": nt, "steps_per_interval": steps, "dtype": "float32"}, "op_latency_cycles": latency}
    entry = {
        "name": "lv_rk4", "replaces": LV_REPLACES, **common,
        "launches": None,  # filled from lv_path's run
        "max_abs_err": max(float((g.double() - w).abs().max()) for g, w in zip(got32[:3], want)),
        "ms": ms, "forward_ms": events["forward"], "adjoint_ms": events["adjoint"],
        "device_ms": device["forward"] + device["adjoint"],
        "plain_ms": plain_ms, "plain_forward_ms": plain_fwd_ms, **pair_bounds,
        # measured in this run: chain 0's serial work in each kernel, by its stamps
        "chain_ms": chain["forward"]["chain_ms"] + chain["adjoint"]["chain_ms"],
        "forward_chain_ms": chain["forward"]["chain_ms"], "adjoint_chain_ms": chain["adjoint"]["chain_ms"],
        "cycles_per_step_forward": chain["forward"]["cycles_per_step"],
        "cycles_per_step_adjoint": chain["adjoint"]["cycles_per_step"],
        "sm_clock_ghz_in_kernel": (chain["forward"]["cycles"] + chain["adjoint"]["cycles"])
        / (chain["forward"]["ns"] + chain["adjoint"]["ns"]),
        "states_mb": states.numel() * 4 / 1e6,
        "normalized_err": errs32, "tolerance": tol32, "plain_f32_normalized_err": plain_errs,
        "double_normalized_err": errs64, "double_tolerance": 1e-10,
        "forward_equal_to_plain_f32": forward_equal, "instances": {k: instances[k] for k in pair},
        "ragged": ragged,
    }
    dual_entry = {
        "name": "lv_rk4_dual", "replaces": LV_REPLACES + " (its jax.jvp, and the jvp of its jax.vjp)", **common,
        "launches": None,  # filled from lv_second_order's run
        "max_abs_err": max(float((g.double() - w).abs().max()) for g, w in zip(dual32, dual_want)),
        "ms": dual_ms, "dual_forward_ms": events["dual_forward"], "dual_adjoint_ms": events["dual_adjoint"],
        "device_ms": device["dual_forward"] + device["dual_adjoint"],
        "plain_ms": plain_dual_ms, **dual_bounds,
        "cycles_per_step_dual_forward": chain["dual_forward"]["cycles_per_step"],
        "cycles_per_step_dual_adjoint": chain["dual_adjoint"]["cycles_per_step"],
        "dual_states_mb": dstates.numel() * 4 / 1e6,
        "normalized_err": dual_errs32, "tolerance": LV_DUAL_TOL32, "plain_f32_normalized_err": plain_dual_errs,
        "double_normalized_err": dual_errs64, "double_tolerance": 1e-10, "instances": {k: instances[k] for k in duals},
    }
    emit("kernels_lv", **{k: v for k, v in entry.items() if k != "ragged"}, ragged=ragged)
    emit("kernels_lv_dual", **dual_entry)
    return entry, dual_entry


def drive_lv(*, chains=C_LV, num_warmup=100, num_samples=100, seed=0, device="cuda", dtype=torch.float32):
    """BASELINE config 4 as ``benches/bench_lv.py:18-37`` runs it, the length
    cut from 150 + 150 to 100 + 100: ``make(ts, solver="rk4")`` on
    ``synthetic_data(20)``, ``run_pooled_chains_chunked`` at ``max_depth=7``,
    ``target_accept=0.85``, warmup chunks of 10 and sampling chunks of 15,
    every coordinate started uniform in (-1.5, -0.5) from a numpy seed.
    Returns ``(res, wall_s, model, args, evaluations)``: ``evaluations``
    counts the chain-batched log-density evaluations."""
    ts, y_obs, _, _ = lotka_volterra.synthetic_data(LV_TIMES)
    model = lotka_volterra.make(ts, solver="rk4")
    args = (torch.tensor(y_obs, dtype=dtype, device=device),)
    evaluations = [0]

    def counted(z, *a):
        evaluations[0] += 1
        return model.logp(z, *a)

    z0 = torch.tensor(np.random.default_rng(seed).uniform(-1.5, -0.5, (chains, model.dim)), dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    res, wall = timed(lambda: run_pooled_chains_chunked(
        gen, z0, counted, args=args, num_warmup=num_warmup, num_samples=num_samples, max_depth=7,
        target_accept=0.85, warmup_chunk=10, sample_chunk=15, device=device,
    ), device)
    require(res.position.shape == (chains, num_samples, model.dim), f"lv: draws of shape {tuple(res.position.shape)}")
    return res, wall, model, args, evaluations[0]


def lv_against_float64(model, z, y_obs):
    """``logp`` and gradient of ``model`` at ``z`` (its dtype, its solver on
    its device) against the float64 plain model (the CPU tensors take the
    plain version): ``(max |dlogp|, max normalized gradient error)``, the
    gradient error of a point ``max |dg| / max |g|``."""
    lp, g = model.logp_and_grad(z, y_obs)
    lp64, g64 = model.logp_and_grad(z.double().cpu(), y_obs.double().cpu())
    lp, g = lp.cpu(), g.cpu()
    dlp = float((lp.double() - lp64).abs().max())
    dg = float(((g.double() - g64).abs().amax(1) / g64.abs().amax(1)).max())
    return dlp, dg


def check_lv(res, wall, model, args, evaluations, limits=LV_RECOVERY_LIMIT):
    """The LV path's gates and report.  Limits: divergences < 5% (the other
    paths' gate); finite draws; split R-hat < 1.05 on log theta; recovery
    ``|log mean - log generating value|`` of theta and z0 within ``limits``
    and ``|log mean - log reference mode|`` within ``LV_MODE_LIMIT``;
    ``logp`` and its gradient at 8 final positions against the float64 plain
    model: |dlogp| <= 0.01 + 1e-5 |logp| and normalized gradient error <= 1e-3
    in float32 (the float32 rounding of 480 steps and of a 40-term sum),
    1e-10 in float64."""
    _, _, theta_true, z0_true = lotka_volterra.synthetic_data(LV_TIMES)
    pos = res.position.double().cpu().numpy()
    require(bool(np.isfinite(pos).all()), "lv: non-finite draws")
    div_rate = float(res.diverging.double().mean())
    require(div_rate < 0.05, f"lv: divergence rate {div_rate}")
    rhat = convergence.split_rhat(pos[..., :4])
    require(bool(np.all(rhat < 1.05)), f"lv: split R-hat {rhat} on log theta")
    draws = model.transform_draws(res.position)
    rec = {}
    for name, truth in (("theta", theta_true), ("z0", z0_true)):
        mean = draws[name].double().reshape(-1, len(truth)).mean(0).cpu().numpy()
        err = np.abs(np.log(mean) - np.log(truth))
        require(bool(np.all(err <= limits[name])), f"lv: recovery of {name}: {err} > {limits[name]}")
        mode = LV_REFERENCE_MODE[name]
        err_mode = np.abs(np.log(mean) - np.log(mode))
        require(bool(np.all(err_mode <= LV_MODE_LIMIT)), f"lv: {name} against the reference mode: {err_mode} > {LV_MODE_LIMIT}")
        rec[name] = {"posterior_mean": mean.tolist(), "generating": truth.tolist(), "abs_log_err": err.tolist(),
                     "reference_mode": mode.tolist(), "abs_log_err_vs_mode": err_mode.tolist()}
    z = res.position[:8, -1, :].contiguous()
    dlp, dg = lv_against_float64(model, z, args[0])
    lp_scale = float(model.logp(z, args[0]).double().abs().max())
    double = z.dtype == torch.float64
    require(dlp <= (1e-10 if double else 0.01 + 1e-5 * lp_scale), f"lv: logp against float64: {dlp}")
    require(dg <= (1e-10 if double else 1e-3), f"lv: gradient against float64: {dg}")
    cap = res.max_depth
    return {
        "chains": pos.shape[0], "num_samples": pos.shape[1], "dim": model.dim, "wall_s": wall,
        "grad_calls": res.n_grad_calls, "logp_evaluations": evaluations,
        "ms_per_grad_call": wall / res.n_grad_calls * 1e3, "chunk_caps": list(res.chunk_caps),
        "chunk_seconds": list(res.chunk_seconds), "step_size": float(res.step_size),
        "mean_tree_depth": float(res.tree_depth.double().mean()),
        "mean_lane_leapfrogs_per_transition": float(res.n_leapfrog.double().mean()),
        "deepest_lane_leapfrogs_per_transition": float(res.n_leapfrog.max(0).values.double().mean()),
        "divergence_rate": div_rate, "saturation_rate": float((res.tree_depth >= cap).double().mean()),
        "ess_bulk_log_theta": [float(v) for v in convergence.ess_bulk(pos[..., :4])],
        "split_rhat_log_theta": [float(v) for v in rhat],
        **ess_per_call(pos, res.n_grad_calls),
        "recovery": rec, "recovery_limit": limits, "mode_limit": LV_MODE_LIMIT,
        "max_abs_dlogp_vs_float64": dlp, "max_grad_err_vs_float64": dg,
    }


def phase_lv_path():
    lv_rk4.reset_counts()
    res, wall, model, args, evaluations = drive_lv()
    launches, plain = dict(lv_rk4.LAUNCHES), dict(lv_rk4.PLAIN_CALLS)
    require(launches[lv_rk4.FORWARD] == evaluations > 0, f"lv_path: {launches} for {evaluations} log-density evaluations")
    require(launches[lv_rk4.ADJOINT] == res.n_grad_calls, f"lv_path: {launches} for {res.n_grad_calls} gradient calls")
    require(plain["lv_rk4_plain"] == 0, f"lv_path: the plain version ran: {plain}")
    report = check_lv(res, wall, model, args, evaluations)
    emit("lv_path", **report, kernel_launches=launches, plain_calls=plain)
    return res, model, args, launches[lv_rk4.FORWARD] + launches[lv_rk4.ADJOINT]


def rk45_rhs_evaluations(theta, z0, ts):
    """Right-hand-side evaluations of one ``integrate_ode_rk45`` value and
    adjoint gradient at the model's settings: ``(forward, backward)``.  Each
    step of the adaptive loop evaluates 6 stages on every lane and each
    segment one more, so ``(evaluations - T) / 6`` is the number of loop
    steps: the sum over the segments of the slowest lane's steps, which sets
    the cost."""
    calls = [0]

    def rhs(t, z, th):
        calls[0] += 1
        return lotka_volterra.dz_dt(t, z, th)

    th = theta.detach().requires_grad_(True)
    ys = integrate_ode_rk45(rhs, z0.detach(), 0.0, ts, th, rtol=1e-6, atol=1e-8)
    fwd = calls[0]
    torch.autograd.grad(ys.sum(), th)
    return fwd, calls[0] - fwd


def drive_lv_rk45(position, y_obs, *, device="cuda"):
    """The config's named method (``BASELINE.md:39``): ``make(ts)``, adaptive
    DP5 with the continuous adjoint, eager, at the final positions of
    ``lv_path``: 3 gradient calls in float32 and 1 in float64, timed, and
    ``logp`` / gradient against the RK4 model at the same points.  Gates: in
    float64, ten times the reference's audit (max |dlogp| 0.015, normalized
    gradient difference 7.1e-4): the two discretizations agree as closely on
    the card as in the audit; in float32, 0.05 and 5e-3 (float32 rounding of
    both solves on top)."""
    ts = lotka_volterra.synthetic_data(LV_TIMES)[0]
    m45, m4 = lotka_volterra.make(ts), lotka_volterra.make(ts, solver="rk4")
    out = {"chains": position.shape[0]}
    for dtype, calls in ((torch.float32, 3), (torch.float64, 1)):
        z, y = position.to(dtype).contiguous(), y_obs.to(dtype)
        walls = []
        for _ in range(calls):
            (lp45, g45), wall = timed(lambda: m45.logp_and_grad(z, y), device)
            walls.append(wall)
        lp4, g4 = m4.logp_and_grad(z, y)
        require(bool(torch.isfinite(lp45).all() and torch.isfinite(g45).all()), f"lv_rk45 {dtype}: non-finite logp or gradient")
        dlp = float((lp45.double() - lp4.double()).abs().max())
        dg = float(((g45.double() - g4.double()).abs().amax(1) / g4.double().abs().amax(1)).max())
        lim_lp, lim_g = (10 * LV_AUDIT["max_abs_dlogp"], 10 * LV_AUDIT["max_rel_dgrad"]) if dtype == torch.float64 else (0.05, 5e-3)
        require(dlp <= lim_lp and dg <= lim_g, f"lv_rk45 {dtype}: |dlogp| {dlp} (limit {lim_lp}), gradient {dg} (limit {lim_g})")
        cons = m45.transform_draws(z)
        fwd, bwd = rk45_rhs_evaluations(cons["theta"], cons["z0"], ts)
        out[str(dtype)[6:]] = {
            "grad_call_wall_s": walls, "max_abs_dlogp_vs_rk4": dlp, "max_grad_diff_vs_rk4": dg,
            "limits": {"dlogp": lim_lp, "grad": lim_g}, "rhs_evaluations_forward": fwd, "rhs_evaluations_backward": bwd,
            "loop_steps_forward": (fwd - LV_TIMES) / 6, "loop_steps_backward": (bwd - LV_TIMES) / 6,
        }
    out["reference_audit"] = LV_AUDIT
    return out


# Limits of lv_second_order, set from a CPU rehearsal (float32 through the
# kernel pair's Function with its stand-ins, an LV point near the reference
# mode, against float64): Hessian 1.3e-6 and gradient 7.2e-7 of their
# largest entry (limit 1e-4); the float32 mode's float64 Newton step 6.5e-4
# posterior sd (limit 0.01); the Laplace Hessian 1.5e-6 of its largest
# entry (limit 1e-4); the draws' means and sds against the float64 Gaussian
# at that mode within 5 Monte-Carlo errors of LV_LAPLACE_DRAWS draws (mean
# 5 / sqrt(n) sd, sd 5 / sqrt(2 n)).
LV_LAPLACE_DRAWS = 300
LV_SECOND_ORDER_LIMIT = {"hessian": 1e-4, "gradient": 1e-4, "mode_newton_sd": 0.01, "laplace_hessian": 1e-4}


def lv_hessian64(model, y_obs, z):
    """``(gradient, Hessian)`` of the float64 plain model at ``z`` (CPU
    tensors; the Hessian by a double backward, 3x faster there than forward
    over reverse and equal to 1e-15)."""
    from math_tpu_torch.infer.optimize import hessian

    y64, z64 = y_obs.double().cpu(), z.double().cpu()
    return model.logp_and_grad(z64[None], y64)[1][0], hessian(model.logp, z64, (y64,))


def drive_lv_second_order(model, y_obs, z, *, draws=LV_LAPLACE_DRAWS, seed=0, device="cuda"):
    """ROADMAP C4 on the card: ``functional.hessian`` (forward over reverse)
    at the LV point ``z (dim,)`` and ``laplace_sample`` from it (the mode by
    L-BFGS through the kernel pair, the Hessian by a double backward,
    ``draws`` draws' log densities by the forward kernel), in ``z``'s dtype on
    ``device``, each with its kernel launches and plain calls, against the
    float64 plain model on CPU tensors (``lv_hessian64``).  Gates:
    ``LV_SECOND_ORDER_LIMIT`` and 5 Monte-Carlo errors (above)."""
    from math_tpu_torch.infer import laplace_sample

    lim = LV_SECOND_ORDER_LIMIT
    f = lambda q: model.logp(q[None], y_obs)[0]  # noqa: E731
    out = {"dtype": str(z.dtype), "draws": draws, "limits": lim}
    lv_rk4.reset_counts()
    t0 = time.perf_counter()
    _, g, h = functional.hessian(f, z)
    if device == "cuda":
        torch.cuda.synchronize()
    out["hessian"] = {"seconds": time.perf_counter() - t0, "launches": dict(lv_rk4.LAUNCHES), "plain_calls": dict(lv_rk4.PLAIN_CALLS)}
    lv_rk4.reset_counts()
    t0 = time.perf_counter()
    lap = laplace_sample(model.logp, torch.Generator(device=device).manual_seed(seed), model.dim, draws, args=(y_obs,),
                         init=z, dtype=z.dtype, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    out["laplace"] = {"seconds": time.perf_counter() - t0, "launches": dict(lv_rk4.LAUNCHES), "plain_calls": dict(lv_rk4.PLAIN_CALLS),
                      "lbfgs_grad_calls": int(lap.opt.num_grad_calls), "converged": bool(lap.opt.converged),
                      "grad_norm": float(lap.opt.grad_norm)}
    t0 = time.perf_counter()
    g64, h64 = lv_hessian64(model, y_obs, z)
    gm64, hm64 = lv_hessian64(model, y_obs, lap.mode)
    out["float64_reference_seconds"] = time.perf_counter() - t0
    cov64 = torch.linalg.inv(-hm64)
    sd64 = torch.sqrt(torch.diagonal(cov64))
    newton = cov64 @ gm64  # the float64 step from the float32 mode to the float64 one
    d = lap.draws.double().cpu()
    mode = lap.mode.double().cpu()
    err = {
        "hessian": float((h.double().cpu() - h64).abs().max() / h64.abs().max()),
        "gradient": float((g.double().cpu() - g64).abs().max() / g64.abs().max()),
        "mode_newton_sd": float((newton / sd64).abs().max()),
        "laplace_hessian": float((lap.hessian.double().cpu() - hm64).abs().max() / hm64.abs().max()),
        "draw_mean_sd": float(((d.mean(0) - mode) / sd64).abs().max()),
        "draw_sd_ratio": float((d.std(0) / sd64 - 1.0).abs().max()),
    }
    out["errors"] = err
    for k, v in lim.items():
        require(err[k] <= v, f"lv_second_order: {k} error {err[k]} > {v}")
    require(err["draw_mean_sd"] <= 5.0 / math.sqrt(draws), f"lv_second_order: Laplace draws' mean {err['draw_mean_sd']} sd")
    require(err["draw_sd_ratio"] <= 5.0 / math.sqrt(2 * draws), f"lv_second_order: Laplace draws' sd ratio {err['draw_sd_ratio']}")
    require(bool(torch.isfinite(lap.log_p).all()), "lv_second_order: non-finite Laplace log densities")
    return out


def phase_lv_second_order(position, y_obs):
    """``drive_lv_second_order`` at an ``lv_path`` draw, on the kernels alone
    (no plain call).  The Hessian (``jacfwd`` over ``grad``): one forward
    launch for its primal, one dual forward for its tangents (the basis
    folded into the lanes), one adjoint (``_LvRk4Adjoint``'s primal) and one
    dual forward + dual adjoint for that adjoint's ``jvp``.  Laplace: the
    L-BFGS on the kernel pair (a forward and an adjoint launch a gradient
    call); its Hessian's double backward one forward for the Hessian's lanes,
    one adjoint as ``_LvRk4Adjoint``, one dual forward + dual adjoint for
    that adjoint's backward and one more adjoint for the likelihood's
    cotangent; one forward for the draws' log densities.  Returns the report
    and the dual kernels' launches."""
    model = lotka_volterra.make(lotka_volterra.synthetic_data(LV_TIMES)[0], solver="rk4")
    out = drive_lv_second_order(model, y_obs, position)
    hess, lap = out["hessian"], out["laplace"]
    f, a, df, da = lv_rk4.FORWARD, lv_rk4.ADJOINT, lv_rk4.DUAL_FORWARD, lv_rk4.DUAL_ADJOINT
    require(hess["launches"] == {f: 1, a: 1, df: 2, da: 1} and hess["plain_calls"]["lv_rk4_plain"] == 0,
            f"lv_second_order: the Hessian's launches {hess}")
    n = lap["lbfgs_grad_calls"]
    require(n > 0 and lap["launches"] == {f: n + 2, a: n + 2, df: 1, da: 1} and lap["plain_calls"]["lv_rk4_plain"] == 0,
            f"lv_second_order: Laplace's launches {lap}")
    emit("lv_second_order", hessian_seconds=hess["seconds"], laplace_seconds=lap["seconds"], **out)
    return out, sum(d["launches"][k] for d in (hess, lap) for k in (df, da))


def phase_lv_rk45(position, y_obs):
    lv_rk4.reset_counts()
    out = drive_lv_rk45(position, y_obs)
    emit("lv_rk45", **out, rk4_kernel_launches=dict(lv_rk4.LAUNCHES))



# ---------------------------------------------------------------------------
# The rest of the ODE family: TR-BDF2, the DAE and the algebraic solvers (no
# kernel, no sampler path), at 64 lanes against float64
# ---------------------------------------------------------------------------


def vdp_rhs(t, y, th):
    u, v = y.unbind(-1)
    return torch.stack([v, th[:, 0] * ((1 - u ** 2) * v) - u], -1)


def circle_residual(x, th):
    return torch.stack([x[:, 0] ** 2 + x[:, 1] ** 2 - th[:, 0], x[:, 0] - x[:, 1] * th[:, 1]], -1)


def drive_ode_family(lanes=64, device="cuda"):
    """The systems of the JAX package's tests (``tests/test_ode_stiff.py``'s
    van der Pol, ``tests/test_dae.py``'s nonlinear DAE, ``tests/test_ops.py``'s
    two-equation root) at ``lanes`` lanes with seeded parameters, float32
    against float64 on the same device.  Limits, on the largest error over the
    largest value: 1e-3 for van der Pol (float32 solved at rtol 1e-5 against
    float64 at the test's 1e-7) and the DAE's values and gradients (rtol 1e-5
    against 1e-8), 1e-4 for the roots and their implicit-function Jacobians."""
    rng = np.random.default_rng(500)
    out = {"lanes": lanes}

    def run(label, fn):
        res, wall = timed(fn, device)
        out.setdefault("wall_s", {})[label] = wall
        return res

    mu = 100.0 * np.exp(0.2 * rng.normal(size=(lanes, 1)))
    y0 = np.tile([2.0, 0.0], (lanes, 1))
    ts = np.array([0.3, 0.6, 1.0])
    vdp = {}
    for dtype, rtol, atol in ((torch.float32, 1e-5, 1e-7), (torch.float64, 1e-7, 1e-9)):
        vdp[dtype] = run(f"vdp_{str(dtype)[6:]}", lambda: integrate_ode_bdf(
            vdp_rhs, torch.tensor(y0, dtype=dtype, device=device), 0.0, ts, torch.tensor(mu, dtype=dtype, device=device),
            rtol=rtol, atol=atol))
    require(bool(torch.isfinite(vdp[torch.float32]).all()), "ode_family: van der Pol float32 not finite")
    out["vdp_normalized_err"] = normalized_err(vdp[torch.float32], vdp[torch.float64])
    require(out["vdp_normalized_err"] <= 1e-3, f"ode_family: van der Pol {out['vdp_normalized_err']}")

    th = 0.9 * np.exp(0.2 * rng.normal(size=(lanes, 1)))
    yd = 2.0 * np.exp(0.2 * rng.normal(size=(lanes, 1)))
    dae = {}
    for dtype, rtol, atol in ((torch.float32, 1e-5, 1e-7), (torch.float64, 1e-8, 1e-10)):
        ty0 = torch.tensor(yd, dtype=dtype, device=device, requires_grad=True)
        tth = torch.tensor(th, dtype=dtype, device=device, requires_grad=True)

        def solve():
            ys, zs = integrate_dae(lambda t, y, z, q: -z, lambda t, y, z, q: z ** 3 + z - q[:, :1] * y, ty0,
                                   torch.tensor([0.5], dtype=dtype, device=device), 0.0, np.linspace(0.5, 2.0, 4), tth,
                                   rtol=rtol, atol=atol)
            return (ys.detach(), zs.detach(), *torch.autograd.grad(torch.square(ys).sum(), (ty0, tth)))

        dae[dtype] = run(f"dae_{str(dtype)[6:]}", solve)
    out["dae_normalized_err"] = {name: normalized_err(a, b) for name, a, b in
                                 zip(("ys", "zs", "grad_y0", "grad_theta"), dae[torch.float32], dae[torch.float64])}
    require(max(out["dae_normalized_err"].values()) <= 1e-3, f"ode_family: DAE {out['dae_normalized_err']}")

    sth = np.stack([4.0 * np.exp(0.2 * rng.normal(size=lanes)), np.exp(0.3 * rng.normal(size=lanes))], -1)
    for name in ("algebra_solver_newton", "algebra_solver_powell"):
        got = {}
        for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-10)):
            q = torch.tensor(sth, dtype=dtype, device=device, requires_grad=True)

            def root():
                x = getattr(solve_ops, name)(circle_residual, torch.tensor([1.0, 1.0], dtype=dtype, device=device), q,
                                             tol=tol)
                jac = torch.stack([torch.autograd.grad(x[:, i].sum(), q, retain_graph=True)[0] for i in range(2)], 1)
                return x.detach(), jac

            got[dtype] = run(f"{name}_{str(dtype)[6:]}", root)
        errs = {part: normalized_err(a, b) for part, a, b in zip(("root", "jacobian"), got[torch.float32], got[torch.float64])}
        require(max(errs.values()) <= 1e-4, f"ode_family: {name} {errs}")
        out[f"{name}_normalized_err"] = errs
    return out


def phase_ode_family():
    emit("ode_family", **drive_ode_family())


# ---------------------------------------------------------------------------
# Constrained matrix and simplex parameters: the block kernel at the small
# shapes of per-chain covariance matrices, a prior over every constrained
# Transform, and the LKJ varying-slopes model
# ---------------------------------------------------------------------------

VS_GROUPS, VS_K, VS_PER_GROUP, C_VS = 100, 5, 20, 256
C_PRIOR = 1024
# B4 launches a gradient call: varying slopes factors one (C, 5, 5) block
# twice (multi_normal_lpdf's spd_solve_logdiag and lkj_corr_lpdf's check);
# the prior seven times (lkj_corr 1, wishart 2, inv_wishart 2,
# multi_student_t 1, multi_normal_prec 1).  First-order backward passes
# launch nothing (ops/chol_blocked.py).
VS_LAUNCHES_PER_CALL = 2
PRIOR_LAUNCHES_PER_CALL = 7
# Limits set from a 64-chain CPU rehearsal (PERF.md, PR 9).
VS_RECOVERY_LIMIT = {"mu": 0.3, "tau_rel": 0.25, "Omega": 0.25, "sigma": 0.05}
VS_FLOAT32_LIMIT = {"logp_rel": 1e-5, "grad_rel": 1e-4}
SMALL_SHAPES = ((C_VS, VS_K), (C_PRIOR, 3))
# Unconstrained inits of both constrained phases: uniform(-0.5, 0.5) (why:
# ``drive_varying_slopes``, ``drive_constrained_prior``).
INIT_RADIUS = 0.5
RAGGED_SMALL_B = (1, 3, 7, 17)
EPS32 = 2.0**-24


def small_blocks(cb, b, seed):
    """SPD blocks like those the paths factor, made on the CPU in float64 and
    moved to the card as float32: at B = 5 ``quad_form_diag(Omega, tau)`` with
    Omega ~ LKJ(2) and log tau ~ normal(0, 0.5) (the varying-slopes
    covariance); at B = 3 Wishart(6, S) draws (the constrained prior's)."""
    gen = torch.Generator().manual_seed(seed)
    if b == VS_K:
        omega = dists.lkj_corr_rng(gen, b, 2.0, shape=(cb,))
        tau = torch.exp(0.5 * torch.randn((cb, b), generator=gen, dtype=torch.float64))
        d = omega * tau[:, :, None] * tau[:, None, :]
    else:
        d = dists.wishart_rng(gen, constrained_models.NU_WISHART, torch.tensor(constrained_models.S_WISHART), shape=(cb,))
    return d.float().cuda().contiguous()


def compare_chol_conditioned(d32, label):
    """Kernel (float32) against the plain version in float64 on the same
    blocks, matrix by matrix: ``max |U - U64| / max |U64|`` and the same for
    ``W`` at most ``64 u kappa`` (u the float32 unit roundoff, kappa the
    block's 2-norm condition number: the forward-error scale of a float32
    factorization and inverse; Wishart draws reach kappa ~ 1e4 and more).
    Also the float32 plain version's worst error, for comparison."""
    u, w = chol_blocked.chol_inv_block_parts(d32)
    torch.cuda.synchronize()
    d64 = d32.double().cpu()
    u64, w64 = chol_blocked.chol_inv_block_reference(d64)
    up, wp = chol_blocked.chol_inv_block_reference(d32.cpu())
    kappa = torch.linalg.cond(d64)
    out = {}
    for name, got, plain, want in (("U", u, up, u64), ("W", w, wp, w64)):
        require(bool(torch.isfinite(got).all()), f"{label}: non-finite {name} of an SPD block")
        scale = want.abs().amax((-2, -1))
        rel = (got.double().cpu() - want).abs().amax((-2, -1)) / scale
        rel_plain = (plain.double() - want).abs().amax((-2, -1)) / scale
        ratio = rel / (EPS32 * kappa)
        require(float(ratio.max()) <= 64.0, f"{label} {name}: error {float(rel.max())} is {float(ratio.max())} u kappa")
        out[name] = {"max_abs_err": float((got.double().cpu() - want).abs().max()), "max_rel_err": float(rel.max()),
                     "max_rel_err_plain_f32": float(rel_plain.max()), "max_err_in_u_kappa": float(ratio.max())}
    out["kappa"] = {"max": float(kappa.max()), "median": float(kappa.median())}
    return out


def compare_chol_ragged_small(b, cb=5, bad=2):
    """``cb`` blocks of size ``b``, block ``bad`` not positive definite from
    pivot ``b // 2`` on: its NaN pattern equal to the plain version's, the
    others finite and within 1e-4 of their largest entry."""
    rng = np.random.default_rng(500 + b)
    a = rng.normal(size=(cb, b, b))
    d = a @ np.swapaxes(a, -1, -2) + b * np.eye(b)
    p = b // 2
    d[bad, p, p] = -5.0 * b
    d32 = torch.tensor(d, dtype=torch.float32, device="cuda")
    u, w = chol_blocked.chol_inv_block_parts(d32)
    torch.cuda.synchronize()
    u64, w64 = chol_blocked.chol_inv_block_reference(d32.double().cpu())
    good = [i for i in range(cb) if i != bad]
    for got, want in ((u.cpu(), u64), (w.cpu(), w64)):
        require(bool((torch.isnan(got) == torch.isnan(want)).all()), f"ragged B={b}: NaN pattern differs from the plain version")
        require(bool(torch.isnan(got[bad]).any()), f"ragged B={b}: the bad block is not NaN")
        require(bool(torch.isfinite(got[good]).all()), f"ragged B={b}: a positive definite block was poisoned")
        err = float((got.double() - want)[good].abs().max())
        require(err <= 1e-4 * float(want[good].abs().max()), f"ragged B={b}: max abs err {err}")
    return {"b": b, "cb": cb, "bad_matrix": bad, "bad_pivot": p}


def phase_kernels_chol_small():
    """B4 at the shapes of per-chain covariance matrices: against its plain
    version in float64, timed beside the float32 plain version, one PyTorch
    call pair and its bound; ragged sizes with a matrix that is not positive
    definite."""
    shapes = {}
    for cb, b in SMALL_SHAPES:
        d = small_blocks(cb, b, seed=600 + b)
        if b == VS_K:
            check = compare_chol(d, f"B4 at ({cb}, {b})")
            check["conditioned"] = compare_chol_conditioned(d, f"B4 at ({cb}, {b})")
        else:
            check = compare_chol_conditioned(d, f"B4 at ({cb}, {b}) on Wishart draws")
        ms = time_ms(lambda: chol_blocked.chol_inv_block_parts(d), warmup=5, reps=200)
        plain_ms = time_ms(lambda: chol_blocked.chol_inv_block_reference(d), warmup=1, reps=5)
        library_ms = time_ms(lambda: library_chol_inv(d), warmup=3, reps=50)
        nbytes, flops = 3.0 * cb * b * b * 4, (4.0 / 3.0) * b**3 * cb
        t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
        shapes[f"{cb}x{b}"] = {
            "cb": cb, "b": b, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "barrier_stages": chol_blocked.block_kernel_stages(b),
            "check": check,
        }
    ragged = [compare_chol_ragged_small(b) for b in RAGGED_SMALL_B]
    emit("kernels_chol_small", shapes=shapes, ragged=ragged,
         tolerance={"factor_rel_to_max": 1e-4, "conditioned_u_kappa": 64.0, "ragged_rel_to_max": 1e-4})
    return {"shapes": shapes, "ragged": ragged}


def vs_args(x, g, y, device="cuda", dtype=torch.float32):
    return (torch.tensor(x, dtype=dtype, device=device), torch.tensor(g, device=device),
            torch.tensor(y, dtype=dtype, device=device))


def drive_varying_slopes(*, groups=VS_GROUPS, chains=C_VS, num_warmup=100, num_samples=100, max_depth=6, seed=0,
                         device="cuda", dtype=torch.float32):
    """The varying-slopes model (``tools/constrained_models.py``: 100 groups of
    20 rows, K = 5, dimension 521) under ``run_pooled_chains``, 256 chains,
    accept 0.8, inits uniform(-0.5, 0.5): from Stan's radius 2 (sigma and tau
    from e^-2 to e^2) a 64-chain CPU rehearsal still had split R-hat ~1.5 and
    17% divergences after 100 warmup iterations (PERF.md, PR 9).  Returns
    ``(res, wall_s, model, args, truth)``."""
    x, g, y, truth = constrained_models.varying_slopes_data(groups, VS_K, VS_PER_GROUP, seed=0)
    model = constrained_models.make_varying_slopes(groups, VS_K)
    args = vs_args(x, g, y, device, dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    z0 = model.initial_positions(gen, chains, INIT_RADIUS, device=device, dtype=dtype)
    res, wall = timed(lambda: run_pooled_chains(
        gen, z0, model.logp, args=args, num_warmup=num_warmup, num_samples=num_samples, max_depth=max_depth,
        target_accept=0.8, device=device,
    ), device)
    require(res.position.shape == (chains, num_samples, model.dim), f"varying slopes: draws of shape {tuple(res.position.shape)}")
    return res, wall, model, args, truth


def vs_monitored(draws):
    """(names, values (chains, draws, 21)): mu, log tau, Omega's
    off-diagonals and sigma, as numpy float64."""
    k = draws["mu"].shape[-1]
    r, c = np.tril_indices(k, -1)
    omega = draws["Omega"].double().cpu().numpy()[..., r, c]
    cols = [draws["mu"].double().cpu().numpy(), np.log(draws["tau"].double().cpu().numpy()), omega,
            draws["sigma"].double().cpu().numpy()[..., None]]
    names = [f"mu[{i}]" for i in range(k)] + [f"log_tau[{i}]" for i in range(k)] + \
        [f"Omega[{i},{j}]" for i, j in zip(r, c)] + ["sigma"]
    return names, np.concatenate(cols, -1)


def check_varying_slopes(res, wall, model, args, truth, limits=VS_RECOVERY_LIMIT):
    """Gates: divergences < 5%, split R-hat < 1.05 on the monitored
    quantities, posterior means within ``limits`` of the generating values
    (``tau`` relative), ``logp`` and gradient at 8 final positions against
    the float64 model on CPU tensors, and the gradient at the 256 final
    positions equal bit for bit across two calls."""
    pos = res.position.double().cpu().numpy()
    require(bool(np.isfinite(pos).all()), "varying slopes: non-finite draws")
    div_rate = float(res.diverging.double().mean())
    require(div_rate < 0.05, f"varying slopes: divergence rate {div_rate}")
    draws = model.transform_draws(res.position)
    names, mon = vs_monitored(draws)
    rhat = convergence.split_rhat(mon)
    require(bool(np.all(rhat < 1.05)), f"varying slopes: split R-hat {dict(zip(names, rhat))}")
    mean = {k: draws[k].double().cpu().numpy().reshape((-1,) + tuple(draws[k].shape[2:])).mean(0) for k in ("mu", "tau", "Omega", "sigma")}
    errs = {
        "mu": float(np.max(np.abs(mean["mu"] - truth["mu"]))),
        "tau_rel": float(np.max(np.abs(mean["tau"] / truth["tau"] - 1.0))),
        "Omega": float(np.max(np.abs(mean["Omega"] - truth["Omega"]))),
        "sigma": float(abs(mean["sigma"] - truth["sigma"])),
    }
    require(all(errs[k] < limits[k] for k in errs), f"varying slopes: recovery {errs} against limits {limits}")
    z8 = res.position[:8, -1, :].contiguous()
    lp32, g32 = model.logp_and_grad(z8, *args)
    args64 = tuple(a.cpu().double() if a.is_floating_point() else a.cpu() for a in args)
    lp64, g64 = model.logp_and_grad(z8.double().cpu(), *args64)
    f32 = {"logp_rel": float((lp32.double().cpu() - lp64).abs().max() / lp64.abs().max()),
           "grad_rel": float((g32.double().cpu() - g64).abs().max() / g64.abs().max())}
    require(all(f32[k] <= VS_FLOAT32_LIMIT[k] for k in f32), f"varying slopes: float32 against float64 {f32}, limits {VS_FLOAT32_LIMIT}")
    z = res.position[:, -1, :].contiguous()
    a, b = model.logp_and_grad(z, *args), model.logp_and_grad(z, *args)
    repeatable = bool(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))
    require(repeatable, "varying slopes: logp or gradient differs between two calls at the same positions")
    return {
        "chains": pos.shape[0], "num_samples": pos.shape[1], "dim": model.dim, "groups": len(truth["beta"]),
        "wall_s": wall, "grad_calls": res.n_grad_calls, "ms_per_grad_call": wall / res.n_grad_calls * 1e3,
        "step_size": float(res.step_size), "mean_tree_depth": float(res.tree_depth.double().mean()),
        "deepest_lane_tree_depth": float(res.tree_depth.max(0).values.double().mean()),
        "mean_lane_leapfrogs_per_transition": float(res.n_leapfrog.double().mean()),
        "deepest_lane_leapfrogs_per_transition": float(res.n_leapfrog.max(0).values.double().mean()),
        "divergence_rate": div_rate, "saturation_rate": float((res.tree_depth >= res.max_depth).double().mean()),
        "split_rhat": dict(zip(names, (float(v) for v in rhat))),
        "ess_bulk": dict(zip(names, (float(v) for v in convergence.ess_bulk(mon)))),
        **ess_per_call(pos, res.n_grad_calls),
        "posterior_mean": {k: np.asarray(v).tolist() for k, v in mean.items()}, "abs_err": errs, "recovery_limit": limits,
        "float32_vs_float64_at_8": f32, "float32_limit": VS_FLOAT32_LIMIT, "logp_grad_bitwise_repeatable": repeatable,
    }


def phase_varying_slopes_path():
    chol_blocked.reset_counts()
    glm_fused.reset_counts()
    lv_rk4.reset_counts()
    res, wall, model, args, truth = drive_varying_slopes()
    launches, plain = chol_blocked.LAUNCHES["chol_inv_block"], chol_blocked.PLAIN_CALLS["chol_inv_block"]
    others = {**glm_fused.LAUNCHES, **glm_fused.PLAIN_CALLS, **lv_rk4.LAUNCHES, **lv_rk4.PLAIN_CALLS}
    require(plain == 0, f"varying_slopes_path: the plain version ran {plain} times")
    require(launches == VS_LAUNCHES_PER_CALL * res.n_grad_calls > 0,
            f"varying_slopes_path: {launches} launches for {res.n_grad_calls} gradient calls, expected {VS_LAUNCHES_PER_CALL} each")
    require(not any(others.values()), f"varying_slopes_path: another hand kernel ran: {others}")
    report = check_varying_slopes(res, wall, model, args, truth)
    emit("varying_slopes_path", **report, kernel_launches=launches, launches_per_grad_call=launches / res.n_grad_calls,
         plain_calls=plain)
    return res, model, args, launches


def drive_constrained_prior(*, chains=C_PRIOR, num_warmup=50, num_samples=50, max_depth=5, seed=0, device="cuda",
                            dtype=torch.float32):
    """NUTS on the prior-only model of every constrained Transform
    (``tools/constrained_models.py``), 1024 chains, accept 0.8, inits
    uniform(-0.5, 0.5), depth 5 (256-chain CPU rehearsals: from radius 2 the
    inverse Wishart's mean was 6.3 Monte-Carlo errors off after 100 warmup
    iterations; from radius 0.5 within 3 errors at depth 6, 5.1 at depth 5;
    the first chip run, 1024 chains at depth 5, within 3.0, in half the
    calls of depth 6: PERF.md).  50 + 50 of the earlier 100 + 100, to leave
    the script its margin on a slow host (PERF.md section 4): 50 warmup
    iterations adapt it as 60 do (step size 0.359 against 0.370, mean depth
    3.97 against 3.95, no divergence); the worst moment reads 4.07 errors
    there, 3.04 at 60 + 60 (PERF.md section 7).
    Returns ``(res, wall_s, model)``."""
    model = constrained_models.make_constrained_prior()
    gen = torch.Generator(device=device).manual_seed(seed)
    z0 = model.initial_positions(gen, chains, INIT_RADIUS, device=device, dtype=dtype)
    res, wall = timed(lambda: run_pooled_chains(
        gen, z0, model.logp, num_warmup=num_warmup, num_samples=num_samples, max_depth=max_depth, target_accept=0.8,
        device=device,
    ), device)
    require(res.position.shape == (chains, num_samples, model.dim), f"prior: draws of shape {tuple(res.position.shape)}")
    return res, wall, model


def check_constrained_prior(res, wall, model, z_limit=5.0):
    """Every moment of ``constrained_models.prior_moments`` within
    ``z_limit`` Monte-Carlo standard errors (sd over sqrt(bulk ESS)) of its
    closed form."""
    pos = res.position.double().cpu().numpy()
    require(bool(np.isfinite(pos).all()), "prior: non-finite draws")
    draws = {k: v.double().cpu().numpy() for k, v in model.transform_draws(res.position).items()}
    table = constrained_models.prior_moments(draws)
    blocks, worst = {}, 0.0
    for name, (vals, expected) in table.items():
        ess = np.asarray(convergence.ess_bulk(vals), dtype=np.float64)
        se = vals.reshape(-1, vals.shape[-1]).std(0) / np.sqrt(ess)
        z = (vals.reshape(-1, vals.shape[-1]).mean(0) - expected) / se
        blocks[name] = {"max_abs_z": float(np.max(np.abs(z))), "min_ess_bulk": float(np.min(ess)),
                        "mean": vals.reshape(-1, vals.shape[-1]).mean(0).tolist(), "expected": expected.tolist()}
        worst = max(worst, float(np.max(np.abs(z))))
    require(worst < z_limit, f"prior: a moment is {worst} Monte-Carlo errors from its closed form: "
            f"{ {k: v['max_abs_z'] for k, v in blocks.items()} }")
    return {
        "chains": pos.shape[0], "num_samples": pos.shape[1], "dim": model.dim, "wall_s": wall,
        "grad_calls": res.n_grad_calls, "ms_per_grad_call": wall / res.n_grad_calls * 1e3,
        "step_size": float(res.step_size), "mean_tree_depth": float(res.tree_depth.double().mean()),
        "divergence_rate": float(res.diverging.double().mean()),
        "saturation_rate": float((res.tree_depth >= res.max_depth).double().mean()),
        "max_abs_z": worst, "z_limit": z_limit, "moments": blocks,
    }


def phase_constrained_prior():
    chol_blocked.reset_counts()
    res, wall, model = drive_constrained_prior()
    launches, plain = chol_blocked.LAUNCHES["chol_inv_block"], chol_blocked.PLAIN_CALLS["chol_inv_block"]
    require(plain == 0, f"constrained_prior: the plain version ran {plain} times")
    require(launches == PRIOR_LAUNCHES_PER_CALL * res.n_grad_calls > 0,
            f"constrained_prior: {launches} launches for {res.n_grad_calls} gradient calls, expected {PRIOR_LAUNCHES_PER_CALL} each")
    emit("constrained_prior", **check_constrained_prior(res, wall, model), kernel_launches=launches, plain_calls=plain)
    return launches


# ---------------------------------------------------------------------------
# The univariate slice: the top-coded negative-binomial regression (B1's NB-2
# family under a sampler, inc_beta on the card) and the sweep of every
# univariate function
# ---------------------------------------------------------------------------

C_NB = 256
NB_FAMILY = "neg_binomial_2_log"
# Limits set from a CPU rehearsal (PERF.md section 6), before the chip run that tests them.
NB_RECOVERY_LIMIT = {"alpha": 0.05, "beta": 0.03, "phi_rel": 0.10}
# float32 against float64, relative to the largest magnitude: the gradient
# sums 94,613 rows through the NB-2 kernel (3xTF32 products, float32 sums;
# its max abs err 0.115 at N = 100,000 in the kernels phase); the CPU float32
# plain version is 4.3e-5 off at the full size, a first chip run 2.0e-4
NB_FLOAT32_LIMIT = {"logp_rel": 1e-5, "grad_rel": 1e-3}
# the sweep's gates: float32 on the card against float64 on CPU tensors,
# values relative to max(1, |v|) per row, gradients relative to the largest
# entry per argument; the functions through inc_beta's quadrature partials
# get the wider gradient limit (a CPU rehearsal: worst 2.3e-4)
SWEEP_VALUE_RTOL, SWEEP_GRAD_RTOL, SWEEP_GRAD_RTOL_INC_BETA = 1e-4, 1e-3, 5e-3
INC_BETA_FAMILIES = ("student_t_", "beta_", "binomial_", "neg_binomial", "beta_binomial_", "inc_beta")
# float64 port against scipy: inc_beta relative to max(I, 1 - I) (XLA's
# continued fraction), gamma_p / gamma_q relative (XLA's series and continued
# fraction: 5.0e-14 on the sweep's rows on the CPU)
SCIPY_RTOL = {"inc_beta": 1e-11, "gamma_p": 1e-12, "gamma_q": 1e-12}
# 250,000 draws an _rng (10^6 before: cut for the script's time; the gate
# counts Monte-Carlo errors)
RNG_DRAWS, RNG_Z_LIMIT = 250_000, 5.0


def drive_censored_nb(x, *, chains=C_NB, num_warmup=60, num_samples=60, max_depth=6, seed=0, device="cuda",
                      dtype=torch.float32, naive=False):
    """The top-coded NB regression of ``tools/univariate_models.py`` on the
    design ``x`` under ``run_pooled_chains``, accept 0.8, inits
    uniform(-0.5, 0.5) (``INIT_RADIUS``), 60 + 60 (100 + 100 cut to keep the
    script inside its time limit: PERF.md section 4).  ``naive``: the top-coded rows taken
    as exact counts at ``U`` (no lccdf term).  Returns ``(res, wall_s, model,
    args, data, lentz)`` with ``lentz`` the Lentz iterations the sampler's
    ``inc_beta`` calls ran."""
    data = univariate_models.censored_nb_data(x, seed=0)
    model = univariate_models.make_censored_nb(x.shape[1])
    args = univariate_models.censored_args(data, device=device, dtype=dtype, naive=naive)
    gen = torch.Generator(device=device).manual_seed(seed)
    z0 = model.initial_positions(gen, chains, INIT_RADIUS, device=device, dtype=dtype)
    lp0 = model.logp(z0, *args)
    require(bool(torch.isfinite(lp0).all()), "censored NB: a non-finite logp at the initial positions")
    # the counts from 0 just before the sampler (the check above launched too)
    for counts in (incbeta, glm_fused, chol_blocked, lv_rk4):
        counts.reset_counts()
    res, wall = timed(lambda: run_pooled_chains(
        gen, z0, model.logp, args=args, num_warmup=num_warmup, num_samples=num_samples, max_depth=max_depth,
        target_accept=0.8, device=device,
    ), device)
    lentz = dict(incbeta.LENTZ)
    require(res.position.shape == (chains, num_samples, model.dim), f"censored NB: draws of shape {tuple(res.position.shape)}")
    return res, wall, model, args, data, lentz


def nb_monitored(draws):
    """(names, values (chains, draws, K + 2)): alpha, beta, log phi."""
    k = draws["beta"].shape[-1]
    cols = [draws["alpha"].double().cpu().numpy()[..., None], draws["beta"].double().cpu().numpy(),
            np.log(draws["phi"].double().cpu().numpy())[..., None]]
    return ["alpha"] + [f"beta[{i}]" for i in range(k)] + ["log_phi"], np.concatenate(cols, -1)


def censored_nb_recovery(draws, data):
    mean = {k: draws[k].double().cpu().numpy().reshape((-1,) + tuple(draws[k].shape[2:])).mean(0) for k in ("alpha", "beta", "phi")}
    return mean, {
        "alpha": float(abs(mean["alpha"] - data["alpha"])),
        "beta": float(np.max(np.abs(mean["beta"] - data["beta"]))),
        "phi_rel": float(abs(mean["phi"] / data["phi"] - 1.0)),
    }


def check_censored_nb(res, wall, model, args, data, lentz, limits=NB_RECOVERY_LIMIT):
    """Gates: divergences < 5%, split R-hat < 1.05 on alpha, beta and log
    phi, posterior means within ``limits`` of the generating values (phi
    relative), ``logp`` and gradient at 8 final positions against the float64
    model on CPU tensors."""
    pos = res.position.double().cpu().numpy()
    require(bool(np.isfinite(pos).all()), "censored NB: non-finite draws")
    div_rate = float(res.diverging.double().mean())
    require(div_rate < 0.05, f"censored NB: divergence rate {div_rate}")
    draws = model.transform_draws(res.position)
    names, mon = nb_monitored(draws)
    rhat = convergence.split_rhat(mon)
    ess = convergence.ess_bulk(mon)
    require(bool(np.all(rhat < 1.05)), f"censored NB: split R-hat {dict(zip(names, rhat))}")
    mean, errs = censored_nb_recovery(draws, data)
    require(all(errs[k] < limits[k] for k in errs), f"censored NB: recovery {errs} against limits {limits}")
    z8 = res.position[:8, -1, :].contiguous()
    lp32, g32 = model.logp_and_grad(z8, *args)
    args64 = tuple(a.cpu().double() if isinstance(a, torch.Tensor) else a for a in args)
    lp64, g64 = model.logp_and_grad(z8.double().cpu(), *args64)
    f32 = {"logp_rel": float((lp32.double().cpu() - lp64).abs().max() / lp64.abs().max()),
           "grad_rel": float((g32.double().cpu() - g64).abs().max() / g64.abs().max())}
    require(all(f32[k] <= NB_FLOAT32_LIMIT[k] for k in f32), f"censored NB: float32 against float64 {f32}, limits {NB_FLOAT32_LIMIT}")
    order = np.argsort(rhat)[::-1][:5]
    return {
        "U": data["U"], "top_coded_share": data["share"], "exact_rows": int(args[0].shape[0]), "top_coded_rows": int(args[2].shape[0]),
        "chains": pos.shape[0], "num_samples": pos.shape[1], "dim": model.dim,
        "wall_s": wall, "grad_calls": res.n_grad_calls, "ms_per_grad_call": wall / res.n_grad_calls * 1e3,
        "step_size": float(res.step_size), "mean_tree_depth": float(res.tree_depth.double().mean()),
        "deepest_lane_tree_depth": float(res.tree_depth.max(0).values.double().mean()),
        "divergence_rate": div_rate, "saturation_rate": float((res.tree_depth >= res.max_depth).double().mean()),
        "max_split_rhat": float(np.max(rhat)), "worst_split_rhat": {names[i]: float(rhat[i]) for i in order},
        "split_rhat_alpha_log_phi": {"alpha": float(rhat[0]), "log_phi": float(rhat[-1])},
        "min_ess_bulk_beta": float(np.min(ess[1:-1])), "ess_bulk_alpha_log_phi": {"alpha": float(ess[0]), "log_phi": float(ess[-1])},
        **ess_per_call(pos, res.n_grad_calls),
        "posterior_mean": {"alpha": float(mean["alpha"]), "phi": float(mean["phi"])}, "abs_err": errs, "recovery_limit": limits,
        "float32_vs_float64_at_8": f32, "float32_limit": NB_FLOAT32_LIMIT,
        "lentz": {**lentz, "iterations_per_call": lentz["iterations"] / max(lentz["calls"], 1)},
    }


def nb_kernel_at_path(args, position):
    """B1's NB-2 family at the path's exact rows (N_u, K = 50, C = 256) at the
    final positions: time, plain version's time and the bound, as ``phase_kernels``."""
    x_u, y_u = args[0], args[1]
    z = position.contiguous()
    alpha, beta, phi = z[:, 0].contiguous(), z[:, 1:-1].T.contiguous(), torch.exp(z[:, -1]).contiguous()
    t = (y_u, x_u, alpha, beta, phi)
    ms = time_ms(lambda: glm_fused.glm_fused_parts(NB_FAMILY, *t), warmup=3, reps=20)
    plain_ms = time_ms(lambda: glm_fused.glm_fused_parts_reference(NB_FAMILY, *t), warmup=1, reps=5)
    n, k, c = x_u.shape[0], x_u.shape[1], z.shape[0]
    flops = 4.0 * n * k * c + float(CORE_OPS[NB_FAMILY]) * n * c
    nbytes = 4.0 * (n * k + n + 2 * k * c + 3 * c + 2 * c)
    return {"shape": {"n": n, "k": k, "c": c}, "ms": ms, "plain_ms": plain_ms,
            **tensor_core_bounds(n, k, c, CORE_OPS[NB_FAMILY], flops, nbytes)}


def phase_censored_nb_path(x):
    """B1's NB-2 family launched once a gradient call (the exact rows), the
    lccdf's inc_beta on the card (the top-coded rows); no other hand kernel,
    no plain version, no layout copy."""
    res, wall, model, args, data, lentz = drive_censored_nb(x)
    launches = dict(glm_fused.LAUNCHES)
    others = {**chol_blocked.LAUNCHES, **lv_rk4.LAUNCHES, **{f"{f}_tiled": n for f, n in glm_fused.LAUNCHES_TILED.items()},
              **{f: n for f, n in launches.items() if f != NB_FAMILY}}
    plain, copies = sum(glm_fused.PLAIN_CALLS.values()), sum(glm_fused.LAYOUT_COPIES.values())
    require(launches[NB_FAMILY] == res.n_grad_calls > 0,
            f"censored_nb_path: {launches[NB_FAMILY]} NB-2 launches for {res.n_grad_calls} gradient calls")
    require(plain == 0, f"censored_nb_path: the plain version ran {plain} times")
    require(copies == 0, f"censored_nb_path: {copies} layout copies")
    require(not any(others.values()), f"censored_nb_path: another hand kernel ran: {others}")
    report = check_censored_nb(res, wall, model, args, data, lentz)
    at_path = nb_kernel_at_path(args, res.position[:, -1, :])
    emit("censored_nb_path", **report, nb2_kernel_launches=launches[NB_FAMILY], plain_calls=plain, layout_copies=copies,
         nb2_kernel_at_path=at_path)
    return res, model, args, launches[NB_FAMILY], at_path


def profile_inc_beta_share(res, model, args, transitions=5):
    """Only with ``--profile``: ``phase_profile`` on the path, and the device
    time inside ``inc_beta``'s profiler ranges (the Lentz loop, the
    quadrature) as shares of the traced device time."""
    from torch.profiler import ProfilerActivity, profile

    from math_tpu_torch.infer.nuts import ChainNoise, LogpGrad
    from math_tpu_torch.infer.pooled import sample_pooled

    kernels, total_us, calls = phase_profile(res, model, args, label="profile_censored_nb", transitions=transitions)
    fn = LogpGrad(model.logp, args)
    noise = ChainNoise(torch.Generator(device="cuda").manual_seed(8), "cuda", torch.float32)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.no_grad():
            sample_pooled(noise, res.final_state, fn, res.step_size, res.inv_mass, transitions, max_depth=res.max_depth)
        torch.cuda.synchronize()
    device_total = device_kernels(prof)[1]

    def range_us(name):
        """Device time of the kernels launched inside the host-side range ``name``."""
        spans = [e for e in prof.events() if e.name == name and e.device_type == torch.autograd.DeviceType.CPU]
        return sum(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0) for e in spans)

    lentz_us, quad_us = range_us("inc_beta.lentz"), range_us("inc_beta.quadrature")
    emit("profile_censored_nb_inc_beta", grad_calls_traced=fn.calls, device_ms_traced=device_total / 1e3,
         lentz_device_ms=lentz_us / 1e3, quadrature_device_ms=quad_us / 1e3,
         lentz_device_share=lentz_us / device_total, quadrature_device_share=quad_us / device_total,
         lentz_ms_per_grad_call=lentz_us / 1e3 / max(fn.calls, 1), quadrature_ms_per_grad_call=quad_us / 1e3 / max(fn.calls, 1))


def sweep_gate(label, got, want):
    """Worst errors of float32 (card) against float64 (CPU): ``(value err,
    [grad err per argument])``; non-finite values must sit where float64's are."""
    (v32, g32), (v64, g64) = got, want
    fin = torch.isfinite(v64)
    require(bool((torch.isfinite(v32) == fin).all()), f"sweep {label}: non-finite values where float64's are finite, or the reverse")
    require(bool((v32[~fin] == v64[~fin]).all()), f"sweep {label}: non-finite values differ")
    verr = float(((v32 - v64).abs() / v64.abs().clamp_min(1.0))[fin].max()) if bool(fin.any()) else 0.0
    gerr = []
    for a, b in zip(g32, g64):
        require(bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all()), f"sweep {label}: a non-finite gradient")
        gerr.append(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30)))
    grad_rtol = SWEEP_GRAD_RTOL_INC_BETA if label.startswith(INC_BETA_FAMILIES) else SWEEP_GRAD_RTOL
    require(verr <= SWEEP_VALUE_RTOL, f"sweep {label}: value error {verr} > {SWEEP_VALUE_RTOL}")
    require(max(gerr, default=0.0) <= grad_rtol, f"sweep {label}: gradient error {gerr} > {grad_rtol}")
    return {"value_rel_err": verr, "grad_rel_err": max(gerr, default=0.0), "grad_rtol": grad_rtol}


def drive_univariate_sweep(rows=1024, cols=64, device="cuda", draws=RNG_DRAWS):
    """Every density and cdf of ``dists/{continuous,discrete,more}.py`` at one
    valid row a family, broadcast to ``(rows, cols)`` with a seeded jitter,
    float32 on ``device`` against float64 on CPU tensors, values and gradients
    in every float argument; the special functions likewise and their values
    against scipy in float64 (``inc_beta``, ``gamma_p``, ``gamma_q``); every
    ``_rng``: ``draws`` draws, moments within 5 Monte-Carlo errors of the
    closed forms, the same draws again from the same seed."""
    t0 = time.perf_counter()
    funcs = {}
    for label, fn, args, floats in univariate_models.sweep_cases(rows, cols):
        got = univariate_models.evaluate(fn, args, floats, device, torch.float32)
        want = univariate_models.evaluate(fn, args, floats, "cpu", torch.float64)
        funcs[label] = sweep_gate(label, got, want)
    special_report = {}
    for name, args in univariate_models.special_inputs(rows, cols).items():
        floats = univariate_models.SPECIAL_FLOATS[name]
        got = univariate_models.evaluate(name, args, floats, device, torch.float32)
        want = univariate_models.evaluate(name, args, floats, "cpu", torch.float64)
        special_report[name] = sweep_gate(name, got, want)
        if name in univariate_models.SCIPY_SPECIAL:
            t64 = [torch.tensor(a, dtype=torch.float64) for a in args]
            port64 = getattr(special, name)(*t64).numpy()
            ref = univariate_models.SCIPY_SPECIAL[name](*args)
            scale = np.maximum(ref, 1.0 - ref) if name == "inc_beta" else np.maximum(np.abs(ref), 1e-30)
            err = float(np.max(np.abs(port64 - ref) / scale))
            require(err <= SCIPY_RTOL[name], f"sweep {name}: float64 against scipy {err} > {SCIPY_RTOL[name]}")
            special_report[name]["float64_vs_scipy_rel_err"] = err
    rngs = {}
    for name in univariate_models.RNG_ROWS:
        gen = lambda: torch.Generator(device=device).manual_seed(11)  # noqa: E731
        x = univariate_models.rng_draws(name, gen(), draws)
        z = univariate_models.rng_z_scores(name, x)
        require(max(abs(v) for v in z.values()) < RNG_Z_LIMIT, f"sweep {name}_rng: {z} Monte-Carlo errors")
        require(torch.equal(x, univariate_models.rng_draws(name, gen(), draws)), f"sweep {name}_rng: a replay from the seed differs")
        rngs[name] = z
    return {"functions": funcs, "special": special_report, "rngs": rngs, "seconds": time.perf_counter() - t0}


def phase_univariate_sweep():
    rep = drive_univariate_sweep()
    worst = lambda d, k: max(d.items(), key=lambda kv: kv[1][k])  # noqa: E731
    emit("univariate_sweep", shape=[1024, 64], n_functions=len(rep["functions"]), n_special=len(rep["special"]),
         n_rngs=len(rep["rngs"]), rng_draws=RNG_DRAWS, seconds=rep["seconds"],
         worst_value=worst(rep["functions"], "value_rel_err")[0], worst_grad=worst(rep["functions"], "grad_rel_err")[0],
         tolerance={"value_rtol": SWEEP_VALUE_RTOL, "grad_rtol": SWEEP_GRAD_RTOL, "grad_rtol_inc_beta": SWEEP_GRAD_RTOL_INC_BETA,
                    "rng_z": RNG_Z_LIMIT},
         functions=rep["functions"], special=rep["special"], rngs=rep["rngs"])


# --- postfit_glm: what a user does after the main path's fit ------------------

# Gates of postfit_glm, set from a CPU rehearsal at a small size and the
# first chip runs (PERF.md section 6): float32 on the card against float64.
POSTFIT_LIMITS = {
    # vectorised PSIS against the per-observation loop, both float64: read
    # 2.7e-14 / 1.7e-13 (elpd) and 2.1e-15 / 3.9e-13 (k), rehearsal / card
    "psis_elpd_abs": 1e-11, "psis_k_abs": 1e-11,
    # float32 MAP on the card against the float64 MAP, in posterior sd: read
    # 2.0e-6 / 1.8e-5 (the float32 noise floor), rehearsal / card
    "map_sd": 1e-3,
    # the issue's 0.1 is ~3 Monte-Carlo errors of 1,000 draws for the largest
    # of 51 coordinates (0.032 sd each): 0.15
    "laplace_mean_sd": 0.15, "laplace_sd_rel": 0.15, "laplace_k": 0.7,
    "pathfinder_mean_sd": 0.2, "gq_mc_errors": 5.0,
}
POSTFIT_CHECK_OBS = 2000  # observations the plain PSIS loop checks
POSTFIT_GQ_DRAWS = 256


def glm_pointwise_log_lik(theta, x, y):
    """The main path's model's per-observation log likelihood, ``(S, dim) ->
    (S, N)``: ``y log sigmoid(eta) + (1 - y) log sigmoid(-eta)``."""
    eta = theta[:, :1] + theta[:, 1:] @ x.mT
    return -F.softplus(-(2.0 * y[None, :] - 1.0) * eta)


def glm_y_rep(params, gen, x):
    """Posterior-predictive replicates of the main path's model (a generated
    quantities block): ``(p, y_rep)`` for every draw, ``y_rep ~
    bernoulli(p)`` drawn from ``gen``."""
    p = torch.sigmoid(params["alpha"][:, None] + params["beta"] @ x.mT)
    return {"p": p, "y_rep": torch.bernoulli(p, generator=gen)}


def b1_at_lanes(x_main, lanes):
    """B1 (bernoulli-logit) at the main path's width with 1-4 lanes against the
    plain version in float64 (the tolerances of ``compare``), its time, the
    plain version's and its bound."""
    out = {}
    for c in lanes:
        arrays = make_inputs("bernoulli_logit", N_MAIN, K_MAIN, c, seed=500 + c, scale=0.1, x=x_main)
        errs, _ = compare("bernoulli_logit", arrays, grad_atol=1e-3 * N_MAIN / 3000.0)
        t32 = on_gpu(arrays, torch.float32)
        ms = time_ms(lambda: glm_fused.glm_fused_parts("bernoulli_logit", *t32), warmup=3, reps=20)
        plain_ms = time_ms(lambda: glm_fused.glm_fused_parts_reference("bernoulli_logit", *t32), warmup=2, reps=10)
        n, k = N_MAIN, K_MAIN
        flops = 4.0 * n * k * c + float(CORE_OPS["bernoulli_logit"]) * n * c
        nbytes = 4.0 * (n * k + n + 2 * k * c + 3 * c)
        out[f"c{c}"] = {"ms": ms, "plain_ms": plain_ms, **tensor_core_bounds(n, k, c, CORE_OPS["bernoulli_logit"], flops, nbytes),
                        "max_abs_err": max(errs.values()), "abs_err": errs,
                        "tile_plan": glm_fused.glm_tile_plan(n, k, c, torch.cuda.get_device_properties(0).multi_processor_count)}
    return out


def moments_in_sd(draws, nuts_mean, nuts_sd):
    d = draws.double().cpu().numpy().reshape(-1, nuts_mean.size)
    return float(np.max(np.abs(d.mean(0) - nuts_mean) / nuts_sd)), float(np.max(np.abs(d.std(0) / nuts_sd - 1.0)))


def glm_map(model, xt, yt):
    """The MAP of config 2's density ``model`` on ``(xt, yt)`` (Stan's
    optimize, ``jacobian=False``), in their dtype on their device."""
    from math_tpu_torch.infer import map_estimate

    return map_estimate(model.logp, model.dim, args=(xt, yt), jacobian=False, unadjusted_fn=model.logp_unadjusted,
                        dtype=xt.dtype, device=xt.device)


def drive_postfit_glm(x, y, position, *, device="cuda", dtype=torch.float32, seed=0, check_obs=POSTFIT_CHECK_OBS,
                      limits=POSTFIT_LIMITS):
    """The layer around a fitted posterior on the main path's model and draws
    ``position (chains, draws, dim)``: PSIS-LOO and WAIC, MAP
    (``jacobian=False``), Laplace (1,000 draws), Pathfinder (the reference's
    defaults), posterior-predictive generated quantities and a Stan CSV round
    trip, in ``dtype`` on ``device``; then the float64 references on CPU
    tensors (the MAP; the per-observation PSIS loop, host numpy).  Returns
    ``(report, evaluations, wall, map_theta)`` with the density evaluations
    (value and gradient, or value) each step made through the model, which the
    kernel counts are held against, and the float32 MAP."""
    from math_tpu_torch import diagnostics, io as tio
    from math_tpu_torch.diagnostics import psis as psis_mod
    from math_tpu_torch.infer import laplace_sample, pathfinder

    k = x.shape[1]
    model = glm_logistic.make(k)
    xt = torch.tensor(x, dtype=dtype, device=device)
    yt = torch.tensor(y, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    pos = position.to(device=device, dtype=dtype)
    nuts = pos.double().cpu().numpy().reshape(-1, k + 1)
    nuts_mean, nuts_sd = nuts.mean(0), nuts.std(0)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    report, evaluations, seconds = {}, {}, {}

    sync()
    t_all = time.perf_counter()
    # 1. PSIS-LOO and WAIC over every draw
    t0 = time.perf_counter()
    ll = diagnostics.pointwise_log_lik(glm_pointwise_log_lik, pos, xt, yt)
    with warnings.catch_warnings():  # the counts the warnings give are in the report
        warnings.simplefilter("ignore")
        lo = diagnostics.loo(ll)
        wa = diagnostics.waic(ll)
    sync()
    seconds["loo_waic"] = time.perf_counter() - t0
    require(tuple(ll.shape) == tuple(pos.shape[:2]) + (x.shape[0],), f"pointwise shape {tuple(ll.shape)}")
    require(math.isfinite(lo.elpd_loo) and math.isfinite(wa.elpd_waic), "loo / waic not finite")
    check = ll.reshape(-1, ll.shape[-1])[:, :check_obs].double().cpu().numpy()
    report["loo"] = {"draws": int(check.shape[0]), "observations": int(ll.shape[-1]), "elpd_loo": lo.elpd_loo,
                     "se_elpd_loo": lo.se_elpd_loo, "p_loo": lo.p_loo, "max_k": float(lo.pareto_k.max()),
                     "n_k_above_0.7": lo.n_bad_k, "elpd_waic": wa.elpd_waic, "p_waic": wa.p_waic,
                     "n_high_var": wa.n_high_var, "seconds": seconds["loo_waic"]}
    del ll

    # 2. MAP (Stan's optimize: jacobian=False)
    t0 = time.perf_counter()
    opt = glm_map(model, xt, yt)
    sync()
    seconds["map"] = time.perf_counter() - t0
    evaluations["map"] = opt.num_grad_calls
    # 3. Laplace: the mode again (jacobian=True), one Hessian, 1,000 draws
    t0 = time.perf_counter()
    lap = laplace_sample(model.logp, gen, model.dim, 1000, args=(xt, yt), dtype=dtype, device=device)
    sync()
    seconds["laplace"] = time.perf_counter() - t0
    evaluations["laplace"] = lap.opt.num_grad_calls + 2  # the Hessian's forward and log_p of the draws
    # 4. Pathfinder, the reference's defaults
    t0 = time.perf_counter()
    pf = pathfinder(model.logp, gen, model.dim, args=(xt, yt), dtype=dtype, device=device)
    sync()
    seconds["pathfinder"] = time.perf_counter() - t0
    evaluations["pathfinder"] = pf.num_grad_calls + pf.num_logp_calls
    # 5. generated quantities: y_rep on a thinned 256 draws, and a replay
    t0 = time.perf_counter()
    thin = pos.reshape(-1, k + 1)[:: max(1, pos.shape[0] * pos.shape[1] // POSTFIT_GQ_DRAWS)][:POSTFIT_GQ_DRAWS]
    gq = model.generate_quantities(glm_y_rep, thin, xt, key=torch.Generator(device=device).manual_seed(seed + 1))
    replay = model.generate_quantities(glm_y_rep, thin, xt, key=torch.Generator(device=device).manual_seed(seed + 1))
    sync()
    seconds["generate_quantities"] = time.perf_counter() - t0
    # 6. Stan CSV round trip of the draws
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cons = model.transform_draws(pos)
        paths = tio.write_stan_csv(os.path.join(tmp, "fit"), cons)
        csv_ok = True
        for c in (0, len(paths) - 1):
            names, mat = tio.read_stan_csv(paths[c])
            back = torch.tensor(mat[:, 7:], dtype=dtype)
            want = torch.cat([cons["alpha"][c][:, None], cons["beta"][c]], dim=1).cpu()
            csv_ok = csv_ok and names[7:] == ["alpha"] + [f"beta.{i + 1}" for i in range(k)] and torch.equal(back, want)
    seconds["stan_csv"] = time.perf_counter() - t0
    wall = time.perf_counter() - t_all

    # the references and the gates (after the counts were read by the caller)
    def references():
        t0 = time.perf_counter()
        lw_k = [psis_mod.psis_smooth(-check[:, i]) for i in range(check.shape[1])]
        plain_elpd = np.array([np.logaddexp.reduce(lw + check[:, i]) - np.logaddexp.reduce(lw)
                               for i, (lw, _) in enumerate(lw_k)])
        plain_k = np.array([kk for _, kk in lw_k])
        elpd_err = float(np.max(np.abs(lo.pointwise[:check_obs].cpu().numpy() - plain_elpd)))
        k_err = float(np.max(np.abs(lo.pareto_k[:check_obs].cpu().numpy() - plain_k)))
        require(elpd_err < limits["psis_elpd_abs"], f"vectorised PSIS elpd {elpd_err} from the plain loop")
        require(k_err < limits["psis_k_abs"], f"vectorised PSIS k {k_err} from the plain loop")
        report["loo"].update(check_observations=check_obs, plain_seconds=time.perf_counter() - t0,
                             max_abs_elpd_err_vs_plain=elpd_err, max_abs_k_err_vs_plain=k_err)

        ref = glm_map(model, torch.tensor(x, dtype=torch.float64), torch.tensor(y, dtype=torch.float64))
        map_err = float(np.max(np.abs(opt.theta.double().cpu().numpy() - ref.theta.numpy()) / nuts_sd))
        require(map_err < limits["map_sd"], f"float32 MAP {map_err} posterior sd from the float64 MAP")
        require(bool(torch.isfinite(opt.theta).all()) and math.isfinite(float(opt.grad_norm)), "MAP not finite")
        report["map"] = {"iterations": opt.iterations, "grad_calls": opt.num_grad_calls, "converged": opt.converged,
                         "grad_norm": float(opt.grad_norm), "value": float(opt.value), "seconds": seconds["map"],
                         "float64_cpu": {"iterations": ref.iterations, "grad_calls": ref.num_grad_calls,
                                         "converged": ref.converged, "grad_norm": float(ref.grad_norm)},
                         "max_err_vs_float64_in_posterior_sd": map_err}

        lap_mean, lap_sd = moments_in_sd(lap.draws, nuts_mean, nuts_sd)
        w = (lap.log_p - lap.log_q).double().cpu().numpy()
        lap_k = psis_mod.psis_smooth(w)[1]
        require(bool(torch.isfinite(lap.draws).all()) and np.isfinite(w).all(), "Laplace draws or weights not finite")
        require(lap_mean < limits["laplace_mean_sd"], f"Laplace mean {lap_mean} NUTS sd off")
        require(lap_sd < limits["laplace_sd_rel"], f"Laplace sd {lap_sd} off NUTS's (relative)")
        require(lap_k < limits["laplace_k"], f"Laplace PSIS k {lap_k}")
        report["laplace"] = {"draws": int(lap.draws.shape[0]), "map_iterations": lap.opt.iterations,
                             "grad_calls": lap.opt.num_grad_calls, "converged": lap.opt.converged,
                             "grad_norm": float(lap.opt.grad_norm), "max_mean_err_in_nuts_sd": lap_mean,
                             "max_rel_sd_err": lap_sd, "psis_k": lap_k, "seconds": seconds["laplace"]}

        pf_mean, pf_sd = moments_in_sd(pf.draws, nuts_mean, nuts_sd)
        require(bool(torch.isfinite(pf.draws).all()), "Pathfinder draws not finite")
        require(pf_mean < limits["pathfinder_mean_sd"], f"Pathfinder mean {pf_mean} NUTS sd off")
        report["pathfinder"] = {"k_hat": pf.k_hat, "path_elbos": [float(e) for e in pf.path_elbos],
                                "best_iters": [int(i) for i in pf.best_iters], "grad_calls": pf.num_grad_calls,
                                "logp_calls": pf.num_logp_calls, "max_mean_err_in_nuts_sd": pf_mean,
                                "max_rel_sd_err": pf_sd, "seconds": seconds["pathfinder"]}

        p, y_rep = gq["p"].double(), gq["y_rep"].double()
        mc = float(torch.sqrt((p * (1.0 - p)).sum()) / p.numel())
        gq_z = float((y_rep.mean() - p.mean()).abs()) / mc
        require(tuple(y_rep.shape) == (thin.shape[0], x.shape[0]), f"y_rep shape {tuple(y_rep.shape)}")
        require(gq_z < limits["gq_mc_errors"], f"mean y_rep {gq_z} Monte-Carlo errors from mean p")
        require(torch.equal(gq["y_rep"], replay["y_rep"]), "generated quantities not replayed from the seed")
        report["generate_quantities"] = {"draws": int(thin.shape[0]), "mean_y_rep": float(y_rep.mean()),
                                         "mean_p": float(p.mean()), "z": gq_z, "replay_equal": True,
                                         "seconds": seconds["generate_quantities"]}
        require(csv_ok, "Stan CSV round trip not equal")
        report["stan_csv"] = {"files": len(paths), "round_trip_equal": True, "seconds": seconds["stan_csv"]}
        return report

    return references, evaluations, wall, opt.theta.detach()


def phase_postfit_glm(x, y, position, b1_entry):
    """postfit_glm: B1 at 1 and 4 lanes against its plain version, then the
    layer around the main path's posterior on the card (``drive_postfit_glm``)
    with B1's launches held to the evaluations (plain version: the Laplace
    Hessian's one differentiable pass; no layout copy); B4 factors the
    Laplace precision.  Returns the B4 launches and the MAP (float32)."""
    small = b1_at_lanes(x, (1, 4))
    glm_fused.reset_counts()
    chol_blocked.reset_counts()
    references, evaluations, wall, map_theta = drive_postfit_glm(x, y, position)
    launches = dict(glm_fused.LAUNCHES)
    plain, copies, tiled = dict(glm_fused.PLAIN_CALLS), dict(glm_fused.LAYOUT_COPIES), dict(glm_fused.LAUNCHES_TILED)
    chol_launches = chol_blocked.LAUNCHES[chol_blocked.KERNEL]
    chol_plain = chol_blocked.PLAIN_CALLS[chol_blocked.KERNEL]
    total = sum(evaluations.values())
    require(launches["bernoulli_logit"] == total, f"B1 launches {launches} against {evaluations} evaluations")
    require(plain["bernoulli_logit"] == 1 and sum(plain.values()) == 1, f"plain-version calls {plain}")
    require(all(v == 0 for v in copies.values()) and all(v == 0 for v in tiled.values()), (copies, tiled))
    require(chol_launches == 1 and chol_plain == 0, f"B4: {chol_launches} launches, {chol_plain} plain calls; "
            "one Laplace factorisation expected")
    report = references()
    b1_entry["launches"] += launches["bernoulli_logit"]
    b1_entry["postfit_glm"] = {"launches": launches["bernoulli_logit"], **small}
    emit("postfit_glm", wall_s=wall, evaluations=evaluations, kernel_launches=launches["bernoulli_logit"],
         plain_calls=plain["bernoulli_logit"], chol_block_launches=chol_launches, b1_small_lanes=small, **report)
    return chol_launches, map_theta


# ---------------------------------------------------------------------------
# forward_mode and stan_surface: forward mode through the kernels' rules, the
# Hessian and Hessian-vector product of two BASELINE densities through
# ``functional``, and the Stan name surface on the card
# ---------------------------------------------------------------------------

JVP_RTOL = 3e-4  # the reverse comparison's gradient rtol (``compare``), applied to each partial of the tangent


def tangent_like(a, seed, scale):
    return (np.random.default_rng(seed).normal(size=np.shape(a)) * scale).astype(np.float32)


def glm_tangent_bound(family, p64, t64, grad_atol):
    """The reverse comparison's gate carried to the tangent, chain by chain:
    each partial may be off by ``grad_atol + 3e-4 |partial|`` (float64
    partials), times its input tangent; the data tangent (plain float32
    products, one eta recompute) by ``grad_atol + 3e-4`` of the sum of its
    terms' magnitudes."""
    y, x, a, b, e = p64
    ty, tx, ta, tb, te = t64
    _, ga, gb, ge = glm_fused.glm_fused_parts_reference(family, y, x, a, b, e)
    bound = ta.abs() * (grad_atol + JVP_RTOL * ga.abs()) + (tb.abs() * (grad_atol + JVP_RTOL * gb.abs())).sum(0)
    if ge is not None:
        bound = bound + te.abs() * (grad_atol + JVP_RTOL * ge.abs())
    eta = x @ b + a[None, :]
    _, thetap, _ = glm_fused._core(family, eta, y[:, None], None if e is None else e[None, :])
    terms = (thetap * (tx @ b)).abs().sum(0) + (ty[:, None] * glm_fused._dy_rows(family, eta, thetap, y, e)).abs().sum(0)
    return bound + grad_atol + JVP_RTOL * terms


def count_launches(fn):
    """``(fn(), kernel launches of every kind, plain calls)`` with the counts set to 0 just before."""
    glm_fused.reset_counts()
    chol_blocked.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = {**{k: v for k, v in glm_fused.LAUNCHES.items() if v}, **{k: v for k, v in chol_blocked.LAUNCHES.items() if v},
                **{f"{k}_tiled": v for k, v in glm_fused.LAUNCHES_TILED.items() if v}}
    plain = {**{k: v for k, v in glm_fused.PLAIN_CALLS.items() if v}, **{k: v for k, v in chol_blocked.PLAIN_CALLS.items() if v}}
    return out, launches, plain


def glm_family_tangents(x_main):
    """B1, each family at N = 100,000, D = 50, C = 256: ``torch.func.jvp`` of
    ``GlmFused`` (float32, the kernel's partials) against the ``jvp`` of the
    plain version in float64, tangents on alpha, beta, extra, x and y.  One
    launch, no plain call.  Times: the rule with parameter tangents only (the
    launch and the partials' products), with the data tangents too (one eta
    recompute), and the plain version's ``jvp`` in float32."""
    out = {}
    grad_atol = 1e-3 * N_MAIN / 3000.0
    for i, family in enumerate(glm_fused.FAMILIES):
        arrays = make_inputs(family, N_MAIN, K_MAIN, C_MAIN, seed=600 + i, scale=0.1, x=x_main)
        has_extra = glm_fused.HAS_EXTRA[family]
        tans = [tangent_like(a, 610 + 10 * i + j, 0.1) if a is not None else None for j, a in enumerate(arrays)]
        p32, t32 = on_gpu(arrays, torch.float32), on_gpu(tans, torch.float32)
        p64, t64 = on_gpu(arrays, torch.float64), on_gpu(tans, torch.float64)
        kernel = lambda y, x, a, b, e=None: glm_fused.GlmFused.apply(family, y, x, a, b, e)[0]  # noqa: E731
        plain = lambda y, x, a, b, e=None: glm_fused.glm_fused_parts_reference(family, y, x, a, b, e)[0]  # noqa: E731
        n_in = 5 if has_extra else 4
        (_, got), launches, plain_calls = count_launches(lambda: torch.func.jvp(kernel, tuple(p32[:n_in]), tuple(t32[:n_in])))
        require(launches == {family: 1} and not plain_calls, f"{family} jvp: launches {launches}, plain calls {plain_calls}")
        want = torch.func.jvp(plain, tuple(p64[:n_in]), tuple(t64[:n_in]))[1]
        bound = glm_tangent_bound(family, p64, t64, grad_atol)
        err = (got.double() - want).abs()
        require(bool(torch.isfinite(got).all()) and bool((err <= bound).all()),
                f"{family} jvp: max abs err {float(err.max())}, worst err / bound {float((err / bound).max())}")
        params = lambda: torch.func.jvp(lambda a, b, *e: kernel(p32[0], p32[1], a, b, *e),  # noqa: E731
                                        tuple(p32[2:n_in]), tuple(t32[2:n_in]))
        out[family] = {
            "max_abs_err": float(err.max()), "max_err_over_bound": float((err / bound).max()), "max_abs_want": float(want.abs().max()),
            "launches": launches[family],
            "jvp_ms": time_ms(params, warmup=3, reps=20),
            "jvp_with_data_tangents_ms": time_ms(lambda: torch.func.jvp(kernel, tuple(p32[:n_in]), tuple(t32[:n_in])), warmup=2, reps=10),
            "plain_jvp_ms": time_ms(lambda: torch.func.jvp(plain, tuple(p32[:n_in]), tuple(t32[:n_in])), warmup=2, reps=5),
        }
        del p32, t32, p64, t64
    return out


def multi_tangents(x_main):
    """B2 and B3 at N = 100,000, D = 50, C = 256, K = 5: the ``jvp`` of the
    Function against its plain version's in float64, tangents on every
    parameter and on x; gate: the reverse comparison's (rtol 3e-4 and
    ``grad_atol`` on each partial) carried to the tangent as for B1."""
    out = {}
    grad_atol = 1e-3 * N_MAIN / 3000.0
    specs = [(glm_fused.ORDERED, ordered_inputs, glm_fused.OrderedGlmFused, glm_fused.ordered_logistic_glm_parts_reference),
             (glm_fused.CATEGORICAL, categorical_inputs, glm_fused.CategoricalGlmFused,
              glm_fused.categorical_logit_glm_parts_reference)]
    for i, (kind, make, fn, ref) in enumerate(specs):
        y, _, *params = make(N_MAIN, K_MAIN, C_MAIN, K_CAT, seed=700 + i, scale=0.1, x=x_main)
        floats = [x_main, *params]
        tans = [tangent_like(a, 710 + 10 * i + j, 0.1) for j, a in enumerate(floats)]
        yt, *p32 = with_y(y, floats, torch.float32)
        t32 = on_gpu(tans, torch.float32)
        _, *p64 = with_y(y, floats, torch.float64)
        t64 = on_gpu(tans, torch.float64)
        kernel = lambda *a: fn.apply(yt, *a)[0]  # noqa: E731
        plain = lambda *a: ref(yt, *a)[0]  # noqa: E731
        (_, got), launches, plain_calls = count_launches(lambda: torch.func.jvp(kernel, tuple(p32), tuple(t32)))
        require(launches == {kind: 1} and not plain_calls, f"{kind} jvp: launches {launches}, plain calls {plain_calls}")
        want = torch.func.jvp(plain, tuple(p64), tuple(t64))[1]
        parts = ref(yt, *p64)[1:]
        if kind == glm_fused.ORDERED:
            lanes = lambda t: t.abs().sum(0)  # noqa: E731
            x_terms = (glm_fused._ordered_eta_partials(yt, *p64) * (t64[0] @ p64[1])).abs().sum(0)
        else:
            lanes = lambda t: t.abs().flatten(1).sum(1)  # noqa: E731
            thetap = glm_fused._categorical_thetap(yt, *p64)[2]
            x_terms = (thetap * torch.einsum("nd,cdk->cnk", t64[0], p64[2])).abs().sum((1, 2))
        # each partial's gate times its tangent; the x tangent (plain float32
        # products, an eta recompute) as B1's data tangent
        bound = sum(lanes(t * (grad_atol + JVP_RTOL * g.abs())) for t, g in zip(t64[1:], parts))
        bound = bound + grad_atol + JVP_RTOL * x_terms
        err = (got.double() - want).abs()
        require(bool(torch.isfinite(got).all()) and bool((err <= bound).all()),
                f"{kind} jvp: max abs err {float(err.max())}, worst err / bound {float((err / bound).max())}")
        out[kind] = {
            "max_abs_err": float(err.max()), "max_err_over_bound": float((err / bound).max()), "max_abs_want": float(want.abs().max()),
            "launches": launches[kind],
            "jvp_ms": time_ms(lambda: torch.func.jvp(lambda *a: kernel(p32[0], *a), tuple(p32[1:]), tuple(t32[1:])), warmup=3, reps=20),
            "jvp_with_data_tangents_ms": time_ms(lambda: torch.func.jvp(kernel, tuple(p32), tuple(t32)), warmup=2, reps=10),
            "plain_jvp_ms": time_ms(lambda: torch.func.jvp(plain, tuple(p32), tuple(t32)), warmup=2, reps=5),
        }
        del p32, t32, p64, t64
    return out


def chol_block_tangents(x_gp):
    """B4 at (32, 128), the GP path's Schur blocks: ``jvp`` of ``_CholInvBlock``
    (the kernel's U, W in the rule) against the plain version's in float64, a
    symmetric tangent; gate: ``1e-4 max |want|`` (the reverse comparison's),
    or 4x the float32 plain version's own error where that is larger.  Then
    ``vmap`` over two halves of the batch: one launch at Cb = 32."""
    _, d32 = gp_blocks(x_gp, get_config().cholesky_block_size, block_index=8)
    rng = np.random.default_rng(720)
    t = rng.normal(size=tuple(d32.shape)) * 0.01 * float(d32.abs().max())
    dd32 = torch.tensor(t + np.swapaxes(t, -1, -2), dtype=torch.float32, device="cuda")
    (_, (du, dw)), launches, plain_calls = count_launches(lambda: torch.func.jvp(chol_blocked._CholInvBlock.apply, (d32,), (dd32,)))
    require(launches == {chol_blocked.KERNEL: 1} and not plain_calls, f"B4 jvp: launches {launches}, plain calls {plain_calls}")
    _, (du64, dw64) = torch.func.jvp(chol_blocked.chol_inv_block_reference, (d32.double(),), (dd32.double(),))
    _, (dup, dwp) = torch.func.jvp(chol_blocked.chol_inv_block_reference, (d32,), (dd32,))
    report = {}
    for name, got, want, plain in (("dU", du, du64, dup), ("dW", dw, dw64, dwp)):
        err, plain_err = float((got.double() - want).abs().max()), float((plain.double() - want).abs().max())
        gate = max(1e-4 * float(want.abs().max()), 4.0 * plain_err)
        require(bool(torch.isfinite(got).all()) and err <= gate, f"B4 jvp {name}: max abs err {err}, gate {gate}")
        report[name] = {"max_abs_err": err, "plain_f32_max_abs_err": plain_err, "max_abs_want": float(want.abs().max()), "gate": gate}
    halves = d32.reshape((2, -1) + tuple(d32.shape[1:]))
    (u2, _), launches_v, _ = count_launches(lambda: torch.func.vmap(chol_blocked._CholInvBlock.apply)(halves))
    require(launches_v == {chol_blocked.KERNEL: 1}, f"B4 vmap over 2 halves: launches {launches_v}")
    u1, _ = chol_blocked.chol_inv_block_parts(d32)
    require(torch.equal(u2.reshape(d32.shape), u1), "B4 vmap: the folded launch differs from the single launch")
    report.update(launches=1, vmap_launches=1,
                  jvp_ms=time_ms(lambda: torch.func.jvp(chol_blocked._CholInvBlock.apply, (d32,), (dd32,)), warmup=3, reps=20),
                  plain_jvp_ms=time_ms(lambda: torch.func.jvp(chol_blocked.chol_inv_block_reference, (d32,), (dd32,)), warmup=0, reps=1))
    return report


def b1_vmap_fold(x_main):
    """``vmap`` of B1 over two parameter sets of 128 chains: one launch on
    256 lanes, against the two single launches (the reverse comparison's
    logp tolerance, rtol 2e-5: the lanes' row blocks differ)."""
    y, x, a, b, _ = on_gpu(make_inputs("bernoulli_logit", N_MAIN, K_MAIN, 2 * 128, seed=730, scale=0.1, x=x_main), torch.float32)
    a2, b2 = a.reshape(2, 128), b.reshape(K_MAIN, 2, 128).permute(1, 0, 2)
    f = lambda a, b: glm_fused.GlmFused.apply("bernoulli_logit", y, x, a, b.contiguous(), None)[0]  # noqa: E731
    got, launches, _ = count_launches(lambda: torch.func.vmap(f)(a2, b2))
    require(launches == {"bernoulli_logit": 1}, f"B1 vmap: launches {launches}")
    want = torch.stack([f(a2[v], b2[v]) for v in range(2)])
    err = float((got - want).abs().max())
    require(err <= 2e-5 * float(want.abs().max()), f"B1 vmap: {err} from the single launches")
    return {"lanes": 256, "launches": 1, "max_abs_err_vs_single_launches": err}


def glm_hessian(x, y, theta, device="cuda", dtype=torch.float32):
    """``functional.hessian`` (forward over reverse) of BASELINE config 2's
    log density at ``theta (dim,)`` in ``dtype`` on ``device``; beside it
    ``infer.optimize.hessian`` (reverse over reverse, the chains' lanes) and
    the float64 value on CPU tensors.  Returns ``(report, counts)``."""
    from math_tpu_torch import functional
    from math_tpu_torch.infer.optimize import hessian as rr_hessian

    k = x.shape[1]
    model = glm_logistic.make(k)
    xt, yt = torch.tensor(x, dtype=dtype, device=device), torch.tensor(y, dtype=dtype, device=device)
    th = theta.to(device=device, dtype=dtype)
    f = lambda t: model.logp(t[None], xt, yt)[0]  # noqa: E731
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    glm_fused.reset_counts()
    sync()
    t0 = time.perf_counter()
    fx, g, h = functional.hessian(f, th)
    sync()
    seconds = time.perf_counter() - t0
    counts = {"launches": dict(glm_fused.LAUNCHES), "plain_calls": dict(glm_fused.PLAIN_CALLS)}
    # first order under torch.func: the backward reads the kernel's partials
    glm_fused.reset_counts()
    sync()
    t0 = time.perf_counter()
    _, g1 = functional.gradient(f, th)
    sync()
    grad_seconds = time.perf_counter() - t0
    counts["gradient"] = {"launches": dict(glm_fused.LAUNCHES), "plain_calls": dict(glm_fused.PLAIN_CALLS)}
    zr = th.detach().clone().requires_grad_(True)
    (g_ag,) = torch.autograd.grad(f(zr), zr)
    t0 = time.perf_counter()
    h_rr = rr_hessian(model.logp, th, (xt, yt))
    sync()
    rr_seconds = time.perf_counter() - t0
    x64, y64 = torch.tensor(x, dtype=torch.float64), torch.tensor(y, dtype=torch.float64)
    h64 = rr_hessian(model.logp, th.double().cpu(), (x64, y64))
    scale = float(h64.abs().max())
    err, rr_err = float((h.double().cpu() - h64).abs().max()), float((h_rr.double().cpu() - h64).abs().max())
    asym = float((h - h.mT).abs().max())
    report = {"dim": int(th.shape[0]), "seconds": seconds, "optimize_hessian_seconds": rr_seconds, "max_abs_h": scale,
              "max_abs_err_vs_float64": err, "optimize_hessian_max_abs_err_vs_float64": rr_err,
              "max_abs_diff_vs_optimize_hessian": float((h - h_rr).abs().max()), "asymmetry": asym,
              "grad_norm": float(g.norm()), "logp": float(fx), "gradient_seconds": grad_seconds,
              "gradient_max_abs_diff_vs_autograd": float((g1 - g_ag).abs().max()), "gradient_max_abs": float(g_ag.abs().max())}
    return report, counts


def gp_hvp(z, v, n=N_GP, device="cuda", dtype=torch.float32):
    """``functional.hessian_times_vector`` of the marginal GP log density at
    ``z (3,)`` along ``v`` in ``dtype`` on ``device`` (the blocked Cholesky,
    ``_CholeskySolveLogdiag``'s rules); beside it the float64 value on CPU
    tensors of the independent ``torch.linalg`` density.  Returns ``(report,
    counts)``."""
    from math_tpu_torch import functional

    model, xt, yt = gp_setup(n, device=device, dtype=dtype)
    zt, vt = z.to(device=device, dtype=dtype), v.to(device=device, dtype=dtype)
    f = lambda t: model.logp(t[None], xt, yt)[0]  # noqa: E731
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    chol_blocked.reset_counts()
    sync()
    t0 = time.perf_counter()
    hv = functional.hessian_times_vector(f, zt, vt)
    sync()
    seconds = time.perf_counter() - t0
    counts = {"launches": chol_blocked.LAUNCHES[chol_blocked.KERNEL], "plain_calls": chol_blocked.PLAIN_CALLS[chol_blocked.KERNEL]}
    x64, y64 = xt.double().cpu(), yt.double().cpu()
    f64 = lambda t: gp_reference_logp(t[None], x64, y64, JITTER_GP)[0]  # noqa: E731
    hv64 = torch.func.jvp(torch.func.grad(f64), (zt.double().cpu(),), (vt.double().cpu(),))[1]
    err = float((hv.double().cpu() - hv64).abs().max())
    report = {"n": n, "seconds": seconds, "hvp": hv.double().cpu().tolist(), "hvp_float64": hv64.tolist(),
              "max_abs_err_vs_float64": err, "max_abs_want": float(hv64.abs().max())}
    return report, counts


FORWARD_HESSIAN_REL = 2e-5  # float32 Hessian of config 2 against float64, relative to max |H| (CPU rehearsal: 5.9e-7)
FORWARD_HVP_REL = 2e-4  # float32 HVP of the 2000-point GP against float64, relative to max |Hv| (CPU rehearsal: 7.4e-6)


def phase_forward_mode(x, y, theta_map, gp_z, entries):
    """forward_mode: each kernel's forward rule at full width against its
    plain version's (one launch a primal; ``vmap`` folded into one launch),
    then the Hessian of config 2 at the MAP of ``postfit_glm`` and the
    Hessian-vector product of the 2000-point GP at a posterior draw, each
    against float64 on the CPU.  Adds the launches to the kernel entries."""
    t_phase = time.perf_counter()
    fam = glm_family_tangents(x_main=x)
    multi = multi_tangents(x)
    chol = chol_block_tangents(gp_regression.synthetic_data(N_GP, seed=0)[0])
    fold = b1_vmap_fold(x)
    by_name = {e["name"]: e for e in entries}
    for family, r in fam.items():
        by_name[f"glm_fused[{family}]"].update(jvp_ms=r["jvp_ms"], forward_mode=r)
        by_name[f"glm_fused[{family}]"]["launches"] += r["launches"]
    by_name["glm_fused[bernoulli_logit]"]["launches"] += 1  # the vmap fold
    for kind, name in ((glm_fused.ORDERED, "glm_ordered_logistic"), (glm_fused.CATEGORICAL, "glm_categorical_logit")):
        by_name[name].update(jvp_ms=multi[kind]["jvp_ms"], forward_mode=multi[kind])
        by_name[name]["launches"] += 1
    by_name["chol_inv_block"].update(jvp_ms=chol["jvp_ms"], forward_mode=chol)
    by_name["chol_inv_block"]["launches"] += 2

    hess, hess_counts = glm_hessian(x, y, theta_map)
    require(hess_counts["launches"]["bernoulli_logit"] == 1 and hess_counts["plain_calls"]["bernoulli_logit"] >= 1,
            f"GLM Hessian: {hess_counts} (one launch for the primal, the plain version for the coefficients' derivative)")
    require(hess["max_abs_err_vs_float64"] <= FORWARD_HESSIAN_REL * hess["max_abs_h"],
            f"GLM Hessian {hess['max_abs_err_vs_float64']} from float64 (max |H| {hess['max_abs_h']})")
    require(hess["max_abs_diff_vs_optimize_hessian"] <= FORWARD_HESSIAN_REL * hess["max_abs_h"],
            f"GLM Hessian {hess['max_abs_diff_vs_optimize_hessian']} from optimize.hessian (max |H| {hess['max_abs_h']})")
    grad_counts = hess_counts["gradient"]
    require(grad_counts["launches"]["bernoulli_logit"] == 1 and grad_counts["plain_calls"]["bernoulli_logit"] == 0,
            f"GLM gradient under torch.func: {grad_counts} (one launch; the backward reads the kernel's partials)")
    require(hess["gradient_max_abs_diff_vs_autograd"] <= 1e-6 * (1.0 + hess["gradient_max_abs"]),
            f"GLM gradient under torch.func {hess['gradient_max_abs_diff_vs_autograd']} from torch.autograd's")
    by_name["glm_fused[bernoulli_logit]"]["launches"] += 2
    v = torch.tensor([1.0, -0.5, 0.25], dtype=torch.float64)
    hvp, hvp_counts = gp_hvp(gp_z, v)
    nb = -(-N_GP // get_config().cholesky_block_size)
    require(hvp_counts["launches"] >= nb and hvp_counts["launches"] % nb == 0 and hvp_counts["plain_calls"] == 0,
            f"GP HVP: {hvp_counts} (whole factorizations of {nb} blocks on the kernel)")
    require(hvp["max_abs_err_vs_float64"] <= FORWARD_HVP_REL * hvp["max_abs_want"],
            f"GP HVP {hvp['max_abs_err_vs_float64']} from float64 (max |Hv| {hvp['max_abs_want']})")
    by_name["chol_inv_block"]["launches"] += hvp_counts["launches"]
    seconds = time.perf_counter() - t_phase
    emit("forward_mode", seconds=seconds, glm_families=fam, ordered_categorical=multi, chol_inv_block=chol, b1_vmap=fold,
         glm_hessian={**hess, **hess_counts, "gate_rel": FORWARD_HESSIAN_REL},
         gp_hvp={**hvp, **hvp_counts, "gate_rel": FORWARD_HVP_REL})
    return seconds


def stan_surface(device="cuda", dtype=torch.float64):
    """``integrate_1d`` on ``device``, value and gradient in theta, for the
    three node sets against ``scipy.integrate.quad``; then the ``stan`` names
    that reach the blocked Cholesky on ``device`` tensors (float32 on the
    card) against float64 on the CPU.  Returns ``(report, counts)``."""
    import scipy.integrate

    from math_tpu_torch import stan
    from math_tpu_torch.ops.integrate import integrate_1d

    report = {"integrate_1d": {}}
    cases = {
        "tanh_sinh": (0.0, 1.0, lambda x, t: torch.pow(x, t), lambda x, t: x**t, lambda x, t: math.log(x) * x**t if x > 0 else 0.0),
        "exp_sinh": (0.0, math.inf, lambda x, t: torch.exp(-t * x), lambda x, t: math.exp(-t * x), lambda x, t: -x * math.exp(-t * x)),
        "sinh_sinh": (-math.inf, math.inf, lambda x, t: torch.exp(-0.5 * (x / t) ** 2), lambda x, t: math.exp(-0.5 * (x / t) ** 2),
                      lambda x, t: (x * x / t**3) * math.exp(-0.5 * (x / t) ** 2)),
    }
    theta = 1.7
    for name, (a, b, f, f_np, df_np) in cases.items():
        for dt, rtol in ((torch.float64, 1e-9), (torch.float32, 1e-5)):
            t = torch.tensor(theta, dtype=dt, device=device)
            val, grad = torch.func.grad_and_value(lambda tt: integrate_1d(f, a, b, tt))(t)[::-1]
            want = scipy.integrate.quad(lambda xx: f_np(xx, theta), a, b, epsabs=0.0, epsrel=1e-13)[0]
            want_g = scipy.integrate.quad(lambda xx: df_np(xx, theta), a, b, epsabs=0.0, epsrel=1e-13)[0]
            err, gerr = abs(float(val) - want) / abs(want), abs(float(grad) - want_g) / abs(want_g)
            require(val.device.type == torch.device(device).type and err <= rtol and gerr <= rtol,
                    f"integrate_1d {name} {dt}: value rel err {err}, gradient rel err {gerr}, gate {rtol}")
            report["integrate_1d"][f"{name}_{str(dt)[6:]}"] = {"value": float(val), "quad": want, "rel_err": err,
                                                              "grad": float(grad), "quad_grad": want_g, "grad_rel_err": gerr}
    rng = np.random.default_rng(800)
    a = rng.normal(size=(64, 200, 200)) / np.sqrt(200.0)
    spd = a @ np.swapaxes(a, -1, -2) + np.eye(200)
    b = rng.normal(size=(64, 200, 3))
    a_dev, b_dev = torch.tensor(spd, dtype=torch.float32, device=device), torch.tensor(b, dtype=torch.float32, device=device)
    a64, b64 = torch.tensor(spd), torch.tensor(b)
    names = {
        "cholesky_decompose": lambda m, r: stan.cholesky_decompose(m),
        "inverse_spd": lambda m, r: stan.inverse_spd(m),
        "mdivide_left_spd": lambda m, r: stan.mdivide_left_spd(m, r),
        "log_determinant_spd": lambda m, r: stan.log_determinant_spd(m),
        "mdivide_left_ldlt": lambda m, r: stan.mdivide_left_ldlt(stan.ldlt_factor(m), r),
        "trace_inv_quad_form_ldlt": lambda m, r: stan.trace_inv_quad_form_ldlt(stan.ldlt_factor(m), r),
    }
    chol_blocked.reset_counts()
    got = {k: fn(a_dev, b_dev) for k, fn in names.items()}
    if device == "cuda":
        torch.cuda.synchronize()
    counts = {"launches": chol_blocked.LAUNCHES[chol_blocked.KERNEL], "plain_calls": chol_blocked.PLAIN_CALLS[chol_blocked.KERNEL]}
    report["linalg"] = {}
    for k, fn in names.items():
        want = fn(a64, b64)
        err = float((got[k].double().cpu() - want).abs().max())
        gate = 1e-4 * max(1.0, float(want.abs().max()))
        require(got[k].device.type == torch.device(device).type and err <= gate, f"stan.{k}: max abs err {err}, gate {gate}")
        report["linalg"][k] = {"max_abs_err": err, "max_abs_want": float(want.abs().max())}
    report["linalg_shape"] = [64, 200, 200]
    return report, counts


def phase_stan_surface():
    """stan_surface: ``integrate_1d`` on the card against scipy, and the Stan
    names that reach B4 on CUDA tensors against float64; B4 launches counted."""
    t0 = time.perf_counter()
    report, counts = stan_surface()
    require(counts["launches"] > 0 and counts["plain_calls"] == 0, f"stan names: B4 {counts}")
    seconds = time.perf_counter() - t0
    emit("stan_surface", seconds=seconds, chol_block_launches=counts["launches"], **report)
    return seconds, counts["launches"]


# tools/sharded_phases.py's phases (the process's start-up, five processes
# importing torch and making CUDA contexts together, is reported beside them:
# 46-61 s in all on slow hosts)
SHARDED_BUDGET_S = 45.0


def start_worker(args):
    """The script ``args`` (this one with ``--worker``, or a tool's) in a
    process of its own; its output is read by a thread (a full pipe would
    stall it)."""
    cmd = [sys.executable] + args
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True)
    reader.start()
    return proc, reader, lines


def finish_worker(worker, key="worker_result"):
    """Wait for a worker, print its phases' lines, return its result (the
    line that holds ``key``)."""
    proc, reader, lines = worker
    rc = proc.wait()
    reader.join()
    result = None
    for line in lines:
        if line.startswith('{"' + key + '"'):
            result = json.loads(line)[key]
        else:
            print(line, end="", flush=True)
    require(rc == 0 and result is not None, f"the phases of {key} failed (exit code {rc})")
    return result


def worker_main(profiling):
    """``lv_path``, ``lv_rk45``, ``ode_family``, ``constrained_prior``,
    ``varying_slopes_path``, ``censored_nb_path`` and ``univariate_sweep``,
    beside the main process; the last line is their launches."""
    require(torch.cuda.is_available(), "the worker needs the GPU")
    require(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 must stay off: the port's products are float32")
    x = glm_logistic.synthetic_data(N_MAIN, K_MAIN)[0]
    lv_res, lv_model, lv_args, lv_launches = phase_lv_path()
    lv_second, lv_dual_launches = phase_lv_second_order(lv_res.position[0, -1, :].contiguous(), lv_args[0])
    if profiling:
        kernels, total_us, calls = phase_profile(lv_res, lv_model, lv_args, label="profile_lv")
        pair_us = sum(dev_us(e) for e in kernels if lv_rk4.KERNEL in e.key)
        emit("profile_lv_pair", device_ms_per_grad_call=pair_us / 1e3 / calls, device_share=pair_us / total_us)
    phase_lv_rk45(lv_res.position[:, -1, :].contiguous(), lv_args[0])
    del lv_res, lv_model, lv_args
    phase_ode_family()

    chol_launches = phase_constrained_prior()
    vs_res, vs_model, vs_args_, vs_launches = phase_varying_slopes_path()
    chol_launches += vs_launches
    if profiling:
        phase_profile(vs_res, vs_model, vs_args_, label="profile_varying_slopes")
    del vs_res, vs_model, vs_args_

    nb_res, nb_model, nb_args, nb_launches, nb_at_path = phase_censored_nb_path(x)
    if profiling:
        profile_inc_beta_share(nb_res, nb_model, nb_args)
    del nb_res, nb_model, nb_args
    phase_univariate_sweep()
    print(json.dumps({"worker_result": {"lv_launches": lv_launches, "lv_second_order": lv_second,
                                        "lv_dual_launches": lv_dual_launches, "chol_launches": chol_launches,
                                        "nb_launches": nb_launches, "nb_at_path": nb_at_path}}), flush=True)


def main():
    profiling = "--profile" in sys.argv[1:]
    smi = phase_device()
    phase_build()
    x, y, beta_true, _ = glm_logistic.synthetic_data(N_MAIN, K_MAIN)
    entries = phase_kernels(x)
    chol_entry = phase_kernels_chol(gp_regression.synthetic_data(N_GP, seed=0)[0])
    ord_entry, cat_entry = phase_kernels_ordered_categorical(x)
    phase_kernels_wide()
    _, _, tiled_entry, glm_tiled = phase_wide(x)
    lv_entry, lv_dual_entry = phase_kernels_lv()
    chol_entry["small_shapes"] = phase_kernels_chol_small()
    worker = start_worker([os.path.abspath(__file__), "--worker"] + (["--profile"] if profiling else []))
    sharded = None
    try:
        main_phases(profiling, x, y, beta_true, entries, chol_entry, ord_entry, cat_entry)
        # beside the worker's last phases, in a process of its own (so that
        # the NCCL group never lives in this one): after the worker it added
        # its 40 s to the script (1,115 s on the slowest host seen)
        t0 = time.perf_counter()
        sharded = start_worker([os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", "sharded_phases.py")])
        sharded_result = finish_worker(sharded, "sharded_result")
        sharded_wall = time.perf_counter() - t0
        result = finish_worker(worker)
    finally:
        for w in (worker, sharded):
            if w is not None and w[0].poll() is None:
                w[0].kill()
                w[0].wait()
    emit("sharded_wall", process_s=sharded_wall, phases_s=sharded_result["seconds"], budget_s=SHARDED_BUDGET_S)
    require(sharded_result["seconds"] <= SHARDED_BUDGET_S,
            f"the sharded phases took {sharded_result['seconds']} s of their {SHARDED_BUDGET_S} s")
    entries[0]["launches"] += sharded_result["b1_launches"]
    entries[0]["sharded"] = {"launches": sharded_result["b1_launches"]}
    chol_entry["launches"] += result["chol_launches"]
    lv_entry["launches"] = result["lv_launches"]
    lv_entry["second_order"] = {k: result["lv_second_order"][k] for k in ("hessian", "laplace", "errors")}
    lv_dual_entry["launches"] = result["lv_dual_launches"]
    entries += [lv_entry, lv_dual_entry]
    nb_entry = next(e for e in entries if e["name"] == f"glm_fused[{NB_FAMILY}]")
    nb_entry["launches"] += result["nb_launches"]
    nb_entry["censored_nb_path"] = {"launches": result["nb_launches"], **result["nb_at_path"]}
    entries += [tiled_entry, glm_tiled]
    require(len(entries) == 11, f"{len(entries)} kernel entries")
    require(all(math.isfinite(e["ms"]) and e["launches"] > 0 for e in entries), "a kernel has no time or no launch")
    emit("script", seconds=time.perf_counter() - START, limit_s=1200)
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)


def main_phases(profiling, x, y, beta_true, entries, chol_entry, ord_entry, cat_entry):
    """Every phase from ``main_path`` on but the worker's, in this process."""
    res = phase_main_path(x, y, beta_true, entries)
    if profiling:
        args = (torch.tensor(x, device="cuda"), torch.tensor(y, device="cuda"))
        phase_profile(res, glm_logistic.make(K_MAIN), args)
    postfit_chol_launches, map_theta = phase_postfit_glm(x, y, res.position, entries[0])
    del res

    phase_sample_path(x, y, beta_true)

    res, model, args, _ = phase_glm_path(
        "ordinal_path", glm_fused.ORDERED, ord_entry, drive_ordinal_sampler, make_ordinal(K_MAIN, fused=False),
        x, ordinal_data(x), tol=0.05,
    )
    if profiling:
        phase_profile(res, model, args, label="profile_ordinal")
    del res, model, args
    phase_chunked_path(x, ordinal_data(x))
    res, model, args, cat_report = phase_glm_path(
        "categorical_path", glm_fused.CATEGORICAL, cat_entry, drive_categorical_sampler, make_multinomial(K_MAIN, fused=False),
        x, categorical_data(x), tol=0.08,
    )
    if profiling:
        phase_profile(res, model, args, label="profile_categorical")
    del res, model, args
    phase_dense_categorical(x, categorical_data(x), cat_report)
    entries += [ord_entry, cat_entry]

    gp_res, gp_model, gp_x, gp_y = phase_gp_path(chol_entry)
    chol_entry["launches"] += postfit_chol_launches
    entries.append(chol_entry)
    if profiling:
        phase_profile_gp(gp_res, gp_model, gp_x, gp_y)
    forward_s = phase_forward_mode(x, y, map_theta, gp_res.position[0, -1, :], entries)
    stan_s, stan_chol_launches = phase_stan_surface()
    chol_entry["launches"] += stan_chol_launches
    require(forward_s + stan_s <= 30.0, f"forward_mode and stan_surface took {forward_s + stan_s} s of their 30 s")
    phase_eight_schools()

    radon_res, radon_model, radon_data = phase_radon_path()
    if profiling:
        phase_profile(radon_res, radon_model, radon_data, label="profile_radon")
    phase_advi_radon(radon_model, radon_data, radon_res.position)
    del radon_res, radon_model, radon_data
    chol_entry["launches"] += phase_resume_gp()
    chol_entry["launches"] += phase_smc_gp(gp_res.position)


if __name__ == "__main__":
    if "--worker" in sys.argv[1:]:
        worker_main("--profile" in sys.argv[1:])
    else:
        main()
