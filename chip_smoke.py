#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on an NVIDIA GPU.

Run from the repository root with no arguments; needs one GPU, ``nvcc`` and
no network:

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises: the exit code is then
not 0 and no result line is printed):

1. ``device``   the GPU's name and power limit, torch/CUDA versions, TF32 off.
2. ``build``    compiles ``math_tpu_torch/csrc/*.cu`` from source with nvcc.
3. ``kernels``  every family of the fused GLM kernel against its plain PyTorch
   version (float64, on the GPU) at the main-path shape N=100,000, K=50, C=256
   and at the ragged shape N=1537, K=7, C=5; times of the kernel, of the plain
   version in float32, and the least time the card could take for the work.
4. ``main_path`` with every launch count set to 0 just before and read just
   after: chain-batched NUTS with pooled warmup on the 100,000 x 50 logistic
   GLM, 256 chains, float32, through ``run_pooled_chains``; then value and
   gradient through the public dispatchers of the three other GLM families at
   the same width.  The bernoulli kernel must have been launched exactly once
   per chain-batched gradient call of the sampler, the plain version never.
5. ``eight_schools`` 64 chains on the GPU (a model without a kernel).

With ``--profile`` a further phase traces a few sampling transitions of the
main path with ``torch.profiler`` and prints the device time by kernel.

The last line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from math_tpu_torch import get_config
from math_tpu_torch.diagnostics import convergence
from math_tpu_torch.infer.pooled import run_pooled_chains
from math_tpu_torch.models import eight_schools, glm_logistic
from math_tpu_torch.ops import _build, glm_fused

# Published peaks of one H100 SXM (NVIDIA's data sheet): float32 outside the
# tensor cores (the arithmetic the kernel uses) and HBM bandwidth.
PEAK_FP32_FLOPS = 67e12
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


def require(cond, what):
    """A check of this script: raises (``assert`` would vanish under -O)."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


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


def phase_build():
    t0 = time.perf_counter()
    names = ["glm_fused"]
    started = {name: _build.start_build(name) for name in names}  # one nvcc per source, together
    for name in names:
        _build.finish_build(name, started[name])
    glm_fused._library()
    emit("build", sources=[f"math_tpu_torch/csrc/{n}.cu" for n in names],
         seconds=time.perf_counter() - t0, nvcc_seconds=dict(_build.BUILD_SECONDS))


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
    errs, plain_errs = {}, {}
    for name, g, w, p in zip(("logp", "ga", "gb", "ge"), got, want, plain32):
        if w is None:
            require(g is None, f"{family}: {name} returned for a family without an extra parameter")
            continue
        require(g.shape == w.shape and g.dtype == torch.float32 and bool(torch.isfinite(g).all()), (family, name))
        rtol, atol = (2e-5, 0.0) if name == "logp" else (3e-4, grad_atol)
        err = (g.double() - w).abs()
        require(bool((err <= atol + rtol * w.abs()).all()), (
            f"{family} {name}: kernel disagrees with the plain version: max abs err {float(err.max())}, "
            f"max |want| {float(w.abs().max())}, rtol {rtol}, atol {atol}"
        ))
        errs[name] = float(err.max())
        plain_errs[name] = float((p.double() - w).abs().max())
    return errs, plain_errs


def phase_kernels(x_main):
    entries = []
    for i, family in enumerate(glm_fused.FAMILIES):
        ragged = make_inputs(family, N_RAGGED, K_RAGGED, C_RAGGED, seed=100 + i, scale=0.2)
        ragged_errs, _ = compare(family, ragged, grad_atol=1e-3)
        main = make_inputs(family, N_MAIN, K_MAIN, C_MAIN, seed=200 + i, scale=0.1, x=x_main)
        grad_atol = 1e-3 * N_MAIN / 3000.0
        errs, plain_errs = compare(family, main, grad_atol=grad_atol)

        t32 = on_gpu(main, torch.float32)
        # the design matrix (20 MB) stays in the 50 MB L2 between launches, as
        # it does between the gradient calls of the sampler
        ms = time_ms(lambda: glm_fused.glm_fused_parts(family, *t32), warmup=3, reps=20)
        plain_ms = time_ms(lambda: glm_fused.glm_fused_parts_reference(family, *t32), warmup=2, reps=5)
        n, k, c = N_MAIN, K_MAIN, C_MAIN
        flops = 4.0 * n * k * c + float(CORE_OPS[family]) * n * c
        nbytes = 4.0 * (n * k + n + 2 * k * c + 3 * c + (2 * c if glm_fused.HAS_EXTRA[family] else 0))
        t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
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
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,  # no one PyTorch call computes this function
            "shape": {"n": n, "k": k, "c": c},
            "abs_err": errs,
            "plain_f32_abs_err": plain_errs,
            "ragged_abs_err": ragged_errs,
            "tolerance": {"logp_rtol": 2e-5, "grad_rtol": 3e-4, "grad_atol": grad_atol, "ragged_grad_atol": 1e-3},
            "tflops": flops / (ms * 1e-3) / 1e12,
        })
    return entries


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
        logp, _, _, _ = glm_fused.glm_fused_parts_reference(
            family, y, x64, params[0], params[1], params[2] if len(params) > 2 else None
        )
        n = y.shape[0]
        if family == "normal_id":
            logp = logp - n * torch.log(params[2])
        elif family == "neg_binomial_2_log":
            phi = params[2]
            logp = logp + torch.lgamma(y[:, None] + phi[None, :]).sum(0) - n * torch.lgamma(phi) + n * phi * torch.log(phi)
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
    plain_calls = dict(glm_fused.PLAIN_CALLS)
    driven = drive_other_families(x_gpu)
    launches = dict(glm_fused.LAUNCHES)

    require(launches_sampler["bernoulli_logit"] == res.n_grad_calls > 0, (launches_sampler, res.n_grad_calls))
    require(all(v == 0 for v in plain_calls.values()), f"the plain version ran on the main path: {plain_calls}")
    for e in entries:
        family = e["name"][len("glm_fused["):-1]
        e["launches"] = launches[family]
        require(e["launches"] > 0, f"{e['name']} was not launched on the main path")
    others = check_other_families(x_gpu, driven)
    emit("main_path", **report, kernel_launches=launches, plain_calls=plain_calls, other_families=others)
    return res


def phase_profile(x, y, res, transitions=5):
    """Only with ``--profile``: where the time of a sampling transition goes.
    Continues the main path's chains at their adapted step size and metric;
    times ``transitions`` transitions on the host clock, then traces as many
    with ``torch.profiler`` and sums the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from math_tpu_torch.infer.nuts import ChainNoise, LogpGrad
    from math_tpu_torch.infer.pooled import sample_pooled

    model = glm_logistic.make(x.shape[1])
    args = (torch.tensor(x, device="cuda"), torch.tensor(y, device="cuda"))
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
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)  # noqa: E731
    total_us = sum(dev_us(e) for e in kernels)
    require(total_us > 0, "the profiler saw no device time")
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    emit(
        "profile", transitions=transitions, wall_s_untraced=wall, grad_calls_untraced=calls,
        ms_per_grad_call_untraced=wall / calls * 1e3, grad_calls_traced=calls_traced,
        device_ms_traced=total_us / 1e3, device_ms_per_grad_call=total_us / 1e3 / calls_traced,
        device_launches_per_grad_call=sum(e.count for e in kernels) / calls_traced,
        device_busy_share=(total_us / 1e6 / calls_traced) / (wall / calls),
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


def main():
    smi = phase_device()
    phase_build()
    x, y, beta_true, _ = glm_logistic.synthetic_data(N_MAIN, K_MAIN)
    entries = phase_kernels(x)
    res = phase_main_path(x, y, beta_true, entries)
    if "--profile" in sys.argv[1:]:
        phase_profile(x, y, res)
    phase_eight_schools()
    require(all(math.isfinite(e["ms"]) and e["launches"] > 0 for e in entries), "a kernel has no time or no launch")
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)


if __name__ == "__main__":
    main()
