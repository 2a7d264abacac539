#!/usr/bin/env python3
"""Time the categorical-logit GLM at the shapes past ``glm_categorical_kernel``.

Run from the repository root on a machine with one GPU and nvcc:

    python3 tools/categorical_tiled_timing.py [--root DIR] [--check] [--reps 3]

``--root`` is the checkout whose ``math_tpu_torch`` is timed (default: the
one holding this script), so that two trees can be compared in one call
(parent, change, change, parent); each tree must have the tiled tensor-core
pair and its ``LAUNCHES_TILED`` count.  At
N = 100,000, C = 256 and (D, K) = (50, 65), (50, 200), (400, 5), (212, 41)
(``chip_smoke.py``'s ``wide`` shapes) it times ``categorical_logit_glm_parts``
and, on the same inputs, the two products alone as float32 cuBLAS calls
(``x @ beta`` and ``[x, 1]^T`` times its result): one warm-up, then each of
``--reps`` calls timed by CUDA events, the median and every rep reported;
beside them the bound of three TF32 products (3 x 4*N*D*C*K at 495 TFLOP/s)
and the float32 one (4*N*D*C*K and the core's operations at 67 TFLOP/s).
``--check`` first holds the function against the float64 plain version at N
= 4,099, C = 20 on those shapes, (7, 65), (320, 5), (700, 3), (330, 30) and
(400, 12), with the tolerances of
``chip_smoke.py`` (logp rtol 2e-5; gradients rtol 3e-4, atol 1e-3 * max(1, N
/ 3000)).  ``--profile`` adds the device time of each kernel of one call a shape
(``torch.profiler``).  Prints one JSON line (``--out`` writes it to a file
too), then the card's name and power limit.  Exits 2 without a GPU.
"""

import argparse
import json
import os
import subprocess
import sys

SHAPES = ((50, 65), (50, 200), (400, 5), (212, 41))
CHECK_SHAPES = SHAPES + ((7, 65), (320, 5), (700, 3), (330, 30), (400, 12))
N, C = 100_000, 256
CHECK_N, CHECK_C = 4099, 20
PEAK_TF32_FLOPS, PEAK_FP32_FLOPS = 495e12, 67e12


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--profile", action="store_true", help="device time of each kernel of one call a shape (torch.profiler)")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no GPU: nothing timed", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from math_tpu_torch.ops import _build, glm_fused

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def inputs(n, d, c, k, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn((n, d), generator=gen, device="cuda")
        y = torch.randint(1, k + 1, (n,), generator=gen, device="cuda", dtype=torch.int32)
        alpha = 0.3 * torch.randn((c, k), generator=gen, device="cuda")
        beta = min(0.1, d ** -0.5) * torch.randn((c, d, k), generator=gen, device="cuda")
        return y, x, alpha, beta

    def event_ms(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    def median_ms(fn):
        fn()
        torch.cuda.synchronize()
        reps = [event_ms(fn) for _ in range(args.reps)]
        return float(np.median(reps)), reps

    out = {"root": root, "checks": {}, "timed": []}
    if args.check:
        for i, (d, k) in enumerate(CHECK_SHAPES):
            y, x, alpha, beta = inputs(CHECK_N, d, CHECK_C, k, 100 + i)
            got = glm_fused.categorical_logit_glm_parts(y, x, alpha, beta)
            want = glm_fused.categorical_logit_glm_parts_reference(y, x.double(), alpha.double(), beta.double())
            atol = 1e-3 * max(1.0, CHECK_N / 3000.0)
            errs, ok = {}, True
            for name, g, w in zip(("logp", "galpha", "gbeta"), got, want):
                rtol, at = (2e-5, 0.0) if name == "logp" else (3e-4, atol)
                err = (g.double() - w).abs()
                ok &= bool(torch.isfinite(g).all()) and bool((err <= at + rtol * w.abs()).all())
                errs[name] = float(err.max())
            out["checks"][f"d{d}_k{k}"] = {"ok": ok, "abs_err": errs}
    route_of = glm_fused.categorical_route
    for i, (d, k) in enumerate(SHAPES):
        y, x, alpha, beta = inputs(N, d, C, k, 700 + d + k)
        plan = route_of(N, d, C, k, sms)
        counts = {"tensor_cores": dict(glm_fused.LAUNCHES), "tiled": dict(glm_fused.LAUNCHES_TILED)}
        ms, reps = median_ms(lambda: glm_fused.categorical_logit_glm_parts(y, x, alpha, beta))
        bmat = beta.permute(1, 0, 2).reshape(d, C * k)
        x1 = torch.cat([x, torch.ones_like(x[:, :1])], dim=1)
        rows = max(1, int(2.5e8 // bmat.shape[1]))  # eta of a block of rows at a time

        def products():
            acc = None
            for r in range(0, N, rows):
                p = x1[r : r + rows].mT @ (x[r : r + rows] @ bmat)
                acc = p if acc is None else acc + p
            return acc

        products_ms, products_reps = median_ms(products)
        kernels = {}
        if args.profile:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                glm_fused.categorical_logit_glm_parts(y, x, alpha, beta)
                torch.cuda.synchronize()
            for ev in prof.key_averages():
                us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
                if us and "kernel" in ev.key.lower():
                    kernels[ev.key[:90]] = {"ms": us / 1e3, "count": ev.count}
        del bmat, x1
        flops = 4.0 * N * d * C * k
        core = (8.0 * k + 3.0) * N * C
        nbytes = 4.0 * (N + N * d + C * k + C * d * k) + 4.0 * (C + C * k + C * d * k)
        out["timed"].append({
            "d": d, "k": k, "n": N, "c": C, "route": plan["route"], "kernel": plan.get("kernel"),
            "plan": {key: v for key, v in plan.items() if isinstance(v, (int, str))},
            "ms": ms, "reps_ms": reps, "kernels": kernels, "products_ms": products_ms, "products_reps_ms": products_reps,
            "bound_tf32x3_ms": max(3.0 * flops / PEAK_TF32_FLOPS, core / PEAK_FP32_FLOPS, nbytes / 3.35e12) * 1e3,
            "bound_fp32_ms": max((flops + core) / PEAK_FP32_FLOPS, nbytes / 3.35e12) * 1e3,
            "calls_counted": {"tensor_cores": glm_fused.LAUNCHES[glm_fused.CATEGORICAL] - counts["tensor_cores"][glm_fused.CATEGORICAL],
                              "tiled": glm_fused.LAUNCHES_TILED[glm_fused.CATEGORICAL] - counts["tiled"][glm_fused.CATEGORICAL]},
        })
        del y, x, alpha, beta
        torch.cuda.empty_cache()
    out["ptxas"] = _build.BUILD_LOG.get("glm_categorical", "")
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
