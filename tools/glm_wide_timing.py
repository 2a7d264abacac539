#!/usr/bin/env python3
"""Time B1 and B2 (the four GLM families and the ordered GLM) at the shapes past ``glm_tc_kernel``.

Run from the repository root on a machine with one GPU and nvcc:

    python3 tools/glm_wide_timing.py [--root DIR] [--check] [--reps 3] [--profile] [--out FILE]

``--root`` is the checkout whose ``math_tpu_torch`` is timed (default: the
one holding this script), so that two trees can be compared in one call
(parent, change, change, parent): in a tree with the tiled tensor-core route
the shapes go there, in an older one to the float32-FMA kernels it replaced.
At N = 100,000 it times ``glm_fused_parts`` (the four families at D = 282 and
1,024, C = 256; bernoulli-logit and normal-id at D = 282 with C = 4 and 32)
and ``ordered_logistic_glm_parts`` ((D, K) = (236, 5) and (1024, 12) at C =
256; (282, 5) at C = 4 and 32): one warm-up, then each of ``--reps`` calls
timed by CUDA events, the median and every rep reported; beside them, on the
same inputs, the two products alone as float32 cuBLAS calls (``x @ beta``
and ``[x, 1]^T`` times its result) timed alike, the bound of three TF32
products (3 x 4*N*D*C at 495 TFLOP/s, the core's operations at 67 TFLOP/s or
the bytes at 3.35 TB/s, whichever is largest) and the FP32-FMA one (4*N*D*C
and the core at 67 TFLOP/s, or the bytes), and which kernel the wrapper's
counters saw.  ``--check`` first holds the functions against the float64
plain version at the wide shapes at N = 4,099, C = 20 and at N = 20,000, C
= 200 (several row tiles a block, a ragged second column tile), then every
timed call on its inputs, with the tolerances of ``chip_smoke.py`` (logp
rtol 2e-5; gradients rtol 3e-4, atol 1e-3 * max(1, N / 3000)).  ``--profile`` adds the device time of each kernel of one
call a shape (``torch.profiler``).  Also times the two products alone at the
narrow shapes of ``glm_tc_kernel`` that ``PERF.md`` lists without them (D =
50: N = 94,613, C = 256, the censored path's rows; N = 100,000, C = 1 and 4).
Prints one JSON line (``--out`` writes it to a file too), then the card's
name and power limit.  Exits 2 without a GPU.
"""

import argparse
import json
import os
import subprocess
import sys

FAMILIES = ("bernoulli_logit", "poisson_log", "normal_id", "neg_binomial_2_log")
N = 100_000
SHAPES = ([(f, 282, None, 256) for f in FAMILIES] + [(f, 1024, None, 256) for f in FAMILIES]
          + [("ordered", 236, 5, 256), ("ordered", 1024, 12, 256)]
          + [(f, 282, None, c) for c in (4, 32) for f in ("bernoulli_logit", "normal_id")]
          + [("ordered", 282, 5, c) for c in (4, 32)])  # (kind, d, k, c)
CHECK_SHAPES = [(f, d, None) for f in FAMILIES for d in (282, 1024)] + [("ordered", 236, 5), ("ordered", 1024, 12)]
CHECK_SIZES = ((4099, 20), (20_000, 200))  # (n, c)
NARROW_PRODUCTS = ((94_613, 50, 256), (100_000, 50, 1), (100_000, 50, 4))  # (n, d, c)
CORE_OPS = {"bernoulli_logit": 18, "poisson_log": 5, "normal_id": 8, "neg_binomial_2_log": 24}  # chip_smoke.py's counts
ORDERED_CORE_OPS = 36  # chip_smoke.py's ordered_core_ops: the same for every K
PEAK_TF32_FLOPS, PEAK_FP32_FLOPS, PEAK_BYTES = 495e12, 67e12, 3.35e12


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

    def inputs(kind, n, d, c, k, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn((n, d), generator=gen, device="cuda")
        beta = min(0.1, d ** -0.5) * torch.randn((d, c), generator=gen, device="cuda")
        if kind == "ordered":
            y = torch.randint(1, k + 1, (n,), generator=gen, device="cuda", dtype=torch.int32)
            # cut gaps of 0.3-1.3, as chip_smoke.py's (nearly equal cuts make w1 and w2 large and their
            # difference ill-conditioned in float32)
            cuts = torch.cumsum(0.3 + torch.rand((k - 1, c), generator=gen, device="cuda"), dim=0) - 0.5 * k
            return (y, x, beta, cuts), lambda *a: glm_fused.ordered_logistic_glm_parts(*a), \
                lambda *a: glm_fused.ordered_logistic_glm_parts_reference(*a)
        alpha = 0.1 * torch.randn((c,), generator=gen, device="cuda")
        if kind == "bernoulli_logit":
            y = torch.randint(0, 2, (n,), generator=gen, device="cuda").float()
        elif kind == "normal_id":
            y = torch.randn((n,), generator=gen, device="cuda")
        else:
            y = torch.poisson(torch.full((n,), 2.0, device="cuda"), generator=gen)
        extra = 0.5 + 3.0 * torch.rand((c,), generator=gen, device="cuda") if glm_fused.HAS_EXTRA[kind] else None
        return (y, x, alpha, beta, extra), lambda *a: glm_fused.glm_fused_parts(kind, *a), \
            lambda *a: glm_fused.glm_fused_parts_reference(kind, *a)

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

    def counts():
        # an older tree counts its float32 kernels' launches in LAUNCHES_FMA
        return {name: dict(getattr(glm_fused, name)) for name in ("LAUNCHES", "LAUNCHES_TILED", "LAUNCHES_FMA")
                if hasattr(glm_fused, name)}

    def seen(before, after):
        return {name: {f: after[name][f] - before[name].get(f, 0) for f in after[name] if after[name][f] != before[name].get(f, 0)}
                for name in after}

    def hold(kind, fn, ref, arrays):
        # fn's result against the float64 plain version on the same inputs
        got = fn(*arrays)
        want = ref(*[a.double() if a is not None and a.dtype == torch.float32 else a for a in arrays])
        atol = 1e-3 * max(1.0, arrays[1].shape[0] / 3000.0)
        names = ("logp", "gbeta", "gcuts") if kind == "ordered" else ("logp", "ga", "gb", "ge")
        errs, ok = {}, True
        for name, g, w in zip(names, got, want):
            if w is None:
                continue
            rtol, at = (2e-5, 0.0) if name == "logp" else (3e-4, atol)
            err = (g.double() - w).abs()
            ok &= bool(torch.isfinite(g).all()) and bool((err <= at + rtol * w.abs()).all())
            errs[name] = float(err.max())
        return {"ok": ok, "abs_err": errs}

    out = {"root": root, "checks": {}, "timed": []}
    if args.check:
        for j, (n, c) in enumerate(CHECK_SIZES):
            for i, (kind, d, k) in enumerate(CHECK_SHAPES):
                arrays, fn, ref = inputs(kind, n, d, c, k, 100 + i + 50 * j)
                out["checks"][f"{kind}_d{d}" + (f"_k{k}" if k else "") + f"_n{n}_c{c}"] = hold(kind, fn, ref, arrays)
                del arrays
    for i, (kind, d, k, c) in enumerate(SHAPES):
        arrays, fn, ref = inputs(kind, N, d, c, k, 700 + d + (k or 0) + c)
        plan = glm_fused.glm_tile_plan(N, d, c, sms, kcat=k)
        before = counts()
        ms, reps = median_ms(lambda: fn(*arrays))
        seen_calls = seen(before, counts())
        check = hold(kind, fn, ref, arrays) if args.check else None
        x, beta = arrays[1], arrays[-2] if kind == "ordered" else arrays[3]
        x1 = torch.cat([x, torch.ones_like(x[:, :1])], dim=1)
        products_ms, products_reps = median_ms(lambda: x1.mT @ (x @ beta))
        kernels = {}
        if args.profile:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn(*arrays)
                torch.cuda.synchronize()
            for ev in prof.key_averages():
                us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
                if us and ("kernel" in ev.key.lower() or "reduce" in ev.key.lower()):
                    kernels[ev.key[:90]] = {"ms": us / 1e3, "count": ev.count}
        del x1
        flops = 4.0 * N * d * c
        core = float(ORDERED_CORE_OPS if kind == "ordered" else CORE_OPS[kind]) * N * c
        if kind == "ordered":
            nbytes = 4.0 * (N + N * d + d * c + (k - 1) * c) + 4.0 * (c + d * c + (k - 1) * c)
        else:
            nbytes = 4.0 * (N * d + N + 2 * d * c + 3 * c + (2 * c if glm_fused.HAS_EXTRA[kind] else 0))
        out["timed"].append({
            "kind": kind, "d": d, "k": k, "n": N, "c": c, "route": plan["route"], "kernel": plan.get("kernel"),
            "plan": {key: v for key, v in plan.items() if isinstance(v, (int, str))}, "calls_counted": seen_calls,
            "ms": ms, "reps_ms": reps, "check": check, "kernels": kernels, "products_ms": products_ms, "products_reps_ms": products_reps,
            "bound_tf32x3_ms": max(3.0 * flops / PEAK_TF32_FLOPS, core / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3,
            "bound_fp32_ms": max((flops + core) / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3,
            "bound_bytes_ms": nbytes / PEAK_BYTES * 1e3,
        })
        del arrays, x, beta
        torch.cuda.empty_cache()
    out["narrow_products"] = []
    for n, d, c in NARROW_PRODUCTS:
        gen = torch.Generator(device="cuda").manual_seed(n + d + c)
        x = torch.randn((n, d), generator=gen, device="cuda")
        beta = 0.1 * torch.randn((d, c), generator=gen, device="cuda")
        x1 = torch.cat([x, torch.ones_like(x[:, :1])], dim=1)
        products_ms, products_reps = median_ms(lambda: x1.mT @ (x @ beta))
        out["narrow_products"].append({"n": n, "d": d, "c": c, "products_ms": products_ms, "products_reps_ms": products_reps})
        del x, beta, x1
    out["ptxas"] = _build.BUILD_LOG.get("glm_fused", "")
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
