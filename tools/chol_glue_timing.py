#!/usr/bin/env python3
"""Time the blocked Cholesky's glue at the GP path's shape on the GPU.

Run from the repository root on a machine with one GPU and nvcc:

    python3 tools/chol_glue_timing.py [--root DIR]

``--root`` is the checkout whose ``math_tpu_torch`` is timed (default: the
one holding this script), so that two trees can be compared in one call
(parent, change, change, parent).  At ``gp_path``'s shape (32 chains, n =
2000, float32, block size 128) it times, with CUDA events over back-to-back
calls:

- ``value_and_grad_ms``: value and gradient of the marginal GP density
  (``gp_path``'s ``blocked_kernel_path``);
- ``forward_ms``: ``cholesky_solve_logdiag`` without a gradient (the blocked
  factorization and the forward substitution).

Where the tree holds two block factorizations (``_chol_blocked_impl`` with
the substitution ``_lower_solve_blocks``, writing into one allocation, and
``_chol_parts_fn`` with ``_lower_solve_fn``, out of place), it times both
measures with the forward of ``ops/chol_blocked.py``'s Functions taken by
each pair, in the order in-place, out-of-place, out-of-place, in-place.
Prints one JSON line, then the card's name and power limit.  ``--device
cpu --n 300 --chains 4`` rehearses it on the CPU (times are then the host's).
"""

import argparse
import json
import os
import subprocess
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--chains", type=int, default=32)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no GPU: nothing timed", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from math_tpu_torch.models import gp_regression
    from math_tpu_torch.ops import chol_blocked as cb

    dev, dtype = args.device, torch.float32
    x, y = gp_regression.synthetic_data(args.n, seed=0)
    model = gp_regression.make_marginal(args.n, jitter=1e-3)
    xt, yt = (torch.tensor(a, dtype=dtype, device=dev) for a in (x, y))
    rng = np.random.default_rng(0)
    z = torch.tensor(np.log([1.0, 1.0, 0.3]) + 0.1 * rng.normal(size=(args.chains, 3)), dtype=dtype, device=dev)
    a = torch.tensor(rng.normal(size=(args.chains, args.n, args.n // 2)), dtype=dtype, device=dev)
    a = a @ a.mT / args.n + torch.eye(args.n, dtype=dtype, device=dev)
    b = torch.tensor(rng.normal(size=(args.chains, args.n)), dtype=dtype, device=dev)

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    def time_ms(fn, warmup=3):
        for _ in range(warmup):
            fn()
        sync()
        if dev != "cuda":
            t0 = time.perf_counter()
            for _ in range(args.reps):
                fn()
            return (time.perf_counter() - t0) / args.reps * 1e3
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        sync()
        return start.elapsed_time(end) / args.reps

    def measures():
        with torch.no_grad():
            fwd = time_ms(lambda: cb.cholesky_solve_logdiag(a, b))
        vg = time_ms(lambda: model.logp_and_grad(z, xt, yt))
        return {"value_and_grad_ms": vg, "forward_ms": fwd}

    out = {"root": root, "shape": [args.chains, args.n, args.n], "dtype": "float32",
           "block_size": cb.get_config().cholesky_block_size, "device": dev, "reps": args.reps}
    pairs = all(hasattr(cb, f) for f in ("_chol_blocked_impl", "_lower_solve_blocks", "_chol_parts_fn", "_lower_solve_fn"))
    if not pairs:
        out.update(measures())
    else:
        in_place = (cb._chol_blocked_impl, cb._lower_solve_blocks)
        out_of_place = (lambda flat, B: cb._chol_parts_fn(flat, B), cb._lower_solve_fn)
        runs = {"in_place": [], "out_of_place": []}
        for name, (impl, solve) in (("in_place", in_place), ("out_of_place", out_of_place),
                                    ("out_of_place", out_of_place), ("in_place", in_place)):
            cb._chol_blocked_impl, cb._lower_solve_blocks = impl, solve
            runs[name].append(measures())
        with torch.no_grad():
            got = {}
            for name, (impl, solve) in (("in_place", in_place), ("out_of_place", out_of_place)):
                cb._chol_blocked_impl, cb._lower_solve_blocks = impl, solve
                got[name] = cb.cholesky_solve_logdiag(a, b)
        cb._chol_blocked_impl, cb._lower_solve_blocks = in_place
        out["by_forward_pair"] = runs
        out["pairs_max_abs_diff"] = [float((u - v).abs().max()) for u, v in zip(got["in_place"], got["out_of_place"])]
        out.update(runs["in_place"][0])
    with torch.no_grad():
        y_f, s_f = cb.cholesky_solve_logdiag(a, b)
    out["forward_finite"] = bool(torch.isfinite(y_f).all() and torch.isfinite(s_f).all())
    print(json.dumps(out), flush=True)
    if dev == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
