#!/usr/bin/env python3
"""Time the Lotka-Volterra RK4 kernels of two trees, parent against change, and their second orders.

Run from the repository root on a machine with one GPU and nvcc:

    python3 tools/lv_timing.py --check
    python3 tools/lv_timing.py --parent-root DIR [--out FILE]

``--check`` runs ``chip_smoke.py``'s ``kernels_lv`` (every LV kernel against
its plain version, with its gates) and ``lv_second_order`` (``functional.hessian``
and ``laplace_sample`` at the JAX package's posterior mode, float32, with its
gates) on this tree, and nothing else.

``--parent-root DIR`` is a checkout of the parent commit (``git archive
<parent> | tar -x -C DIR`` where the history is at hand; the machine with the
card has none).  The tool builds the parent's ``csrc/lv_rk4.cu`` and this
tree's into two libraries, binds each by its own C interface, and times both
in one process, parent, change, change, parent, at C = 512, T = 20, S = 24
(the sampler's chains) and at the lane counts of ``laplace_sample`` on the LV
model (300: the draws' log densities; 8: the Hessian's lanes; 1: the L-BFGS):
for the forward, the adjoint and the pair (the parent's forward has no
states; this tree's keeps them), the device time of each kernel from
``torch.profiler`` (20 calls), CUDA events over 50 back-to-back calls, and
chain 0's cycles a step from the kernels' stamps (median of 5); this tree's
dual forward and dual adjoint alike.  The two trees' results on the same
inputs are compared (``ys`` bit for bit, the gradients' largest error over
the largest value).  Then, in a process of its own for each tree (parent,
change, change, parent), a short ``lv_path`` (512 chains, 20 + 10) and
``profile_lv`` over 5 transitions (device time a gradient call, the pair's
share), ``functional.hessian`` at the posterior mode (its first call and a
second), and ``laplace_sample`` (300 draws) from there, each with its
seconds, kernel launches and plain calls; the first run of this tree also
times both through the plain route (``lv_rk4_plain`` on CUDA tensors).
Prints one JSON line (``--out`` writes it to a file too), then the card's
name and power limit.  Exits 2 without a GPU.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

HERE = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
LANES = (512, 300, 8, 1)
REPS_EVENTS, REPS_PROFILE = 50, 20


def smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def build_pair(parent_root):
    """``{"parent": CDLL, "change": CDLL}``: each tree's ``lv_rk4.cu`` by one
    ``nvcc`` (started together) into the build directory."""
    from math_tpu_torch.config import get_config
    from math_tpu_torch.ops import _build

    out_dir = os.path.join(get_config().kernel_build_dir, "lv_timing")
    os.makedirs(out_dir, exist_ok=True)
    sources = {"parent": os.path.join(parent_root, "math_tpu_torch", "csrc", "lv_rk4.cu"),
               "change": os.path.join(HERE, "math_tpu_torch", "csrc", "lv_rk4.cu")}
    procs = {}
    for tag, src in sources.items():
        lib = os.path.join(out_dir, f"liblv_rk4_{tag}.so")
        procs[tag] = (lib, subprocess.Popen([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for tag, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {sources[tag]}:\n{log}")
        libs[tag] = ctypes.CDLL(lib)
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name, argtypes in (("lv_rk4_forward_f32", [P] * 3 + [D] + [I] * 3 + [P] * 3),
                           ("lv_rk4_adjoint_f32", [P] * 3 + [D] + [I] * 3 + [P] * 7)):
        getattr(libs["parent"], name).argtypes = argtypes
    from math_tpu_torch.ops import lv_rk4

    for name, argtypes in lv_rk4._ARGTYPES.items():
        getattr(libs["change"], f"{name}_f32").argtypes = argtypes
    for lib in libs.values():
        for name in ("lv_rk4_forward_f32", "lv_rk4_adjoint_f32"):
            getattr(lib, name).restype = ctypes.c_int
    return libs


def kernel_timing(parent_root):
    """The in-process part: both trees' kernels at every lane count, parent,
    change, change, parent."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, HERE)
    import chip_smoke
    from math_tpu_torch.ops import lv_rk4

    libs = build_pair(parent_root)
    ts = chip_smoke.lotka_volterra.synthetic_data(chip_smoke.LV_TIMES)[0]
    nt, steps = chip_smoke.LV_TIMES, chip_smoke.LV_STEPS
    n_steps = nt * steps

    def ok(err, what):
        if err != 0:
            raise RuntimeError(f"{what}: CUDA error {err}")

    def launches(c, seed):
        """``{tree: {kernel: launch(stamps or None)}}`` and the outputs to compare."""
        z0, theta, gbar = chip_smoke.lv_kernel_inputs(c, nt, seed=seed)
        tz0, tth, tg = chip_smoke.lv_tangents(c, nt, seed=seed + 1)
        z, th, g, tz, tt, tgt = (torch.tensor(a, dtype=torch.float32, device="cuda") for a in (z0, theta, gbar, tz0, tth, tg))
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        tsd = torch.tensor(ts, dtype=torch.float32, device="cuda")
        hs = torch.tensor(lv_rk4._step_sizes(0.0, ts, torch.float32, steps), dtype=torch.float32, device="cuda")
        p_ys, p_zb, p_tb = torch.empty((c, nt, 2), device="cuda"), torch.empty((c, 2), device="cuda"), torch.empty((c, 4), device="cuda")
        scratch = torch.empty((steps, c, 2), device="cuda")
        c_ys, c_zb, c_tb = torch.empty_like(p_ys), torch.empty_like(p_zb), torch.empty_like(p_tb)
        states = torch.empty((n_steps, c, 2), device="cuda")
        d_ys, d_tys, d_zb, d_tzb, d_tb, d_ttb = (torch.empty_like(t) for t in (p_ys, p_ys, p_zb, p_zb, p_tb, p_tb))
        dstates = torch.empty((n_steps, c, 2, 2), device="cuda")
        ptr = lambda st: None if st is None else st.data_ptr()  # noqa: E731
        P, C = libs["parent"], libs["change"]
        fns = {
            "parent": {
                "forward": lambda st=None: ok(P.lv_rk4_forward_f32(z.data_ptr(), th.data_ptr(), tsd.data_ptr(), 0.0, c, nt, steps,
                                                                   p_ys.data_ptr(), ptr(st), stream()), "parent forward"),
                "adjoint": lambda st=None: ok(P.lv_rk4_adjoint_f32(z.data_ptr(), th.data_ptr(), tsd.data_ptr(), 0.0, c, nt, steps,
                                                                   p_ys.data_ptr(), g.data_ptr(), scratch.data_ptr(), p_zb.data_ptr(),
                                                                   p_tb.data_ptr(), ptr(st), stream()), "parent adjoint"),
            },
            "change": {
                "forward": lambda st=None: ok(C.lv_rk4_forward_f32(z.data_ptr(), th.data_ptr(), hs.data_ptr(), c, nt, steps,
                                                                   c_ys.data_ptr(), states.data_ptr(), ptr(st), stream()), "forward"),
                "adjoint": lambda st=None: ok(C.lv_rk4_adjoint_f32(th.data_ptr(), hs.data_ptr(), c, nt, steps, states.data_ptr(),
                                                                   g.data_ptr(), c_zb.data_ptr(), c_tb.data_ptr(), ptr(st), stream()),
                                              "adjoint"),
                "dual_forward": lambda st=None: ok(C.lv_rk4_dual_forward_f32(
                    z.data_ptr(), tz.data_ptr(), th.data_ptr(), tt.data_ptr(), hs.data_ptr(), c, nt, steps, d_ys.data_ptr(),
                    d_tys.data_ptr(), dstates.data_ptr(), ptr(st), stream()), "dual forward"),
                "dual_adjoint": lambda st=None: ok(C.lv_rk4_dual_adjoint_f32(
                    th.data_ptr(), tt.data_ptr(), hs.data_ptr(), c, nt, steps, dstates.data_ptr(), g.data_ptr(), tgt.data_ptr(),
                    d_zb.data_ptr(), d_tzb.data_ptr(), d_tb.data_ptr(), d_ttb.data_ptr(), ptr(st), stream()), "dual adjoint"),
            },
        }
        return fns, {"parent": (p_ys, p_zb, p_tb), "change": (c_ys, c_zb, c_tb), "dual": (d_ys, d_zb, d_tb)}

    def events_ms(fn, reps=REPS_EVENTS):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def device_ms(fns):
        """Device time a call of each kernel of ``fns``, from one profile of
        REPS_PROFILE calls of each in turn."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for fn in fns.values():
                for _ in range(REPS_PROFILE):
                    fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        out = {}
        for name in fns:
            kernel = "lv_rk4_" + name.replace("dual_", "") + "_kernel<"
            dual = name.startswith("dual")
            sel = [e for e in rows if kernel in e.key and ("Dual<" in e.key) == dual]
            n = sum(e.count for e in sel)
            if n == 0:
                raise RuntimeError(f"{name}: the profiler saw no launch; its kernels: {[(e.key[:80], e.count) for e in rows]}")
            out[name] = sum(chip_smoke.dev_us(e) for e in sel) / 1e3 / n
            out[name + "_profiled_launches"] = n
        return out

    def stamps(fn, reps=5):
        rows = []
        for _ in range(reps):
            st = torch.zeros(4, dtype=torch.int64, device="cuda")
            fn(st)
            rows.append(st.cpu().tolist())
        cycles = float(np.median([r[1] - r[0] for r in rows]))
        ns = float(np.median([r[3] - r[2] for r in rows]))
        return {"cycles_per_step": cycles / n_steps, "chain_ms": ns / 1e6, "ghz": cycles / ns}

    def one_round(tree, fns):
        kf = fns[tree]
        out = {k: {"events_ms": events_ms(fn), "stamps": stamps(fn)} for k, fn in kf.items()}
        out["pair_events_ms"] = events_ms(lambda: (kf["forward"](), kf["adjoint"]()))
        for k, ms in device_ms(kf).items():
            if k in out:
                out[k]["device_ms"] = ms
            else:
                out[k.replace("_profiled_launches", "")]["profiled_launches"] = ms
        out["pair_device_ms"] = out["forward"]["device_ms"] + out["adjoint"]["device_ms"]
        return out

    result = {}
    for c in LANES:
        fns, outs = launches(c, seed=900 + c)
        rounds = [(tree, one_round(tree, fns)) for tree in ("parent", "change", "change", "parent")]
        for tree in ("parent", "change"):
            fns[tree]["forward"]()
            fns[tree]["adjoint"]()
        fns["change"]["dual_forward"]()
        fns["change"]["dual_adjoint"]()
        torch.cuda.synchronize()
        (p_ys, p_zb, p_tb), (c_ys, c_zb, c_tb), (d_ys, d_zb, d_tb) = outs["parent"], outs["change"], outs["dual"]
        err = lambda a, b: float((a.double() - b.double()).abs().max() / b.double().abs().max())  # noqa: E731
        result[str(c)] = {
            "rounds": [{"tree": t, **r} for t, r in rounds],
            "ys_equal": bool(torch.equal(c_ys, p_ys)), "dual_ys_equal": bool(torch.equal(d_ys, c_ys)),
            "z0bar_err": err(c_zb, p_zb), "thetabar_err": err(c_tb, p_tb),
            "dual_z0bar_err": err(d_zb, c_zb), "dual_thetabar_err": err(d_tb, c_tb),
        }
        del fns, outs
    return result


def second_order(root, plain_route):
    """The part run in a process of its own for the tree at ``root``."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke
    from math_tpu_torch import functional
    from math_tpu_torch.infer import laplace_sample
    from math_tpu_torch.ops import lv_rk4

    from math_tpu_torch.ops import chol_blocked

    out = {"root": root}
    t0 = time.perf_counter()
    lv_rk4._library()
    chol_blocked._library()  # laplace_sample's precision factor (B4): built before anything is timed
    out["build_s"] = time.perf_counter() - t0
    lv_rk4.reset_counts()
    res, wall, model, args, _ = chip_smoke.drive_lv(num_warmup=20, num_samples=10)
    out["lv_path_short"] = {"wall_s": wall, "grad_calls": res.n_grad_calls, "ms_per_grad_call": wall / res.n_grad_calls * 1e3,
                            "launches": dict(lv_rk4.LAUNCHES), "plain_calls": dict(lv_rk4.PLAIN_CALLS)}
    kernels, total_us, calls = chip_smoke.phase_profile(res, model, args, label="profile_lv")
    pair_us = sum(chip_smoke.dev_us(e) for e in kernels if "lv_rk4" in e.key)
    out["profile_lv"] = {"device_ms_per_grad_call": total_us / 1e3 / calls, "pair_device_ms_per_grad_call": pair_us / 1e3 / calls,
                         "pair_share": pair_us / total_us, "traced_grad_calls": calls}
    y = args[0]
    mode = chip_smoke.LV_REFERENCE_MODE
    z = torch.tensor(np.concatenate([np.log(mode["theta"]), np.log(mode["z0"]), np.log([0.25, 0.25])]), dtype=torch.float32,
                     device="cuda")
    routes = [("kernels", None)]
    if plain_route:
        routes.append(("plain", lambda z0, t0, ts, theta, s: lv_rk4.lv_rk4_plain(z0, t0, ts, theta, s)))
    kernel_route = lv_rk4.lv_rk4
    for route, replace in routes:
        lv_rk4.lv_rk4 = replace or kernel_route
        f = lambda q: model.logp(q[None], y)[0]  # noqa: E731
        runs = []
        for _ in range(2):
            lv_rk4.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, h = functional.hessian(f, z)
            torch.cuda.synchronize()
            runs.append({"seconds": time.perf_counter() - t0, "launches": dict(lv_rk4.LAUNCHES),
                         "plain_calls": dict(lv_rk4.PLAIN_CALLS), "finite": bool(torch.isfinite(h).all())})
        lv_rk4.reset_counts()
        t0 = time.perf_counter()
        lap = laplace_sample(model.logp, torch.Generator(device="cuda").manual_seed(0), model.dim, 300, args=(y,), init=z,
                             dtype=z.dtype, device="cuda")
        torch.cuda.synchronize()
        out[route] = {"hessian_first": runs[0], "hessian_second": runs[1],
                      "laplace": {"seconds": time.perf_counter() - t0, "launches": dict(lv_rk4.LAUNCHES),
                                  "plain_calls": dict(lv_rk4.PLAIN_CALLS), "lbfgs_grad_calls": int(lap.opt.num_grad_calls),
                                  "finite": bool(torch.isfinite(lap.log_p).all())}}
    lv_rk4.lv_rk4 = kernel_route
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent-root", default=None)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--second-order-root", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--plain-route", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no GPU: nothing timed", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.second_order_root:
        print(json.dumps({"second_order": second_order(os.path.abspath(args.second_order_root), args.plain_route)}), flush=True)
        return
    sys.path.insert(0, HERE)
    if args.check:
        import numpy as np

        import chip_smoke
        from math_tpu_torch.ops import lv_rk4

        from math_tpu_torch.ops import chol_blocked

        lv_rk4._library()
        chol_blocked._library()
        chip_smoke.phase_kernels_lv()
        mode = chip_smoke.LV_REFERENCE_MODE
        z = torch.tensor(np.concatenate([np.log(mode["theta"]), np.log(mode["z0"]), np.log([0.25, 0.25])]),
                         dtype=torch.float32, device="cuda")
        y = torch.tensor(chip_smoke.lotka_volterra.synthetic_data(chip_smoke.LV_TIMES)[1], dtype=torch.float32, device="cuda")
        chip_smoke.phase_lv_second_order(z, y)
        print(smi(), flush=True)
        return
    if not args.parent_root:
        ap.error("--parent-root DIR (a checkout of the parent commit) or --check")
    parent_root = os.path.abspath(args.parent_root)
    out = {"device": torch.cuda.get_device_name(0), "parent_root": parent_root, "kernels": kernel_timing(parent_root)}
    out["second_order"] = []
    for i, root in enumerate((parent_root, HERE, HERE, parent_root)):
        cmd = [sys.executable, os.path.abspath(__file__), "--second-order-root", root] + (["--plain-route"] if i == 1 else [])
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=root)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"second_order"')]
        if proc.returncode != 0 or not lines:
            raise RuntimeError(f"the second-order run of {root} failed ({proc.returncode}):\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        out["second_order"].append({"tree": "parent" if root == parent_root else "change", **json.loads(lines[-1])["second_order"]})
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(line + "\n")
    print(line, flush=True)
    print(smi(), flush=True)


if __name__ == "__main__":
    main()
