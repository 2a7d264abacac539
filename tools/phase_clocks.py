#!/usr/bin/env python3
"""Where the time of the hand kernels goes, from clock64() reads on the GPU.

Run from the repository root on a machine with one GPU and nvcc:

    python3 tools/phase_clocks.py

It builds, next to the port's kernels (``get_config().kernel_build_dir``):

- ``tools/wgmma_layout_probe.cu`` and runs it: the register and shared-memory
  layouts of ``csrc/tf32x3.cuh``, the accuracy of one and of three TF32
  products, and the bulk copy;
- a copy of ``csrc/glm_categorical.cu`` with a clock read by thread 0 of block
  (0, 0) between the phases of each row tile (wait for the tile, product 1,
  eta to shared memory, softmax, lp sums, product 2, the barrier at the top of
  the next tile), run at the categorical path's shape (N=100,000, D=50,
  C=256, K=5); printed as clocks per tile;
- a copy of ``csrc/glm_fused.cu`` with a clock read by thread 0 of block
  (0, 0) between the phases of each row tile of the tensor-core kernels
  (the barrier at the top of the tile, wait for the tile, the x layouts,
  product 1, the core, the tile sums, product 2), run for kernel 1
  (bernoulli-logit, and normal-id, whose core is the cheapest) at the main
  path's shape (N=100,000, D=50, C=256) and for the ordered kernel (K=5) at
  the ordinal path's; the time of each beside the tiled route's (the kernels
  that take the shapes glm_tc_kernel cannot hold) on the same inputs, there
  and at 32 chains (a block of 128 chains then holds one pair of warpgroups
  with no chains);
- a copy of ``csrc/chol_inv_block.cu`` with a clock read by thread 0 of block
  0 between its stages, run on a Schur block of the GP path (Cb=32, B=128);
  printed as clocks per launch;
- ``tools/chol_inv_block_columnwise.cu``, the column-by-column block kernel the
  panelled one replaced, with its load / factor / inverse / store stamps on
  the same blocks;
- a copy of ``csrc/glm_categorical.cu`` with a clock read by thread 0 of
  block (0, 0, 0) between the phases of the tiled pair's two kernels
  (launch 1: the slices' wait / product / barrier / request, the window's
  alpha barrier, eta to shared memory, the sweep; launch 2: the same slices,
  the tile's lse wait, theta', the window wait, product 2, the barrier at
  the tile's end), run once at each of the four timed wide shapes (N =
  100,000, C = 256); printed as clocks per row tile of that block, with its
  windows and slices.  ``--tiled`` runs this alone;
- ``--wide`` (alone): a copy of ``csrc/glm_fused.cu`` with a clock read by
  thread 0 of block (0, 0, 0) (warp 0 of the first consumer warpgroup)
  between the phases of B1 / B2's tiled route (launch 1: per slice the wait
  for its stage, the products, the release and the adds; per row tile the
  core, its sums and theta' out; launch 2: per chunk the wait, the A
  fragments, the products, the release and the adds), run at the six timed
  wide shapes (N = 100,000, C = 256: bernoulli-logit and poisson-log at D =
  282 and 1,024, the ordered GLM at (236, 5) and (1024, 12)); printed as
  clocks per row tile (launch 1) and per chunk (launch 2) of that block,
  beside the device time of each of the five launches of one call
  (``torch.profiler``).

Each result is one JSON line; the last line is the card's name and power
limit.  Measurement only: nothing of the port calls these copies.
"""

import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from math_tpu_torch import get_config  # noqa: E402
from math_tpu_torch.models import glm_logistic, gp_regression  # noqa: E402
from math_tpu_torch.ops import _build, glm_fused  # noqa: E402

CSRC = os.path.join(ROOT, "math_tpu_torch", "csrc")
OUT = os.path.join(get_config().kernel_build_dir, "probes")
PROF = (
    "__device__ long long g_prof[16];\n"
    "#define PROF(i) if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0) "
    "{ long long now_ = clock64(); g_prof[i] += now_ - last_; last_ = now_; }\n"
)
READ = (
    '\nextern "C" void prof_read(long long* out) { cudaMemcpyFromSymbol(out, g_prof, 16 * sizeof(long long)); }\n'
    'extern "C" void prof_reset() { long long z[16] = {0}; cudaMemcpyToSymbol(g_prof, z, sizeof(z)); }\n'
)

# (anchor, the phase that ends there or None for the first read) for each
# copy; a clock read goes just before its anchor
CATEGORICAL = [
    ("    for (int it = 0;; ++it) {", None),
    ("        const float* xs = xring + (size_t)s * TM * d;", "top_barrier"),
    ("        // --- product 1: eta", "wait_for_tile"),
    ("        // eta + alpha into the theta' buffer", "product_1"),
    ("        // --- lp and theta' of each", "eta_to_shared"),
    ("        // the tile's lp, per chain in float", "softmax"),
    ("        // --- product 2:", "lp_sums"),
    ("        fence_proxy_async();  // theta' is written again", "product_2"),
]
GLM_TC = [
    ("    for (int it = 0;; ++it) {\n        const int tile = blockIdx.x + it * gridDim.x;\n        if (tile >= n_tiles) break;\n"
     "        const int r0 = tile * 64;", None),
    ("        if (tile < full_tiles) {\n            mbar_wait(bar, (uint32_t)(it & 1));", "top_barrier"),
    ("        // --- the x tile into both layouts", "wait_for_tile"),
    ("        // --- product 1: eta^T", "x_layouts"),
    ("        // --- the core on the accumulator", "product_1"),
    ("        // the tile's sums per chain and half", "core"),
    ("        // --- product 2: [gb; ga]^T", "tile_sums"),
    ("        fence_proxy_async();  // the x layouts are written again", "product_2"),
]
BLOCK = [
    ("    // --- factor: d = U^T U, by panels of P columns", None),
    ("        const int t0 = k0 + kb;  // first trailing row / column", "diagonal_blocks"),
    ("        // 2. the panel's row block", "barrier_after_diagonal"),
    ("        // 3. trailing update of the upper triangle", "panel_row_blocks"),
    ("    }\n    __syncthreads();\n    stamp(stamps, 2);", "trailing_updates"),
    ("    // off-diagonal row panels, bottom up", "diagonal_inverses"),
    ("        // rows i0 .. i0+P-1 of W beyond the panel", "products_T"),
    ("    }\n    stamp(stamps, 3);", "back_substitutions"),
]


def instrument(src, anchors, slots=16):
    """The source with a clock read before each anchor; the names of the phases."""
    text = open(os.path.join(CSRC, src)).read()
    head = text.index("namespace {")
    text = text[:head] + PROF.replace("[16]", f"[{slots}]") + text[head:]
    names = []
    for anchor, name in anchors:
        if anchor not in text:
            raise RuntimeError(f"{src}: anchor not found: {anchor!r}")
        indent = anchor[: len(anchor) - len(anchor.lstrip())]
        if name is None:
            read = f"{indent}long long last_ = clock64();\n"
        else:
            read = f"{indent}PROF({len(names)})\n"
            names.append(name)
        text = text.replace(anchor, read + anchor, 1)
    return text + READ.replace("16 * sizeof", f"{slots} * sizeof").replace("z[16]", f"z[{slots}]"), names


def nvcc(src, out, shared=True):
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-I", CSRC]
    flags += ["-shared", "-Xcompiler", "-fPIC"] if shared else []
    return subprocess.Popen([_build.find_nvcc(), *flags, "-o", out, src], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def finish(proc, what):
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {what}:\n{out}")


def read_clocks(lib, names, per):
    buf = (ctypes.c_longlong * 16)()
    lib.prof_read(buf)
    return {name: buf[i] / per for i, name in enumerate(names)}


def glm_tc_clocks(names, reps=5):
    """Kernel 1 (bernoulli-logit, and normal-id, the family with the cheapest
    core) and the ordered kernel (K=5) on the tensor cores at the main shape:
    the stamped copy's time and the tiled route's on the same inputs, the
    clocks per tile of block (0, 0); then, at 32 chains, the port's kernel
    (through its wrapper) against the tiled route."""
    n, d, c, k = cs.N_MAIN, cs.K_MAIN, cs.C_MAIN, cs.K_CAT
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    x = glm_logistic.synthetic_data(n, d)[0]
    fam = cs.on_gpu(cs.make_inputs("bernoulli_logit", n, d, c, seed=200, scale=0.1, x=x), torch.float32)
    y_o, *floats_o = cs.ordered_inputs(n, d, c, k, seed=521, scale=0.1, x=x)
    y_o, x_o, beta_o, cuts_o = cs.with_y(y_o, floats_o, torch.float32)
    lib = ctypes.CDLL(os.path.join(OUT, "libglm_tc_clocks.so"))
    main_lib = glm_fused._library()
    lib.glm_tc_launch.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    nid = cs.on_gpu(cs.make_inputs("normal_id", n, d, c, seed=202, scale=0.1, x=x), torch.float32)
    kernels = {
        "bernoulli_logit": (0, 0, fam[0], fam[1], fam[2], fam[3], None, d + 3, None),
        "normal_id": (2, 0, nid[0], nid[1], nid[2], nid[3], nid[4], d + 3, None),
        "ordered_logistic": (glm_fused.ORDERED_KIND, k, y_o, x_o, None, beta_o, cuts_o, d + k, k),
    }
    stream = torch.cuda.current_stream().cuda_stream

    def tiled_ms(kind, kcat, yy, xx, aa, bb, ee, rows, cc):
        """The tiled route (the kernels that take the shapes glm_tc_kernel
        cannot hold) on the first ``cc`` chains of the same inputs."""
        plan = glm_fused.glm_tiled_plan(n, d, cc, sms)
        return cs.time_ms(lambda: glm_fused._launch_tiled("phase_clocks", kind, kcat, plan, yy, xx, aa, bb, ee, rows),
                          warmup=3, reps=20)

    for label, (kind, kcat, yy, xx, aa, bb, ee, rows, kplan) in kernels.items():
        plan = glm_fused.glm_tile_plan(n, d, c, sms, kcat=kplan)
        out = torch.empty((rows, c), device="cuda")
        part = torch.empty((plan["row_blocks"], rows, c), device="cuda")

        def launch():
            err = lib.glm_tc_launch(kind, kcat, yy.data_ptr(), xx.data_ptr(), None if aa is None else aa.data_ptr(),
                                    bb.data_ptr(), None if ee is None else ee.data_ptr(), part.data_ptr(), out.data_ptr(),
                                    n, d, c, plan["row_blocks"], stream)
            if err != 0:
                raise RuntimeError(f"{label} copy: CUDA error {err}")

        ms = cs.time_ms(launch, warmup=3, reps=20)
        lib.prof_reset()
        for _ in range(reps):
            launch()
        torch.cuda.synchronize()
        tiles = reps * len(range(0, -(-n // 64), plan["row_blocks"]))
        clocks = read_clocks(lib, names, tiles)
        print(json.dumps({"phase": "glm_tc_clocks", "kernel": label, "shape": {"n": n, "d": d, "c": c, "k": kplan},
                          "plan": plan, "ms_with_clocks": ms,
                          "tiled_route_ms": tiled_ms(kind, kcat, yy, xx, aa, bb, ee, rows, c),
                          "clocks_per_tile_of_block_0": clocks,
                          "total": sum(clocks.values())}), flush=True)

        # 32 chains: the port's kernel (half of each block without chains)
        # against the tiled route
        small = 32
        aa_s, bb_s = None if aa is None else aa[:small].contiguous(), bb[:, :small].contiguous()
        ee_s = None if ee is None else (ee[:small] if ee.ndim == 1 else ee[:, :small]).contiguous()
        if kplan is None:
            fam_name = glm_fused.FAMILIES[kind]
            tc = lambda: glm_fused.glm_fused_parts(fam_name, yy, xx, aa_s, bb_s, ee_s)  # noqa: E731
        else:
            tc = lambda: glm_fused.ordered_logistic_glm_parts(yy, xx, bb_s, ee_s)  # noqa: E731
        small_plan = glm_fused.glm_tile_plan(n, d, small, sms, kcat=kplan)
        tc_ms = cs.time_ms(tc, warmup=3, reps=20)
        print(json.dumps({"phase": "glm_tc_small_chains", "kernel": label,
                          "shape": {"n": n, "d": d, "c": small, "k": kplan}, "plan": small_plan,
                          "tensor_core_ms": tc_ms, "tiled_route_ms": tiled_ms(kind, kcat, yy, xx, aa_s, bb_s, ee_s, rows, small)}),
              flush=True)


# The tiled categorical pair: launch 1 (categorical_lse_kernel), then launch 2
# (categorical_grad_kernel<MT>); anchors written with their leading newline
# and indent where a shorter indent would match the other kernel first.
TILED = [
    ("    RingPlace at(LSE_STAGES);", None),
    ("        for (int w = 0; w < nwin; ++w) {", "l_tile_end_and_start"),
    ("            // the window's alpha (the previous window's epilogue", "l_sweep"),
    ("            float eta[20];\n#pragma unroll\n            for (int e = 0; e < 20; ++e) eta[e] = 0.0f;\n", "l_window_start"),
    ("\n                mbar_wait(&bars[at.st], at.parity);", "l_slice_top"),
    ("\n                const float* stage = reinterpret_cast<const float*>(ring + at.st * STAGE_BYTES);", "l_wait"),
    ("\n                started = true;\n                __syncthreads();  // every thread is done with the stage (and", "l_product_and_request"),
    ("\n                at.next();\n            }\n            cp_async_wait_all();", "l_slice_barrier"),
    ("            float a[10];  // alpha of this thread's ten columns", "l_alpha_barrier"),
    ("            // the (row, chain segment) sweep", "l_eta_to_shared"),
    ("        __syncthreads();\n        // lse, and lp of each (chain, row), masked past N", "l_sweep_last"),
    ("    RingPlace at(stages);", None),
    ("        // --- product 1: eta = x_tile @ beta_tile, a slice at a time", "g_tile_top_and_whole_x"),
    ("\n            mbar_wait(&bars[at.st], at.parity);", "g_slice_top"),
    ("\n            const float* stage = reinterpret_cast<const float*>(ring + at.st * RING_STAGE);", "g_wait"),
    ("\n            started = true;\n            __syncthreads();  // every thread is done with the stage\n", "g_product_1_and_request"),
    ("\n            at.next();\n        }\n        cp_async_wait_all();", "g_slice_barrier"),
    ("        // --- theta' = onehot(y)", "g_lse_wait"),
    ("\n        fence_proxy_async();  // theta' is read by wgmma next\n        __syncthreads();\n        if (!WHOLE_X", "g_thetap_math"),
    ("        if (!WHOLE_X && wsl > 0) mbar_wait(wbar, (uint32_t)(it & 1));", "g_thetap_fence"),
    ("        // --- product 2: the group's rows", "g_window_wait"),
    ("        fence_proxy_async();  // theta' and the window are written again for the next tile", "g_product_2"),
    ("        if (tid == 0) request_window(it + 1);", "g_tile_end"),
]


# B1 / B2's tiled route: launch 1 (value_kernel), then launch 2 (grad_kernel)
WIDE = [
    ("    RingPlace at(STAGES);\n    for (int it = 0; it < my_tiles; ++it) {", None),
    ("            const float* stage = reinterpret_cast<const float*>(ring + at.st * STAGE_BYTES);\n            const uint64_t da_hi",
     "v_wait"),
    ("            release(empty, at);\n#pragma unroll\n            for (int e = 0; e < 64; ++e) eta[e] += acc[e];", "v_products"),
    ("        }\n\n        // --- the core on the accumulator: eta[e] is", "v_release_and_adds"),
    ("    }\n}\n\n// Launch 2.", "v_core_sums_and_theta_out"),
    ("    RingPlace at(STAGES);\n    for (int i = 0; i < my_chunks; ++i) {", None),
    ("        const float* xs = stage + 2 * TILE_FLOATS + fq * (TILE_FLOATS / 2);", "g_wait"),
    ("        const uint64_t db_hi = kmajor_desc(stage, DS);", "g_a_fragments"),
    ("        release(empty, at);\n#pragma unroll\n        for (int e = 0; e < 64; ++e) gs[e] += acc[e];", "g_products"),
    ("    }\n\n    // --- this block's partial: gs[e]", "g_release_and_adds"),
]
WIDE_SHAPES = [("bernoulli_logit", 282, None), ("poisson_log", 282, None), ("bernoulli_logit", 1024, None),
               ("poisson_log", 1024, None), ("ordered", 236, 5), ("ordered", 1024, 12)]  # (kind, d, k)


def wide_clocks(reps=2):
    """B1 / B2's tiled route, stamped, at the six timed wide shapes: clocks of
    block (0, 0, 0) of launches 1 and 2, per row tile and per chunk of that
    block; the stamped copy's time; each launch's device time of one call of
    the port's route (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    src, names = instrument("glm_fused.cu", WIDE, slots=16)
    path = os.path.join(OUT, "wide_clocks.cu")
    with open(path, "w") as f:
        f.write(src)
    finish(nvcc(path, os.path.join(OUT, "libwide_clocks.so")), "wide_clocks")
    lib = ctypes.CDLL(os.path.join(OUT, "libwide_clocks.so"))
    lib.glm_tiled_launch.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n, c = cs.N_MAIN, cs.C_MAIN
    for kind, d, k in WIDE_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(700 + d + (k or 0))
        x = torch.randn((n, d), generator=gen, device="cuda")
        beta = min(0.1, d ** -0.5) * torch.randn((d, c), generator=gen, device="cuda")
        if kind == "ordered":
            y = torch.randint(1, k + 1, (n,), generator=gen, device="cuda", dtype=torch.int32)
            alpha, extra = None, torch.sort(torch.randn((k - 1, c), generator=gen, device="cuda"), dim=0).values
            code, kcat, rows = glm_fused.ORDERED_KIND, k, d + k
            port = lambda: glm_fused.ordered_logistic_glm_parts(y, x, beta, extra)  # noqa: E731
        else:
            y = (torch.randint(0, 2, (n,), generator=gen, device="cuda") if kind == "bernoulli_logit"
                 else torch.poisson(torch.full((n,), 2.0, device="cuda"), generator=gen)).float()
            alpha, extra = 0.1 * torch.randn((c,), generator=gen, device="cuda"), None
            code, kcat, rows = glm_fused.FAMILIES.index(kind), 0, d + 3
            port = lambda: glm_fused.glm_fused_parts(kind, y, x, alpha, beta)  # noqa: E731
        plan = glm_fused.glm_tile_plan(n, d, c, sms, kcat=k)
        packed_n, theta_n, sums_n, part_n = glm_fused.glm_tiled_scratch(n, d, c, k)
        packed, theta = torch.empty((packed_n,), device="cuda"), torch.empty((theta_n,), device="cuda")
        sums = torch.empty((plan["row_blocks_value"] * sums_n,), dtype=torch.float64, device="cuda")
        part, out = torch.empty((plan["row_blocks"] * part_n,), device="cuda"), torch.empty((rows, c), device="cuda")

        def launch():
            err = lib.glm_tiled_launch(
                code, kcat, y.data_ptr(), x.data_ptr(), None if alpha is None else alpha.data_ptr(), beta.data_ptr(),
                None if extra is None else extra.data_ptr(), packed.data_ptr(), theta.data_ptr(), sums.data_ptr(),
                part.data_ptr(), out.data_ptr(), n, d, c, plan["row_blocks_value"], plan["row_blocks"],
                torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"wide copy: CUDA error {err}")

        ms = cs.time_ms(launch, warmup=1, reps=3)
        lib.prof_reset()
        for _ in range(reps):
            launch()
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * 16)()
        lib.prof_read(buf)
        row_tiles = -(-n // glm_fused.GLM_TILED_ROWS)
        tiles1 = len(range(0, row_tiles, plan["row_blocks_value"]))
        chunks2 = len(range(0, 4 * row_tiles, plan["row_blocks"]))
        per = {name: buf[i] / reps / (tiles1 if name.startswith("v_") else chunks2) for i, name in enumerate(names)}
        port()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            port()
            torch.cuda.synchronize()
        launches = {}
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
            if us:
                launches[ev.key[:80]] = us / 1e3
        print(json.dumps({"phase": "wide_clocks", "shape": {"kind": kind, "n": n, "d": d, "c": c, "k": k}, "plan": plan,
                          "ms_with_clocks": ms, "slices": plan["slices"],
                          "clocks_per_row_tile_of_block_0": {key: v for key, v in per.items() if key.startswith("v_")},
                          "clocks_per_chunk_of_block_0": {key: v for key, v in per.items() if key.startswith("g_")},
                          "launch_1_total_per_row_tile": sum(v for key, v in per.items() if key.startswith("v_")),
                          "launch_2_total_per_chunk": sum(v for key, v in per.items() if key.startswith("g_")),
                          "device_ms_by_kernel": launches}), flush=True)
        del x, y, beta, alpha, extra, packed, theta, sums, part, out
        torch.cuda.empty_cache()


def tiled_clocks(reps=2):
    """The tiled pair's stamped copy at the four timed wide shapes: clocks of
    block (0, 0, 0) of each launch, per row tile of that block."""
    src, names = instrument("glm_categorical.cu", TILED, slots=32)
    path = os.path.join(OUT, "tiled_clocks.cu")
    with open(path, "w") as f:
        f.write(src)
    finish(nvcc(path, os.path.join(OUT, "libtiled_clocks.so")), "tiled_clocks")
    lib = ctypes.CDLL(os.path.join(OUT, "libtiled_clocks.so"))
    lib.glm_categorical_tiled_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n, c = cs.N_MAIN, cs.C_MAIN
    for d, k in cs.C1_CATEGORICAL:
        gen = torch.Generator(device="cuda").manual_seed(700 + d + k)
        x = torch.randn((n, d), generator=gen, device="cuda")
        y = torch.randint(1, k + 1, (n,), generator=gen, device="cuda", dtype=torch.int32)
        alpha = 0.3 * torch.randn((c, k), generator=gen, device="cuda")
        beta = min(0.1, d ** -0.5) * torch.randn((c, d, k), generator=gen, device="cuda")
        plan = glm_fused.categorical_tiled_plan(n, d, c, k, sms)
        rb1, rb2 = plan["row_blocks_lse"], plan["row_blocks"]
        lse = torch.empty((c, n), device="cuda")
        packed = torch.empty((sum(glm_fused.categorical_packed_floats(n, d, c, k, plan["cpb"])),), device="cuda")
        part = torch.empty((rb1 * c + rb2 * c * k * (d + 1),), device="cuda")
        out = torch.empty((c * (1 + k + d * k),), device="cuda")

        def launch():
            err = lib.glm_categorical_tiled_launch(
                y.data_ptr(), x.data_ptr(), alpha.data_ptr(), beta.data_ptr(), lse.data_ptr(), packed.data_ptr(),
                part.data_ptr(), out.data_ptr(), n, d, c, k, plan["mt"], plan["groups"], plan["cpb"], rb1, rb2,
                plan["stages"], int(plan["whole_x"]), torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"tiled copy: CUDA error {err}")

        ms = cs.time_ms(launch, warmup=1, reps=2)
        lib.prof_reset()
        for _ in range(reps):
            launch()
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * 32)()
        lib.prof_read(buf)
        n_tiles = -(-n // 64)
        tiles1, tiles2 = len(range(0, n_tiles, rb1)), len(range(0, n_tiles, rb2))
        windows = -(-plan["cpb"] * k // glm_fused.TILED_COLUMNS)
        per = {name: buf[i] / reps / (tiles1 if name.startswith("l_") else tiles2) for i, name in enumerate(names)}
        print(json.dumps({"phase": "tiled_clocks", "shape": {"n": n, "d": d, "c": c, "k": k}, "plan": plan,
                          "ms_with_clocks": ms, "windows_per_tile_launch_1": windows,
                          "slices": -(-d // glm_fused.TILED_DS),
                          "clocks_per_row_tile_of_block_0": per,
                          "launch_1_total": sum(v for key, v in per.items() if key.startswith("l_")),
                          "launch_2_total": sum(v for key, v in per.items() if key.startswith("g_"))}), flush=True)
        del x, y, alpha, beta, lse, packed, part, out
        torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        print("phase_clocks: no GPU", file=sys.stderr)
        sys.exit(2)
    os.makedirs(OUT, exist_ok=True)
    if "--tiled" in sys.argv[1:] or "--wide" in sys.argv[1:]:
        if "--tiled" in sys.argv[1:]:
            tiled_clocks()
        if "--wide" in sys.argv[1:]:
            wide_clocks()
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip(), flush=True)
        return
    cat_src, cat_names = instrument("glm_categorical.cu", CATEGORICAL)
    blk_src, blk_names = instrument("chol_inv_block.cu", BLOCK)
    tc_src, tc_names = instrument("glm_fused.cu", GLM_TC)
    paths = {}
    for name, text in (("categorical_clocks", cat_src), ("block_clocks", blk_src), ("glm_tc_clocks", tc_src)):
        paths[name] = os.path.join(OUT, name + ".cu")
        with open(paths[name], "w") as f:
            f.write(text)
    procs = {
        "probe": nvcc(os.path.join(ROOT, "tools", "wgmma_layout_probe.cu"), os.path.join(OUT, "wgmma_layout_probe"), False),
        "categorical_clocks": nvcc(paths["categorical_clocks"], os.path.join(OUT, "libcategorical_clocks.so")),
        "block_clocks": nvcc(paths["block_clocks"], os.path.join(OUT, "libblock_clocks.so")),
        "glm_tc_clocks": nvcc(paths["glm_tc_clocks"], os.path.join(OUT, "libglm_tc_clocks.so")),
        "columnwise": nvcc(os.path.join(ROOT, "tools", "chol_inv_block_columnwise.cu"), os.path.join(OUT, "libcolumnwise.so")),
    }
    for what, proc in procs.items():
        finish(proc, what)

    probe = subprocess.run([os.path.join(OUT, "wgmma_layout_probe")], check=True, capture_output=True, text=True, timeout=120)
    for line in probe.stdout.splitlines():
        print(json.dumps({"phase": "wgmma_layout_probe", **json.loads(line)}), flush=True)

    # the categorical kernel at the categorical path's shape
    n, d, c, k = cs.N_MAIN, cs.K_MAIN, cs.C_MAIN, cs.K_CAT
    x = glm_logistic.synthetic_data(n, d)[0]
    y, _, *params = cs.categorical_inputs(n, d, c, k, seed=521, scale=0.1, x=x)
    yy, xx, aa, bb = cs.with_y(y, [x, *params], torch.float32)
    plan = glm_fused.categorical_tile_plan(n, d, c, k, torch.cuda.get_device_properties(0).multi_processor_count)
    lib = ctypes.CDLL(os.path.join(OUT, "libcategorical_clocks.so"))
    lib.glm_categorical_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    m = c * (1 + k + d * k)
    part = torch.empty((plan["row_blocks"], m), device="cuda")
    out = torch.empty(m, device="cuda")

    def launch():
        err = lib.glm_categorical_launch(yy.data_ptr(), xx.data_ptr(), aa.data_ptr(), bb.data_ptr(), part.data_ptr(),
                                         out.data_ptr(), n, d, c, k, plan["wgs"], plan["mt"], plan["cpt"], plan["stages"],
                                         plan["row_blocks"], torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"categorical copy: CUDA error {err}")

    ms = cs.time_ms(launch, warmup=3, reps=20)
    lib.prof_reset()
    reps = 5
    for _ in range(reps):
        launch()
    torch.cuda.synchronize()
    tiles = reps * len(range(0, -(-n // 64), plan["row_blocks"]))
    clocks = read_clocks(lib, cat_names, tiles)
    print(json.dumps({"phase": "categorical_clocks", "shape": {"n": n, "d": d, "c": c, "k": k}, "plan": plan,
                      "ms_with_clocks": ms, "clocks_per_tile_of_block_0": clocks,
                      "total": sum(clocks.values())}), flush=True)

    glm_tc_clocks(tc_names)

    # the block kernel on a Schur block of the GP path, and the column-by-column one
    _, schur = cs.gp_blocks(gp_regression.synthetic_data(cs.N_GP, seed=0)[0], get_config().cholesky_block_size, block_index=8)
    cb, bsz, _ = schur.shape
    u, w = torch.empty_like(schur), torch.empty_like(schur)
    stamps = torch.zeros((cb, 5), dtype=torch.int64, device="cuda")
    blk = ctypes.CDLL(os.path.join(OUT, "libblock_clocks.so"))
    col = ctypes.CDLL(os.path.join(OUT, "libcolumnwise.so"))
    blk.chol_inv_block_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    col.chol_inv_block_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream
    blk_ms = cs.time_ms(lambda: blk.chol_inv_block_launch(schur.data_ptr(), u.data_ptr(), w.data_ptr(), cb, bsz, stream),
                        warmup=3, reps=20)
    blk.prof_reset()
    for _ in range(reps):
        blk.chol_inv_block_launch(schur.data_ptr(), u.data_ptr(), w.data_ptr(), cb, bsz, stream)
    torch.cuda.synchronize()
    clocks = read_clocks(blk, blk_names, reps)
    print(json.dumps({"phase": "block_clocks", "cb": cb, "b": bsz, "ms_with_clocks": blk_ms,
                      "clocks_per_launch_of_block_0": clocks, "total": sum(clocks.values())}), flush=True)
    col_ms = cs.time_ms(lambda: col.chol_inv_block_launch(schur.data_ptr(), u.data_ptr(), w.data_ptr(), stamps.data_ptr(),
                                                          cb, bsz, stream), warmup=3, reps=20)
    spans = (stamps[:, 1:] - stamps[:, :-1]).double().mean(0)
    total = float(spans.sum())
    phases = ("load", "factor", "inverse", "store")
    print(json.dumps({"phase": "columnwise_block_stamps", "cb": cb, "b": bsz, "ms": col_ms,
                      "clocks": {p: float(v) for p, v in zip(phases, spans)},
                      "share": {p: float(v) / total for p, v in zip(phases, spans)}}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)


if __name__ == "__main__":
    main()
