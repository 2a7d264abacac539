"""PyTorch port: the GLM inputs the dispatchers once refused, on the CPU (the kernels run only on the card).

- B1's and B2's tiled tensor-core route (``csrc/glm_fused.cu``, namespace
  ``tiled``) emulated in its order: 3xTF32 products (``tf32_emulation.py``),
  eta over slices of 32 features, each slice's product from zero, added in
  float32; the core; its per-chain sums over each 128-row tile in float32,
  the tiles of a block and the blocks in float64; theta' through product 2
  by chunks of 32 rows, each from zero, a block's chunks in float32 and the
  blocks in float64.  Also held against the Pallas kernels of the JAX
  package in interpret mode (``tests/test_torch_glm_tc.py``).
- The tiled categorical pair's arithmetic (``csrc/glm_categorical.cu``)
  emulated in its order: 3xTF32 products, eta over slices of 32 features
  added in float32, launch 1's online log-sum-exp over the 80-column tiles,
  theta' from ``lse``, product 2 by 64-row tiles, the blocks' partials in
  float64.
- Both held against the float64 plain version at the wide shapes of
  ``chip_smoke.py``'s ``wide`` phase (N cut to 1,000) with its tolerances:
  logp rtol 2e-5; gradients rtol 3e-4, atol 1e-3.
- The route functions give a route, never None, for every such input; the
  tiled routes' plans and shared-memory layouts against the C sources.
- The dispatchers' layout helper: what it copies, what it casts, what it
  counts, and that it leaves CPU tensors alone.
"""

import os
import re

import numpy as np
import pytest

import torch
import torch.nn.functional as F

from math_tpu_torch.ops import glm_fused as gf
from tf32_emulation import tc_blocked_product, tc_chunked_product, tc_product, tc_product_small_first
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMS = 132
N, C, TM = 1000, 20, 64
FAMILY_D = (282, 1024)
ORDERED = ((236, 5), (1024, 12), (63, 8), (20, 10), (40, 20))  # K = 20: gcuts in two passes of sixteen cuts
CATEGORICAL = ((50, 65), (50, 200), (400, 5), (212, 41))


def tiled_eta(x, beta):
    """Launch 1's eta (N, C) = x @ beta: D in slices of 32 (zeros past D),
    each slice's product eta^T = beta^T x^T from zero, the slices added in
    float32."""
    ds = gf.GLM_TILED_DS
    pad = (-x.shape[1]) % ds
    xp, bp = F.pad(x, (0, pad)), F.pad(beta, (0, 0, 0, pad))
    eta = torch.zeros((beta.shape[1], x.shape[0]), dtype=torch.float32)
    for d0 in range(0, xp.shape[1], ds):
        eta = eta + tc_product_small_first(bp[d0 : d0 + ds].mT, xp[:, d0 : d0 + ds].mT)
    return eta.mT


def tile_sums(rows, row_blocks):
    """Per-row values (N, ...) summed as launch 1 does: over each 128-row
    tile in float32, tile t into block t % row_blocks in float64, the blocks
    in float64."""
    rt = gf.GLM_TILED_ROWS
    tiles = [rows[r : r + rt].sum(0).double() for r in range(0, rows.shape[0], rt)]
    return sum(sum(tiles[b::row_blocks]) for b in range(row_blocks))


def tiled_family(family, y, x, alpha, beta, extra):
    """(logp, ga, gb, ge) of the tiled route in its arithmetic."""
    n, d = x.shape
    plan = gf.glm_tile_plan(n, d, beta.shape[1], SMS)
    eta = tiled_eta(x, beta) + alpha
    lp, tp, de = gf._core(family, eta, y[:, None], None if extra is None else extra[None, :])
    rb1 = plan["row_blocks_value"]
    gb = tc_chunked_product(x.mT, tp, plan["row_blocks"], gf.GLM_TILED_CHUNK)
    return tile_sums(lp, rb1), tile_sums(tp, rb1), gb, (tile_sums(de, rb1) if extra is not None else None)


def tiled_ordered(y, x, beta, cuts):
    """(logp, gbeta, gcuts) of the tiled route in its arithmetic: the cut
    pair by index (-/+1e4 at the ends), log1m_exp(c_{y-1} - c_y) per
    element, gcuts as per-row sums of w2 at y = j and -w1 at y = j + 1."""
    n, d = x.shape
    k = cuts.shape[0] + 1
    plan = gf.glm_tile_plan(n, d, beta.shape[1], SMS, kcat=k)
    eta = tiled_eta(x, beta)
    big = torch.full((1, cuts.shape[1]), gf.ORD_BIG)
    ext = torch.cat([-big, cuts, big])
    yl = torch.clamp(y.long(), 1, k)
    u2, u1 = ext[yl] - eta, ext[yl - 1] - eta
    sp2, sp1 = gf._softplus(u2), gf._softplus(u1)
    lp = u2 - sp2 - sp1 + gf.log1m_exp(torch.clamp(ext[yl - 1] - ext[yl], -80.0, -1e-20))
    w2, w1 = torch.exp(u2 - 2.0 * sp2 - lp), torch.exp(u1 - 2.0 * sp1 - lp)
    onehot = F.one_hot(yl, k + 1).float()  # (N, K+1)
    rb1 = plan["row_blocks_value"]
    gc = tile_sums(onehot[:, 1:k, None] * w2[:, None, :] - onehot[:, 2 : k + 1, None] * w1[:, None, :], rb1)
    gbeta = tc_chunked_product(x.mT, w1 - w2, plan["row_blocks"], gf.GLM_TILED_CHUNK)
    return tile_sums(lp, rb1), gbeta, gc


def _check(got, want, names):
    for name, g, w in zip(names, got, want):
        rtol, atol = (2e-5, 0.0) if name == "logp" else (3e-4, 1e-3)
        err = (g.double() - w).abs()
        assert bool((err <= atol + rtol * w.abs()).all()), (name, float(err.max()))


def _x(d, seed):
    return torch.tensor(np.random.default_rng(seed).normal(size=(N, d)), dtype=torch.float32)


@pytest.mark.parametrize("family", gf.FAMILIES)
@pytest.mark.parametrize("d", FAMILY_D)
def test_sliced_family_kernel_holds_the_tolerance(family, d):
    """The tiled route's four families: D in slices of 32, theta' through
    product 2 by chunks of 32 rows."""
    rng = np.random.default_rng(d)
    x = _x(d, d + 1)
    scale = 1.0 / np.sqrt(d)
    alpha = torch.tensor(rng.normal(size=C) * scale, dtype=torch.float32)
    beta = torch.tensor(rng.normal(size=(d, C)) * scale, dtype=torch.float32)
    y = {"bernoulli_logit": rng.integers(0, 2, N), "poisson_log": rng.poisson(2.0, N),
         "normal_id": rng.normal(size=N), "neg_binomial_2_log": rng.poisson(3.0, N)}[family]
    y = torch.tensor(y, dtype=torch.float32)
    extra = torch.tensor(0.5 + rng.uniform(size=C) * 3.0, dtype=torch.float32) if gf.HAS_EXTRA[family] else None
    assert gf.glm_tile_plan(N, d, C, SMS)["kernel"] == "tiled"
    got = [g for g in tiled_family(family, y, x, alpha, beta, extra) if g is not None]
    want = gf.glm_fused_parts_reference(family, y.double(), x.double(), alpha.double(), beta.double(),
                                        None if extra is None else extra.double())
    _check(got, [w for w in want if w is not None], ["logp", "ga", "gb", "ge"])


@pytest.mark.parametrize("d, k", ORDERED)
def test_sliced_ordered_kernel_holds_the_tolerance(d, k):
    """The tiled route's ordered GLM, at the wide shapes, at the widest D
    whose glm_tc_kernel block does not fit (63, 8), past its K (20, 10), and
    at K = 20 (gcuts in two passes of sixteen cuts)."""
    rng = np.random.default_rng(d + k)
    x = _x(d, d + k + 1)
    beta = torch.tensor(rng.normal(size=(d, C)) / np.sqrt(d), dtype=torch.float32)
    cuts = torch.tensor(np.cumsum(0.3 + rng.uniform(size=(k - 1, C)), axis=0) - 0.5 * k, dtype=torch.float32)
    y = torch.tensor(rng.integers(1, k + 1, N), dtype=torch.int32)
    assert gf.glm_tile_plan(N, d, C, SMS, kcat=k)["kernel"] == "tiled"
    got = tiled_ordered(y, x, beta, cuts)
    want = gf.ordered_logistic_glm_parts_reference(y, x.double(), beta.double(), cuts.double())
    _check(got, want, ["logp", "gbeta", "gcuts"])


def _tiled_eta(x, bmat):
    """Product 1 of the tiled categorical pair: x (N, D) @ bmat (D, M), D in
    slices of 32, each slice's 3xTF32 product (zero-padded to whole k8 steps)
    from zero, the slices added in float32."""
    eta = None
    for d0 in range(0, x.shape[1], gf.TILED_DS):
        xs, bs = x[:, d0 : d0 + gf.TILED_DS], bmat[d0 : d0 + gf.TILED_DS]
        pad = (-xs.shape[1]) % 8
        p = tc_product(F.pad(xs, (0, pad)), F.pad(bs, (0, 0, 0, pad)))
        eta = p if eta is None else eta + p
    return eta


def _online_lse(eta, k, cpb):
    """Launch 1's log-sum-exp in float32: each chain's classes in the segments
    its group's windows of 80 columns cut them into (``cpb`` chains a group),
    a segment's maximum and sum of exponentials merged into the running pair
    in window order."""
    n, ck = eta.shape
    c = ck // k
    e = eta.view(n, c, k)
    in_group = (torch.arange(c) % cpb)[:, None] * k + torch.arange(k)[None, :]  # a column's place in its group
    tile = in_group // gf.TILED_COLUMNS
    seg = tile - tile[:, :1]  # the segment of each column within its chain
    m = torch.full((n, c), -float("inf"))
    s = torch.zeros((n, c))
    for j in range(int(seg.max()) + 1):
        inseg = seg == j
        if not bool(inseg.any()):
            continue
        em = torch.where(inseg, e, -float("inf"))
        sm = em.max(-1).values
        has = inseg.any(-1)  # chains with a segment j
        ss = torch.where(inseg, torch.exp(e - torch.where(has, sm, 0.0)[..., None]), 0.0).sum(-1)
        m_new = torch.where(has, torch.maximum(m, sm), m)
        s = torch.where(has, s * torch.exp(m - m_new) + ss * torch.exp(sm - m_new), s)
        m = m_new
    return m + torch.log(s)


def _tiled_categorical(y, x, alpha, beta, plan):
    """The tiled pair's arithmetic in its order: (logp, galpha, gbeta)."""
    n, d = x.shape
    c, _, k = beta.shape
    bmat = beta.permute(1, 0, 2).reshape(d, c * k)  # flat column q = c*K + k
    eta = _tiled_eta(x, bmat) + alpha.reshape(-1)
    lse = _online_lse(eta, k, plan["cpb"])  # (N, C)
    yk = (y.long() - 1).clamp(0, k - 1)
    e = eta.view(n, c, k)
    lp = torch.gather(e, -1, yk[:, None, None].expand(n, c, 1))[..., 0] - lse
    # rows of a tile in order in float32, the tiles of a block and the blocks in double
    tiles = [lp[r : r + TM].sum(0).double() for r in range(0, n, TM)]
    logp = sum(sum(tiles[b :: plan["row_blocks_lse"]]) for b in range(plan["row_blocks_lse"]))
    onehot = F.one_hot(yk, k).float()[:, None, :]
    thetap = (onehot - torch.exp(e - lse[..., None])).reshape(n, c * k)
    g = tc_blocked_product(torch.cat([x, torch.ones(n, 1)], 1).mT, thetap, plan["row_blocks"]).view(d + 1, c, k)
    return logp, g[d], g[:d].permute(1, 0, 2)


@pytest.mark.parametrize("d, k", CATEGORICAL)
def test_two_sweep_categorical_kernel_holds_the_tolerance(d, k):
    """The tiled pair's two launches (the log-sum-exp sweep, then theta' and
    the gradients) in its arithmetic, against the float64 plain version."""
    rng = np.random.default_rng(d * k)
    x = _x(d, d + k)
    alpha = torch.tensor(rng.normal(size=(C, k)) * 0.3, dtype=torch.float32)
    beta = torch.tensor(rng.normal(size=(C, d, k)) * min(0.1, 1.0 / np.sqrt(d)), dtype=torch.float32)
    y = torch.tensor(rng.integers(1, k + 1, N), dtype=torch.int32)
    plan = gf.categorical_route(N, d, C, k, SMS)
    assert plan["kernel"] == "tiled"
    got = _tiled_categorical(y, x, alpha, beta, plan)
    want = gf.categorical_logit_glm_parts_reference(y, x.double(), alpha.double(), beta.double())
    _check(got, want, ["logp", "galpha", "gbeta"])


# --- routes -------------------------------------------------------------------


def _tiled_plan_holds(plan, n, d, c, k):
    """The tiled pair's plan covers the shape within a block's shared memory."""
    assert plan["route"] == "tensor_cores" and plan["kernel"] == "tiled", (d, k)
    assert plan["column_tiles"] * gf.TILED_COLUMNS >= c * k > (plan["column_tiles"] - 1) * gf.TILED_COLUMNS
    assert plan["mt"] in gf.TILED_MT
    assert plan["groups"] * 64 * plan["mt"] >= d + 1 > (plan["groups"] - 1) * 64 * plan["mt"]
    assert 1 <= plan["cpb"] <= min(c, gf.TILED_MAX_CPB)
    assert plan["chain_groups"] * plan["cpb"] >= c > (plan["chain_groups"] - 1) * plan["cpb"]
    assert plan["smem_lse"] == gf.categorical_lse_smem_bytes(plan["cpb"]) <= gf.MAX_SMEM_BYTES
    assert 2 <= plan["stages"] <= gf.TILED_MAX_GRAD_STAGES
    assert plan["smem"] == gf.categorical_grad_smem_bytes(plan["mt"], plan["nch"], plan["stages"], plan["whole_x"], d) <= gf.MAX_SMEM_BYTES
    for key in ("row_blocks_lse", "row_blocks"):
        assert 1 <= plan[key] <= min(-(-n // 64), 65535), (key, plan[key])
    assert plan["row_blocks"] * c * k * (d + 1) <= max(gf.TILED_PARTIAL_FLOATS, c * k * (d + 1))


def _glm_tiled_plan_holds(plan, n, d, c):
    """B1 / B2's tiled plan covers the shape, one block an SM, within shared memory."""
    assert plan["route"] == "tensor_cores" and plan["kernel"] == "tiled", (n, d, c)
    assert plan["column_tiles"] * gf.GLM_TILED_CHAINS >= c > (plan["column_tiles"] - 1) * gf.GLM_TILED_CHAINS
    assert plan["slices"] == -(-d // gf.GLM_TILED_DS) and plan["feature_groups"] == -(-d // gf.GLM_TILED_FEATURES)
    assert plan["smem"] == gf.glm_tiled_smem_bytes() <= gf.MAX_SMEM_BYTES
    row_tiles = -(-n // gf.GLM_TILED_ROWS)
    assert 1 <= plan["row_blocks_value"] <= min(row_tiles, 65535)
    assert 1 <= plan["row_blocks"] <= min(4 * row_tiles, 65535)
    assert plan["row_blocks"] * d * c <= max(gf.GLM_TILED_PARTIAL_FLOATS, d * c)
    assert plan["launches"] == gf.GLM_TILED_LAUNCHES_PER_CALL == 5


@pytest.mark.parametrize("n, c", [(4099, 20), (100_000, 256)])
def test_every_c1_input_has_a_route(n, c):
    for d in FAMILY_D:
        _glm_tiled_plan_holds(gf.glm_tile_plan(n, d, c, SMS), n, d, c)
    for d, k in ORDERED:
        _glm_tiled_plan_holds(gf.glm_tile_plan(n, d, c, SMS, kcat=k), n, d, c)
    for d, k in CATEGORICAL + ((7, 65), (320, 5), (700, 3), (330, 30), (400, 12)):
        _tiled_plan_holds(gf.categorical_route(n, d, c, k, SMS), n, d, c, k)
    # a shape of the first tensor-core kernel keeps it: a route by shape, not a threshold
    assert gf.categorical_route(n, 50, c, 5, SMS)["kernel"] == "single"
    assert gf.categorical_route(n, 50, c, 5, SMS)["n_cols"] == gf.categorical_tile_plan(n, 50, c, 5, SMS)["n_cols"]
    assert gf.categorical_route(n, 211, c, 40, SMS)["kernel"] == "single"
    assert gf.categorical_route(n, 319, c, 5, SMS)["kernel"] == "single"
    assert gf.categorical_route(n, 64, c, 64, SMS)["kernel"] == "single"
    assert gf.glm_tile_plan(n, 33, c, SMS)["kernel"] == "single"
    assert gf.glm_tile_plan(n, 63, c, SMS, kcat=5)["kernel"] == "single"


def test_chip_checks_reach_every_branch_of_the_tiled_route():
    """``chip_smoke.py``'s ``kernels_wide`` shapes, planned for the H100's 132
    SMs, take B1 / B2's tiled route and between them reach every branch that
    ``tiled_route_reach`` names: a block of launch 1 over several row tiles
    and one of launch 2 over several row chunks, a second column tile and
    feature group, each launch's second warpgroup with and without work, and
    ring stages that do not divide a row tile's slices.  The timed shapes
    (N = 100,000, C = 256), which ``time_wide`` holds against float64 too,
    take a dozen row tiles a block of launch 1."""
    import sys

    sys.path.insert(0, ROOT)
    import chip_smoke

    shapes = [(n, d, c, None) for n, d, c in chip_smoke.WIDE_FAMILY] + list(chip_smoke.WIDE_ORDERED)
    reach = []
    for n, d, c, k in shapes:
        assert gf.glm_tile_plan(n, d, c, SMS, kcat=k)["kernel"] == "tiled", (n, d, c, k)
        reach.append(chip_smoke.tiled_route_reach(n, d, c, SMS))
    for key in ("one_warpgroup_launch_1", "one_warpgroup_launch_2", "ring_turns_within_tiles"):
        assert {r[key] for r in reach} == {True, False}, key
    for key in ("tiles_a_block", "chunks_a_block", "column_tiles", "feature_groups"):
        assert max(r[key] for r in reach) > 1, key
    for d in chip_smoke.C1_FAMILY_D + tuple(d for d, _ in chip_smoke.C1_ORDERED):
        timed = chip_smoke.tiled_route_reach(chip_smoke.N_MAIN, d, chip_smoke.C_MAIN, SMS)
        assert timed["tiles_a_block"] >= 12 and timed["column_tiles"] == 2 and timed["chunks_a_block"] > 1, d


def test_tiled_plan_packs_the_classes_and_groups_d():
    """Flat column tiles leave no column idle but at the end of C*K; launch
    1's groups of chains leave the fewest idle; D + 1 rows go in the fewest groups of at
    most 7 row tiles where shared memory holds them (else 4), each of the
    least instance that covers it; and every
    shape, however wide, has a plan."""
    p = gf.categorical_tiled_plan(4099, 50, 20, 200, SMS)
    assert (p["column_tiles"], p["cpb"], p["nch"], p["mt"], p["groups"]) == (50, 16, 2, 1, 1)
    p = gf.categorical_tiled_plan(4099, 50, 20, 65, SMS)
    assert (p["column_tiles"], p["cpb"], p["mt"]) == (17, 16, 1) and 16 * 65 == 13 * 80
    p = gf.categorical_tiled_plan(100_000, 212, 256, 41, SMS)
    assert (p["cpb"], p["chain_groups"], p["mt"], p["groups"], p["column_tiles"], p["launches"]) == (15, 18, 4, 1, 132, 5)
    assert 15 * 41 == 615 and -(-615 // 80) * 80 == 640  # launch 1's windows: 4% idle, the fewest of 1-16 chains
    p = gf.categorical_tiled_plan(4099, 400, 20, 5, SMS)  # 7 row tiles: one group of the 7-tile instance
    assert (p["groups"], p["mt"]) == (1, 7)
    assert (gf.categorical_tiled_plan(4099, 150, 20, 65, SMS)["mt"], gf.categorical_tiled_plan(4099, 100, 20, 65, SMS)["mt"]) == (4, 2)
    # 17 row tiles; x too wide to come whole, and a window of 14 slices beside x's ring does not fit: five groups of 4
    p = gf.categorical_tiled_plan(4099, 1024, 20, 3, SMS)
    assert (p["groups"], p["mt"], p["whole_x"]) == (5, 4, False)
    assert gf.categorical_tiled_plan(4099, 400, 20, 5, SMS)["whole_x"] and gf.categorical_tiled_plan(4099, 50, 20, 65, SMS)["whole_x"]
    p = gf.categorical_tiled_plan(4099, 600, 20, 3, SMS)  # 10 row tiles: two groups of 7 do not fit, three of 4
    assert (p["groups"], p["mt"]) == (3, 4)
    p = gf.categorical_tiled_plan(4099, 256, 20, 3, SMS)  # 5 row tiles, the last the row of ones: one group of 7
    assert (p["groups"], p["mt"]) == (1, 7)
    for n, d, c, k in ((1, 1, 1, 65), (64, 5000, 3, 1), (777, 63, 1000, 1000), (100_000, 2, 1, 3000)):
        _tiled_plan_holds(gf.categorical_tiled_plan(n, d, c, k, SMS), n, d, c, k)


def _c_layout(cu, function, **values):
    """Evaluate a layout function of the C source: the sum of its ``at +=``
    terms, with ``up128`` and the constants as the source defines them."""
    env = {"up128": lambda b: (b + 127) // 128 * 128, "TM": 64, **values}
    for name, expr in re.findall(r"^constexpr (?:int|uint32_t|size_t) (\w+) = ([^;]+);", cu, re.M):
        env[name] = eval(re.sub(r"\((?:size_t|uint32_t)\)", "", expr), {}, env)
    body = re.search(r"inline \w+ " + function + r"\([^)]*\) \{(.*?)\n\}", cu, re.S).group(1)
    terms = [re.sub(r"\((?:size_t|uint32_t)\)", "", t) for t in re.findall(r"at \+= ([^;]+);", body)]
    terms = [re.sub(r"\(([^()?]+) \? ([^():]+) : ([^()]+)\)", r"(\2 if \1 else \3)", t) for t in terms]
    return sum(eval(t, {}, env) for t in terms)


def test_glm_tiled_shared_memory_does_not_grow():
    """B1 / B2's tiled route, read from the C source: its block layout
    (``layout_of`` of namespace ``tiled``) takes no D and no K, and is the
    wrapper's ``glm_tiled_smem_bytes``; its constants are the plan's; the
    float32 kernels are gone; every shape's plan holds that layout."""
    with open(os.path.join(ROOT, "math_tpu_torch/csrc/glm_fused.cu"), encoding="utf-8") as f:
        source = f.read()
    cu = source.split("namespace tiled {", 1)[1]
    assert re.search(r"inline Layout layout_of\(([^)]*)\)", cu).group(1) == "int stages"
    consts = {"CH": gf.GLM_TILED_CHAINS, "RT": gf.GLM_TILED_ROWS, "DS": gf.GLM_TILED_DS, "RCH": gf.GLM_TILED_CHUNK,
              "FG": gf.GLM_TILED_FEATURES, "STAGES": gf.GLM_TILED_STAGES}
    for name, value in consts.items():
        assert re.search(rf"^constexpr int {name} = {value};", cu, re.M), name
    assert _c_layout(cu, "layout_of", stages=gf.GLM_TILED_STAGES) == gf.glm_tiled_smem_bytes() <= gf.MAX_SMEM_BYTES
    assert _c_layout(cu, "layout_of", stages=2) - _c_layout(cu, "layout_of", stages=1) == gf.GLM_TILED_STAGE_BYTES
    line = re.search(r"#define GLM_TILED_KINDS\(X\)(.*)", cu).group(1)
    assert re.findall(r"X\((\d)\)", line) == [str(i) for i in range(gf.ORDERED_KIND + 1)]
    for name in ("glm_fused_kernel", "glm_ordered_kernel", "FUSED_SMEM", "ORDERED_SMEM", "stage_x_slice", "eta_over_slices",
                 "gradient_over_slices", "LibraryMath"):
        assert name not in source, name
    for n, d, c, k in ((1, 1, 1, 300), (4099, 64, 20, None), (100_000, 1024, 256, 12), (777, 57, 300, 6), (64, 5000, 3, 9)):
        plan = gf.glm_tile_plan(n, d, c, SMS, kcat=k)
        _glm_tiled_plan_holds(plan, n, d, c)
        assert plan["smem"] == _c_layout(cu, "layout_of", stages=gf.GLM_TILED_STAGES)


def test_tiled_layout_is_the_plans():
    """The wrapper's shared-memory counts of the tiled pair are the kernels'
    ``lse_layout_of`` / ``grad_layout_of``, read from the C source, and the
    instances of launch 2 are the plan's."""
    with open(os.path.join(ROOT, "math_tpu_torch/csrc/glm_categorical.cu"), encoding="utf-8") as f:
        cu = f.read().split("namespace tiled {", 1)[1]
    line = re.search(r"#define GLM_CATEGORICAL_TILED_MT\(X\)(.*)", cu).group(1)
    assert sorted(re.findall(r"X\((\d+), (true|false)\)", line)) == sorted(
        (str(mt), w) for mt in gf.TILED_MT for w in ("true", "false"))
    assert (f"constexpr int NC = {gf.TILED_COLUMNS};" in cu and f"constexpr int DS = {gf.TILED_DS};" in cu
            and "constexpr int XS = DS + 4;" in cu and gf.TILED_XS == gf.TILED_DS + 4
            and f"constexpr int LSE_STAGES = {gf.TILED_LSE_STAGES};" in cu
            and f"constexpr int MAX_GRAD_STAGES = {gf.TILED_MAX_GRAD_STAGES};" in cu
            and f"constexpr int MAX_CPB = {gf.TILED_MAX_CPB};" in cu)
    for cpb in (1, 2, 15, 16):
        assert _c_layout(cu, "lse_layout_of", cpb=cpb) == gf.categorical_lse_smem_bytes(cpb), cpb
    for mt in gf.TILED_MT:
        for nch in (1, 2, 17, 81):
            for stages in range(2, gf.TILED_MAX_GRAD_STAGES + 1):
                for whole_x in (True, False):
                    for d in (7, 50, 400):
                        want = gf.categorical_grad_smem_bytes(mt, nch, stages, whole_x, d)
                        assert _c_layout(cu, "grad_layout_of", mt=mt, nch=nch, stages=stages, whole_x=whole_x,
                                         ns=-(-d // 32)) == want, (mt, nch, stages, whole_x, d)


# --- the dispatchers' layout helper ------------------------------------------


def _misaligned(shape, dtype=torch.float32):
    buf = torch.randn((int(np.prod(shape)) + 1,), dtype=torch.float64).to(dtype)
    t = buf[1:].view(shape)
    assert t.data_ptr() % 16 != 0
    return t


@pytest.mark.parametrize("case", ["misaligned_x", "transposed_x", "int64_y", "laid_out"])
@pytest.mark.parametrize("family", ["bernoulli_logit", gf.ORDERED, gf.CATEGORICAL])
def test_kernel_layout_copies_and_casts(family, case):
    n, d = 37, 7
    x = torch.randn((n, d))
    y = torch.randint(1, 4, (n,), dtype=torch.int32)
    if family in gf.FAMILIES:
        y = y.float()
    if case == "misaligned_x":
        x = _misaligned((n, d))
    elif case == "transposed_x":
        x = torch.randn((d, n)).mT
    elif case == "int64_y":
        y = y.long()
    before = dict(gf.LAYOUT_COPIES)
    x2, y2 = gf.kernel_layout(family, x, y)
    copied = case != "laid_out"
    assert gf.LAYOUT_COPIES == dict(before, **{family: before[family] + copied})
    assert x2.is_contiguous() and x2.data_ptr() % 16 == 0 and torch.equal(x2, x)
    assert y2.is_contiguous() and y2.data_ptr() % 16 == 0 and torch.equal(y2.long(), y.long())
    assert y2.dtype == (torch.float32 if family in gf.FAMILIES else torch.int32)
    assert (x2 is x) == (case in ("laid_out", "int64_y")) and (y2 is y) == (case != "int64_y")


def test_kernel_layout_casts_a_family_integer_y_and_keeps_the_x_gradient():
    x = _misaligned((10, 3)).requires_grad_(True)
    y = torch.randint(0, 3, (10,))
    x2, y2 = gf.kernel_layout("poisson_log", x, y)
    assert y2.dtype == torch.float32 and torch.equal(y2, y.float())
    (g,) = torch.autograd.grad((x2 * 2.0).sum(), x)
    assert torch.equal(g, torch.full_like(x, 2.0))
    y_float = torch.rand(10)  # an ordered y that is not integer is left for the wrapper to refuse
    assert gf.kernel_layout(gf.ORDERED, x.detach().clone(), y_float)[1] is y_float


def test_dispatchers_leave_cpu_tensors_alone():
    """The plain version on the CPU takes any layout: no copy is made or counted."""
    before = dict(gf.LAYOUT_COPIES)
    x = _misaligned((50, 3), torch.float64)
    y = torch.randint(1, 4, (50,))
    gf.ordered_logistic_glm_lpmf_chains(y, x, torch.randn(3, 2, dtype=torch.float64),
                                        torch.tensor([[-1.0, -1.0], [1.0, 1.0]], dtype=torch.float64))
    gf.bernoulli_logit_glm_lpmf_chains(y.double().clamp(max=1.0), x, torch.zeros(2, dtype=torch.float64),
                                       torch.randn(3, 2, dtype=torch.float64))
    assert gf.LAYOUT_COPIES == before
