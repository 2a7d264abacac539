"""PyTorch port: the GLM inputs the dispatchers once refused, on the CPU (the kernels run only on the card).

- The float32 kernels' arithmetic (B1, B2) emulated in their order: eta
  summed over slices of 64 features, the gradient sums of each 64-row tile
  added into the block's partial in float32 and the partials in float64.
- The tiled categorical pair's arithmetic (``csrc/glm_categorical.cu``)
  emulated in its order: 3xTF32 products (``tf32_emulation.py``), eta over
  slices of 32 features added in float32, launch 1's online log-sum-exp over
  the 80-column tiles, theta' from ``lse``, product 2 by 64-row tiles, the
  blocks' partials in float64.
- Both held against the float64 plain version at the wide shapes of
  ``chip_smoke.py``'s ``wide`` phase (N cut to 1,000) with its tolerances:
  logp rtol 2e-5; gradients rtol 3e-4, atol 1e-3.
- The route functions give a route, never None, for every such input; the
  tiled pair's plan and its shared-memory layout against the C source.
- The dispatchers' layout helper: what it copies, what it casts, what it
  counts, and that it leaves CPU tensors alone.
"""

import os
import re

import numpy as np
import pytest

import torch

from math_tpu_torch.ops import glm_fused as gf
from tf32_emulation import tc_blocked_product, tc_product
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMS = 132
N, C, TM, DS = 1000, 20, 64, 64
RB = 3  # blocks along the rows
FAMILY_D = (282, 1024)
ORDERED = ((236, 5), (1024, 12))
CATEGORICAL = ((50, 65), (50, 200), (400, 5), (212, 41))


def _sliced_eta(x, bmat):
    """x (N, D) @ bmat (D, M) in float32, the slices of 64 features added in order."""
    eta = torch.zeros((x.shape[0], bmat.shape[1]), dtype=torch.float32)
    for d0 in range(0, x.shape[1], DS):
        eta = eta + x[:, d0 : d0 + DS] @ bmat[d0 : d0 + DS]
    return eta


def _tile_sums(rows):
    """Per-row values (N, ...) summed as the kernels do: each block's tiles
    (tile t goes to block t % RB) in float32 in tile order, the blocks' partials
    in float64."""
    tiles = [rows[r : r + TM].sum(0) for r in range(0, rows.shape[0], TM)]
    partials = []
    for b in range(RB):
        acc = None
        for t in tiles[b::RB]:
            acc = t if acc is None else acc + t
        partials.append(acc.double())
    return sum(partials)


def _xt_theta(x, th):
    """[x^T theta'] (D, M) by tiles: each tile's product in float32, then _tile_sums."""
    return _tile_sums(torch.einsum("nd,nm->ndm", x, th))


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
    rng = np.random.default_rng(d)
    x = _x(d, d + 1)
    scale = 1.0 / np.sqrt(d)
    alpha = torch.tensor(rng.normal(size=C) * scale, dtype=torch.float32)
    beta = torch.tensor(rng.normal(size=(d, C)) * scale, dtype=torch.float32)
    y = {"bernoulli_logit": rng.integers(0, 2, N), "poisson_log": rng.poisson(2.0, N),
         "normal_id": rng.normal(size=N), "neg_binomial_2_log": rng.poisson(3.0, N)}[family]
    y = torch.tensor(y, dtype=torch.float32)
    extra = torch.tensor(0.5 + rng.uniform(size=C) * 3.0, dtype=torch.float32) if gf.HAS_EXTRA[family] else None
    eta = _sliced_eta(x, beta) + alpha
    lp, tp, de = gf._core(family, eta, y[:, None], None if extra is None else extra[None, :])
    got = [_tile_sums(lp), _tile_sums(tp), _xt_theta(x, tp)] + ([_tile_sums(de)] if extra is not None else [])
    want = gf.glm_fused_parts_reference(family, y.double(), x.double(), alpha.double(), beta.double(),
                                        None if extra is None else extra.double())
    _check(got, [w for w in want if w is not None], ["logp", "ga", "gb", "ge"])


@pytest.mark.parametrize("d, k", ORDERED)
def test_sliced_ordered_kernel_holds_the_tolerance(d, k):
    """The ordered kernel's core on the sliced eta, the cut pair read by index
    (-/+1e4 at the ends), gcuts summed by tiles."""
    rng = np.random.default_rng(d + k)
    x = _x(d, d + k + 1)
    beta = torch.tensor(rng.normal(size=(d, C)) / np.sqrt(d), dtype=torch.float32)
    cuts = torch.tensor(np.cumsum(0.3 + rng.uniform(size=(k - 1, C)), axis=0) - 0.5 * k, dtype=torch.float32)
    y = torch.tensor(rng.integers(1, k + 1, N), dtype=torch.int32)
    eta = _sliced_eta(x, beta)
    ext = torch.cat([torch.full((1, C), -gf.ORD_BIG), cuts, torch.full((1, C), gf.ORD_BIG)])
    yl = y.long()
    u2, u1 = ext[yl] - eta, ext[yl - 1] - eta
    sp2, sp1 = gf._softplus(u2), gf._softplus(u1)
    lp = u2 - sp2 - sp1 + gf.log1m_exp(torch.clamp(u1 - u2, -80.0, -1e-20))
    w2, w1 = torch.exp(u2 - 2.0 * sp2 - lp), torch.exp(u1 - 2.0 * sp1 - lp)
    onehot = torch.nn.functional.one_hot(yl, k + 1).float()  # (N, K+1)
    gc = _tile_sums(onehot[:, 1:k, None] * w2[:, None, :] - onehot[:, 2 : k + 1, None] * w1[:, None, :])
    got = [_tile_sums(lp), _xt_theta(x, w1 - w2), gc]
    want = gf.ordered_logistic_glm_parts_reference(y, x.double(), beta.double(), cuts.double())
    _check(got, want, ["logp", "gbeta", "gcuts"])


def _tiled_eta(x, bmat):
    """Product 1 of the tiled pair: x (N, D) @ bmat (D, M), D in slices of 32,
    each slice's 3xTF32 product (zero-padded to whole k8 steps) from zero,
    the slices added in float32."""
    eta = None
    for d0 in range(0, x.shape[1], gf.TILED_DS):
        xs, bs = x[:, d0 : d0 + gf.TILED_DS], bmat[d0 : d0 + gf.TILED_DS]
        pad = (-xs.shape[1]) % 8
        p = tc_product(torch.nn.functional.pad(xs, (0, pad)), torch.nn.functional.pad(bs, (0, 0, 0, pad)))
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
    onehot = torch.nn.functional.one_hot(yk, k).float()[:, None, :]
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


@pytest.mark.parametrize("n, c", [(4099, 20), (100_000, 256)])
def test_every_c1_input_has_a_route(n, c):
    for d in FAMILY_D:
        assert gf.glm_tile_plan(n, d, c, SMS)["route"] == "fma"
    for d, k in ORDERED:
        assert gf.glm_tile_plan(n, d, c, SMS, kcat=k)["route"] == "fma"
    for d, k in CATEGORICAL + ((7, 65), (320, 5), (700, 3), (330, 30), (400, 12)):
        _tiled_plan_holds(gf.categorical_route(n, d, c, k, SMS), n, d, c, k)
    # a shape of the first tensor-core kernel keeps it: a route by shape, not a threshold
    assert gf.categorical_route(n, 50, c, 5, SMS)["kernel"] == "single"
    assert gf.categorical_route(n, 50, c, 5, SMS)["n_cols"] == gf.categorical_tile_plan(n, 50, c, 5, SMS)["n_cols"]
    assert gf.categorical_route(n, 211, c, 40, SMS)["kernel"] == "single"
    assert gf.categorical_route(n, 319, c, 5, SMS)["kernel"] == "single"
    assert gf.categorical_route(n, 64, c, 64, SMS)["kernel"] == "single"
    assert gf.glm_tile_plan(n, 33, c, SMS)["route"] == "tensor_cores"


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


def test_float32_kernels_shared_memory_does_not_grow():
    """The C source: the slices are 64 wide, and the float32 kernels' shared
    memory is a constant."""
    with open(os.path.join(ROOT, "math_tpu_torch/csrc/glm_fused.cu"), encoding="utf-8") as f:
        cu = f.read()
    assert f"constexpr int DS = {DS};" in cu
    assert "constexpr size_t FUSED_SMEM = sizeof(float) * (TM * TC + DS * TC + TM * DS + TM);" in cu
    assert "glm_categorical_wide" not in cu and "CatTile" not in cu  # the categorical shapes are all on the tensor cores


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
