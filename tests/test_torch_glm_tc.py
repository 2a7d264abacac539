"""PyTorch port: the arithmetic of the tensor-core GLM kernels (kernel 1, four
families, and the ordered kernel), emulated on the CPU.

``glm_tc_kernel`` in ``csrc/glm_fused.cu`` runs only on a GPU.  What is checked
here is the arithmetic it is built on, in its order:

- both products taken transposed, as three TF32 products each (the 3xTF32 split
  of ``csrc/tf32x3.cuh``, small terms first: in product 1 those of every k8
  step before the large ones, in product 2 per k8 step): eta^T = beta^T
  x^T per half tile of 32 rows, and theta'^T [x, 1] per half tile from zero,
  added into the block's float32 sums; the tile sums of lp, ge and gcuts in
  double; the two halves added, then the blocks' partials in double.  Held
  against the float64 plain version with the kernels' gates (logp rtol 2e-5;
  gradients rtol 3e-4, atol 1e-3 * N / 3000; ``chip_smoke.compare``) at
  N=3,000, D=50, C=64, and against the Pallas kernels of the JAX package in
  interpret mode (``pallas_glm._fused_forward``, ``_ordered_forward``) at N=700,
  D=12, C=16, two float32 implementations, at the tolerances of
  ``tests/test_torch_glm_fused.py`` (values rtol 3e-5, atol 1e-3; gradients
  rtol 3e-4, atol 1e-3); and, with sums truncated into the accumulator as
  the tensor core takes them, product 1's order keeping poisson's ga inside
  its gate where the per-step order does not;
- the permutation that lets product 2 take theta' from product 1's
  accumulator registers: the fragment order of ``glm_fused.cu`` and
  ``k8_position`` of ``tf32x3.cuh``, read from the sources, are exactly the map
  from the accumulator of an m64nNk8 product to the A fragment of the next, as
  an index map and on integers; wrong maps fail;
- the tiled route's arithmetic (``tests/test_torch_glm_wide.py``) against
  the Pallas kernels in interpret mode at a wide shape (N=300, D=96, C=16);
- ``glm_tile_plan``: the main shape, and which kernel the wrapper's plan sends
  each shape to.
"""

import os
import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch
import torch.nn.functional as F

from math_tpu.ops import pallas_glm as pg
from math_tpu_torch.ops import glm_fused as gf
from test_torch_glm_wide import tiled_family, tiled_ordered
from test_torch_kernel_designs import split, tc_product
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SMS = 132  # the H100's SMs, for the tile plan
N_E, D_E, C_E = 3000, 50, 64
N_P, D_P, C_P = 700, 12, 16
K_ORD = 5


def _source(name):
    with open(os.path.join(ROOT, "math_tpu_torch", "csrc", name), encoding="utf-8") as f:
        return f.read()


# --- the kernel's arithmetic -------------------------------------------------


def _family_core(family, extra):
    def core(eta, y):
        e2 = extra[None, :] if gf.HAS_EXTRA[family] else None
        lp, tp, de = gf._core(family, eta, y[:, None], e2)
        sums = [lp.sum(0)] + ([de.sum(0)] if de is not None else [torch.zeros_like(lp[0])])
        return tp, torch.stack(sums)
    return core


def _ordered_core(cuts):
    """The ordered kernel's core: the cut pair by index from the extended cut
    tile, log1m_exp of c_{y-1} - c_y (it does not depend on eta), gcuts as
    sums of w2 at y = j and -w1 at y = j + 1."""
    k = cuts.shape[0] + 1
    big = torch.full((1, cuts.shape[1]), gf.ORD_BIG, dtype=cuts.dtype)
    ext = torch.cat([-big, cuts, big])  # (K + 1, C)
    lm = gf.log1m_exp(torch.clamp(ext[:-1] - ext[1:], -80.0, -1e-20))  # (K, C): y = 1..K

    def core(eta, y):
        yl = torch.clamp(y.long(), 1, k)
        u2 = ext[yl] - eta
        u1 = ext[yl - 1] - eta
        sp2, sp1 = gf._softplus(u2), gf._softplus(u1)
        lp = u2 - sp2 - sp1 + lm[yl - 1]
        w2 = torch.exp(u2 - 2.0 * sp2 - lp)
        w1 = torch.exp(u1 - 2.0 * sp1 - lp)
        gc = [(w2 * (yl == j)[:, None]).sum(0) - (w1 * (yl == j + 1)[:, None]).sum(0) for j in range(1, k)]
        return w1 - w2, torch.stack([lp.sum(0)] + gc)
    return core


def tc_product_small_first(a, b, terms=3, acc_round=lambda v: v.float()):
    """Product 1 as the kernel orders it: the two small products
    ``lo_a hi_b + hi_a lo_b`` of every k8 step first, then the ``hi_a hi_b``
    of every step, each added into one float32 accumulator (``acc_round``:
    how a sum taken exactly is rounded into it; ``terms=1``: ``hi_a hi_b``
    alone)."""
    a_hi, a_lo = split(a.float())
    b_hi, b_lo = split(b.float())
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    steps = [slice(k, k + 8) for k in range(0, a.shape[1], 8)]
    if terms == 3:
        for s in steps:
            acc = acc_round(acc.double() + a_lo[:, s].double() @ b_hi[s].double())
            acc = acc_round(acc.double() + a_hi[:, s].double() @ b_lo[s].double())
    for s in steps:
        acc = acc_round(acc.double() + a_hi[:, s].double() @ b_hi[s].double())
    return acc


def emulate_tc(x, beta, y, core, ones_column, row_blocks, terms=3):
    """The tensor-core kernel's arithmetic in float32: per block of row tiles
    (tile t in block t % row_blocks), per half tile of 32 rows, eta^T by
    ``tc_product_small_first`` of beta^T and the rows' x^T (Dp padded to 8);
    the core; product 2 theta'^T [x, 1] (64 columns) from zero, added to the half's
    float32 sums; the core's sums per tile in double.  Returns the core's sums
    (Q, C) and [gb; ga] (64, C), the blocks' partials added in double."""
    n, d = x.shape
    dp = -(-d // 8) * 8
    xp = F.pad(x, (0, dp - d))
    x2 = torch.zeros((n, 64), dtype=torch.float32)
    x2[:, :d] = x
    if ones_column:
        x2[:, d] = 1.0
    bt = F.pad(beta.mT, (0, dp - d))  # (C, Dp): chains x features, A of product 1
    total_s = total_g = 0.0
    for blk in range(row_blocks):
        dsum = [0.0, 0.0]
        gsum = [torch.zeros((beta.shape[1], 64)), torch.zeros((beta.shape[1], 64))]
        for t in range(blk, -(-n // 64), row_blocks):
            for h in (0, 1):
                r = slice(64 * t + 32 * h, min(64 * t + 32 * h + 32, n))
                if r.start >= n:
                    continue
                eta = tc_product_small_first(bt, xp[r].mT, terms).mT  # (rows, C)
                tp, sums = core(eta, y[r])
                dsum[h] = dsum[h] + sums.double()
                gsum[h] = gsum[h] + tc_product(tp.mT, x2[r], terms)
        total_s = total_s + (dsum[0] + dsum[1]).float().double()
        total_g = total_g + (gsum[0] + gsum[1]).mT.double()
    return total_s, total_g


def emulated_family(family, y, x, alpha, beta, extra, terms=3):
    """(logp, ga, gb, ge) of kernel 1 by ``emulate_tc``; alpha enters the core."""
    n, d = x.shape
    plan = gf.glm_tile_plan(n, d, beta.shape[1], SMS)
    core = _family_core(family, extra)
    s, g = emulate_tc(x, beta, y, lambda eta, yy: core(eta + alpha[None, :], yy), True, plan["row_blocks"], terms)
    return s[0], g[d], g[:d], (s[1] if gf.HAS_EXTRA[family] else None)


def emulated_ordered(y, x, beta, cuts, terms=3):
    """(logp, gbeta, gcuts) of the ordered kernel by ``emulate_tc``."""
    n, d = x.shape
    plan = gf.glm_tile_plan(n, d, beta.shape[1], SMS, kcat=cuts.shape[0] + 1)
    s, g = emulate_tc(x, beta, y, _ordered_core(cuts), False, plan["row_blocks"], terms)
    return s[0], g[:d], s[1:]


def family_inputs(family, n, d, c, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    alpha = (rng.normal(size=c) * 0.1).astype(np.float32)
    beta = (rng.normal(size=(d, c)) * 0.1).astype(np.float32)
    extra = None
    if family == "bernoulli_logit":
        y = rng.integers(0, 2, n)
    elif family == "poisson_log":
        y = rng.poisson(2.0, n)
    elif family == "normal_id":
        y = rng.normal(size=n)
        extra = (0.5 + rng.uniform(size=c)).astype(np.float32)
    else:
        y = rng.poisson(3.0, n)
        extra = (1.0 + 3.0 * rng.uniform(size=c)).astype(np.float32)
    return y.astype(np.float32), x, alpha, beta, extra


def ordered_inputs(n, d, c, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    beta = (rng.normal(size=(d, c)) * 0.1).astype(np.float32)
    cuts = (np.cumsum(0.3 + rng.uniform(size=(k - 1, c)), axis=0) - 0.5 * k).astype(np.float32)
    y = rng.integers(1, k + 1, n).astype(np.int32)
    return y, x, beta, cuts


def t32(arrays):
    return [None if a is None else torch.tensor(a) for a in arrays]


def t64(arrays):
    return [None if a is None else torch.tensor(a, dtype=torch.float64 if a.dtype.kind == "f" else None) for a in arrays]


def within_gates(got, want, names, n):
    """The kernels' gates against float64: logp rtol 2e-5; gradients rtol
    3e-4, atol 1e-3 * N / 3000.  Returns (ok, worst error by output)."""
    ok, worst = True, {}
    for name, g, w in zip(names, got, want):
        if w is None:
            continue
        rtol, atol = (2e-5, 0.0) if name == "logp" else (3e-4, 1e-3 * n / 3000.0)
        err = (g.double() - w).abs()
        ok &= bool((err <= atol + rtol * w.abs()).all())
        worst[name] = float(err.max())
    return ok, worst


@pytest.mark.parametrize("family", gf.FAMILIES)
def test_family_emulation_against_float64(family):
    arrays = family_inputs(family, N_E, D_E, C_E, seed=31)
    got = emulated_family(family, *t32(arrays))
    want = gf.glm_fused_parts_reference(family, *t64(arrays))
    ok, worst = within_gates(got, want, ("logp", "ga", "gb", "ge"), N_E)
    assert ok, worst


def test_ordered_emulation_against_float64():
    arrays = ordered_inputs(N_E, D_E, C_E, K_ORD, seed=32)
    got = emulated_ordered(*t32(arrays))
    want = gf.ordered_logistic_glm_parts_reference(*t64(arrays))
    ok, worst = within_gates(got, want, ("logp", "gbeta", "gcuts"), N_E)
    assert ok, worst


@pytest.mark.parametrize("which", ["family", "ordered"])
def test_one_tf32_product_misses_the_gates(which):
    """The check above can fail: with one TF32 product (hi*hi alone) the same
    emulation breaks the gates, which is why the kernels take three."""
    if which == "family":
        arrays = family_inputs("bernoulli_logit", N_E, D_E, C_E, seed=31)
        got = emulated_family("bernoulli_logit", *t32(arrays), terms=1)
        want = gf.glm_fused_parts_reference("bernoulli_logit", *t64(arrays))
        names = ("logp", "ga", "gb", "ge")
    else:
        arrays = ordered_inputs(N_E, D_E, C_E, K_ORD, seed=32)
        got = emulated_ordered(*t32(arrays), terms=1)
        want = gf.ordered_logistic_glm_parts_reference(*t64(arrays))
        names = ("logp", "gbeta", "gcuts")
    ok, worst = within_gates(got, want, names, N_E)
    assert not ok, worst


def _toward_zero(v):
    """float64 -> float32 rounded toward zero, as the tensor core rounds a sum
    into its accumulator."""
    f = v.float()
    return torch.where(f.double().abs() > v.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def _per_step_order(a, b):
    """Product 1 with each k8 step's three products in turn, small first: the
    order the kernel took before, kept as the check's counterexample."""
    a_hi, a_lo = split(a.float())
    b_hi, b_lo = split(b.float())
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        for p, q in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
            acc = _toward_zero(acc.double() + p[:, s].double() @ q[s].double())
    return acc


def test_product_1_order_under_truncating_sums():
    """With sums truncated into the accumulator, poisson's ga (theta' = y -
    exp(eta) carries eta's bias, a sum over every row) stays inside its gate
    with the kernel's order of product 1 and not with the per-step order:
    N=4099, D=33, C=200, beta and alpha at 0.2 (|eta| up to ~6.5)."""
    n, d, c = 4099, 33, 200
    rng = np.random.default_rng(120)
    x = torch.tensor(rng.normal(size=(n, d)), dtype=torch.float32)
    alpha = torch.tensor(rng.normal(size=c) * 0.2, dtype=torch.float32)
    beta = torch.tensor(rng.normal(size=(d, c)) * 0.2, dtype=torch.float32)
    y = torch.tensor(rng.poisson(2.0, n), dtype=torch.float64)[:, None]
    xp = F.pad(x, (0, 40 - d))
    bt = F.pad(beta.mT, (0, 40 - d))
    want = (y - torch.exp(x.double() @ beta.double() + alpha.double())).sum(0)
    gate = 1e-3 * n / 3000.0 + 3e-4 * want.abs()

    def worst(eta_t):
        return float(((y - torch.exp(eta_t.mT.double() + alpha.double())).sum(0) - want).abs().div(gate).max())

    kernel_order = worst(tc_product_small_first(bt, xp.mT, acc_round=_toward_zero))
    per_step = worst(_per_step_order(bt, xp.mT))
    assert kernel_order < 0.8 and per_step > 1.0, (kernel_order, per_step)


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("family", gf.FAMILIES)
def test_family_emulation_against_pallas_interpret(family):
    y, x, alpha, beta, extra = family_inputs(family, N_P, D_P, C_P, seed=33)
    want = pg._fused_forward(family, jnp.asarray(y), jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(beta),
                             None if extra is None else jnp.asarray(extra), interpret=True)
    got = emulated_family(family, *t32((y, x, alpha, beta, extra)))
    for i, (g, w) in enumerate(zip(got, want)):
        if w is not None:
            _close(g.float(), w, rtol=3e-5 if i == 0 else 3e-4, atol=1e-3)


def test_ordered_emulation_against_pallas_interpret():
    y, x, beta, cuts = ordered_inputs(N_P, D_P, C_P, K_ORD, seed=34)
    want = pg._ordered_forward(jnp.asarray(y), jnp.asarray(x), jnp.asarray(beta), jnp.asarray(cuts), interpret=True)
    got = emulated_ordered(*t32((y, x, beta, cuts)))
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.float(), w, rtol=3e-5 if i == 0 else 3e-4, atol=1e-3)


N_W, D_W, C_W = 300, 96, 16  # a wide shape of the tiled route


def test_tiled_family_emulation_against_pallas_interpret():
    """The tiled route's arithmetic (``test_torch_glm_wide.tiled_family``) at
    D = 96 against the Pallas kernel in interpret mode, at the tolerances of
    the narrow shapes above."""
    y, x, alpha, beta, extra = family_inputs("poisson_log", N_W, D_W, C_W, seed=35)
    assert gf.glm_tile_plan(N_W, D_W, C_W, SMS)["kernel"] == "tiled"
    want = pg._fused_forward("poisson_log", jnp.asarray(y), jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(beta), None,
                             interpret=True)
    got = tiled_family("poisson_log", *t32((y, x, alpha, beta, extra)))
    for i, (g, w) in enumerate(zip(got, want)):
        if w is not None:
            _close(g.float(), w, rtol=3e-5 if i == 0 else 3e-4, atol=1e-3)


def test_tiled_ordered_emulation_against_pallas_interpret():
    y, x, beta, cuts = ordered_inputs(N_W, D_W, C_W, 10, seed=36)
    assert gf.glm_tile_plan(N_W, D_W, C_W, SMS, kcat=10)["kernel"] == "tiled"
    want = pg._ordered_forward(jnp.asarray(y), jnp.asarray(x), jnp.asarray(beta), jnp.asarray(cuts), interpret=True)
    got = tiled_ordered(*t32((y, x, beta, cuts)))
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.float(), w, rtol=3e-5 if i == 0 else 3e-4, atol=1e-3)


# --- the accumulator-to-fragment permutation ---------------------------------


def kernel_fragment_order():
    """The accumulator registers product 2's A fragment of k8 step j takes,
    as offsets from 4j, read from glm_fused.cu."""
    m = re.search(r"const uint32_t ah\[4\] = \{([^}]*)\};", _source("glm_fused.cu"))
    return tuple(int(v or 0) for v in re.findall(r"acc\[4 \* j(?: \+ (\d))?\]", m.group(1)))


def kernel_k8_position():
    """``k8_position`` of tf32x3.cuh as a Python function of the row."""
    expr = re.search(r"int k8_position\(int r\) \{ return (.*); \}", _source("tf32x3.cuh")).group(1)
    return lambda r: eval(expr, {"r": r})  # the same integer operators in both languages


def acc_place(w, g, t, i):
    """(row, column) of accumulator register i of lane (g, t) in warp w of an
    m64nNk8 product (tf32x3.cuh): d[4j+0] = D[16w+g][8j+2t], d[4j+1] =
    D[16w+g][8j+2t+1], d[4j+2] = D[16w+g+8][8j+2t], d[4j+3] = D[16w+g+8][8j+2t+1]."""
    j, q = divmod(i, 4)
    return 16 * w + g + 8 * (q >> 1), 8 * j + 2 * t + (q & 1)


def a_place(w, g, t, j, q):
    """(row, K index) of A fragment register q of k8 step j (tf32x3.cuh):
    a[0] = A[16w+g][t], a[1] = A[16w+g+8][t], a[2] = A[16w+g][t+4], a[3] = A[16w+g+8][t+4]."""
    return 16 * w + g + 8 * (q & 1), 8 * j + t + 4 * (q >> 1)


def map_errors(order, position, k8_steps=4):
    """Places where A fragment register q of step j, fed by accumulator
    register 4j + order[q], would not hold the element that B's position
    expects: the same chain row, and B's row at that K position being the
    accumulator's column."""
    bad = 0
    for w in range(4):
        for g in range(8):
            for t in range(4):
                for j in range(k8_steps):
                    for q in range(4):
                        row_acc, col_acc = acc_place(w, g, t, 4 * j + order[q])
                        row_a, k_a = a_place(w, g, t, j, q)
                        bad += row_acc != row_a or position(col_acc) != k_a
    return bad


def test_the_kernels_map_is_the_accumulator_to_fragment_map():
    order, position = kernel_fragment_order(), kernel_k8_position()
    assert order == (0, 2, 1, 3)
    assert sorted(position(r) for r in range(64)) == list(range(64))  # a permutation within groups of 8
    assert all(position(r) // 8 == r // 8 for r in range(64))
    assert map_errors(order, position) == 0


@pytest.mark.parametrize("wrong", ["plain_positions", "accumulator_order", "swapped_halves"])
def test_a_wrong_map_fails(wrong):
    order, position = kernel_fragment_order(), kernel_k8_position()
    if wrong == "plain_positions":
        position = lambda r: r  # noqa: E731
    elif wrong == "accumulator_order":
        order = (0, 1, 2, 3)
    else:
        order = (2, 0, 3, 1)
    assert map_errors(order, position) > 0


@pytest.mark.parametrize("use_kernels_map", [True, False])
def test_product_through_the_registers_on_integers(use_kernels_map):
    """D2 = D1 M with D1 handed from accumulator registers to A fragments and
    M's rows at k8_position: exact on integers with the kernel's map, wrong
    with the plain order."""
    rng = np.random.default_rng(5)
    d1 = rng.integers(-3, 4, size=(64, 32)).astype(np.float64)  # 64 chains x 32 rows (one half tile)
    m = rng.integers(-4, 5, size=(32, 64)).astype(np.float64)  # rows x features
    order, position = kernel_fragment_order(), kernel_k8_position()
    if not use_kernels_map:
        order = (0, 1, 2, 3)
    b = np.zeros_like(m)  # B by K position
    for r in range(32):
        b[position(r)] = m[r]
    a = np.zeros_like(d1)  # A as the fragments hold it
    for w in range(4):
        for g in range(8):
            for t in range(4):
                for j in range(4):
                    for q in range(4):
                        row_acc, col_acc = acc_place(w, g, t, 4 * j + order[q])
                        row_a, k_a = a_place(w, g, t, j, q)
                        a[row_a, k_a] = d1[row_acc, col_acc]
    assert np.array_equal(a @ b, d1 @ m) == use_kernels_map


def test_split_and_product_are_the_designs():
    """The helpers this file shares with the categorical kernel's tests: the
    split keeps 10 explicit bits in hi, and three TF32 products of one k8
    step are within float32 of the exact product."""
    a = torch.tensor(np.random.default_rng(6).uniform(-1, 1, (64, 8)), dtype=torch.float32)
    b = torch.tensor(np.random.default_rng(7).uniform(-1, 1, (8, 32)), dtype=torch.float32)
    hi, lo = split(a)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert float((tc_product(a, b).double() - a.double() @ b.double()).abs().max()) < 1e-5


# --- the tile plan -----------------------------------------------------------


def test_tile_plan_at_the_main_shape():
    smem = gf.glm_tc_smem_bytes(50, 0)
    assert gf.glm_tile_plan(100_000, 50, 256, SMS) == {
        "route": "tensor_cores", "kernel": "single", "chains_per_block": 128, "column_tiles": 2, "smem": smem,
        "row_blocks": 66}
    plan = gf.glm_tile_plan(100_000, 50, 256, SMS, kcat=5)
    assert plan["route"] == "tensor_cores" and plan["kernel"] == "single" and plan["smem"] == gf.glm_tc_smem_bytes(50, 5)
    assert plan["smem"] <= gf.MAX_SMEM_BYTES
    # the widest ordered shapes whose block fits: D = 63 up to K = 5, D = 56 at K = 6-8; past them, the tiled route
    assert gf.glm_tile_plan(100_000, 63, 256, SMS, kcat=5)["kernel"] == "single"
    assert gf.glm_tile_plan(100_000, 56, 256, SMS, kcat=8)["kernel"] == "single"
    assert gf.glm_tile_plan(100_000, 57, 256, SMS, kcat=6)["kernel"] == "tiled"
    assert gf.glm_tile_plan(100_000, 63, 256, SMS, kcat=8)["kernel"] == "tiled"
    assert gf.glm_tile_plan(100_000, 57, 256, SMS, kcat=6)["route"] == "tensor_cores"


@pytest.mark.parametrize("kcat", [None, 2, 3, 5, 8, 9, 12])
@pytest.mark.parametrize("d", [1, 7, 50, 55, 56, 63, 64, 96, 235])
def test_tile_plan_routes_by_shape(d, kcat):
    """D <= 63 and K <= 8 go to glm_tc_kernel where its block fits shared
    memory, in a grid that covers every chain in one wave, one block an SM;
    the other shapes go to the tiled route: column tiles of 128 chains, D in
    slices of 32 and groups of 128, one block an SM over the card.  Every
    shape is on the tensor cores."""
    for n, c in ((100_000, 256), (1537, 5), (300, 64), (5000, 300)):
        plan = gf.glm_tile_plan(n, d, c, SMS, kcat=kcat)
        assert plan["route"] == "tensor_cores", (n, d, c, kcat)
        assert plan["column_tiles"] * plan["chains_per_block"] >= c > (plan["column_tiles"] - 1) * plan["chains_per_block"]
        assert plan["smem"] + 1024 <= gf.SM_SMEM_BYTES
        fits = gf.glm_tc_smem_bytes(d, kcat or 0) <= gf.MAX_SMEM_BYTES
        if d <= gf.TC_MAX_D and (kcat is None or kcat <= gf.TC_MAX_CATEGORIES) and fits:
            assert plan["kernel"] == "single", (n, d, c, kcat)
            assert plan["chains_per_block"] == gf.TC_CHAINS
            assert plan["smem"] == gf.glm_tc_smem_bytes(d, kcat or 0) <= gf.MAX_SMEM_BYTES
            assert 1 <= plan["row_blocks"] <= -(-n // 64)
            assert plan["row_blocks"] * plan["column_tiles"] <= SMS or plan["row_blocks"] == 1
        else:
            assert plan["kernel"] == "tiled", (n, d, c, kcat)
            assert plan["chains_per_block"] == gf.GLM_TILED_CHAINS
            assert plan["smem"] == gf.glm_tiled_smem_bytes() <= gf.MAX_SMEM_BYTES
            assert plan["slices"] == -(-d // gf.GLM_TILED_DS) and plan["feature_groups"] == -(-d // gf.GLM_TILED_FEATURES)
            row_tiles = -(-n // gf.GLM_TILED_ROWS)
            assert 1 <= plan["row_blocks_value"] <= row_tiles
            assert plan["row_blocks_value"] * plan["column_tiles"] <= SMS or plan["row_blocks_value"] == 1
            assert 1 <= plan["row_blocks"] <= 4 * row_tiles
            assert plan["row_blocks"] * plan["feature_groups"] * plan["column_tiles"] <= SMS or plan["row_blocks"] == 1
            assert plan["launches"] == gf.GLM_TILED_LAUNCHES_PER_CALL


def test_tile_plan_constants_are_the_kernels():
    cu = _source("glm_fused.cu")
    assert f"constexpr int TC_MAX_D = {gf.TC_MAX_D};" in cu
    assert f"constexpr int TC_MAX_CATEGORIES = {gf.TC_MAX_CATEGORIES};" in cu
    assert f"constexpr int GSUM_STRIDE = {gf.GSUM_STRIDE};" in cu
    assert f"constexpr int ORDERED_KIND = {gf.ORDERED_KIND};" in cu
    assert f"constexpr int TC_CHAINS = 64 * TC_PAIRS;" in cu and "constexpr int TC_PAIRS = 2;" in cu
    assert gf.TC_CHAINS == 128
    # the limit is glm_common.cuh's, shared with glm_categorical.cu; no source defines its own
    assert f"constexpr size_t MAX_SMEM = {gf.MAX_SMEM_BYTES};" in _source("glm_common.cuh")
    for name in ("glm_fused.cu", "glm_categorical.cu"):
        assert "using glm_common::MAX_SMEM;" in _source(name)
        assert not re.search(r"constexpr size_t \w*MAX_SMEM\b", _source(name)), name
    body = re.search(r"#define GLM_TC_INSTANCES\(X\)(.*?)\n\n", cu, re.S).group(1)
    pairs = {(int(a), int(b)) for a, b in re.findall(r"X\((\d), (\d)\)", body)}
    assert pairs == {(f, 0) for f in range(4)} | {(gf.ORDERED_KIND, k) for k in range(2, gf.TC_MAX_CATEGORIES + 1)}
