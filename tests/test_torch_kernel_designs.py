"""PyTorch port: the arithmetic of the hand-written CUDA kernels, emulated on the CPU.

The kernels run only on a GPU.  What can be checked here is the arithmetic they
are built on, in the order they do it:

- the 3xTF32 split of ``csrc/tf32x3.cuh`` (``cvt.rna.tf32.f32``: round to
  nearest, ties away from zero, to 10 explicit mantissa bits) and the three
  products of the categorical kernel, ``x @ beta`` and ``[x, 1]^T theta'``,
  emulated in float32 in the kernel's order (k8 steps, small terms first, a
  float32 sum per block of row tiles, the blocks' partials in double) and held
  against float64 at N=4,000, D=50, C*K=80 with the kernel's tolerances: logp
  rtol 2e-5; gradients rtol 3e-4, atol 1e-3 * N / 3000 (``chip_smoke.compare``);
- the categorical kernel's tile plan for every K the dispatcher takes;
- the block kernel's panelled factor and inverse (``csrc/chol_inv_block.cu``)
  emulated step by step in float32 at panel widths 8 and 16, held against
  float64 ``torch.linalg`` with the tolerances of ``chip_smoke.compare_chol``
  and against ``math_tpu.ops.chol_pallas.chol_inv_block`` (its Pallas kernel in
  interpret mode), NaN pattern included;
- the kernel loader's hash covers the headers a source includes.
"""

import os
import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from math_tpu.ops import chol_pallas as jcp
from math_tpu_torch import get_config, update_config
from math_tpu_torch.ops import _build
from math_tpu_torch.ops import chol_blocked as tcb
from math_tpu_torch.ops import glm_fused as gf
from tf32_emulation import split, tc_blocked_product, tc_product
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SMS = 132  # the H100's SMs, for the tile plan

# --- 3xTF32 (the emulation in tf32_emulation.py) ----------------------------


N_EMU, D_EMU, C_EMU, K_EMU = 4000, 50, 16, 5  # C*K = 80 columns
GRAD_ATOL = 1e-3 * N_EMU / 3000.0


def _categorical_data():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(N_EMU, D_EMU)).astype(np.float32)
    alpha = (rng.normal(size=(C_EMU, K_EMU)) * 0.3).astype(np.float32)
    beta = (rng.normal(size=(C_EMU, D_EMU, K_EMU)) * 0.1).astype(np.float32)
    y = rng.integers(1, K_EMU + 1, N_EMU).astype(np.int32)
    return torch.tensor(y), torch.tensor(x), torch.tensor(alpha), torch.tensor(beta)


def _emulated_categorical(y, x, alpha, beta, eta_terms=3, grad_terms=3, emulate=("eta", "grad")):
    """The categorical kernel's arithmetic (logp, galpha, gbeta); the products
    named in ``emulate`` go through ``tc_product``, the rest in float64."""
    n, d = x.shape
    c, _, k = beta.shape
    plan = gf.categorical_tile_plan(n, d, c, k, SMS)
    bmat = beta.permute(1, 0, 2).reshape(d, c * k)  # (D, C*K): column c*K + k
    if "eta" in emulate:
        eta = tc_product(torch.nn.functional.pad(x, (0, (-d) % 8)),
                         torch.nn.functional.pad(bmat, (0, 0, 0, (-d) % 8)), eta_terms) + alpha.reshape(-1)
    else:
        eta = (x.double() @ bmat.double() + alpha.reshape(-1).double()).float()
    e = eta.view(n, c, k)
    yk = (y.long() - 1).clamp(0, k - 1)
    mx = e.max(-1, keepdim=True).values
    se = torch.exp(e - mx).sum(-1, keepdim=True)
    lp = torch.gather(e, -1, yk[:, None, None].expand(n, c, 1))[..., 0] - (mx + torch.log(se))[..., 0]
    thetap = torch.nn.functional.one_hot(yk, k)[:, None, :].float() - torch.exp(e - mx) * (1.0 / se)
    logp = torch.stack([lp[r : r + 64].sum(0).double() for r in range(0, n, 64)]).sum(0)  # per tile in float
    xt1 = torch.cat([x, torch.ones(n, 1)], dim=1).mT  # (D + 1, N)
    th = thetap.reshape(n, c * k)
    if "grad" in emulate:
        g = tc_blocked_product(xt1, th, plan["row_blocks"], grad_terms)
    else:
        g = xt1.double() @ th.double()
    g = g.view(d + 1, c, k)
    return logp, g[d], g[:d].permute(1, 0, 2)


def _check_against_float64(got, want):
    ok = True
    worst = {}
    for name, gv, wv in zip(("logp", "galpha", "gbeta"), got, want):
        rtol, atol = (2e-5, 0.0) if name == "logp" else (3e-4, GRAD_ATOL)
        err = (gv.double() - wv).abs()
        ok &= bool((err <= atol + rtol * wv.abs()).all())
        worst[name] = float(err.max())
    return ok, worst


@pytest.mark.parametrize("a", [1.0, -1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-12, -(1.0 + 2.0**-11), 3.14159265, 1e-30, 7.0e20])
def test_tf32_round_is_round_to_nearest_ties_away(a):
    v = torch.tensor([a], dtype=torch.float32)
    hi, lo = split(v)
    assert int(hi.view(torch.int32)) & 0x1FFF == 0 and int(lo.view(torch.int32)) & 0x1FFF == 0
    exact = float(v)
    ulp = 2.0 ** (np.floor(np.log2(abs(exact))) - 10)  # TF32 keeps 10 explicit mantissa bits
    assert abs(float(hi) - exact) <= ulp / 2
    if exact == 1.0 + 2.0**-11:  # a tie: away from zero
        assert float(hi) == 1.0 + 2.0**-10
    assert abs(float(hi) + float(lo) - exact) <= abs(exact) * 2.0**-21


@pytest.mark.parametrize("case", ["eta", "xt_theta", "function"])
def test_tf32x3_products_hold_the_kernel_tolerance(case):
    """Each product, then the whole function, with 3xTF32 in place of float32
    products, against the float64 plain version."""
    y, x, alpha, beta = _categorical_data()
    want = gf.categorical_logit_glm_parts_reference(y, x.double(), alpha.double(), beta.double())
    emulate = {"eta": ("eta",), "xt_theta": ("grad",), "function": ("eta", "grad")}[case]
    ok, worst = _check_against_float64(_emulated_categorical(y, x, alpha, beta, emulate=emulate), want)
    assert ok, worst


@pytest.mark.parametrize("which", ["eta", "xt_theta"])
def test_one_tf32_product_misses_the_tolerance(which):
    """The check above can fail: one TF32 product (hi*hi alone) is some three
    digits and breaks the kernel's tolerance, which is why the kernel takes three."""
    y, x, alpha, beta = _categorical_data()
    want = gf.categorical_logit_glm_parts_reference(y, x.double(), alpha.double(), beta.double())
    kw = {"eta_terms": 1, "emulate": ("eta",)} if which == "eta" else {"grad_terms": 1, "emulate": ("grad",)}
    ok, worst = _check_against_float64(_emulated_categorical(y, x, alpha, beta, **kw), want)
    assert not ok, worst


# --- the categorical kernel's tile plan -------------------------------------


def test_tile_plan_instances_are_the_kernels():
    with open(os.path.join(ROOT, "math_tpu_torch/csrc/glm_categorical.cu"), encoding="utf-8") as f:
        cu = f.read()
    line = re.search(r"#define GLM_CATEGORICAL_INSTANCES\(X\)(.*)", cu).group(1)
    pairs = [(int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", line)]
    assert sorted(pairs) == sorted(gf.CATEGORICAL_INSTANCES)
    assert {mt for _, mt in pairs} == set(range(1, 6))


def test_tile_plan_at_the_main_shape():
    plan = gf.categorical_tile_plan(100_000, 50, 256, 5, SMS)
    assert plan == {"wgs": 2, "n_cols": 80, "mt": 1, "cpt": 16, "column_tiles": 16, "stages": 2,
                    "smem": gf.categorical_smem_bytes(80, 50, 16, 2), "blocks_per_sm": 2, "row_blocks": 16}
    assert 2 * (plan["smem"] + 1024) <= gf.SM_SMEM_BYTES


@pytest.mark.parametrize("k", range(1, gf.MAX_CLASSES + 1))
def test_tile_plan_for_every_class_count(k):
    """Every K the dispatcher takes has a plan at the main width and at a
    ragged one: whole chains in a tile whose width is a multiple of 32 (so of
    8), every chain in some tile, shared memory within a block's, enough row
    blocks to fill the card without a second wave of blocks."""
    for n, d, c in ((100_000, 50, 256), (1537, 7, 5), (300, 127, 3)):
        plan = gf.categorical_tile_plan(n, d, c, k, SMS)
        assert plan is not None, (n, d, c, k)
        assert plan["n_cols"] == 40 * plan["wgs"] and plan["n_cols"] % 8 == 0
        assert (plan["wgs"], plan["mt"]) in gf.CATEGORICAL_INSTANCES and 64 * plan["mt"] >= d + 1
        assert plan["cpt"] == plan["n_cols"] // k >= 1
        assert plan["column_tiles"] * plan["cpt"] >= c > (plan["column_tiles"] - 1) * plan["cpt"]
        assert plan["smem"] == gf.categorical_smem_bytes(plan["n_cols"], d, plan["cpt"], plan["stages"]) <= gf.MAX_SMEM_BYTES
        assert plan["blocks_per_sm"] * (plan["smem"] + 1024) <= gf.SM_SMEM_BYTES
        assert 1 <= plan["row_blocks"] <= -(-n // 64)
        assert plan["row_blocks"] * plan["column_tiles"] <= plan["blocks_per_sm"] * SMS or plan["row_blocks"] == 1


# --- the block kernel's panels ----------------------------------------------


def panel_chol_inv(d, p):
    """``(U, W)`` by the block kernel's algorithm, in its order, in float32:
    right-looking panels of ``p`` columns (diagonal block, the panel's row
    block by forward substitution, the trailing update), then the diagonal
    blocks of ``W`` and its row panels from the bottom up (``T = U_i,> W_>``,
    then back substitution with ``U_ii``)."""
    d = d.float()
    cb, B, _ = d.shape
    m = d.clone()
    w = torch.zeros_like(d)
    bad = torch.zeros(cb, dtype=torch.bool)
    nan = torch.tensor(float("nan"))
    upper = torch.ones(B, B, dtype=torch.bool).triu()
    for k0 in range(0, B, p):
        kb = min(p, B - k0)
        for j in range(kb):
            kj = k0 + j
            piv2 = m[:, kj, kj].clone()
            ok = piv2 > 0
            bad |= ~ok
            pivot = torch.where(ok, torch.sqrt(torch.where(ok, piv2, 1.0)), nan)
            m[:, kj, kj : k0 + kb] = m[:, kj, kj : k0 + kb] / pivot[:, None]
            u = m[:, kj, kj + 1 : k0 + kb]
            blk = m[:, kj + 1 : k0 + kb, kj + 1 : k0 + kb]
            tri = upper[: kb - j - 1, : kb - j - 1]
            m[:, kj + 1 : k0 + kb, kj + 1 : k0 + kb] = torch.where(tri, blk - u[:, :, None] * u[:, None, :], blk)
        t0 = k0 + kb
        if t0 >= B:
            break
        for i in range(kb):
            ki = k0 + i
            acc = m[:, ki, t0:].clone()
            for l in range(i):
                acc = acc - m[:, k0 + l, ki, None] * m[:, k0 + l, t0:]
            m[:, ki, t0:] = acc / m[:, ki, ki, None]
        panel = m[:, k0:t0, t0:]
        trail = m[:, t0:, t0:]
        m[:, t0:, t0:] = torch.where(upper[t0:, t0:], trail - panel.mT @ panel, trail)
    n_panels = -(-B // p)
    for q in range(n_panels):
        p0, pb = q * p, min(p, B - q * p)
        for k in reversed(range(pb)):
            rk = p0 + k
            ek = torch.zeros(pb - k)
            ek[0] = 1.0
            acc = ek - (m[:, rk, None, rk + 1 : p0 + pb] @ w[:, rk + 1 : p0 + pb, rk : p0 + pb])[:, 0]
            w[:, rk, rk : p0 + pb] = acc / m[:, rk, rk, None]
    for q in reversed(range(n_panels - 1)):
        i0, j0 = q * p, q * p + p
        t = m[:, i0:j0, j0:] @ w[:, j0:, j0:]
        for k in reversed(range(p)):
            rk = i0 + k
            acc = -t[:, k] - (m[:, rk, None, rk + 1 : j0] @ w[:, rk + 1 : j0, j0:])[:, 0]
            w[:, rk, j0:] = acc / m[:, rk, rk, None]
    u = torch.where(upper, m, torch.zeros(()))
    w = torch.where(bad[:, None, None], nan, w)
    return u, w


def _gp_block(rng, b):
    """A block as the GP path meets it: squared-exponential kernel of sorted
    points plus (sigma^2 + jitter) on the diagonal (condition number ~ 3e3)."""
    x = np.sort(rng.uniform(-5.0, 5.0, b))
    k = 1.4**2 * np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2 / 0.6**2)
    return k + (0.3**2 + 1e-3) * np.eye(b)


@pytest.mark.parametrize("b", [16, 37, 128])
@pytest.mark.parametrize("p", [8, 16])
def test_panel_order_against_float64_and_the_pallas_kernel(p, b):
    rng = np.random.default_rng(b + p)
    a = rng.normal(size=(2, b, b))
    d = np.concatenate([a @ np.swapaxes(a, -1, -2) + b * np.eye(b), _gp_block(rng, b)[None]])
    u, w = panel_chol_inv(torch.tensor(d, dtype=torch.float32), p)
    u32 = torch.tensor(d, dtype=torch.float32).double()  # the float32 inputs, exactly
    l64 = torch.linalg.cholesky(u32)
    u64 = l64.mT
    w64 = torch.linalg.solve_triangular(u64, torch.eye(b, dtype=torch.float64).expand_as(u64), upper=True)
    ju, jw = (torch.tensor(np.asarray(v)) for v in jcp.chol_inv_block(jnp.asarray(u32.numpy())))
    for want_u, want_w in ((u64, w64), (ju, jw)):
        assert float((u.double() - want_u).abs().max()) <= 1e-4 * float(want_u.abs().max())
        assert float((w.double() - want_w).abs().max()) <= 1e-4 * float(want_w.abs().max())
    assert float((u.double().mT @ u.double() - u32).abs().max()) <= 2e-5 * float(u32.abs().max())
    assert float((u.double() @ w.double() - torch.eye(b, dtype=torch.float64)).abs().max()) <= 1e-4
    assert bool((u.tril(-1) == 0).all() and (w.tril(-1) == 0).all())


@pytest.mark.parametrize("b,bad_pivot", [(16, 5), (37, 20), (128, 70)])
@pytest.mark.parametrize("p", [8, 16])
def test_panel_order_nan_pattern_on_a_non_pd_block(p, b, bad_pivot):
    """Matrix 1 of 3 is not positive definite from ``bad_pivot`` on: NaN
    exactly where the Pallas kernel has NaN (U from that row on, W
    everywhere), the other matrices untouched."""
    rng = np.random.default_rng(5)
    a = rng.normal(size=(3, b, b))
    d = a @ np.swapaxes(a, -1, -2) + b * np.eye(b)
    d[1, bad_pivot, bad_pivot] = -5.0
    u, w = panel_chol_inv(torch.tensor(d, dtype=torch.float32), p)
    ju, jw = (np.asarray(v) for v in jcp.chol_inv_block(jnp.asarray(np.asarray(d, dtype=np.float32).astype(np.float64))))
    for got, want in ((u.numpy(), ju), (w.numpy(), jw)):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.isfinite(got[[0, 2]]).all()
    assert np.isnan(u.numpy()[1, bad_pivot:, bad_pivot:][np.triu_indices(b - bad_pivot)]).all()
    assert np.isfinite(u.numpy()[1, :bad_pivot]).all()


@pytest.mark.parametrize("b,p", [(16, 16), (37, 16), (128, 16), (128, 8)])
def test_block_kernel_stage_count(b, p):
    """The stages the kernel separates by block barriers: load, per panel the
    diagonal block (and, but for the last, the row block and the trailing
    update), the diagonal inverses, two per off-diagonal row panel of W."""
    n = -(-b // p)
    assert tcb.block_kernel_stages(b, p) == 1 + (3 * n - 2) + 1 + 2 * (n - 1)
    assert tcb.block_kernel_stages(128) == 38 < 2 * 128
    with open(os.path.join(ROOT, "math_tpu_torch/csrc/chol_inv_block.cu"), encoding="utf-8") as f:
        assert f"constexpr int P = {tcb.PANEL};" in f.read()


# --- the kernel loader -------------------------------------------------------


@pytest.mark.parametrize("edit", ["header", "source"])
def test_library_hash_covers_included_headers(tmp_path, monkeypatch, edit):
    """An edited header, or source, gives another library path, so the
    library is rebuilt; an unchanged tree gives the same path."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "h.cuh"\nextern "C" int f() { return G; }\n')
    (csrc / "h.cuh").write_text('#pragma once\n#include "g.cuh"\n')
    (csrc / "g.cuh").write_text("#define G 1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    old = get_config().kernel_build_dir
    update_config(kernel_build_dir=str(tmp_path / "build"))
    try:
        assert [os.path.basename(s) for s in _build.sources_of(_build.source_path("k"))] == ["k.cu", "h.cuh", "g.cuh"]
        first = _build.library_path("k")
        assert _build.library_path("k") == first
        if edit == "header":
            (csrc / "g.cuh").write_text("#define G 2\n")
        else:
            (csrc / "k.cu").write_text('#include "h.cuh"\nextern "C" int f() { return G + 1; }\n')
        assert _build.library_path("k") != first
    finally:
        update_config(kernel_build_dir=old)
