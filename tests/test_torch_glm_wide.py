"""PyTorch port: the GLM inputs the dispatchers once refused, on the CPU (the kernels run only on the card).

- The float32 kernels' arithmetic emulated in their order: eta summed over
  slices of 64 features, the gradient sums of each 64-row tile added into the
  block's partial in float32 and the partials in float64; for the categorical
  kernel, the online log-sum-exp over class tiles and the second sweep's
  theta'.  Held against the float64 plain version at the wide shapes of
  ``chip_smoke.py``'s ``wide`` phase (N cut to 1,000) with its tolerances:
  logp rtol 2e-5; gradients rtol 3e-4, atol 1e-3.
- The route functions give a route, never None, for every such input.
- The dispatchers' layout helper: what it copies, what it casts, what it
  counts, and that it leaves CPU tensors alone.
"""

import os

import numpy as np
import pytest

import torch

from math_tpu_torch.ops import glm_fused as gf
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


def _two_sweeps(eta, yk, kt):
    """The categorical kernel's sweeps on eta (N, C, K) in float32: the online
    log-sum-exp over class tiles of ``kt``, then theta' = onehot - softmax and
    lp = eta_y - lse."""
    n, c, k = eta.shape
    m = s = None
    for k0 in range(0, k, kt):
        e = eta[..., k0 : k0 + kt]
        mt = e.max(-1).values
        st = torch.exp(e - mt[..., None]).sum(-1)
        if m is None:
            m, s = mt, st
        else:
            m_new = torch.maximum(m, mt)
            s = s * torch.exp(m - m_new) + st * torch.exp(mt - m_new)
            m = m_new
    lse = m + torch.log(s)
    onehot = torch.nn.functional.one_hot(yk, k).float()[:, None, :]
    thetap = onehot - torch.exp(eta - lse[..., None])
    lp = torch.gather(eta, -1, yk[:, None, None].expand(n, c, 1))[..., 0] - lse
    return lse, thetap, lp


@pytest.mark.parametrize("d, k", CATEGORICAL)
def test_two_sweep_categorical_kernel_holds_the_tolerance(d, k):
    rng = np.random.default_rng(d * k)
    x = _x(d, d + k)
    alpha = torch.tensor(rng.normal(size=(C, k)) * 0.3, dtype=torch.float32)
    beta = torch.tensor(rng.normal(size=(C, d, k)) * min(0.1, 1.0 / np.sqrt(d)), dtype=torch.float32)
    y = torch.tensor(rng.integers(1, k + 1, N), dtype=torch.int32)
    plan = gf.categorical_wide_plan(N, d, C, k, SMS)
    bmat = beta.permute(1, 0, 2).reshape(d, C * k)
    eta = (_sliced_eta(x, bmat) + alpha.reshape(-1)).view(N, C, k)
    lse, thetap, lp = _two_sweeps(eta, y.long() - 1, plan["kt"])
    # float32: a few roundings of values of order 1-10
    assert torch.allclose(lse.double(), torch.logsumexp(eta.double(), -1), rtol=1e-6, atol=1e-5)
    g = _xt_theta(torch.cat([x, torch.ones(N, 1)], 1), thetap.reshape(N, C * k)).view(d + 1, C, k)
    got = [_tile_sums(lp), g[d], g[:d].permute(1, 0, 2)]
    want = gf.categorical_logit_glm_parts_reference(y, x.double(), alpha.double(), beta.double())
    _check(got, want, ["logp", "galpha", "gbeta"])


# --- routes -------------------------------------------------------------------


@pytest.mark.parametrize("n, c", [(4099, 20), (100_000, 256)])
def test_every_c1_input_has_a_route(n, c):
    for d in FAMILY_D:
        assert gf.glm_tile_plan(n, d, c, SMS)["route"] == "fma"
    for d, k in ORDERED:
        assert gf.glm_tile_plan(n, d, c, SMS, kcat=k)["route"] == "fma"
    for d, k in CATEGORICAL + ((7, 65), (320, 5)):
        plan = gf.categorical_route(n, d, c, k, SMS)
        assert plan is not None and plan["route"] == "fma", (d, k)
        assert plan["cpt"] * plan["kt"] <= gf.WIDE_COLUMNS and plan["nkt"] * plan["kt"] >= k > (plan["nkt"] - 1) * plan["kt"]
        assert plan["cpt"] == 1 or plan["kt"] == k
        assert plan["column_tiles"] * plan["cpt"] >= c and 1 <= plan["row_blocks"] <= -(-n // 64)
        assert plan["smem"] == gf.categorical_wide_smem_bytes(plan["cpt"]) <= gf.MAX_SMEM_BYTES
    # a shape of the tensor-core routes keeps them: a route by shape, not a threshold
    assert gf.categorical_route(n, 50, c, 5, SMS)["route"] == "tensor_cores"
    assert gf.categorical_route(n, 50, c, 5, SMS)["n_cols"] == gf.categorical_tile_plan(n, 50, c, 5, SMS)["n_cols"]
    assert gf.categorical_route(n, 211, c, 40, SMS)["route"] == "tensor_cores"
    assert gf.categorical_route(n, 319, c, 5, SMS)["route"] == "tensor_cores"
    assert gf.categorical_route(n, 64, c, 64, SMS)["route"] == "tensor_cores"
    assert gf.glm_tile_plan(n, 33, c, SMS)["route"] == "tensor_cores"


def test_wide_plan_splits_the_classes_evenly():
    assert gf.categorical_wide_plan(4099, 50, 20, 200, SMS)["kt"] == 50
    assert gf.categorical_wide_plan(4099, 50, 20, 65, SMS)["kt"] == 33
    assert gf.categorical_wide_plan(4099, 400, 20, 5, SMS)["cpt"] == 12


def test_float32_kernels_shared_memory_does_not_grow():
    """The C source: the slices are 64 wide, and the float32 kernels' shared
    memory is a constant (the categorical one's grows with cpt alone, as the
    wrapper's plan says)."""
    with open(os.path.join(ROOT, "math_tpu_torch/csrc/glm_fused.cu"), encoding="utf-8") as f:
        cu = f.read()
    assert f"constexpr int DS = {DS};" in cu
    assert "sizeof(float) * ((size_t)TM * TC + DS * TC + TM * DS + 2 * (size_t)TM * cpt + TM)" in cu
    assert "constexpr size_t FUSED_SMEM = sizeof(float) * (TM * TC + DS * TC + TM * DS + TM);" in cu
    assert gf.categorical_wide_smem_bytes(64) == 4 * (3 * 64 * 64 + 2 * 64 * 64 + 64)


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
