"""PyTorch port: the ordered and categorical GLM ops, second order through
every fused GLM, and the ordinal and multinomial models, against
``math_tpu`` (CPU).

Here, where there is no GPU, the wrappers take the plain PyTorch versions of
the kernels (only because the tensors lie on the CPU).  Those are held

- against the JAX package's plain formulations ``_ordered_xla_parts`` /
  ``_categorical_xla_parts`` in float64 at ``rtol=1e-10``.  The cut gaps are
  at least 0.3: below 0.25 the JAX formulation's polynomial ``expm1`` (a
  Mosaic workaround, exact to 5e-8) takes over, which the port does not copy;
- against the Pallas kernels run in interpret mode, the way the JAX package's
  own tests run them (N=3000 and a ragged N=1537, D=7, C=5, K=5), in float32
  at ``rtol=3e-5, atol=1e-3`` on values and ``rtol=3e-4, atol=1e-3`` on
  gradients (float32 sums taken in another order);
- the categorical one also at (D, K) = (50, 65), N=300, a shape of the tiled
  categorical kernel, against both JAX forms;
- for second order, Hessians and a grad-of-grad against ``jax.hessian`` through
  the Pallas path (the twin of ``tests/test_glm_second_order.py``).

The CUDA kernels themselves are compared with the same plain versions on the
GPU by ``chip_smoke.py``, whose two models are tested here at a small size.
"""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from math_tpu import dists as jdists
from math_tpu import transforms as jtr
from math_tpu.model import make_log_density as j_make_log_density
from math_tpu.ops import pallas_glm as pg

from math_tpu_torch import convert
from math_tpu_torch.ops import glm_fused as gf

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402  (the models the GPU run samples)
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)

RNG = np.random.default_rng(0)
N, D, C, K = 3000, 7, 5, 5
N_RAGGED = 1537
X = RNG.normal(size=(N, D)).astype(np.float32)
B_ORD = (RNG.normal(size=(D, C)) * 0.2).astype(np.float32)
CUTS = (np.cumsum(0.3 + RNG.uniform(size=(K - 1, C)), axis=0) - 2.5).astype(np.float32)  # gaps >= 0.3
Y = RNG.integers(1, K + 1, N).astype(np.int32)
A_CAT = (RNG.normal(size=(C, K)) * 0.3).astype(np.float32)
B_CAT = (RNG.normal(size=(C, D, K)) * 0.2).astype(np.float32)


def tt(a, dtype=torch.float32, grad=False):
    return torch.tensor(np.asarray(a), dtype=dtype, requires_grad=grad)


def ty(y):
    return torch.tensor(np.asarray(y), dtype=torch.int32)


def close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


ORDERED = {
    "params": (B_ORD, CUTS),
    "parts": gf.ordered_logistic_glm_parts,
    "xla": pg._ordered_xla_parts,
    "pallas": pg._ordered_forward,
    "fused_jax": pg.ordered_logistic_glm_fused,
    "chains": gf.ordered_logistic_glm_lpmf_chains,
    "dist": lambda y, x, b, c: jax.vmap(lambda bc, cc: jdists.ordered_logistic_glm_lpmf(y, x, bc, cc, propto=True), in_axes=(1, 1))(b, c),
}
CATEGORICAL = {
    "params": (A_CAT, B_CAT),
    "parts": gf.categorical_logit_glm_parts,
    "xla": pg._categorical_xla_parts,
    "pallas": pg._categorical_forward,
    "fused_jax": pg.categorical_logit_glm_fused,
    "chains": gf.categorical_logit_glm_lpmf_chains,
    "dist": lambda y, x, a, b: jax.vmap(lambda ac, bc: jdists.categorical_logit_glm_lpmf(y, x, ac, bc, propto=True))(a, b),
}
OPS = {"ordered_logistic": ORDERED, "categorical_logit": CATEGORICAL}


@pytest.mark.parametrize("op", sorted(OPS))
def test_plain_parts_vs_jax_formulation_float64(op):
    spec = OPS[op]
    p64 = [p.astype(np.float64) for p in spec["params"]]
    want = jax.jit(lambda *p: spec["xla"](jnp.asarray(Y), jnp.asarray(X, jnp.float64), *p))(*map(jnp.asarray, p64))
    before = gf.PLAIN_CALLS[op]
    got = spec["parts"](ty(Y), tt(X, torch.float64), *[tt(p, torch.float64) for p in p64])
    assert gf.PLAIN_CALLS[op] == before + 1 and gf.LAUNCHES[op] == 0  # CPU tensors: the plain version, counted
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and tuple(g.shape) == tuple(w.shape)
        close(g, w, rtol=1e-10, atol=1e-9)


@pytest.mark.parametrize("n", [N, N_RAGGED])
@pytest.mark.parametrize("op", sorted(OPS))
def test_plain_parts_vs_pallas_interpret(op, n):
    """All three outputs against the Pallas kernel in interpret mode, also for
    N not a multiple of the TPU kernel's row tile."""
    spec = OPS[op]
    pallas = jax.jit(lambda *a: spec["pallas"](*a, interpret=True))
    want = pallas(jnp.asarray(Y[:n]), jnp.asarray(X[:n]), *map(jnp.asarray, spec["params"]))
    got = spec["parts"](ty(Y[:n]), tt(X[:n]), *map(tt, spec["params"]))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == tuple(w.shape)
        close(g, w, rtol=3e-5, atol=1e-3)


@pytest.mark.parametrize("n", [N, N_RAGGED])
@pytest.mark.parametrize("op", sorted(OPS))
def test_fused_value_and_grads_vs_jax_grad(op, n):
    """The ``autograd.Function`` through its dispatcher: value and the
    gradients of both parameters and of ``x`` against ``jax.grad`` of the JAX
    fused function (Pallas in interpret mode)."""
    spec = OPS[op]
    yj, xj = jnp.asarray(Y[:n]), jnp.asarray(X[:n])
    jf = lambda xx, *p: jnp.sum(spec["fused_jax"](yj, xx, *p, True))  # noqa: E731
    jp = tuple(map(jnp.asarray, spec["params"]))
    want_val = jax.jit(lambda xx, *p: spec["fused_jax"](yj, xx, *p, True))(xj, *jp)
    want_g = jax.jit(jax.grad(jf, (0, 1, 2)))(xj, *jp)
    tx = tt(X[:n], grad=True)
    tp = [tt(p, grad=True) for p in spec["params"]]
    val = spec["chains"](ty(Y[:n]), tx, *tp)
    got_g = torch.autograd.grad(val.sum(), [tx, *tp])
    close(val.detach(), want_val, rtol=3e-5, atol=1e-3)
    assert float(got_g[0].abs().max()) > 0.0
    for g, w in zip(got_g, want_g):
        close(g, w, rtol=3e-4, atol=1e-3)


@pytest.mark.parametrize("op", sorted(OPS))
def test_chains_dispatcher_vs_vmapped_density_float64(op):
    """The dispatcher (propto=True, the kernel's -/+1e4 boundary cuts) against
    ``jax.vmap`` of the ``dists`` density, float64."""
    spec = OPS[op]
    p64 = [p.astype(np.float64) for p in spec["params"]]
    want = jax.jit(lambda *p: spec["dist"](Y, X.astype(np.float64), *p))(*map(jnp.asarray, p64))
    got = spec["chains"](ty(Y), tt(X, torch.float64), *[tt(p, torch.float64) for p in p64])
    close(got, want, rtol=1e-10, atol=0.0)


# A shape of the tiled categorical kernel (more than 64 classes): the plain
# version the card holds it against, against both JAX forms.
N_WIDE, D_WIDE, C_WIDE, K_WIDE = 300, 50, 3, 65
RNG_WIDE = np.random.default_rng(65)
X_WIDE = RNG_WIDE.normal(size=(N_WIDE, D_WIDE)).astype(np.float32)
Y_WIDE = RNG_WIDE.integers(1, K_WIDE + 1, N_WIDE).astype(np.int32)
A_WIDE = (RNG_WIDE.normal(size=(C_WIDE, K_WIDE)) * 0.3).astype(np.float32)
B_WIDE = (RNG_WIDE.normal(size=(C_WIDE, D_WIDE, K_WIDE)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("against", ["xla_float64", "pallas_interpret"])
def test_wide_categorical_plain_parts_vs_jax(against):
    """(D, K) = (50, 65): ``categorical_logit_glm_parts_reference`` against
    ``_categorical_xla_parts`` in float64 at ``rtol=1e-10``, and against the
    Pallas kernel in interpret mode in float32 with the tolerances above."""
    params = (A_WIDE, B_WIDE)
    if against == "xla_float64":
        p64 = [p.astype(np.float64) for p in params]
        want = jax.jit(lambda *p: pg._categorical_xla_parts(jnp.asarray(Y_WIDE), jnp.asarray(X_WIDE, jnp.float64), *p))(
            *map(jnp.asarray, p64))
        got = gf.categorical_logit_glm_parts_reference(ty(Y_WIDE), tt(X_WIDE, torch.float64), *[tt(p, torch.float64) for p in p64])
        rtol, atol = 1e-10, 1e-9
    else:
        want = jax.jit(lambda *a: pg._categorical_forward(*a, interpret=True))(
            jnp.asarray(Y_WIDE), jnp.asarray(X_WIDE), *map(jnp.asarray, params))
        got = gf.categorical_logit_glm_parts_reference(ty(Y_WIDE), tt(X_WIDE), *map(tt, params))
        rtol, atol = 3e-5, 1e-3
    assert gf.categorical_route(N_WIDE, D_WIDE, C_WIDE, K_WIDE, 132)["kernel"] == "tiled"
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        close(g, w, rtol=rtol, atol=atol)


def test_wrappers_reject_bad_operands():
    x, b, cu, a, bc = tt(X), tt(B_ORD), tt(CUTS), tt(A_CAT), tt(B_CAT)
    with pytest.raises(ValueError):
        gf.ordered_logistic_glm_parts(ty(Y[:-1]), x, b, cu)
    with pytest.raises(ValueError):
        gf.ordered_logistic_glm_parts(ty(Y), x, b, cu[:, :-1])
    with pytest.raises(TypeError, match="integer categories"):
        gf.ordered_logistic_glm_parts(tt(Y), x, b, cu)
    with pytest.raises(ValueError):
        gf.categorical_logit_glm_parts(ty(Y), x, a[:, :-1], bc)
    with pytest.raises(TypeError, match="integer categories"):
        gf.categorical_logit_glm_parts(tt(Y), x, a, bc)
    meta = [torch.empty(t.shape, device="meta") for t in (x, b, cu)]
    before = dict(gf.PLAIN_CALLS)
    with pytest.raises(ValueError, match="no kernel for device"):
        gf.ordered_logistic_glm_parts(torch.empty(N, dtype=torch.int32, device="meta"), *meta)
    with pytest.raises(ValueError, match="no kernel for device"):
        gf.categorical_logit_glm_parts(
            torch.empty(N, dtype=torch.int32, device="meta"), meta[0],
            torch.empty(a.shape, device="meta"), torch.empty(bc.shape, device="meta"),
        )
    assert gf.PLAIN_CALLS == before


# --- second order through every fused GLM (twin of tests/test_glm_second_order.py)

N2, D2, C2 = 640, 4, 3
RNG2 = np.random.default_rng(7)
X2 = RNG2.normal(size=(N2, D2)).astype(np.float32)
A2 = (RNG2.normal(size=(C2,)) * 0.2).astype(np.float32)
B2 = (RNG2.normal(size=(D2, C2)) * 0.2).astype(np.float32)
E2 = (0.6 + RNG2.uniform(size=C2)).astype(np.float32)
Y2 = {
    "bernoulli_logit": RNG2.integers(0, 2, N2).astype(np.float32),
    "poisson_log": RNG2.poisson(2.0, N2).astype(np.float32),
    "normal_id": RNG2.normal(size=N2).astype(np.float32),
    "neg_binomial_2_log": RNG2.poisson(3.0, N2).astype(np.float32),
}
K2 = 4
YC2 = RNG2.integers(1, K2 + 1, N2).astype(np.int32)
CUTS2 = (np.cumsum(0.3 + RNG2.uniform(size=(K2 - 1, C2)), axis=0) - 1.5).astype(np.float32)
AC2 = (RNG2.normal(size=(C2, K2)) * 0.2).astype(np.float32)
BC2 = (RNG2.normal(size=(C2, D2, K2)) * 0.2).astype(np.float32)
J_FUSED = {
    "bernoulli_logit": pg.bernoulli_logit_glm_fused,
    "poisson_log": pg.poisson_log_glm_fused,
    "normal_id": pg.normal_id_glm_fused,
    "neg_binomial_2_log": pg.neg_binomial_2_log_glm_fused,
}
T_CHAINS = {
    "bernoulli_logit": gf.bernoulli_logit_glm_lpmf_chains,
    "poisson_log": gf.poisson_log_glm_lpmf_chains,
    "normal_id": gf.normal_id_glm_lpdf_chains,
    "neg_binomial_2_log": gf.neg_binomial_2_log_glm_lpmf_chains,
}


def _second_order_pair(family):
    """(torch scalar fn, JAX scalar fn through the Pallas kernel, flat p0)
    over one flat parameter vector, as ``tests/test_glm_second_order.py``."""
    if family == "ordered_logistic":
        parts = [B2, CUTS2]

        def tf(p):
            return gf.ordered_logistic_glm_lpmf_chains(ty(YC2), tt(X2, torch.float64), p[: D2 * C2].reshape(D2, C2),
                                                       p[D2 * C2 :].reshape(K2 - 1, C2)).sum()

        def jf(p):
            return jnp.sum(pg.ordered_logistic_glm_fused(jnp.asarray(YC2), jnp.asarray(X2), p[: D2 * C2].reshape(D2, C2),
                                                         p[D2 * C2 :].reshape(K2 - 1, C2), True))
    elif family == "categorical_logit":
        parts = [AC2, BC2]

        def tf(p):
            return gf.categorical_logit_glm_lpmf_chains(ty(YC2), tt(X2, torch.float64), p[: C2 * K2].reshape(C2, K2),
                                                        p[C2 * K2 :].reshape(C2, D2, K2)).sum()

        def jf(p):
            return jnp.sum(pg.categorical_logit_glm_fused(jnp.asarray(YC2), jnp.asarray(X2), p[: C2 * K2].reshape(C2, K2),
                                                          p[C2 * K2 :].reshape(C2, D2, K2), True))
    else:
        has_extra = family in ("normal_id", "neg_binomial_2_log")
        parts = [A2, B2] + ([E2] if has_extra else [])

        def split(p):
            out = [p[:C2], p[C2 : C2 + D2 * C2].reshape(D2, C2)]
            return out + ([p[C2 + D2 * C2 :]] if has_extra else [])

        def tf(p):
            return T_CHAINS[family](tt(Y2[family], torch.float64), tt(X2, torch.float64), *split(p)).sum()

        def jf(p):
            return jnp.sum(J_FUSED[family](jnp.asarray(Y2[family]), jnp.asarray(X2), *split(p), True))

    return tf, jf, np.concatenate([q.ravel() for q in parts]).astype(np.float32)


SECOND_ORDER = list(gf.FAMILIES) + ["ordered_logistic", "categorical_logit"]


@pytest.mark.parametrize("family", SECOND_ORDER)
def test_hessian_through_the_fused_function_vs_jax_hessian(family):
    """The Hessian of the summed logp through each ``autograd.Function``
    (float64 plain version on the CPU) against ``jax.hessian`` through the
    Pallas kernel (float32): ``rtol=1e-3, atol=1e-3 max|H|`` as the JAX test."""
    tf, jf, p0 = _second_order_pair(family)
    h = torch.autograd.functional.hessian(tf, tt(p0, torch.float64))
    want = np.asarray(jax.jit(jax.hessian(jf))(jnp.asarray(p0)))
    assert float(h.abs().max()) > 0.0
    close(h, want, rtol=1e-3, atol=1e-3 * np.abs(want).max())
    assert bool(torch.allclose(h, h.mT, rtol=1e-10, atol=1e-10 * float(h.abs().max())))


@pytest.mark.parametrize("family", ["bernoulli_logit", "ordered_logistic", "categorical_logit"])
def test_grad_of_grad_vs_jax(family):
    """Reverse over reverse: the gradient of |grad logp|^2."""
    tf, jf, p0 = _second_order_pair(family)
    p = tt(p0, torch.float64, grad=True)
    (g,) = torch.autograd.grad(tf(p), p, create_graph=True)
    (gg,) = torch.autograd.grad((g**2).sum(), p)
    want = np.asarray(jax.jit(jax.grad(lambda q: jnp.sum(jax.grad(jf)(q) ** 2)))(jnp.asarray(p0)))
    close(gg, want, rtol=1e-3, atol=1e-3 * np.abs(want).max())


def test_first_order_reads_the_saved_partials():
    """A first-order backward does not run the plain version again (on a GPU
    it launches nothing); only ``create_graph=True`` does."""
    for chains, params in ((gf.ordered_logistic_glm_lpmf_chains, (B_ORD, CUTS)), (gf.categorical_logit_glm_lpmf_chains, (A_CAT, B_CAT))):
        tp = [tt(q, grad=True) for q in params]
        op = "ordered_logistic" if chains is gf.ordered_logistic_glm_lpmf_chains else "categorical_logit"
        before = gf.PLAIN_CALLS[op]
        val = chains(ty(Y), tt(X), *tp)
        torch.autograd.grad(val.sum(), tp)
        assert gf.PLAIN_CALLS[op] == before + 1
        val = chains(ty(Y), tt(X), *tp)
        torch.autograd.grad(val.sum(), tp, create_graph=True)
        assert gf.PLAIN_CALLS[op] == before + 3


# --- the two models of the GPU run, against the same models built with math_tpu


def _jax_ordinal(d, k):
    def log_prob(p, X, y):
        lp = jdists.normal_lpdf(p["beta"], 0.0, 2.0, propto=True) + jdists.normal_lpdf(p["cuts"], 0.0, 5.0, propto=True)
        return lp + jdists.ordered_logistic_glm_lpmf(y, X, p["beta"], p["cuts"], propto=True)

    return j_make_log_density({"beta": jtr.Identity(shape=(d,)), "cuts": jtr.Ordered(shape=(k - 1,))}, log_prob)


def _jax_multinomial(d, k):
    def log_prob(p, X, y):
        a_raw, b_raw = p["alpha_raw"], p["beta_raw"]
        lp = jdists.normal_lpdf(a_raw, 0.0, 5.0, propto=True) + jdists.normal_lpdf(b_raw, 0.0, 2.0, propto=True)
        alpha = jnp.concatenate([jnp.zeros((1,), a_raw.dtype), a_raw])
        beta = jnp.concatenate([jnp.zeros((d, 1), b_raw.dtype), b_raw], axis=1)
        return lp + jdists.categorical_logit_glm_lpmf(y, X, alpha, beta, propto=True)

    return j_make_log_density(
        {"alpha_raw": jtr.Identity(shape=(k - 1,)), "beta_raw": jtr.Identity(shape=(d, k - 1))}, log_prob
    )


MODELS = {
    "ordinal": (chip_smoke.make_ordinal, _jax_ordinal, chip_smoke.ordinal_data, "ordered_logistic", 54),
    "multinomial": (chip_smoke.make_multinomial, _jax_multinomial, chip_smoke.categorical_data, "categorical_logit", 204),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_logp_and_grad_vs_math_tpu(name):
    """``logp`` and its gradient of the model ``chip_smoke.py`` samples
    (through the fused op, here its plain version) and of the same model
    written with ``math_tpu.model.make_log_density`` and the JAX ``dists``
    density, float64, at ``rtol=1e-10``; the dimension at the GPU run's
    width; and the flat layout shared through ``convert.positions_from_numpy``."""
    make_t, make_j, data, op, full_dim = MODELS[name]
    assert make_t(chip_smoke.K_MAIN).dim == make_j(chip_smoke.K_MAIN, chip_smoke.K_CAT).dim == full_dim
    n, d = 500, 5
    x = np.random.default_rng(3).normal(size=(n, d))
    y = data(x)[0]
    tm, jm = make_t(d), make_j(d, chip_smoke.K_CAT)
    z = np.random.default_rng(4).normal(size=(4, jm.dim)) * 0.3
    want, want_g = jax.jit(jax.vmap(jax.value_and_grad(lambda th: jm.logp(th, jnp.asarray(x), y))))(jnp.asarray(z))
    zt = convert.positions_from_numpy(z, device="cpu", dtype=torch.float64)
    assert torch.equal(zt, torch.tensor(z))  # carried unchanged
    before = gf.PLAIN_CALLS[op]
    got, got_g = tm.logp_and_grad(zt, torch.tensor(x), torch.tensor(y))
    assert gf.PLAIN_CALLS[op] == before + 1
    close(got, want, rtol=1e-10, atol=1e-9)
    close(got_g, want_g, rtol=1e-10, atol=1e-9)
    # the same flat layout: every named block constrains to the same values
    tcons, jcons = tm.constrain(zt), jax.vmap(jm.constrain)(jnp.asarray(z))
    assert list(tcons) == list(jcons)
    for key in tcons:
        close(tcons[key], jcons[key], rtol=1e-12, atol=1e-12)
