"""PyTorch port: forward mode through the kernels' custom rules (CPU).

Every ``autograd.Function`` whose reference is a ``custom_jvp`` (the three GLM
kernels, the block Cholesky and the two blocked functions around it,
``gamma_p`` / ``gamma_q``, ``inc_beta`` / ``log_inc_beta``) goes through
``torch.func.jvp``, ``jacfwd``, ``hessian`` (forward over reverse) and ``vmap``
and is held against ``jax.jvp`` / ``jacfwd`` / ``hessian`` of its
``math_tpu`` counterpart on the same inputs, made from a seed with numpy.

Tolerances: the torch side runs in float64 and agrees to ``rtol=1e-10``
(``atol=1e-12``) with the JAX side in float64: the GLM rules with the
reference's differentiable formulation (``_xla_parts``, the body of its
level-1 rule), the blocked Cholesky with the Pallas kernel in interpret mode
under ``jax.jit``, the specials with ``math_tpu.special``.  The one float32
case, where the Pallas GLM kernel in interpret mode is the reference with its
own ``custom_jvp``, holds ``rtol=3e-4``, ``atol=1e-3`` (float32 sums in
another order, the GLM tests' gradient tolerance).  Here the wrappers take the
kernels' plain versions (CPU tensors); the counters show one call a primal.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.func import hessian, jacfwd, jacrev, jvp, vmap

from math_tpu import special as jsp
from math_tpu.ops import chol_pallas as jcp
from math_tpu.ops import pallas_glm as pg

from math_tpu_torch import special as tsp
from math_tpu_torch.ops import chol_blocked as tcb
from math_tpu_torch.ops import glm_fused as gf
from math_tpu_torch.special import incbeta as tib
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)

RTOL, ATOL = 1e-10, 1e-12
RNG = np.random.default_rng(12)
N, D, C, K = 48, 3, 4, 4
X = RNG.normal(size=(N, D))
A = RNG.normal(size=C) * 0.3
BETA = RNG.normal(size=(D, C)) * 0.3
EXTRA = {"normal_id": 0.5 + RNG.uniform(size=C), "neg_binomial_2_log": 1.0 + 3.0 * RNG.uniform(size=C)}
Y = {
    "bernoulli_logit": RNG.integers(0, 2, N).astype(np.float64),
    "poisson_log": RNG.poisson(2.0, N).astype(np.float64),
    "normal_id": RNG.normal(size=N),
    "neg_binomial_2_log": RNG.poisson(3.0, N).astype(np.float64),
}
Y_CAT = RNG.integers(1, K + 1, N)
# cut gaps of at least 0.3: below 0.25 the reference's polynomial expm1 (a
# Mosaic workaround, exact to 5e-8) takes over, which the port does not copy
CUTS = np.cumsum(0.3 + RNG.uniform(size=(K - 1, C)), axis=0) - 2.0
ALPHA_CAT = RNG.normal(size=(C, K)) * 0.3
BETA_CAT = RNG.normal(size=(C, D, K)) * 0.3
V = 3  # the vmapped batch


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def tangent(shape, seed):
    return np.random.default_rng(seed).normal(size=shape)


# --- the four GLM families (B1) ---------------------------------------------


def glm_params(family):
    """Differentiable parameters of one family as a tuple of numpy arrays."""
    return (A, BETA) + ((EXTRA[family],) if family in EXTRA else ())


def t_glm(family):
    """``(params, x, y) -> logp (C,)`` through ``GlmFused``."""
    def f(params, x, y):
        extra = params[2] if len(params) == 3 else None
        return gf._fused(family, y, x, params[0], params[1], extra)
    return f


def j_glm(family):
    def f(params, x, y):
        extra = params[2] if len(params) == 3 else None
        return pg._xla_parts(family, y, x, params[0], params[1], extra)[0]
    return f


@pytest.fixture(scope="module")
def jax_glm():
    """The JAX side of the GLM cases, one jitted function a family and transform."""
    out = {}
    for family in gf.FAMILIES:
        f = j_glm(family)
        out[family] = {
            "jvp": jax.jit(lambda p, x, y, tp, tx, ty, f=f: jax.jvp(f, (p, x, y), (tp, tx, ty))[1]),
            "jacfwd": jax.jit(jax.jacfwd(lambda p, x, y, f=f: f(p, x, y).sum())),
            "hessian": jax.jit(jax.hessian(lambda p, x, y, f=f: f(p, x, y).sum())),
            "hessian_x": jax.jit(jax.hessian(lambda x, p, y, f=f: f(p, x, y).sum())),
        }
    return out


@pytest.mark.parametrize("family", gf.FAMILIES)
def test_glm_jvp_every_input(family, jax_glm):
    """A tangent on every differentiable input, and on ``x`` and ``y``."""
    params = glm_params(family)
    tp = tuple(tangent(np.shape(p), 10 + i) for i, p in enumerate(params))
    tx, ty = tangent(X.shape, 20), tangent(N, 21)
    want = jax_glm[family]["jvp"](tuple(map(jnp.asarray, params)), X, Y[family], tp, tx, ty)
    gf.reset_counts()
    _, got = jvp(t_glm(family), (tuple(map(t64, params)), t64(X), t64(Y[family])),
                 (tuple(map(t64, tp)), t64(tx), t64(ty)))
    assert gf.PLAIN_CALLS[family] == 1  # one call of the kernel's stand-in for the primal
    close(got, want)


@pytest.mark.parametrize("family", gf.FAMILIES)
def test_glm_jacfwd_and_hessian(family, jax_glm):
    """``jacfwd`` (the tangents vmapped over the rule) and ``hessian`` (forward
    over reverse) in the parameters, and the Hessian in the data ``x``."""
    params = glm_params(family)
    x, y = t64(X), t64(Y[family])
    s = lambda p, x, y: t_glm(family)(p, x, y).sum()  # noqa: E731
    pj = tuple(map(jnp.asarray, params))
    gf.reset_counts()
    got = jacfwd(s)(tuple(map(t64, params)), x, y)
    assert gf.PLAIN_CALLS[family] == 1
    for g, w in zip(got, jax_glm[family]["jacfwd"](pj, X, Y[family])):
        close(g, w)
    got = hessian(s)(tuple(map(t64, params)), x, y)
    want = jax_glm[family]["hessian"](pj, X, Y[family])
    for i in range(len(params)):
        for j in range(len(params)):
            close(got[i][j], want[i][j])
    close(hessian(lambda x: s(tuple(map(t64, params)), x, y))(x), jax_glm[family]["hessian_x"](X, pj, Y[family]))


@pytest.mark.parametrize("family", gf.FAMILIES)
def test_glm_vmap_folds_into_lanes(family):
    """``vmap`` over the parameters is one call on ``V * C`` lanes; over ``x``,
    one call an element."""
    params = glm_params(family)
    batch = tuple(np.stack([p * (1.0 + 0.1 * v) for v in range(V)]) for p in params)
    f = t_glm(family)
    x, y = t64(X), t64(Y[family])
    gf.reset_counts()
    got = vmap(lambda p: f(p, x, y))(tuple(map(t64, batch)))
    assert gf.PLAIN_CALLS[family] == 1
    want = jax.jit(jax.vmap(lambda p: j_glm(family)(p, X, Y[family])))(tuple(map(jnp.asarray, batch)))
    close(got, want)
    xs = np.stack([X * (1.0 + 0.1 * v) for v in range(V)])
    gf.reset_counts()
    got = vmap(lambda x: f(tuple(map(t64, params)), x, y))(t64(xs))
    assert gf.PLAIN_CALLS[family] == V
    close(got, jax.jit(jax.vmap(lambda x: j_glm(family)(tuple(map(jnp.asarray, params)), x, Y[family])))(xs))


def test_glm_jvp_float32_against_pallas_interpret():
    """The rule against the reference's own ``custom_jvp`` over its Pallas
    kernel in interpret mode, float32 (``rtol=3e-4``, ``atol=1e-3``)."""
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    ta, tb, tx = tangent(C, 30), tangent((D, C), 31), tangent(X.shape, 32)
    y = Y["bernoulli_logit"]
    want = jax.jvp(lambda a, b, x: pg.bernoulli_logit_glm_fused(jnp.asarray(f32(y)), x, a, b, interpret=True),
                   (f32(A), f32(BETA), f32(X)), (f32(ta), f32(tb), f32(tx)))[1]
    t32 = lambda a: torch.tensor(f32(a))  # noqa: E731
    got = jvp(lambda a, b, x: gf.bernoulli_logit_glm_lpmf_chains(t32(y), x, a, b),
              (t32(A), t32(BETA), t32(X)), (t32(ta), t32(tb), t32(tx)))[1]
    assert got.dtype == torch.float32
    close(got, want, rtol=3e-4, atol=1e-3)


def test_glm_backward_under_func_grad_takes_the_plain_version():
    """A first-order ``torch.func.grad`` reads the kernel's partials (no plain
    call besides the forward's stand-in here); under a second order
    (``jacfwd`` of ``grad``, ``grad`` of ``grad``, or plain autograd of an
    input that requires grad around ``grad``) the backward rule takes the
    plain version's differentiable partials, never the kernel's (which would
    give zero second derivatives): the Hessian is nonzero and right."""
    family = "bernoulli_logit"
    x, y = t64(X), t64(Y[family])
    yj, xj, aj = jnp.asarray(Y[family]), jnp.asarray(X), jnp.asarray(A)
    sj = lambda b: pg._xla_parts(family, yj, xj, aj, b, None)[0].sum()  # noqa: E731
    s = lambda b: gf._fused(family, y, x, t64(A), b).sum()  # noqa: E731
    gf.reset_counts()
    g = torch.func.grad(s)(t64(BETA))
    assert gf.PLAIN_CALLS[family] == 1  # the forward's stand-in for the kernel: the backward read its partials
    close(g, jax.jit(jax.grad(sj))(jnp.asarray(BETA)))
    gf.reset_counts()
    h = jacfwd(torch.func.grad(s))(t64(BETA))
    assert gf.PLAIN_CALLS[family] == 2  # the forward's stand-in and the backward's plain version
    want = jax.jit(jax.hessian(sj))(jnp.asarray(BETA))
    assert float(h.abs().max()) > 0.0
    close(h, want)
    e = t64(tangent((D, C), 41))
    close(torch.func.grad(lambda b: (torch.func.grad(s)(b) * e).sum())(t64(BETA)),
          np.einsum("ijkl,kl->ij", np.asarray(want), e.numpy()))
    b0 = t64(BETA).requires_grad_(True)
    (hv,) = torch.autograd.grad((torch.func.grad(s)(b0) * e).sum(), b0)
    close(hv, np.einsum("ijkl,kl->ij", np.asarray(want), e.numpy()))


@pytest.mark.parametrize("order", ["grad_of_jvp", "grad_of_hessian_trace"])
def test_glm_reverse_over_forward(order):
    """A reverse pass over the forward rule (``grad`` of a ``jvp``, the third
    order ``grad`` of ``trace(hessian)``): the rule then takes its coefficients
    from the plain version, so the result equals the reference's."""
    family = "poisson_log"
    x, y = t64(X), t64(Y[family])
    yj, xj, aj = jnp.asarray(Y[family]), jnp.asarray(X), jnp.asarray(A)
    tb = tangent((D, C), 40)
    s = lambda a, b: gf._fused(family, y, x, a, b).sum()  # noqa: E731
    sj = lambda a, b: pg._xla_parts(family, yj, xj, a, b, None)[0].sum()  # noqa: E731
    if order == "grad_of_jvp":
        got = torch.func.grad(lambda a: jvp(lambda b: s(a, b), (t64(BETA),), (t64(tb),))[1])(t64(A))
        want = jax.jit(jax.grad(lambda a: jax.jvp(lambda b: sj(a, b), (jnp.asarray(BETA),), (jnp.asarray(tb),))[1]))(aj)
    else:
        got = torch.func.grad(lambda b: torch.trace(hessian(lambda b: s(t64(A), b))(b).reshape(D * C, D * C)))(t64(BETA))
        want = jax.jit(jax.grad(lambda b: jnp.trace(jax.hessian(lambda b: sj(aj, b))(b).reshape(D * C, D * C))))(jnp.asarray(BETA))
    close(got, want)


# --- the ordered (B2) and categorical (B3) GLMs -------------------------------


def t_ord(p, x):
    return gf.ordered_logistic_glm_lpmf_chains(torch.tensor(Y_CAT), x, p[0], p[1])


def j_ord(p, x):
    return pg._ordered_xla_parts(jnp.asarray(Y_CAT), x, p[0], p[1])[0]


def t_cat(p, x):
    return gf.categorical_logit_glm_lpmf_chains(torch.tensor(Y_CAT), x, p[0], p[1])


def j_cat(p, x):
    return pg._categorical_xla_parts(jnp.asarray(Y_CAT), x, p[0], p[1])[0]


MULTI = {
    gf.ORDERED: (t_ord, j_ord, (BETA, CUTS), (1, 1)),
    gf.CATEGORICAL: (t_cat, j_cat, (ALPHA_CAT, BETA_CAT), (0, 0)),
}


@pytest.mark.parametrize("kind", list(MULTI))
@pytest.mark.parametrize("transform", ["jvp", "jacfwd", "hessian", "vmap"])
def test_ordered_and_categorical(kind, transform):
    """``jvp`` (tangents on the parameters and on ``x``), ``jacfwd``,
    ``hessian`` (forward over reverse) and ``vmap`` (the chains of every batch
    element in one call) of B2 and B3 against the reference."""
    tf, jf, params, lane_axes = MULTI[kind]
    tp, pj = tuple(map(t64, params)), tuple(map(jnp.asarray, params))
    x = t64(X)
    gf.reset_counts()
    if transform == "jvp":
        tans = tuple(tangent(np.shape(p), 50 + i) for i, p in enumerate(params))
        tx = tangent(X.shape, 59)
        got = jvp(tf, (tp, x), (tuple(map(t64, tans)), t64(tx)))[1]
        want = jax.jit(lambda p, x, tp, tx: jax.jvp(jf, (p, x), (tp, tx))[1])(pj, jnp.asarray(X), tuple(map(jnp.asarray, tans)),
                                                                            jnp.asarray(tx))
        close(got, want)
    elif transform == "jacfwd":
        got = jacfwd(lambda p: tf(p, x).sum())(tp)
        for g, w in zip(got, jax.jit(jax.jacfwd(lambda p: jf(p, jnp.asarray(X)).sum()))(pj)):
            close(g, w)
    elif transform == "hessian":
        got = hessian(lambda p: tf(p, x).sum())(tp)
        want = jax.jit(jax.hessian(lambda p: jf(p, jnp.asarray(X)).sum()))(pj)
        for i in range(2):
            for j in range(2):
                close(got[i][j], want[i][j])
    else:
        batch = tuple(np.stack([p * (1.0 + 0.1 * v) for v in range(V)]) for p in params)
        got = vmap(lambda p: tf(p, x))(tuple(map(t64, batch)))
        close(got, jax.jit(jax.vmap(lambda p: jf(p, jnp.asarray(X))))(tuple(map(jnp.asarray, batch))))
    assert gf.PLAIN_CALLS[kind] == (2 if transform == "hessian" else 1)  # the primal; the Hessian's backward


# --- the block Cholesky (B4) and the blocked functions around it ---------------

NC, BC = 10, 4  # three blocks, the last one ragged


def spd_np(t):
    m = t.reshape(NC, NC)
    return m @ m.T + NC * np.eye(NC)


T0 = RNG.normal(size=NC * NC) * 0.4
Y0 = RNG.normal(size=NC)


def t_spd(t):
    m = t.reshape(NC, NC)
    return m @ m.mT + NC * torch.eye(NC, dtype=t.dtype)


def j_spd(t):
    m = t.reshape(NC, NC)
    return m @ m.T + NC * jnp.eye(NC)


def t_chol(t):
    L = tcb.cholesky_blocked(t_spd(t), BC)
    return L.diagonal().log().sum() + 0.01 * (L**2).sum()


def j_chol(t):
    L = jcp.cholesky_blocked_pallas(j_spd(t), block_size=BC)
    return jnp.sum(jnp.log(jnp.diagonal(L))) + 0.01 * jnp.sum(L**2)


def t_csl(t):
    z, s = tcb.cholesky_solve_logdiag(t_spd(t), t64(Y0), BC)
    return -0.5 * (z**2).sum() - s


def j_csl(t):
    z, s = jcp.cholesky_solve_logdiag_pallas(j_spd(t), jnp.asarray(Y0), block_size=BC)
    return -0.5 * jnp.sum(z**2) - s


def j_chol_xla(t):
    L = jnp.linalg.cholesky(j_spd(t))
    return jnp.sum(jnp.log(jnp.diagonal(L))) + 0.01 * jnp.sum(L**2)


def j_csl_xla(t):
    L = jnp.linalg.cholesky(j_spd(t))
    z = jax.scipy.linalg.solve_triangular(L, jnp.asarray(Y0), lower=True)
    return -0.5 * jnp.sum(z**2) - jnp.sum(jnp.log(jnp.diagonal(L)))


def t_block(t):
    d = t_spd(t)[None, :BC, :BC].expand(2, BC, BC) * torch.tensor([1.0, 2.0], dtype=t.dtype)[:, None, None]
    u, w = tcb.chol_inv_block(d)
    return (u**2).sum() + 0.1 * (w**3).sum()


def j_block(t):
    d = j_spd(t)[None, :BC, :BC] * jnp.asarray([1.0, 2.0])[:, None, None]
    u, w = jcp.chol_inv_block(d)
    return jnp.sum(u**2) + 0.1 * jnp.sum(w**3)


CHOL = {"cholesky_blocked": (t_chol, j_chol, 3), "cholesky_solve_logdiag": (t_csl, j_csl, 3), "chol_inv_block": (t_block, j_block, 1)}


@pytest.fixture(scope="module")
def jax_chol():
    """One jitted function a case and transform (the Pallas kernel in
    interpret mode: ten times slower eagerly)."""
    tv = tangent(NC * NC, 60)
    out = {}
    for name, (_, jf, _) in CHOL.items():
        out[name] = {
            "jvp": jax.jit(lambda t, jf=jf: jax.jvp(jf, (t,), (jnp.asarray(tv),))[1]),
            # jax.jacfwd cannot batch the reference's custom_transpose: the
            # Jacobian of the scalar is its gradient
            "jacfwd": jax.jit(jax.grad(jf)),
            "hessian": jax.jit(jax.hessian(jf)),
            "vmap": jax.jit(jax.vmap(jf)),
        }
    return out, tv


@pytest.mark.parametrize("name", list(CHOL))
@pytest.mark.parametrize("transform", ["jvp", "jacfwd", "hessian", "vmap"])
def test_cholesky(name, transform, jax_chol):
    """Through the tangent rules over the saved block inverses: ``jvp``,
    ``jacfwd`` (no refactorization: the block function ran once a block for
    the primal), ``hessian`` and ``vmap`` (every batch element's blocks in
    one call a block)."""
    fns, tv = jax_chol
    tf, _, blocks = CHOL[name]
    tcb.reset_counts()
    if transform == "jvp":
        close(jvp(tf, (t64(T0),), (t64(tv),))[1], fns[name]["jvp"](T0))
        assert tcb.PLAIN_CALLS[tcb.KERNEL] == blocks
    elif transform == "jacfwd":
        close(jacfwd(tf)(t64(T0)), fns[name]["jacfwd"](T0))
        assert tcb.PLAIN_CALLS[tcb.KERNEL] == blocks
    elif transform == "hessian":
        close(hessian(tf)(t64(T0)), fns[name]["hessian"](T0), rtol=1e-9, atol=1e-11)
    else:
        ts = np.stack([T0 * (1.0 + 0.1 * v) for v in range(V)])
        close(vmap(tf)(t64(ts)), fns[name]["vmap"](ts))
        assert tcb.PLAIN_CALLS[tcb.KERNEL] == blocks


def t_chol_vec(t):
    L = tcb.cholesky_blocked(t_spd(t), BC)
    return torch.cat([L.diagonal().log(), 0.1 * L[-1]])


def j_chol_vec(t):
    L = jnp.linalg.cholesky(j_spd(t))
    return jnp.concatenate([jnp.log(jnp.diagonal(L)), 0.1 * L[-1]])


def t_csl_vec(t):
    z, s = tcb.cholesky_solve_logdiag(t_spd(t), t64(Y0), BC)
    return torch.cat([z, s[None]])


def j_csl_vec(t):
    L = jnp.linalg.cholesky(j_spd(t))
    z = jax.scipy.linalg.solve_triangular(L, jnp.asarray(Y0), lower=True)
    return jnp.concatenate([z, jnp.sum(jnp.log(jnp.diagonal(L)))[None]])


@pytest.mark.parametrize("name", ["cholesky_blocked", "cholesky_solve_logdiag"])
@pytest.mark.parametrize("transform", ["grad", "jacrev"])
def test_cholesky_first_order_reverse(name, transform):
    """A first-order ``torch.func.grad`` / ``jacrev`` reads the saved block
    inverses (no refactorization: one block call a block, the forward's);
    ``jacrev``'s vmapped cotangents go through the closed-form adjoint."""
    tf, jf = {"cholesky_blocked": (t_chol_vec, j_chol_vec), "cholesky_solve_logdiag": (t_csl_vec, j_csl_vec)}[name]
    tcb.reset_counts()
    if transform == "grad":
        got = torch.func.grad(lambda t: (tf(t) ** 2).sum())(t64(T0))
        want = jax.jit(jax.grad(lambda t: jnp.sum(jf(t) ** 2)))(jnp.asarray(T0))
    else:
        got = jacrev(tf)(t64(T0))
        want = jax.jit(jax.jacrev(jf))(jnp.asarray(T0))
    assert tcb.PLAIN_CALLS[tcb.KERNEL] == 3
    close(got, want, rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("name", ["cholesky_blocked", "cholesky_solve_logdiag"])
def test_cholesky_third_order(name):
    """``grad`` of ``trace(hessian)``: reverse over the forward rules, which
    then take their block inverses from the differentiable path.  Held, as the
    reference's own third-order test, against XLA's ``cholesky``."""
    tf = CHOL[name][0]
    jf = {"cholesky_blocked": j_chol_xla, "cholesky_solve_logdiag": j_csl_xla}[name]
    got = torch.func.grad(lambda t: torch.trace(hessian(tf)(t)))(t64(T0))
    want = jax.jit(jax.grad(lambda t: jnp.trace(jax.hessian(jf)(t))))(jnp.asarray(T0))
    close(got, want, rtol=1e-8, atol=1e-10)


def test_cholesky_forward_ad_and_reverse_over_reverse():
    """``torch.autograd.forward_ad`` (no ``torch.func``) and the old route to
    second order, reverse over reverse, agree with XLA's ``cholesky`` too."""
    tv = tangent(NC * NC, 61)
    with torch.autograd.forward_ad.dual_level():
        out = t_csl(torch.autograd.forward_ad.make_dual(t64(T0), t64(tv)))
        got = torch.autograd.forward_ad.unpack_dual(out).tangent
    close(got, jax.jit(lambda t, v: jax.jvp(j_csl_xla, (t,), (v,))[1])(jnp.asarray(T0), jnp.asarray(tv)), rtol=1e-9, atol=1e-11)
    close(jacrev(jacrev(t_csl))(t64(T0)), jax.jit(jax.hessian(j_csl_xla))(jnp.asarray(T0)), rtol=1e-9, atol=1e-11)


# --- the special functions with hand rules ------------------------------------

SPECIALS = {
    "gamma_p": (tsp.gamma_p, jsp.gamma_p, (2.0, 1.5)),
    "gamma_q": (tsp.gamma_q, jsp.gamma_q, (2.0, 1.5)),
    "inc_beta": (tsp.inc_beta, jsp.inc_beta, (0.7, 1.3, 0.4)),
    "log_inc_beta": (tib.log_inc_beta, lambda a, b, x: jnp.log(jsp.inc_beta(a, b, x)), (2.0, 3.0, 0.3)),
}


@pytest.mark.parametrize("name", list(SPECIALS))
@pytest.mark.parametrize("transform", ["jvp", "jacfwd", "hessian", "vmap"])
def test_special(name, transform):
    """The partials times the tangents (``jvp``), ``jacfwd`` and ``hessian``
    in every argument at once, ``vmap`` over a batch of points, against
    ``math_tpu.special`` in float64."""
    tf, jf, point = SPECIALS[name]
    x0 = np.asarray(point)
    n = len(point)
    t = lambda v: tf(*[v[i] for i in range(n)])  # noqa: E731
    j = lambda v: jf(*[v[i] for i in range(n)])  # noqa: E731
    if transform == "jvp":
        tv = tangent(n, 70)
        close(jvp(t, (t64(x0),), (t64(tv),))[1], jax.jit(lambda x, v: jax.jvp(j, (x,), (v,))[1])(jnp.asarray(x0), jnp.asarray(tv)))
    elif transform == "jacfwd":
        close(jacfwd(t)(t64(x0)), jax.jit(jax.jacfwd(j))(jnp.asarray(x0)))
    elif transform == "hessian":
        # the a / b partials of inc_beta are tanh-sinh quadratures on both
        # sides (the port's 407 nodes, the reference's own): their second
        # derivatives agree to the quadratures' accuracy
        rtol = 1e-10 if name.startswith("gamma") else 1e-7
        close(hessian(t)(t64(x0)), jax.jit(jax.hessian(j))(jnp.asarray(x0)), rtol=rtol, atol=1e-10)
    else:
        xs = np.stack([x0 * (1.0 + 0.05 * v) for v in range(V)], axis=1)  # (n, V): one row an argument
        got = vmap(tf)(*[t64(r) for r in xs])
        close(got, jax.jit(jax.vmap(jf))(*[jnp.asarray(r) for r in xs]))
