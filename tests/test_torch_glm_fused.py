"""PyTorch port: the fused GLM op against ``math_tpu/ops/pallas_glm.py`` (CPU).

Here, where there is no GPU, the port's wrapper takes the plain PyTorch
version of the kernel (it does so only because the tensors lie on the CPU).
That plain version is held against the Pallas kernel run in interpret mode, the
way the JAX package's own tests run it, in float32 with the JAX tests' own
tolerances (``rtol=3e-5, atol=1e-3`` on values, ``rtol=3e-4, atol=1e-3`` on
gradients: float32 sums taken in another order).  The CUDA kernel itself is
compared with the same plain version on the GPU by ``chip_smoke.py``.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from math_tpu import dists as jdists
from math_tpu.ops import pallas_glm as pg

from math_tpu_torch.ops import glm_fused as gf
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)

RNG = np.random.default_rng(0)
N, K, C = 3000, 7, 5
N_RAGGED = 1537
X = RNG.normal(size=(N, K)).astype(np.float32)
B = (RNG.normal(size=(K, C)) * 0.2).astype(np.float32)
A = (RNG.normal(size=(C,)) * 0.2).astype(np.float32)
EXTRA = {
    "bernoulli_logit": None,
    "poisson_log": None,
    "normal_id": (0.5 + RNG.uniform(size=C)).astype(np.float32),
    "neg_binomial_2_log": (1.0 + 3.0 * RNG.uniform(size=C)).astype(np.float32),
}
Y = {
    "bernoulli_logit": RNG.integers(0, 2, N).astype(np.float32),
    "poisson_log": RNG.poisson(2.0, N).astype(np.float32),
    "normal_id": RNG.normal(size=N).astype(np.float32),
    "neg_binomial_2_log": RNG.poisson(3.0, N).astype(np.float32),
}
FAMILIES = list(gf.FAMILIES)
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
J_DIST = {
    "bernoulli_logit": jdists.bernoulli_logit_glm_lpmf,
    "poisson_log": jdists.poisson_log_glm_lpmf,
    "normal_id": jdists.normal_id_glm_lpdf,
    "neg_binomial_2_log": jdists.neg_binomial_2_log_glm_lpmf,
}


def tt(a, dtype=torch.float32, grad=False):
    return None if a is None else torch.tensor(np.asarray(a), dtype=dtype, requires_grad=grad)


def jj(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a, dtype)


def close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("n", [N, N_RAGGED])
@pytest.mark.parametrize("family", FAMILIES)
def test_plain_parts_vs_pallas_interpret(family, n):
    """(logp, ga, gb, ge) of the plain version vs the Pallas kernel in
    interpret mode, also for N not a multiple of the TPU kernel's row tile."""
    y, x, extra = Y[family][:n], X[:n], EXTRA[family]
    want = pg._fused_forward(family, jj(y), jj(x), jj(A), jj(B), jj(extra), interpret=True)
    before = gf.PLAIN_CALLS[family]
    got = gf.glm_fused_parts(family, tt(y), tt(x), tt(A), tt(B), tt(extra))
    assert gf.PLAIN_CALLS[family] == before + 1  # CPU tensors: the plain version, counted
    assert gf.LAUNCHES[family] == 0
    assert (got[3] is None) == (want[3] is None) == (not gf.HAS_EXTRA[family])
    for g, w in zip(got, want):
        if w is not None:
            assert g.dtype == torch.float32 and tuple(g.shape) == tuple(w.shape)
            close(g, w, rtol=3e-5, atol=1e-3)


@pytest.mark.parametrize("family", FAMILIES)
def test_glm_fused_value_and_param_grads(family):
    """``GlmFused`` value and alpha/beta/extra gradients vs ``jax.grad`` of the
    JAX fused function (Pallas in interpret mode)."""
    y, extra = Y[family], EXTRA[family]
    jargs = (jj(A), jj(B)) + (() if extra is None else (jj(extra),))
    jf = lambda *p: J_FUSED[family](jj(y), jj(X), *p, True)  # noqa: E731
    want_val = jf(*jargs)
    want_g = jax.grad(lambda *p: jnp.sum(jf(*p)), tuple(range(len(jargs))))(*jargs)

    targs = [tt(A, grad=True), tt(B, grad=True)] + ([] if extra is None else [tt(extra, grad=True)])
    val = T_CHAINS[family](tt(y), tt(X), *targs)
    got_g = torch.autograd.grad(val.sum(), targs)
    close(val.detach(), want_val, rtol=3e-5, atol=1e-3)
    for g, w in zip(got_g, want_g):
        close(g, w, rtol=3e-4, atol=1e-3)


@pytest.mark.parametrize("family", ["bernoulli_logit", "normal_id"])
def test_glm_fused_data_grads(family):
    """dx, dy are exact, not silent zeros, when the caller differentiates the
    design matrix / response (ref: tests/test_pallas_glm.py:113-141)."""
    y, extra = Y[family], EXTRA[family]
    rest = (jj(A), jj(B)) + (() if extra is None else (jj(extra),))
    want_gy, want_gx = jax.grad(lambda yy, xx: jnp.sum(J_FUSED[family](yy, xx, *rest, True)), (0, 1))(jj(y), jj(X))
    ty, tx = tt(y, grad=True), tt(X, grad=True)
    trest = [tt(A), tt(B)] + ([] if extra is None else [tt(extra)])
    got_gy, got_gx = torch.autograd.grad(T_CHAINS[family](ty, tx, *trest).sum(), (ty, tx))
    assert float(got_gx.abs().max()) > 0.0
    close(got_gx, want_gx, rtol=3e-4, atol=1e-3)
    close(got_gy, want_gy, rtol=3e-4, atol=1e-3)


@pytest.mark.parametrize("family", FAMILIES)
def test_chains_dispatchers_vs_vmapped_dists(family):
    """The ``*_chains`` dispatchers vs ``jax.vmap`` of the per-chain density
    with ``propto=True`` (y numpy, so its constants are pruned), float64."""
    y, extra = Y[family].astype(np.float64), EXTRA[family]
    a64, b64, x64 = A.astype(np.float64), B.astype(np.float64), X.astype(np.float64)
    if extra is None:
        want = jax.vmap(lambda a, b: J_DIST[family](y, x64, a, b, propto=True), in_axes=(0, 1))(jj(a64, None), jj(b64, None))
        got = T_CHAINS[family](tt(y, torch.float64), tt(x64, torch.float64), tt(a64, torch.float64), tt(b64, torch.float64))
    else:
        e64 = extra.astype(np.float64)
        want = jax.vmap(lambda a, b, e: J_DIST[family](y, x64, a, b, e, propto=True), in_axes=(0, 1, 0))(
            jj(a64, None), jj(b64, None), jj(e64, None)
        )
        got = T_CHAINS[family](
            tt(y, torch.float64), tt(x64, torch.float64), tt(a64, torch.float64), tt(b64, torch.float64), tt(e64, torch.float64)
        )
    assert got.dtype == torch.float64
    close(got, want, rtol=1e-10, atol=0.0)


@pytest.mark.parametrize("family", FAMILIES)
def test_double_backward_raises(family):
    """The double backward and forward mode MATCH the plain version.  (The
    name dates from when the op was first-order only and its double backward,
    later its forward mode, raised; it is kept so that the test's history
    stays one.)  Under ``create_graph=True`` the op differentiates the plain
    version, so the second derivative equals autograd's through
    ``glm_fused_parts_reference`` (never silent zeros); forward mode
    (``torch.autograd.forward_ad``) reads the tangent off the saved partials
    and equals the plain version's tangent.  Both sides in float64 at rtol
    1e-10: in float32 the comparison rested on the order of the host's sums."""
    extra = EXTRA[family]
    f64 = functools.partial(tt, dtype=torch.float64)
    targs = [f64(A, grad=True), f64(B, grad=True)] + ([] if extra is None else [f64(extra, grad=True)])
    val = T_CHAINS[family](f64(Y[family]), f64(X), *targs)
    (gb,) = torch.autograd.grad(val.sum(), targs[1], create_graph=True)
    got = torch.autograd.grad(gb.sum(), targs)
    ref = gf.glm_fused_parts_reference(family, f64(Y[family]), f64(X), *targs[:2], targs[2] if extra is not None else None)[0]
    if family == "normal_id":
        ref = ref - N * torch.log(targs[2])
    elif family == "neg_binomial_2_log":
        phi = targs[2]
        ref = ref + torch.lgamma(f64(Y[family])[:, None] + phi[None, :]).sum(0) - N * torch.lgamma(phi) + N * phi * torch.log(phi)
    (gb_ref,) = torch.autograd.grad(ref.sum(), targs[1], create_graph=True)
    want = torch.autograd.grad(gb_ref.sum(), targs)
    assert float(got[1].abs().max()) > 0.0
    for g, w in zip(got, want):
        close(g, w, rtol=1e-10, atol=1e-10)
    fwd = torch.autograd.forward_ad
    tangents = [torch.ones(B.shape, dtype=torch.float64), torch.ones(B.shape, dtype=torch.float64)]
    with fwd.dual_level():
        dual = fwd.make_dual(f64(B), tangents[0])
        got = fwd.unpack_dual(T_CHAINS[family](f64(Y[family]), f64(X), f64(A), dual, *([] if extra is None else [f64(extra)]))).tangent
    with fwd.dual_level():
        dual = fwd.make_dual(f64(B), tangents[1])
        ref = gf.glm_fused_parts_reference(family, f64(Y[family]), f64(X), f64(A), dual, f64(extra))[0]
        want = fwd.unpack_dual(ref).tangent
    close(got, want, rtol=1e-10, atol=1e-10)


def test_wrapper_rejects_bad_operands():
    y, x, a, b = tt(Y["bernoulli_logit"]), tt(X), tt(A), tt(B)
    with pytest.raises(ValueError):
        gf.glm_fused_parts("bernoulli_logit", y[:-1], x, a, b)
    with pytest.raises(ValueError):
        gf.glm_fused_parts("bernoulli_logit", y, x, a[:-1], b)
    with pytest.raises(ValueError):
        gf.glm_fused_parts("probit", y, x, a, b)
    with pytest.raises(TypeError):
        gf.glm_fused_parts("normal_id", y, x, a, b, None)


def test_non_contiguous_beta_is_accepted_by_the_dispatcher():
    """The model hands ``beta.T`` of a (C, K) block: the dispatcher lays it out."""
    y, x = tt(Y["bernoulli_logit"]), tt(X)
    beta_ck = tt(np.ascontiguousarray(B.T))
    got = gf.bernoulli_logit_glm_lpmf_chains(y, x, tt(A), beta_ck.T)
    want = gf.bernoulli_logit_glm_lpmf_chains(y, x, tt(A), tt(B))
    assert torch.equal(got, want)
