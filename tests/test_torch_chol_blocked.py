"""PyTorch port: the blocked Cholesky against ``math_tpu.ops.chol_pallas`` (CPU, float64).

Same inputs, made from a seed with numpy, go through the JAX function and its
counterpart.  The JAX side runs its Pallas kernel in interpret mode (which
``_chunked_blocks`` picks by itself off the TPU; under ``jax.jit`` where the
eager interpreter would take ten times as long); the port's side runs the
kernel's plain version, because the tensors lie on the CPU, and the same
blocked glue and hand-written adjoints that run around the CUDA kernel on a
GPU.  Tolerances: values and first-order gradients ``rtol=1e-9`` (the same
float64 arithmetic up to the order of sums in the matrix products), Hessians
``rtol=1e-7``, the dot-product identity of the hand transposes ``rtol=1e-10``.
Block sizes are 16-32 so that several blocks and a ragged tail engage.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from math_tpu.ops import chol_pallas as jcp
from math_tpu_torch import get_config
from math_tpu_torch.ops import chol_blocked as tcb
from math_tpu_torch.ops import cholesky as tch
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)

RTOL = 1e-9
N, B = 40, 16  # the second-order tests' size: three blocks, the last one ragged


def t64(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float64, requires_grad=grad)


def close(got, want, rtol=RTOL, atol=1e-12):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def spd(rng, n, shape=()):
    a = rng.normal(size=shape + (n, n))
    return a @ np.swapaxes(a, -1, -2) + n * np.eye(n)


# --- the block function ------------------------------------------------------


@pytest.mark.parametrize("cb,b", [(1, 16), (5, 32)])
def test_block_plain_version_matches_pallas_kernel(cb, b):
    d = spd(np.random.default_rng(cb), b, (cb,))
    want_u, want_w = jcp.chol_inv_block(jnp.asarray(d))
    before = dict(tcb.PLAIN_CALLS)
    for fn in (tcb.chol_inv_block_reference, tcb.chol_inv_block_parts, tcb.chol_inv_block):
        u, w = fn(t64(d))
        close(u, want_u)
        close(w, want_w)
    assert tcb.PLAIN_CALLS["chol_inv_block"] == before["chol_inv_block"] + 3
    assert tcb.LAUNCHES["chol_inv_block"] == 0  # no GPU here: nothing was launched
    u, w = tcb.chol_inv_block_reference(t64(d))
    close(u.mT @ u, d, rtol=1e-10, atol=1e-10)
    close(u @ w, np.broadcast_to(np.eye(b), d.shape), rtol=1e-10, atol=1e-10)
    assert bool((u.tril(-1) == 0).all()) and bool((w.tril(-1) == 0).all())


def test_block_accepts_any_leading_axes_and_float32():
    d = spd(np.random.default_rng(2), 8, (2, 3))
    u, w = tcb.chol_inv_block(t64(d))
    assert u.shape == d.shape and w.shape == d.shape
    close(u[1, 2].mT, np.linalg.cholesky(d[1, 2]), rtol=1e-10)
    u32, _ = tcb.chol_inv_block_reference(torch.tensor(d[0], dtype=torch.float32))
    assert u32.dtype == torch.float32
    close(u32.double(), u[0], rtol=1e-4, atol=1e-5)


def test_block_nan_rule_on_a_non_psd_matrix_of_the_batch():
    """A pivot that is not positive gives NaN for that matrix only, exactly
    where the Pallas kernel gives NaN; the others are untouched."""
    d = spd(np.random.default_rng(3), 16, (3,))
    d[1, 5, 5] = -1e3
    want_u, want_w = (np.asarray(v) for v in jcp.chol_inv_block(jnp.asarray(d)))
    u, w = tcb.chol_inv_block_parts(t64(d))
    for got, want in ((u.numpy(), want_u), (w.numpy(), want_w)):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.isfinite(got[[0, 2]]).all()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-12)  # NaN == NaN here
    assert np.isnan(w.numpy()[1]).all() and np.isnan(u.numpy()[1, 5:, 5:][np.triu_indices(11)]).all()
    assert np.isfinite(u.numpy()[1, :5]).all()


def test_wrapper_refuses_what_the_kernel_does_not_take():
    before = dict(tcb.PLAIN_CALLS)
    with pytest.raises(ValueError, match="no kernel for device"):
        tcb.chol_inv_block_parts(torch.empty(2, 4, 4, device="meta"))
    with pytest.raises(ValueError, match=r"shape \(Cb, B, B\)"):
        tcb.chol_inv_block_parts(torch.eye(4))
    with pytest.raises(ValueError, match=r"shape \(Cb, B, B\)"):
        tcb.chol_inv_block_parts(torch.zeros(2, 4, 3))
    assert tcb.PLAIN_CALLS == before
    assert get_config().cholesky_block_size == 128


# --- the blocked factorization and the fused solve ---------------------------


@pytest.mark.parametrize("shape", [(), (3,)])
def test_cholesky_blocked_value_and_grad(shape):
    rng = np.random.default_rng(6)
    n = 40  # not a multiple of the block
    b0 = rng.normal(size=shape + (n, n)) * 0.3

    def jloss(b):  # one matrix; the JAX package batches by vmap outside the gradient
        L = jcp.cholesky_blocked_pallas(b @ b.T + n * jnp.eye(n), block_size=16)
        return jnp.sum(jnp.sin(L)), L

    vg = jax.value_and_grad(jloss, has_aux=True)
    (_, want_L), want_g = jax.jit(jax.vmap(vg) if shape else vg)(jnp.asarray(b0))
    bt = t64(b0, grad=True)
    L = tcb.cholesky_blocked(bt @ bt.mT + n * torch.eye(n, dtype=torch.float64), block_size=16)
    close(L, want_L)
    close(L, np.linalg.cholesky(b0 @ np.swapaxes(b0, -1, -2) + n * np.eye(n)), rtol=1e-10, atol=1e-11)
    (g,) = torch.autograd.grad(torch.sin(L).sum(), bt)
    close(g, want_g, atol=1e-11)


@pytest.mark.parametrize("case", ["vector", "matrix", "batched", "batched_shared_b"])
def test_cholesky_solve_logdiag_value_and_grad(case):
    rng = np.random.default_rng(3)
    n = 40
    batched = case.startswith("batched")
    k0 = spd(rng, n, (3,) if batched else ())
    b0 = rng.normal(size={"vector": (n,), "matrix": (n, 2), "batched": (3, n), "batched_shared_b": (n,)}[case])

    def jlp(k, b):  # one matrix; the JAX package batches by vmap outside the gradient
        y, s = jcp.cholesky_solve_logdiag_pallas(k, b, block_size=16)
        return -0.5 * jnp.sum(jnp.square(y)) - s, (y, s)

    vg = jax.value_and_grad(jlp, argnums=(0, 1), has_aux=True)
    if batched:
        vg = jax.vmap(vg, in_axes=(0, 0 if case == "batched" else None))
    (_, (want_y, want_s)), (want_gk, want_gb) = jax.jit(vg)(jnp.asarray(k0), jnp.asarray(b0))
    if case == "batched_shared_b":
        want_gb = want_gb.sum(0)
    kt, bt = t64(k0, grad=True), t64(b0, grad=True)
    y, s = tcb.cholesky_solve_logdiag(kt, bt, block_size=16)
    assert y.shape == tuple(want_y.shape) and s.shape == tuple(want_s.shape)
    close(y, want_y)
    close(s, want_s)
    gk, gb = torch.autograd.grad(-0.5 * torch.square(y).sum() - s.sum(), (kt, bt))
    close(gb, want_gb, atol=1e-12)  # the shared b's cotangent is summed over the chains
    close(gk, want_gk, atol=1e-12)  # the un-symmetrized transpose, the same in both packages
    # and the dispatcher against the whole-function reference by torch.linalg
    y2, s2 = tch.spd_solve_logdiag(kt, bt, block_size=16)
    y_ref, s_ref = tch.spd_solve_logdiag_reference(kt, bt)
    close(y2, y_ref.detach(), rtol=1e-9, atol=1e-12)
    close(s2, s_ref.detach(), rtol=1e-10)
    gk_ref, gb_ref = torch.autograd.grad(-0.5 * torch.square(y_ref).sum() - s_ref.sum(), (kt, bt))
    close(gb, gb_ref, rtol=1e-8, atol=1e-12)
    close(gk + gk.mT, gk_ref + gk_ref.mT, rtol=1e-7, atol=1e-10)  # conventions meet through the symmetric part


def test_a_matrix_smaller_than_the_block_is_one_block_of_its_own_size():
    a = spd(np.random.default_rng(8), 5, (2,))
    before = tcb.PLAIN_CALLS["chol_inv_block"]
    L = tcb.cholesky_blocked(t64(a))  # the configured block size, 128
    assert tcb.PLAIN_CALLS["chol_inv_block"] == before + 1
    close(L, np.linalg.cholesky(a), rtol=1e-10)
    close(tch.cholesky_decompose(t64(a), block_size=2), tch.cholesky_decompose_reference(t64(a)), rtol=1e-10)


@pytest.mark.parametrize("fn", ["cholesky_blocked", "cholesky_decompose"])
def test_non_psd_propagates_nan(fn):
    # NUTS relies on nan/-inf logp to reject non-PSD proposals: the blocked
    # factorization must signal failure, not return finite garbage
    n = 48
    a = np.eye(n)
    a[5, 5] = -1e15
    chol = getattr(tcb, fn, None) or getattr(tch, fn)
    assert bool(torch.isnan(chol(t64(a), block_size=16)).any())
    assert bool(torch.isnan(tcb.cholesky_solve_logdiag(t64(a), t64(np.ones(n)), block_size=16)[1]))
    good = chol(t64(spd(np.random.default_rng(11), n)), block_size=16)
    assert bool(torch.isfinite(good).all())


def test_kernel_calls_per_factorization_and_none_in_the_backward_pass():
    """``ceil(n / B)`` block calls per forward pass; the first-order backward
    pass reuses the saved block inverses and makes none."""
    rng = np.random.default_rng(4)
    kt, bt = t64(spd(rng, 70, (2,)), grad=True), t64(rng.normal(size=70))
    tcb.reset_counts()
    y, s = tcb.cholesky_solve_logdiag(kt, bt, block_size=16)
    assert tcb.PLAIN_CALLS["chol_inv_block"] == 5
    torch.autograd.grad(-0.5 * torch.square(y).sum() - s.sum(), kt)
    assert tcb.PLAIN_CALLS["chol_inv_block"] == 5 and tcb.LAUNCHES["chol_inv_block"] == 0


def test_mdivide_left_tri_low():
    rng = np.random.default_rng(0)
    L = np.tril(rng.normal(size=(3, 20, 20))) + 20 * np.eye(20)
    for b in (rng.normal(size=(3, 20)), rng.normal(size=(3, 20, 2))):
        want = np.linalg.solve(L, b[..., None] if b.ndim == 2 else b)
        close(tch.mdivide_left_tri_low(t64(L), t64(b)), want[..., 0] if b.ndim == 2 else want, rtol=1e-10)


# --- the hand transposes and second order ------------------------------------


def _spd_np(theta):
    x = np.linspace(-2.0, 2.0, N)
    d2 = (x[:, None] - x[None, :]) ** 2
    return theta[1] ** 2 * np.exp(-0.5 * d2 / theta[0] ** 2) + (0.1 + theta[2] ** 2) * np.eye(N)


def _spd_j(theta):
    x = jnp.linspace(-2.0, 2.0, N)
    d2 = (x[:, None] - x[None, :]) ** 2
    return theta[1] ** 2 * jnp.exp(-0.5 * d2 / theta[0] ** 2) + (0.1 + theta[2] ** 2) * jnp.eye(N)


def _spd_t(theta):
    x = torch.linspace(-2.0, 2.0, N, dtype=torch.float64)
    d2 = (x[:, None] - x[None, :]) ** 2
    return theta[1] ** 2 * torch.exp(-0.5 * d2 / theta[0] ** 2) + (0.1 + theta[2] ** 2) * torch.eye(N, dtype=torch.float64)


T0 = np.array([0.9, 1.1, 0.5])


def test_hand_transposes_are_exact():
    """The closed-form adjoints must be exact transposes of the tangent maps:
    ``<cot, f(lin)> == <f^T(cot), lin>`` on random NON-symmetric tangents, with
    ``f`` the JAX package's tangent map and ``f^T`` the port's transpose; and
    the port's transposes equal the JAX package's."""
    rng = np.random.default_rng(3)
    flat, _, _ = jcp._flatten_pad(jnp.asarray(_spd_np(T0)), N, B)
    Lj, Wsj = jax.jit(lambda f: jcp._chol_blocked_impl(f, B))(flat)
    Wsj = tuple(Wsj)
    L, Ws = tcb._chol_blocked_impl(t64(np.asarray(flat)), B)
    close(L, Lj)

    da, lbar = rng.normal(size=flat.shape), np.tril(rng.normal(size=flat.shape))
    (dL,) = jax.jit(jcp._chb_tan_fun)((Lj, Wsj), (jnp.asarray(da),))
    abar = tcb._chb_tan_transpose(L, Ws, t64(lbar), B)
    np.testing.assert_allclose(float(np.sum(lbar * np.asarray(dL))), float((abar * t64(da)).sum()), rtol=1e-10)
    close(abar, jax.jit(jcp._chb_tan_transpose)((Lj, Wsj), (jnp.asarray(lbar),))[0], atol=1e-11)

    b = rng.normal(size=(1, flat.shape[-1], 2))
    yj = jax.jit(lambda bb: jcp._lower_solve_blocks(Lj, Wsj, bb, B))(jnp.asarray(b))
    y = tcb._lower_solve_blocks(L, Ws, t64(b), B)
    close(y, yj)
    db, ybar, sbar = rng.normal(size=b.shape), rng.normal(size=b.shape), rng.normal(size=(1,))
    dy, ds = jax.jit(jcp._csl_tan_fun)((Lj, Wsj, yj), (jnp.asarray(da), jnp.asarray(db)))
    abar2, bbar2 = tcb._csl_tan_transpose(L, Ws, y, t64(ybar), t64(sbar), B)
    lhs = float(np.sum(ybar * np.asarray(dy)) + np.sum(sbar * np.asarray(ds)))
    rhs = float((abar2 * t64(da)).sum() + (bbar2 * t64(db)).sum())
    np.testing.assert_allclose(lhs, rhs, rtol=1e-10)
    want_a, want_b = jax.jit(jcp._csl_tan_transpose)((Lj, Wsj, yj), (jnp.asarray(ybar), jnp.asarray(sbar)))
    close(abar2, want_a, atol=1e-11)
    close(bbar2, want_b, atol=1e-11)


def test_hessian_through_cholesky_blocked():
    def jf(theta):
        L = jcp.cholesky_blocked_pallas(_spd_j(theta), block_size=B)
        return jnp.sum(jnp.log(jnp.diagonal(L))) + 0.01 * jnp.sum(L**2)

    def tf(theta):
        L = tcb.cholesky_blocked(_spd_t(theta), block_size=B)
        return torch.log(torch.diagonal(L)).sum() + 0.01 * (L**2).sum()

    close(torch.autograd.functional.hessian(tf, t64(T0)), jax.jit(jax.hessian(jf))(jnp.asarray(T0)), rtol=1e-7, atol=1e-9)


def test_hessian_through_cholesky_solve_logdiag():
    y = np.random.default_rng(0).normal(size=N)

    def jf(theta):
        z, slog = jcp.cholesky_solve_logdiag_pallas(_spd_j(theta), jnp.asarray(y), block_size=B)
        return -0.5 * jnp.sum(z**2) - slog  # marginal-MVN logp core

    def tf(theta):
        z, slog = tcb.cholesky_solve_logdiag(_spd_t(theta), t64(y), block_size=B)
        return -0.5 * (z**2).sum() - slog

    h = torch.autograd.functional.hessian(tf, t64(T0))
    close(h, jax.jit(jax.hessian(jf))(jnp.asarray(T0)), rtol=1e-7, atol=1e-9)
    assert float(h.abs().max()) > 1.0  # a double backward never returns silent zeros


def test_second_and_third_order_through_the_block_function():
    """The block function's own rule, differentiated again and once more,
    against autograd through ``torch.linalg`` (the twin of
    tests/test_chol_second_order.py:76-118, which holds the JAX rule against
    ``jnp.linalg`` the same way)."""

    def tf(theta):
        u, w = tcb.chol_inv_block(_spd_t(theta)[:B, :B])
        return torch.log(torch.diagonal(u)).sum() + 0.01 * (w**2).sum()

    def tf_ref(theta):
        L = torch.linalg.cholesky(_spd_t(theta)[:B, :B])
        w = torch.linalg.inv(L).mT  # W = U^-1 = (L^-1)^T
        return torch.log(torch.diagonal(L)).sum() + 0.01 * (w**2).sum()

    hessian = torch.autograd.functional.hessian
    close(hessian(tf, t64(T0)), hessian(tf_ref, t64(T0)), rtol=1e-7, atol=1e-9)
    thirds = []
    for fn in (tf, tf_ref):
        t = t64(T0, grad=True)
        thirds.append(torch.autograd.grad(hessian(fn, t, create_graph=True).diagonal().sum(), t)[0])
    close(thirds[0], thirds[1], rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("n,block,vec", [(37, 16, True), (37, 16, False), (48, 16, False), (5, 256, True)])
def test_mdivide_left_tri_low_blocked_is_the_reference(n, block, vec):
    """The JAX package's blocked forward substitution (padded to whole blocks
    with a unit diagonal), value and the gradients in ``L`` and ``b``."""
    from math_tpu.ops import cholesky as jch

    rng = np.random.default_rng(n + block)
    L = np.tril(rng.normal(size=(2, n, n))) + 3.0 * np.eye(n)
    b = rng.normal(size=(2, n) if vec else (2, n, 3))
    def solve(l, bb):
        out = jch.mdivide_left_tri_low_blocked(l, bb, block_size=block)
        return out.sum(), out

    # value and gradients in one jax.jit: one trace and compile (eager, two traces took twice as long)
    (_, want), want_g = jax.jit(jax.value_and_grad(solve, (0, 1), has_aux=True))(jnp.asarray(L), jnp.asarray(b))
    want, want_g = np.asarray(want), [np.asarray(g) for g in want_g]
    Lt, bt = torch.tensor(L, requires_grad=True), torch.tensor(b, requires_grad=True)
    got = tch.mdivide_left_tri_low_blocked(Lt, bt, block_size=block)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-12, atol=1e-13)
    for g, w in zip(torch.autograd.grad(got.sum(), (Lt, bt)), want_g):
        np.testing.assert_allclose(np.tril(g.numpy()) if g.ndim == 3 and g.shape[-1] == n and g.shape[-2] == n else g.numpy(),
                                   np.tril(w) if w.ndim == 3 and w.shape[-1] == n and w.shape[-2] == n else w,
                                   rtol=1e-10, atol=1e-12)


def test_the_reference_names_are_aliases():
    """``cholesky_decompose_tpu``, ``mdivide_left_tri_low_tpu`` and
    ``spd_solve_logdiag_tpu`` give the JAX package's values (its threshold
    accepted and not used)."""
    from math_tpu.ops import cholesky as jch

    rng = np.random.default_rng(3)
    a = rng.normal(size=(20, 20))
    a = a @ a.T + 20 * np.eye(20)
    b = rng.normal(size=(20, 2))
    L = np.linalg.cholesky(a)
    np.testing.assert_allclose(tch.cholesky_decompose_tpu(torch.tensor(a), threshold=4).numpy(),
                               np.asarray(jch.cholesky_decompose_tpu(jnp.asarray(a))), rtol=1e-11, atol=1e-12)
    np.testing.assert_allclose(tch.mdivide_left_tri_low_tpu(torch.tensor(L), torch.tensor(b)).numpy(),
                               np.asarray(jch.mdivide_left_tri_low_tpu(jnp.asarray(L), jnp.asarray(b))), rtol=1e-11)
    for g, w in zip(tch.spd_solve_logdiag_tpu(torch.tensor(a), torch.tensor(b)),
                    jch.spd_solve_logdiag_tpu(jnp.asarray(a), jnp.asarray(b))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-11, atol=1e-12)
