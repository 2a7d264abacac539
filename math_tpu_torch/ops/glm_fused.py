"""Fused GLM log-prob + parameter gradients for a batch of chains.

Counterpart: ``math_tpu/ops/pallas_glm.py`` (its three kernels, the AD wiring
and the six ``*_chains`` dispatchers).  Hand-written CUDA kernels in two
sources:

- ``_glm_kernel`` (four families with one linear predictor per chain) and
  ``_ordered_kernel`` (the ordered-logistic GLM, ``logp``, ``gbeta``,
  ``gcuts``), ``csrc/glm_fused.cu``: both products on the tensor cores in
  3xTF32 (``csrc/tf32x3.cuh``), taken transposed with the chains as the rows
  of the product, by two kernels: ``glm_tc_kernel`` for ``D <= 63`` (and
  ``K <= 8`` categories) where its block fits shared memory, and the tiled
  route (``pack_kernel``, ``value_kernel``, then ``grad_kernel``: D in slices
  of 32 through a ring of bulk copies, theta' through device memory) for
  every other shape.  ``glm_tile_plan`` picks by shape alone;
- ``_categorical_kernel``, ``csrc/glm_categorical.cu``: the
  categorical-logit GLM, ``logp``, ``galpha``, ``gbeta``, its two products on
  the tensor cores in 3xTF32 at every shape, by two kernels:
  ``glm_categorical_kernel`` where ``categorical_tile_plan`` finds a tile
  (``K <= 64`` and ``D`` up to its instances), and the tiled pair
  (``categorical_pack_kernel``, ``categorical_lse_kernel``, then
  ``categorical_grad_kernel``; the classes in flat column tiles, ``D`` in
  slices and groups) for every other shape.
  ``categorical_route`` picks by shape alone.

For the four families one pass over ``x`` gives, per chain,

    logp = sum lp(eta, y, extra),  ga = sum theta',  gb = x^T theta',
    ge = sum dlp/dextra            with eta = x @ beta + alpha,

so the design matrix is read once for the value and every parameter gradient.
Only the eta-dependent part of the density lives in the kernel; terms in
``(y, extra)`` alone are added outside in plain PyTorch.  All functions here
compute the ``propto=True`` form, as the JAX dispatchers do.

Rules: on a CUDA tensor each ``*_parts`` wrapper launches its kernel or
raises; it takes its plain version (``*_parts_reference``) only for tensors
that lie on the CPU.  No size is refused: every shape has a kernel.  The
``*_parts`` wrappers are strict about layout (float32, contiguous; ``y`` int32
for the ordered and categorical kernels; ``x`` and ``y`` 16-byte aligned on the
tensor-core routes, whose row tiles are bulk copies) and raise on anything
else; the ``*_chains`` dispatchers first lay ``x`` and ``y`` out as the kernels
take them (``kernel_layout``), so they refuse no layout and no integer type.
There are no dispatch thresholds: those of the JAX package were measured on
another chip and are not carried over.  ``LAUNCHES`` counts launches of the
tensor-core kernels per family (``glm_tc_kernel`` and the categorical kernel's),
``LAUNCHES_TILED`` calls of the tiled routes (the four families and the
ordered GLM: ``GLM_TILED_LAUNCHES_PER_CALL`` launches a call; the categorical
pair: ``TILED_LAUNCHES_PER_CALL``), ``PLAIN_CALLS`` calls of the
plain version, ``LAYOUT_COPIES`` the dispatcher calls that had to copy ``x``
or ``y``, so a run can show which one it went through.

Differentiation (ref: pallas_glm.py:219-237): at first order each
``autograd.Function`` reads the gradients (reverse mode) or the tangent
(forward mode, ``jvp``) off the partials its forward launch returned and
launches nothing more; that holds under a first-order ``torch.func``
transform too.  Under a second order (``ops/_forward.py``: ``create_graph=True``
over inputs that require grad, ``torch.func.hessian``, ``grad`` of ``grad``)
its backward takes the differentiable plain version instead, as the JAX package's second level differentiates its XLA
formulation, so Hessians (forward over reverse too) and higher orders work.
Each has a ``vmap`` rule that folds a vmapped parameter axis into the chain
lanes of one launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from math_tpu_torch.ops import _build
from math_tpu_torch.ops._forward import differentiated_again
from math_tpu_torch.special import log1m_exp

FAMILIES = ("bernoulli_logit", "poisson_log", "normal_id", "neg_binomial_2_log")
HAS_EXTRA = {
    "bernoulli_logit": False,
    "poisson_log": False,
    "normal_id": True,
    "neg_binomial_2_log": True,
}
_FAMILY_CODE = {f: i for i, f in enumerate(FAMILIES)}
ORDERED = "ordered_logistic"
ORDERED_KIND = 4  # the ordered kernel's kind beside the families' codes in glm_tc_launch
CATEGORICAL = "categorical_logit"
KERNEL_FAMILIES = FAMILIES + (ORDERED, CATEGORICAL)

LAUNCHES = {f: 0 for f in KERNEL_FAMILIES}
LAUNCHES_TILED = {f: 0 for f in KERNEL_FAMILIES}
PLAIN_CALLS = {f: 0 for f in KERNEL_FAMILIES}
LAYOUT_COPIES = {f: 0 for f in KERNEL_FAMILIES}

MAX_SMEM_BYTES = 232_448  # dynamic shared memory one block may use on sm_90
SM_SMEM_BYTES = 233_472  # shared memory of one SM on sm_90; each resident block also takes 1 KB


def _up128(b):
    return (b + 127) // 128 * 128


def reset_counts():
    for f in KERNEL_FAMILIES:
        LAUNCHES[f] = 0
        LAUNCHES_TILED[f] = 0
        PLAIN_CALLS[f] = 0
        LAYOUT_COPIES[f] = 0


# ---------------------------------------------------------------------------
# Family cores on (N, C) tiles, y as (N, 1), extra as (1, C)
# (ref: pallas_glm.py:62-101)
# ---------------------------------------------------------------------------


def _softplus(t):
    # not F.softplus: its threshold=20 switch differs from the exact form
    return torch.logaddexp(torch.zeros_like(t), t)


def _core(family, eta, y, extra):
    """(lp, theta' = dlp/deta, dlp/dextra or None)."""
    if family == "bernoulli_logit":
        sign = 2.0 * y - 1.0
        return -_softplus(-sign * eta), y - torch.sigmoid(eta), None
    if family == "poisson_log":
        mu = torch.exp(eta)
        return y * eta - mu, y - mu, None
    if family == "normal_id":
        inv_sigma = 1.0 / extra
        z = (y - eta) * inv_sigma
        return -0.5 * torch.square(z), z * inv_sigma, torch.square(z) * inv_sigma
    if family == "neg_binomial_2_log":
        log_phi = torch.log(extra)
        lse = torch.logaddexp(eta, log_phi)  # log(mu + phi), overflow-safe
        lp = y * eta - (y + extra) * lse
        thetap = y - (y + extra) * torch.sigmoid(eta - log_phi)
        return lp, thetap, -lse - (y + extra) * torch.exp(-lse)
    raise ValueError(f"unknown GLM family {family!r}")


def glm_fused_parts_reference(family, y, x, alpha, beta, extra=None):
    """Plain PyTorch version of the kernel (ref: ``_xla_parts``,
    pallas_glm.py:246-260): ``(logp (C,), ga (C,), gb (K, C), ge (C,) or
    None)`` in the dtype of ``x``, on its device.  Differentiable."""
    PLAIN_CALLS[family] += 1
    eta = x @ beta + alpha[None, :]
    e2 = extra[None, :] if HAS_EXTRA[family] else None
    lp, thetap, dextra = _core(family, eta, y[:, None], e2)
    ge = dextra.sum(0) if HAS_EXTRA[family] else None
    return lp.sum(0), thetap.sum(0), x.mT @ thetap, ge


# ---------------------------------------------------------------------------
# The kernel's wrapper
# ---------------------------------------------------------------------------

_lib = None
_cat_lib = None


def _library():
    """The kernels of ``csrc/glm_fused.cu`` (four families, ordered: both
    routes), built at first use."""
    global _lib
    if _lib is None:
        lib = _build.load_library("glm_fused")
        lib.glm_tiled_launch.restype = ctypes.c_int
        lib.glm_tiled_launch.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.glm_tiled_smem_bytes.restype = ctypes.c_longlong
        lib.glm_tiled_smem_bytes.argtypes = []
        lib.glm_tc_launch.restype = ctypes.c_int
        lib.glm_tc_launch.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.glm_tc_smem_bytes.restype = ctypes.c_longlong
        lib.glm_tc_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.glm_tc_chains_per_block.restype = ctypes.c_int
        lib.glm_tc_chains_per_block.argtypes = []
        lib.glm_tc_max_d.restype = ctypes.c_int
        lib.glm_tc_max_d.argtypes = []
        lib.glm_tc_max_categories.restype = ctypes.c_int
        lib.glm_tc_max_categories.argtypes = []
        _lib = lib
    return _lib


def _categorical_library():
    """The categorical kernels of ``csrc/glm_categorical.cu``, built at first use."""
    global _cat_lib
    if _cat_lib is None:
        lib = _build.load_library("glm_categorical")
        lib.glm_categorical_launch.restype = ctypes.c_int
        lib.glm_categorical_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        lib.glm_categorical_smem_bytes.restype = ctypes.c_longlong
        lib.glm_categorical_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.glm_categorical_chains_per_tile.restype = ctypes.c_int
        lib.glm_categorical_chains_per_tile.argtypes = [ctypes.c_int] * 2
        lib.glm_categorical_tiled_launch.restype = ctypes.c_int
        lib.glm_categorical_tiled_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        lib.glm_categorical_tiled_smem_bytes.restype = ctypes.c_longlong
        lib.glm_categorical_tiled_smem_bytes.argtypes = [ctypes.c_int] * 6
        _cat_lib = lib
    return _cat_lib


def _check(name, t, shape, device, who="glm_fused_parts"):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{who}: {name} must be a torch.Tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{who}: {name} is on {t.device}, x is on {device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{who}: {name} has shape {tuple(t.shape)}, expected {shape}")


def _check_cuda_layout(who, y, floats):
    """What a kernel takes: ``y`` int32 and the floating operands float32, all contiguous."""
    if y.dtype != torch.int32:
        raise TypeError(f"{who}: y is {y.dtype}; the CUDA kernel takes int32 categories")
    for name, t in floats:
        if t.dtype != torch.float32:
            raise TypeError(f"{who}: {name} is {t.dtype}; the CUDA kernel takes float32")
    for name, t in [("y", y)] + floats:
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")


# The tensor-core kernels (glm_tc_kernel in csrc/glm_fused.cu): the widest x
# ([x, 1] in one n64 product), the most categories of the ordered kernel
# (compiled per K), and the chains of one block (two pairs of warpgroups, 64
# chains a pair, the rows of a tile split between a pair's two warpgroups).
TC_MAX_D = 63
TC_MAX_CATEGORIES = 8
TC_CHAINS = 128
GSUM_STRIDE = 33  # floats of a thread's gradient sums in shared memory


def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def glm_tc_smem_bytes(d, kcat=0):
    """Bytes of shared memory one block of the tensor-core kernel needs (its
    ``tc_layout_of``): beta hi/lo (128 chains x Dp), the x tile as product 1's
    B hi/lo (64 x Dp) and as product 2's B hi/lo (64 x 64), the raw x tile, y
    raw and staged, the extended cut tile and its log1m_exp terms (``kcat`` >
    0: the ordered kernel), the double sums per chain and half tile, the
    gradient sums of every thread (512 threads), the barrier."""
    dp = (d + 7) // 8 * 8
    chains = TC_CHAINS
    parts = (chains * dp * 4, chains * dp * 4, 64 * dp * 4, 64 * dp * 4, 64 * 64 * 4, 64 * 64 * 4, 64 * d * 4,
             64 * 4, 64 * 4, chains * (2 * kcat + 1) * 4 if kcat else 0, 2 * chains * (kcat if kcat else 2) * 8,
             4 * chains * GSUM_STRIDE * 4, 8)
    return sum(_up128(p) for p in parts)


# The tiled route (csrc/glm_fused.cu, namespace tiled): column tiles of 128
# chains (64 a consumer warpgroup), launch 1's row tiles of 128 rows, D in
# slices of 32, launch 2's chunks of 32 rows and groups of 128 features, a
# ring of three 64 KB stages a block, two consumer warpgroups and a producer
# warp; five launches a call (pack, value, gradient, two reductions).
GLM_TILED_CHAINS = 128
GLM_TILED_ROWS = 128
GLM_TILED_DS = 32
GLM_TILED_CHUNK = 32
GLM_TILED_FEATURES = 128
GLM_TILED_STAGES = 3
GLM_TILED_STAGE_BYTES = 65_536
GLM_TILED_LAUNCHES_PER_CALL = 5
GLM_TILED_PARTIAL_FLOATS = 1 << 26  # launch 2's partials are capped at 256 MB


def glm_tiled_smem_bytes():
    """Bytes of shared memory one block of either launch of the tiled route
    needs (its ``layout_of``): the ring of stages, then their full and empty
    barriers.  The same for every D and K."""
    return GLM_TILED_STAGES * GLM_TILED_STAGE_BYTES + _up128(2 * GLM_TILED_STAGES * 8)


def glm_tiled_scratch(n, d, c, kcat=None):
    """Sizes of the tiled route's scratch: ``(packed floats, theta' floats,
    double sums per row block, gradient partial floats per row block)``.
    ``packed``: beta^T and x split hi / lo in stages of 128 x 32 (8,192
    floats each), then y over whole row tiles, then the ordered GLM's
    extended cuts (K+1, C) and log1m_exp terms (K, C)."""
    n_tiles = -(-n // GLM_TILED_ROWS)
    ns = -(-d // GLM_TILED_DS)
    col_tiles = -(-c // GLM_TILED_CHAINS)
    stage = 2 * GLM_TILED_CHAINS * GLM_TILED_DS
    packed = col_tiles * ns * stage + n_tiles * ns * stage + n_tiles * GLM_TILED_ROWS + ((2 * kcat + 1) * c if kcat else 0)
    theta = n_tiles * (GLM_TILED_ROWS // GLM_TILED_CHUNK) * col_tiles * stage
    return packed, theta, (kcat if kcat else 3) * c, d * c


def glm_tiled_plan(n, d, c, sms):
    """The tiled route's plan for ``x (n, d)`` and ``c`` chains on a card with
    ``sms`` SMs, any shape (the same for every K): column tiles of 128 chains,
    ``slices`` of 32 features, ``feature_groups`` of 128 for launch 2,
    ``row_blocks_value`` (launch 1) and ``row_blocks`` (launch 2): one block
    an SM over the card, launch 2's partials capped; ``smem`` of either
    launch's block, ``launches`` a call."""
    row_tiles = -(-n // GLM_TILED_ROWS)
    col_tiles = -(-c // GLM_TILED_CHAINS)
    groups = -(-d // GLM_TILED_FEATURES)
    cap = max(1, GLM_TILED_PARTIAL_FLOATS // (d * c))
    return {"route": "tensor_cores", "kernel": "tiled", "chains_per_block": GLM_TILED_CHAINS,
            "column_tiles": col_tiles, "slices": -(-d // GLM_TILED_DS), "feature_groups": groups,
            "smem": glm_tiled_smem_bytes(),
            "row_blocks_value": max(1, min(row_tiles, sms // col_tiles, 65535)),
            "row_blocks": max(1, min(4 * row_tiles, sms // (groups * col_tiles), cap, 65535)),
            "launches": GLM_TILED_LAUNCHES_PER_CALL}


def glm_tile_plan(n, d, c, sms, kcat=None):
    """Route and tile of kernel 1 (``kcat`` None) or of the ordered kernel
    (``kcat`` = K categories) for ``x (n, d)`` and ``c`` chains on a card with
    ``sms`` SMs, decided by shape alone; ``route`` is always
    ``"tensor_cores"``.  ``kernel`` ``"single"`` (``glm_tc_kernel``) where
    ``d <= TC_MAX_D``, ``kcat <= TC_MAX_CATEGORIES`` and its block fits shared
    memory: ``TC_CHAINS`` chains a block, ``smem``, ``column_tiles`` and
    ``row_blocks`` (one block an SM, as the register cap of 512 threads
    allows; one wave over the card).  Else ``"tiled"``, any shape:
    ``glm_tiled_plan``."""
    if d <= TC_MAX_D and (kcat is None or kcat <= TC_MAX_CATEGORIES):
        smem = glm_tc_smem_bytes(d, kcat or 0)
        if smem <= MAX_SMEM_BYTES:
            tiles = -(-c // TC_CHAINS)
            return {"route": "tensor_cores", "kernel": "single", "chains_per_block": TC_CHAINS, "column_tiles": tiles,
                    "smem": smem, "row_blocks": max(1, min(-(-n // 64), sms // tiles))}
    return glm_tiled_plan(n, d, c, sms)


def _check_aligned(who, tensors):
    """The tensor-core kernels (here and the categorical one) copy whole row
    tiles of x and y by 1-D bulk copies."""
    for name, t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{who}: {name} must be 16-byte aligned (its row tiles are bulk copies)")


def _launch_tc(who, kind, kcat, plan, y, x, alpha, beta, extra, rows):
    """One launch of ``glm_tc_kernel`` by ``plan``; returns ``out (rows, c)``."""
    lib = _library()
    n, d = x.shape
    c = beta.shape[1]
    if lib.glm_tc_smem_bytes(d, kcat) != plan["smem"] or lib.glm_tc_max_d() != TC_MAX_D \
            or lib.glm_tc_max_categories() != TC_MAX_CATEGORIES or lib.glm_tc_chains_per_block() != TC_CHAINS:
        raise RuntimeError(f"{who}: the tile plan disagrees with the kernel's layout")
    rb = plan["row_blocks"]
    with torch.cuda.device(x.device):
        partials = torch.empty((rb, rows, c), dtype=torch.float32, device=x.device)
        out = torch.empty((rows, c), dtype=torch.float32, device=x.device)
        err = lib.glm_tc_launch(
            kind, kcat, y.data_ptr(), x.data_ptr(), None if alpha is None else alpha.data_ptr(), beta.data_ptr(),
            None if extra is None else extra.data_ptr(), partials.data_ptr(), out.data_ptr(),
            n, d, c, rb, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{who}: tensor-core kernel launch failed: CUDA error {err}")
    return out


def _launch_tiled(who, kind, kcat, plan, y, x, alpha, beta, extra, rows):
    """One call of the tiled route by ``plan`` (five launches); returns ``out (rows, c)``."""
    lib = _library()
    n, d = x.shape
    c = beta.shape[1]
    if lib.glm_tiled_smem_bytes() != plan["smem"]:
        raise RuntimeError(f"{who}: the tiled plan disagrees with the kernels' layout")
    packed_n, theta_n, sums_n, part_n = glm_tiled_scratch(n, d, c, kcat or None)
    rb1, rb2 = plan["row_blocks_value"], plan["row_blocks"]
    # one scratch allocation a call, in floats: the double sums, packed, theta', partials, each 256-byte aligned
    sizes = (2 * rb1 * sums_n, packed_n, theta_n, rb2 * part_n)
    offsets = [0]
    for size in sizes[:-1]:
        offsets.append(offsets[-1] + -(-size // 64) * 64)
    with torch.cuda.device(x.device):
        scratch = torch.empty((offsets[-1] + sizes[-1],), dtype=torch.float32, device=x.device)
        sums, packed, theta, partials = (scratch.data_ptr() + 4 * o for o in offsets)
        out = torch.empty((rows, c), dtype=torch.float32, device=x.device)
        err = lib.glm_tiled_launch(
            kind, kcat, y.data_ptr(), x.data_ptr(), None if alpha is None else alpha.data_ptr(), beta.data_ptr(),
            None if extra is None else extra.data_ptr(), packed, theta, sums, partials, out.data_ptr(), n, d, c, rb1,
            rb2, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{who}: tiled route launch failed: CUDA error {err}")
    return out


def glm_fused_parts(family, y, x, alpha, beta, extra=None):
    """``(logp (C,), ga (C,), gb (K, C), ge (C,) or None)`` for ``y (N,)``,
    ``x (N, K)``, ``alpha (C,)``, ``beta (K, C)``, ``extra (C,)``.

    CUDA tensors go to a hand-written tensor-core kernel by ``glm_tile_plan``
    (float32, contiguous, and x and y 16-byte aligned for ``glm_tc_kernel``'s
    bulk copies, else this raises; the dispatchers lay them out first); CPU
    tensors go to ``glm_fused_parts_reference``.
    """
    if family not in _FAMILY_CODE:
        raise ValueError(f"unknown GLM family {family!r}")
    if not isinstance(x, torch.Tensor) or x.ndim != 2:
        raise ValueError("glm_fused_parts: x must be a 2-D torch.Tensor (N, K)")
    n, k = x.shape
    if beta.ndim != 2:
        raise ValueError("glm_fused_parts: beta must be 2-D (K, C)")
    c = beta.shape[1]
    has_extra = HAS_EXTRA[family]
    operands = [("y", y, (n,)), ("alpha", alpha, (c,)), ("beta", beta, (k, c))]
    if has_extra:
        operands.append(("extra", extra, (c,)))
    for name, t, shape in operands:
        _check(name, t, shape, x.device)

    if x.device.type == "cpu":
        return glm_fused_parts_reference(family, y, x, alpha, beta, extra)
    if x.device.type != "cuda":
        raise ValueError(f"glm_fused_parts: no kernel for device {x.device}")

    for name, t, _ in [("x", x, None)] + operands:
        if t.dtype != torch.float32:
            raise TypeError(f"glm_fused_parts: {name} is {t.dtype}; the CUDA kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"glm_fused_parts: {name} must be contiguous")
    if n < 1 or c < 1 or k < 1:
        raise ValueError(f"glm_fused_parts: need N, K, C >= 1; got {n}, {k}, {c}")

    plan = glm_tile_plan(n, k, c, _sm_count(x.device))
    extra_arg = extra if has_extra else None
    if plan["kernel"] == "single":
        _check_aligned("glm_fused_parts", [("x", x), ("y", y)])
        out = _launch_tc("glm_fused_parts", _FAMILY_CODE[family], 0, plan, y, x, alpha, beta, extra_arg, k + 3)
        LAUNCHES[family] += 1
    else:
        out = _launch_tiled("glm_fused_parts", _FAMILY_CODE[family], 0, plan, y, x, alpha, beta, extra_arg, k + 3)
        LAUNCHES_TILED[family] += 1
    return out[0], out[1], out[3:], (out[2] if has_extra else None)


# ---------------------------------------------------------------------------
# AD wiring (ref: pallas_glm.py:219-391)
# ---------------------------------------------------------------------------


def _dy_rows(family, eta, thetap, y, extra):
    """d logp_c / d y_n rows (N, C) for the float-data families
    (ref: pallas_glm.py:263-274)."""
    if family == "bernoulli_logit":
        sign = 2.0 * y[:, None] - 1.0
        return 2.0 * eta * torch.sigmoid(-sign * eta)
    if family == "poisson_log":
        return eta
    if family == "normal_id":
        return -thetap
    return eta - torch.logaddexp(eta, torch.log(extra)[None, :])


def _data_tangent(family, y, x, alpha, beta, extra, ty, tx):
    """Tangent of ``logp`` from perturbed data ``(y, x)`` by one eta recompute
    (ref: ``_data_tangent``, pallas_glm.py:277-291); its transpose is the data
    cotangent of ``GlmFused.backward``."""
    eta = x @ beta + alpha[None, :]
    e2 = extra[None, :] if HAS_EXTRA[family] else None
    _, thetap, _ = _core(family, eta, y[:, None], e2)
    tan = None
    if tx is not None:
        tan = (thetap * (tx @ beta)).sum(0)
    if ty is not None:
        t = ty @ _dy_rows(family, eta, thetap, y, extra)
        tan = t if tan is None else tan + t
    return tan


def _plus(tan, t):
    return t if tan is None else tan + t


def _lanes(t, d, v, lane_dim):
    """``t`` with the vmapped axis ``d`` (None: not batched, broadcast to ``v``)
    folded into its lane axis ``lane_dim``: ``(..., C, ...)`` -> ``(..., v*C, ...)``."""
    t = t.expand((v,) + tuple(t.shape)) if d is None else t.movedim(d, 0)
    t = t.movedim(0, lane_dim)
    shape = tuple(t.shape)
    return t.reshape(shape[:lane_dim] + (-1,) + shape[lane_dim + 2 :]).contiguous()


def _unfold(t, v, lane_dim):
    """The inverse of ``_lanes``: ``(..., v*C, ...)`` -> ``(..., v, C, ...)``;
    the vmapped axis sits at ``lane_dim``."""
    shape = tuple(t.shape)
    return t.reshape(shape[:lane_dim] + (v, -1) + shape[lane_dim + 1 :])


def _vmap_over_data(apply, info, in_dims, args):
    """A vmapped ``x`` or ``y``: one call (one launch) per batch element,
    stacked.  ``args`` are the Function's tensor operands, ``in_dims`` theirs."""
    outs = []
    for i in range(info.batch_size):
        outs.append(apply(*[t if d is None or t is None else t.select(d, i) for t, d in zip(args, in_dims)]))
    return tuple(torch.stack(o) for o in zip(*outs)), (0,) * len(outs[0])


class GlmFused(torch.autograd.Function):
    """``(logp (C,), ga, gb, ge)`` of one family's eta-part (``ge`` for the
    families with an extra parameter); the partials are outputs that are not
    differentiable, returned so that the rules below can read them.

    - First-order gradients for ``alpha``, ``beta``, ``extra`` are read off
      the partials (the transpose of the linear JVP rule, pallas_glm.py:343-358);
      the data-side cotangents for ``x`` and ``y`` are computed in plain
      PyTorch, and only when asked for.  There is no backward kernel, as in
      the JAX package.  Under a second order (``ops/_forward.py``) the
      partials come from the differentiable plain version (pallas_glm.py:305-311), so the result can
      be differentiated again.
    - Forward mode (``jvp``): the tangent ``ga ta + sum gb tb (+ ge te)`` is
      linear in the input tangent with coefficients from the forward launch's
      partials (level 0, ``fused_jvp`` pallas_glm.py:339-381), plus the data
      tangent by one eta recompute.
    - ``vmap`` folds a vmapped ``alpha`` / ``beta`` / ``extra`` into the
      chain lanes: one launch for every batch element (``_chol_inv_batcher``'s
      idea, chol_pallas.py:163-199); a vmapped ``x`` or ``y`` runs one launch
      per element.

    The operands must be contiguous (the dispatchers lay them out before the
    call, where autograd sees the copy)."""

    @staticmethod
    def forward(family, y, x, alpha, beta, extra):
        logp, ga, gb, ge = glm_fused_parts(family, y, x, alpha, beta, extra)
        return (logp, ga, gb) if ge is None else (logp, ga, gb, ge)

    @staticmethod
    def setup_context(ctx, inputs, output):
        family, y, x, alpha, beta, extra = inputs
        ga, gb = output[1], output[2]
        ge = output[3] if len(output) == 4 else None
        ctx.mark_non_differentiable(*output[1:])
        ctx.set_materialize_grads(False)
        ctx.family = family
        ctx.save_for_backward(y, x, alpha, beta, extra, ga, gb, ge)
        ctx.save_for_forward(y, x, alpha, beta, extra, ga, gb, ge)

    @staticmethod
    def backward(ctx, g, *_):
        y, x, alpha, beta, extra, ga, gb, ge = ctx.saved_tensors
        family = ctx.family
        if g is None:
            return (None,) * 6
        if differentiated_again(y, x, alpha, beta, extra):  # a second order: the partials must carry their derivative
            _, ga, gb, ge = glm_fused_parts_reference(family, y, x, alpha, beta, extra)
        need_y, need_x = ctx.needs_input_grad[1], ctx.needs_input_grad[2]
        gy = gx = None
        if need_y or need_x:
            eta = x @ beta + alpha[None, :]
            e2 = extra[None, :] if HAS_EXTRA[family] else None
            _, thetap, _ = _core(family, eta, y[:, None], e2)
            if need_x:
                gx = (thetap * g[None, :]) @ beta.mT
            if need_y:
                gy = _dy_rows(family, eta, thetap, y, extra) @ g
        g_alpha = g * ga if ctx.needs_input_grad[3] else None
        g_beta = g[None, :] * gb if ctx.needs_input_grad[4] else None
        g_extra = g * ge if (ge is not None and ctx.needs_input_grad[5]) else None
        return None, gy, gx, g_alpha, g_beta, g_extra

    @staticmethod
    def jvp(ctx, _, ty, tx, ta, tb, te):
        y, x, alpha, beta, extra, ga, gb, ge = ctx.saved_tensors
        if differentiated_again(y, x, alpha, beta, extra):
            _, ga, gb, ge = glm_fused_parts_reference(ctx.family, y, x, alpha, beta, extra)
        tan = None
        if ta is not None:
            tan = ga * ta
        if tb is not None:
            tan = _plus(tan, (gb * tb).sum(0))
        if te is not None and ge is not None:
            tan = _plus(tan, ge * te)
        if tx is not None or ty is not None:
            tan = _plus(tan, _data_tangent(ctx.family, y, x, alpha, beta, extra, ty, tx))
        if tan is None:
            tan = torch.zeros_like(ga)
        return (tan,) + (None,) * (3 if ge is not None else 2)

    @staticmethod
    def vmap(info, in_dims, family, y, x, alpha, beta, extra):
        _, yd, xd, ad, bd, ed = in_dims
        if yd is not None or xd is not None:
            return _vmap_over_data(lambda *a: GlmFused.apply(family, *a), info, in_dims[1:], (y, x, alpha, beta, extra))
        v = info.batch_size
        extra = None if extra is None else _lanes(extra, ed, v, 0)
        outs = GlmFused.apply(family, y, x, _lanes(alpha, ad, v, 0), _lanes(beta, bd, v, 1), extra)
        lane_dims = (0, 0, 1, 0)[: len(outs)]
        return tuple(_unfold(o, v, d) for o, d in zip(outs, lane_dims)), lane_dims


def _laid_out(t):
    return t.is_contiguous() and t.data_ptr() % 16 == 0


def kernel_layout(family, x, y):
    """``(x, y)`` as the kernels take them, each copied only where it is not
    already so: ``x`` contiguous and 16-byte aligned (a fresh allocation is);
    ``y`` the same, and of the kernel's type: an integer ``y`` of any width
    becomes int32 for the ordered and categorical kernels, and the families'
    ``y`` takes the type of ``x``.  A floating ``y`` of the ordered or
    categorical GLM is left for the wrapper to refuse.  Each call that copies
    anything counts once in ``LAYOUT_COPIES[family]``.  The dispatchers call it
    for CUDA tensors; a caller that passes an aligned, contiguous ``x`` and a
    ``y`` of the kernel's type pays for no copy.  The copy of ``x`` is made
    where autograd sees it, so its cotangent reaches the caller's ``x``."""
    copied = False
    if not _laid_out(x):
        x = x.clone(memory_format=torch.contiguous_format)
        copied = True
    if family in FAMILIES:
        want = x.dtype
    elif y.dtype.is_floating_point or y.dtype.is_complex or y.dtype == torch.bool:
        want = y.dtype
    else:
        want = torch.int32
    if y.dtype != want:
        y = y.to(want, memory_format=torch.contiguous_format)
        copied = True
    elif not _laid_out(y):
        y = y.clone(memory_format=torch.contiguous_format)
        copied = True
    if copied:
        LAYOUT_COPIES[family] += 1
    return x, y


def _for_kernel(family, x, y):
    """``kernel_layout`` where a kernel will read the tensors (CUDA); the
    plain version on the CPU takes any layout."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda" and isinstance(y, torch.Tensor):
        return kernel_layout(family, x, y)
    return x, y


def _fused(family, y, x, alpha, beta, extra=None):
    x, y = _for_kernel(family, x, y)
    return GlmFused.apply(
        family, y, x, alpha.contiguous(), beta.contiguous(), None if extra is None else extra.contiguous()
    )[0]


# ---------------------------------------------------------------------------
# Dispatchers (ref: pallas_glm.py:831-865, with the ``*_glm_fused`` functions
# of :394-417 folded in): alpha (C,), beta (K, C) -> logp (C,), propto=True.
# The JAX ones choose between the kernel and vmapped XLA by thresholds and take
# an ``interpret`` flag; here the device of the tensors decides alone.
# ---------------------------------------------------------------------------


def bernoulli_logit_glm_lpmf_chains(y, x, alpha, beta):
    """y (N,), x (N, K), alpha (C,), beta (K, C) -> logp (C,)."""
    return _fused("bernoulli_logit", y, x, alpha, beta)


def poisson_log_glm_lpmf_chains(y, x, alpha, beta):
    return _fused("poisson_log", y, x, alpha, beta)


def normal_id_glm_lpdf_chains(y, x, alpha, beta, sigma):
    """Core kernel plus the -N log sigma term (plain PyTorch; its
    sigma-gradient comes from autograd).  ref: pallas_glm.py:400-406."""
    n = y.shape[0]
    return _fused("normal_id", y, x, alpha, beta, sigma) - n * torch.log(sigma)


def neg_binomial_2_log_glm_lpmf_chains(y, x, alpha, beta, phi):
    """Eta-core kernel plus the (y, phi)-only terms lgamma(y+phi) -
    lgamma(phi) + phi log phi (plain PyTorch over the (N, C) y-phi grid; no x
    read).  ref: pallas_glm.py:409-417."""
    n = y.shape[0]
    core = _fused("neg_binomial_2_log", y, x, alpha, beta, phi)
    data = torch.lgamma(y[:, None] + phi[None, :]).sum(0)
    return core + data - n * torch.lgamma(phi) + n * phi * torch.log(phi)


# ---------------------------------------------------------------------------
# ordered_logistic_glm (ref: pallas_glm.py:420-637 and the dispatcher :868-882)
# ---------------------------------------------------------------------------

ORD_BIG = 1e4  # stands in for the -/+ inf boundary cuts c_0, c_K (ref: pallas_glm.py:428)


def _ordered_rows(y, x, beta, cuts):
    """Per (row, chain): ``(lp, w1, w2)`` and the 1-based categories as int64
    (ref: pallas_glm.py:469-481).  The cut pair is read by index from the cut
    matrix extended with -/+ORD_BIG; ``y`` is clamped into 1..K as the kernel does."""
    big = torch.full((1, cuts.shape[1]), ORD_BIG, dtype=cuts.dtype, device=cuts.device)
    ext = torch.cat([-big, cuts, big], dim=0)  # (K+1, C)
    yl = torch.clamp(y.long(), 1, cuts.shape[0] + 1)
    eta = x @ beta
    u2 = ext[yl] - eta
    u1 = ext[yl - 1] - eta
    sp2, sp1 = _softplus(u2), _softplus(u1)
    # log1m_exp as the kernel computes it (ref: pallas_glm.py:449-456): the
    # argument capped at -1e-20 and floored at -80
    lp = u2 - sp2 - sp1 + log1m_exp(torch.clamp(u1 - u2, -80.0, -1e-20))
    w2 = torch.exp(u2 - 2.0 * sp2 - lp)
    w1 = torch.exp(u1 - 2.0 * sp1 - lp)
    return lp, w1, w2, yl


def ordered_logistic_glm_parts_reference(y, x, beta, cuts):
    """Plain PyTorch version of the ordered kernel (ref: ``_ordered_xla_parts``,
    pallas_glm.py:556-576): ``(logp (C,), gbeta (D, C), gcuts (K-1, C))`` in
    the dtype of ``x``, on its device.  Differentiable in ``x``, ``beta``, ``cuts``."""
    PLAIN_CALLS[ORDERED] += 1
    lp, w1, w2, yl = _ordered_rows(y, x, beta, cuts)
    rows = torch.zeros((cuts.shape[0] + 2, cuts.shape[1]), dtype=w1.dtype, device=w1.device)
    gc = rows.index_add(0, yl, w2) - rows.index_add(0, yl - 1, w1)
    return lp.sum(0), x.mT @ (w1 - w2), gc[1:-1]


def _ordered_eta_partials(y, x, beta, cuts):
    """theta' = d lp / d eta (N, C) for the data-side cotangent (ref: pallas_glm.py:579-590)."""
    _, w1, w2, _ = _ordered_rows(y, x, beta, cuts)
    return w1 - w2


def _check_categories(who, y, n, device):
    _check("y", y, (n,), device, who)
    if y.dtype.is_floating_point or y.dtype.is_complex or y.dtype == torch.bool:
        raise TypeError(f"{who}: y must hold integer categories 1..K, got {y.dtype}")


def ordered_logistic_glm_parts(y, x, beta, cuts):
    """``(logp (C,), gbeta (D, C), gcuts (K-1, C))`` for ``y (N,)`` integer
    categories 1..K, ``x (N, D)``, ``beta (D, C)``, ``cuts (K-1, C)``;
    ``propto=True`` form, valid data assumed (as the JAX dispatcher does).

    CUDA tensors go to a hand-written tensor-core kernel by ``glm_tile_plan``
    (``y`` int32, the rest float32, all contiguous, and x and y 16-byte
    aligned for ``glm_tc_kernel``'s bulk copies, else this raises; the
    dispatcher lays them out first); CPU tensors go to
    ``ordered_logistic_glm_parts_reference``.
    """
    who = "ordered_logistic_glm_parts"
    if not isinstance(x, torch.Tensor) or x.ndim != 2:
        raise ValueError(f"{who}: x must be a 2-D torch.Tensor (N, D)")
    n, d = x.shape
    if not isinstance(beta, torch.Tensor) or beta.ndim != 2 or not isinstance(cuts, torch.Tensor) or cuts.ndim != 2:
        raise ValueError(f"{who}: beta must be 2-D (D, C) and cuts 2-D (K-1, C)")
    c, kc = beta.shape[1], cuts.shape[0]
    _check_categories(who, y, n, x.device)
    _check("beta", beta, (d, c), x.device, who)
    _check("cuts", cuts, (kc, c), x.device, who)
    if kc < 1:
        raise ValueError(f"{who}: need at least one cut (K >= 2)")

    if x.device.type == "cpu":
        return ordered_logistic_glm_parts_reference(y, x, beta, cuts)
    if x.device.type != "cuda":
        raise ValueError(f"{who}: no kernel for device {x.device}")
    _check_cuda_layout(who, y, [("x", x), ("beta", beta), ("cuts", cuts)])
    if n < 1 or d < 1 or c < 1:
        raise ValueError(f"{who}: need N, D, C >= 1; got {n}, {d}, {c}")

    plan = glm_tile_plan(n, d, c, _sm_count(x.device), kcat=kc + 1)
    rows = d + kc + 1
    if plan["kernel"] == "single":
        _check_aligned(who, [("x", x), ("y", y)])
        out = _launch_tc(who, ORDERED_KIND, kc + 1, plan, y, x, None, beta, cuts, rows)
        LAUNCHES[ORDERED] += 1
    else:
        out = _launch_tiled(who, ORDERED_KIND, kc + 1, plan, y, x, None, beta, cuts, rows)
        LAUNCHES_TILED[ORDERED] += 1
    return out[0], out[1 : 1 + d], out[1 + d :]


class OrderedGlmFused(torch.autograd.Function):
    """``(logp (C,), gbeta, gcuts)`` of the ordered-logistic GLM, the partials
    not differentiable.  First-order gradients for ``beta`` and ``cuts`` are
    read off the partials (ref: pallas_glm.py:621-634), the ``x`` cotangent is
    computed in plain PyTorch only when asked for (``_ordered_eta_partials``).
    Under a second order the partials come from the differentiable plain
    version (pallas_glm.py:598-607).  ``jvp``: ``sum gbeta tb + sum gcuts tc``
    plus the ``x`` tangent (``_ordered_fused_jvp``, pallas_glm.py:610-637);
    ``vmap`` folds a vmapped ``beta`` / ``cuts`` into the chain lanes."""

    @staticmethod
    def forward(y, x, beta, cuts):
        return ordered_logistic_glm_parts(y, x, beta, cuts)

    @staticmethod
    def setup_context(ctx, inputs, output):
        y, x, beta, cuts = inputs
        ctx.mark_non_differentiable(*output[1:])
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(y, x, beta, cuts, *output[1:])
        ctx.save_for_forward(y, x, beta, cuts, *output[1:])

    @staticmethod
    def backward(ctx, g, *_):
        y, x, beta, cuts, gb, gc = ctx.saved_tensors
        if g is None:
            return None, None, None, None
        if differentiated_again(y, x, beta, cuts):  # a second order: the partials must carry their derivative
            _, gb, gc = ordered_logistic_glm_parts_reference(y, x, beta, cuts)
        gx = None
        if ctx.needs_input_grad[1]:
            gx = (_ordered_eta_partials(y, x, beta, cuts) * g[None, :]) @ beta.mT
        g_beta = g[None, :] * gb if ctx.needs_input_grad[2] else None
        g_cuts = g[None, :] * gc if ctx.needs_input_grad[3] else None
        return None, gx, g_beta, g_cuts

    @staticmethod
    def jvp(ctx, _, tx, tb, tc):
        y, x, beta, cuts, gb, gc = ctx.saved_tensors
        if differentiated_again(x, beta, cuts):
            _, gb, gc = ordered_logistic_glm_parts_reference(y, x, beta, cuts)
        tan = None
        if tb is not None:
            tan = (gb * tb).sum(0)
        if tc is not None:
            tan = _plus(tan, (gc * tc).sum(0))
        if tx is not None:
            tan = _plus(tan, (_ordered_eta_partials(y, x, beta, cuts) * (tx @ beta)).sum(0))
        if tan is None:
            tan = torch.zeros(gb.shape[1:], dtype=gb.dtype, device=gb.device)
        return tan, None, None

    @staticmethod
    def vmap(info, in_dims, y, x, beta, cuts):
        yd, xd, bd, cd = in_dims
        if yd is not None or xd is not None:
            return _vmap_over_data(OrderedGlmFused.apply, info, in_dims, (y, x, beta, cuts))
        v = info.batch_size
        outs = OrderedGlmFused.apply(y, x, _lanes(beta, bd, v, 1), _lanes(cuts, cd, v, 1))
        return (_unfold(outs[0], v, 0), _unfold(outs[1], v, 1), _unfold(outs[2], v, 1)), (0, 1, 1)


def ordered_logistic_glm_lpmf_chains(y, x, beta, cuts):
    """y (N,) int 1..K, x (N, D), beta (D, C), cuts (K-1, C) -> (C,).
    Assumes valid data (like the other chains dispatchers); mirrors
    dists.ordered_logistic_glm_lpmf(..., propto=True) per chain, with the
    kernel's -/+1e4 boundary cuts.  ref: pallas_glm.py:868-882."""
    x, y = _for_kernel(ORDERED, x, y)
    return OrderedGlmFused.apply(y, x, beta.contiguous(), cuts.contiguous())[0]


# ---------------------------------------------------------------------------
# categorical_logit_glm (ref: pallas_glm.py:640-808 and the dispatcher :885-905)
# ---------------------------------------------------------------------------

MAX_CLASSES = 64  # the tensor-core kernel: one chain's classes share a column tile

# The kernel's instantiations (wgs, mt): wgs warpgroups of an n40 column slice
# each (a tile of 40*wgs columns) for mt 64-row tiles of [gbeta; galpha]
# (mt = ceil((D + 1) / 64)).  The same set as GLM_CATEGORICAL_INSTANCES in
# csrc/glm_categorical.cu.
CATEGORICAL_INSTANCES = ((2, 1), (2, 2), (2, 3), (2, 4), (1, 4), (1, 5))
def categorical_smem_bytes(n_cols, d, cpt, stages):
    """Bytes of shared memory one block of the categorical kernel needs (its
    ``layout_of``): beta hi/lo (n_cols x Dp), theta' hi/lo (n_cols x 64), a
    ring of ``stages`` x and y tiles, alpha, the tile's lp by 4-row groups, the
    lp sums, barriers."""
    dp = (d + 7) // 8 * 8
    parts = (n_cols * dp * 4, n_cols * dp * 4, n_cols * 64 * 4, n_cols * 64 * 4, stages * 64 * d * 4,
             stages * 64 * 4, n_cols * 4, 16 * cpt * 4, cpt * 8, stages * 8)
    return sum(_up128(p) for p in parts)


def categorical_tile_plan(n, d, c, k, sms):
    """The categorical kernel's tile for ``x (n, d)``, ``c`` chains of ``k``
    classes on a card with ``sms`` SMs, as a dict: the instantiation (``wgs``
    warpgroups of an n40 slice, ``n_cols = 40*wgs`` columns, ``mt``),
    ``cpt`` (whole chains per tile), ``column_tiles``, ``stages`` of the x ring
    (2 where it fits), ``smem`` bytes, ``blocks_per_sm`` that shared memory
    lets reside together, and ``row_blocks``.  Among the instantiations for
    this D it takes the one with the least padded column work per resident
    block (columns over all tiles / blocks per SM: two blocks on an SM hide
    each other's latencies), then the fewest tiles (each streams x once).
    None when no instantiation takes the shape."""
    mt = (d + 64) // 64
    best = None
    for wgs, imt in CATEGORICAL_INSTANCES:
        n_cols = 40 * wgs
        cpt = n_cols // k
        if imt != mt or cpt < 1:
            continue
        stages = next((s for s in (2, 1) if categorical_smem_bytes(n_cols, d, cpt, s) <= MAX_SMEM_BYTES), None)
        if stages is None:
            continue
        smem = categorical_smem_bytes(n_cols, d, cpt, stages)
        per_sm = max(1, min(2, SM_SMEM_BYTES // (smem + 1024)))
        tiles = -(-c // cpt)
        key = (tiles * n_cols / per_sm, tiles)
        if best is None or key < best[0]:
            best = (key, {"wgs": wgs, "n_cols": n_cols, "mt": mt, "cpt": cpt, "column_tiles": tiles,
                          "stages": stages, "smem": smem, "blocks_per_sm": per_sm})
    if best is None:
        return None
    plan = best[1]
    plan["row_blocks"] = max(1, min(-(-n // 64), sms * plan["blocks_per_sm"] // plan["column_tiles"]))
    return plan


# The tiled pair (categorical_pack_kernel, categorical_lse_kernel,
# categorical_grad_kernel<MT, WHOLE_X> in csrc/glm_categorical.cu): flat (chain, class)
# column tiles of 80 (an n40 slice per warpgroup), D in slices of 32 through a
# ring of stages (beta hi/lo K-major, 20,480 bytes; x rows 36 floats apart,
# 9,216 bytes): 2 in launch 1 (cpb chains a block, at most 16), 2-4 in launch
# 2 (beta alone where x comes whole a row tile, ``whole_x``); launch 2's
# groups of 64*MT rows of [gbeta; galpha] (its instances TILED_MT, each with
# and without whole_x; else a window of 2*MT packed x slices).
TILED_COLUMNS = 80
TILED_DS = 32
TILED_XS = TILED_DS + 4
TILED_LSE_STAGES = 2
TILED_MAX_GRAD_STAGES = 4
TILED_MAX_CPB = 16
TILED_MT = (1, 2, 4, 7)
TILED_BETA_SLICE = 2 * TILED_COLUMNS * TILED_DS * 4
TILED_X_SLICE = 64 * TILED_XS * 4
TILED_LAUNCHES_PER_CALL = 5  # pack, launch 1, launch 2, the two reductions
TILED_PARTIAL_FLOATS = 1 << 26  # launch 2's partials are capped at 256 MB


def tiled_chains_per_tile(k, c):
    """The most chains a tile of 80 flat columns touches."""
    return min(c, (TILED_COLUMNS - 1) // k + 2)


def categorical_lse_smem_bytes(cpb):
    """Bytes of shared memory of a block of launch 1 (its ``lse_layout_of``):
    the ring, eta + alpha of a window (64 rows of 84), its chain segments (two
    tables of 81), the running maximum, sum and picked logit (3 x 64 x
    ``cpb``), the logp sums, alpha of a window, y of a row tile, the
    barriers."""
    parts = (64 * (TILED_COLUMNS + 4) * 4, 2 * (TILED_COLUMNS + 1) * 16, 64 * cpb * 4, 64 * cpb * 4, 64 * cpb * 4, cpb * 8,
             TILED_COLUMNS * 4, 64 * 4, TILED_LSE_STAGES * 8)
    return TILED_LSE_STAGES * (TILED_BETA_SLICE + TILED_X_SLICE) + sum(_up128(p) for p in parts)


def categorical_grad_smem_bytes(mt, nch, stages, whole_x, d):
    """Bytes of shared memory of a block of launch 2 (its ``grad_layout_of``):
    the ring (``stages`` slices of beta, and of x unless ``whole_x``), theta'
    hi/lo (2 x 80 x 64), x (all ``ceil(d / 32)`` packed slices of a row tile
    where ``whole_x``, else the group's 2*mt), the tile's lse (64 x ``nch``),
    y, the column table (class, chain, valid, alpha; offsets), the
    barriers."""
    ring = stages * (TILED_BETA_SLICE + (0 if whole_x else TILED_X_SLICE))
    parts = (2 * TILED_COLUMNS * 64 * 4, (-(-d // TILED_DS) if whole_x else 2 * mt) * TILED_X_SLICE, 64 * nch * 4,
             64 * 4, TILED_COLUMNS * 16, TILED_COLUMNS * 8, (TILED_MAX_GRAD_STAGES + 1) * 8)
    return ring + sum(_up128(p) for p in parts)


def tiled_chains_per_block(c, k):
    """Launch 1's chains a block: at most 16 (its running sums), the fewest
    idle columns in its windows of 80, the most chains among equals."""
    idle = lambda q: -(-q * k // TILED_COLUMNS) * TILED_COLUMNS / (q * k)  # noqa: E731
    return min(range(1, min(c, TILED_MAX_CPB) + 1), key=lambda q: (idle(q), -q))


def categorical_packed_floats(n, d, c, k, cpb):
    """Floats of launch 0's packed operands: launch 2's beta stages (80
    columns by 32 features, hi and lo, per column tile), launch 1's (per
    chain group of ``cpb`` and window), the x stages (64 rows of 36 by
    slice)."""
    ns = -(-d // TILED_DS)
    stage = 2 * TILED_COLUMNS * TILED_DS
    return (-(-(c * k) // TILED_COLUMNS) * ns * stage, -(-c // cpb) * -(-(cpb * k) // TILED_COLUMNS) * ns * stage,
            -(-n // 64) * ns * 64 * TILED_XS)


def _row_blocks(blocks, n_tiles, slots, cap):
    """Row blocks for ``blocks`` blocks a row block: the fewest whose cost,
    waves of ``slots`` resident blocks times row tiles a block, is within 3%
    of the least (more row blocks cost partials and their reduction)."""
    costs = [-(-blocks * rb // slots) * -(-n_tiles // rb) for rb in range(1, max(1, min(n_tiles, cap)) + 1)]
    return next(rb for rb, cost in enumerate(costs, 1) if cost <= 1.03 * min(costs))


@functools.lru_cache(maxsize=256)
def _tiled_plan(n, d, c, k, sms):
    m_tiles = -(-(d + 1) // 64)
    cpb = tiled_chains_per_block(c, k)
    nch = tiled_chains_per_tile(k, c)
    smem_lse = categorical_lse_smem_bytes(cpb)
    per_sm_lse = max(1, min(2, SM_SMEM_BYTES // (smem_lse + 1024)))
    # launch 2: the fewest groups (each computes product 1 again), then the
    # most resident blocks (two at mt = 1, its register cap), then x whole a
    # row tile, then the deepest ring, that fit shared memory
    for cap in reversed(TILED_MT):
        groups = -(-m_tiles // cap)
        mt = next(i for i in TILED_MT if i * groups >= m_tiles)
        options = []
        for whole_x in (True, False):
            for stages in range(2, TILED_MAX_GRAD_STAGES + 1):
                smem = categorical_grad_smem_bytes(mt, nch, stages, whole_x, d)
                if smem <= MAX_SMEM_BYTES:
                    per = max(1, min(2 if mt == 1 else 1, SM_SMEM_BYTES // (smem + 1024)))
                    options.append(((per, whole_x, stages), smem))
        if options:
            break
    (per_sm, whole_x, stages), smem = max(options)
    n_tiles = -(-n // 64)
    chain_groups, column_tiles = -(-c // cpb), -(-(c * k) // TILED_COLUMNS)
    return {"route": "tensor_cores", "kernel": "tiled", "mt": mt, "groups": groups, "cpb": cpb,
            "chain_groups": chain_groups, "column_tiles": column_tiles, "nch": nch, "stages": stages, "whole_x": whole_x,
            "smem_lse": smem_lse, "smem": smem, "blocks_per_sm_lse": per_sm_lse, "blocks_per_sm": per_sm,
            "row_blocks_lse": _row_blocks(chain_groups, n_tiles, sms * per_sm_lse, 65535),
            "row_blocks": _row_blocks(column_tiles * groups, n_tiles, sms * per_sm,
                                      min(65535, TILED_PARTIAL_FLOATS // (c * k * (d + 1)))),
            "launches": TILED_LAUNCHES_PER_CALL}


def categorical_tiled_plan(n, d, c, k, sms):
    """The tiled pair's plan for ``x (n, d)``, ``c`` chains of ``k`` classes on
    a card with ``sms`` SMs, any shape: launch 1's ``cpb`` chains a block
    (``tiled_chains_per_block``), ``chain_groups`` and ``row_blocks_lse``;
    launch 2's ``column_tiles`` of 80 flat columns, ``groups`` of ``64 * mt``
    rows of [gbeta; galpha] (``mt`` the least instance that covers a group of
    at most 7 row tiles, or 4 where 7 do not fit shared memory), ``whole_x``,
    the ring's ``stages`` and ``row_blocks``; ``nch`` chains a tile touches at
    most; shared memory and resident blocks of each launch; ``launches`` a
    call."""
    return dict(_tiled_plan(n, d, c, k, sms))


def categorical_route(n, d, c, k, sms):
    """The categorical kernel's plan for ``x (n, d)`` and ``c`` chains of ``k``
    classes, by shape alone, on the tensor cores at every shape:
    ``glm_categorical_kernel`` (``kernel`` ``"single"`` and
    ``categorical_tile_plan``'s tile) wherever that plan takes the shape,
    else the tiled pair (``categorical_tiled_plan``).  Never None."""
    plan = categorical_tile_plan(n, d, c, k, sms) if k <= MAX_CLASSES else None
    if plan is not None:
        return {"route": "tensor_cores", "kernel": "single", **plan}
    return categorical_tiled_plan(n, d, c, k, sms)


def _categorical_thetap(y, x, alpha, beta):
    """``(eta (C, N, K), onehot (N, K), theta' (C, N, K))``; ``y`` is clamped
    into 1..K as the kernel does."""
    k = beta.shape[-1]
    eta = torch.einsum("nd,cdk->cnk", x, beta) + alpha[:, None, :]
    yl = torch.clamp(y.long() - 1, 0, k - 1)
    onehot = torch.nn.functional.one_hot(yl, k).to(eta.dtype)
    return eta, yl, onehot[None] - torch.softmax(eta, dim=-1)


def categorical_logit_glm_parts_reference(y, x, alpha, beta):
    """Plain PyTorch version of the categorical kernel (ref:
    ``_categorical_xla_parts``, pallas_glm.py:748-761): ``(logp (C,), galpha
    (C, K), gbeta (C, D, K))`` in the dtype of ``x``, on its device.
    Differentiable in ``x``, ``alpha``, ``beta``."""
    PLAIN_CALLS[CATEGORICAL] += 1
    eta, yl, thetap = _categorical_thetap(y, x, alpha, beta)
    logsm = torch.log_softmax(eta, dim=-1)
    picked = torch.gather(logsm, -1, yl.expand(logsm.shape[:-1])[..., None])[..., 0]
    return picked.sum(-1), thetap.sum(1), torch.einsum("nd,cnk->cdk", x, thetap)


def categorical_logit_glm_parts(y, x, alpha, beta):
    """``(logp (C,), galpha (C, K), gbeta (C, D, K))`` for ``y (N,)`` integer
    classes 1..K, ``x (N, D)``, ``alpha (C, K)``, ``beta (C, D, K)``;
    ``propto=True`` form, valid data assumed.

    CUDA tensors go to a hand-written tensor-core kernel by
    ``categorical_route``: ``glm_categorical_kernel``, or the tiled pair for
    the shapes the former does not take (``y`` int32, the rest float32, all
    contiguous, and x and y 16-byte aligned for the former's bulk copies, else
    this raises; the dispatcher lays them out first); CPU tensors go to
    ``categorical_logit_glm_parts_reference``.
    """
    who = "categorical_logit_glm_parts"
    if not isinstance(x, torch.Tensor) or x.ndim != 2:
        raise ValueError(f"{who}: x must be a 2-D torch.Tensor (N, D)")
    n, d = x.shape
    if not isinstance(beta, torch.Tensor) or beta.ndim != 3:
        raise ValueError(f"{who}: beta must be 3-D (C, D, K)")
    c, _, k = beta.shape
    _check_categories(who, y, n, x.device)
    _check("alpha", alpha, (c, k), x.device, who)
    _check("beta", beta, (c, d, k), x.device, who)

    if x.device.type == "cpu":
        return categorical_logit_glm_parts_reference(y, x, alpha, beta)
    if x.device.type != "cuda":
        raise ValueError(f"{who}: no kernel for device {x.device}")
    _check_cuda_layout(who, y, [("x", x), ("alpha", alpha), ("beta", beta)])
    if n < 1 or d < 1 or c < 1 or k < 1:
        raise ValueError(f"{who}: need N, D, C, K >= 1; got {n}, {d}, {c}, {k}")

    plan = categorical_route(n, d, c, k, _sm_count(x.device))
    m = c * (1 + k + d * k)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _categorical_library()
    with torch.cuda.device(x.device):
        out = torch.empty((m,), dtype=torch.float32, device=x.device)
        if plan["kernel"] == "single":
            _check_aligned(who, [("x", x), ("y", y)])
            n_cols, cpt, stages = plan["n_cols"], plan["cpt"], plan["stages"]
            if lib.glm_categorical_smem_bytes(n_cols, d, cpt, stages) != plan["smem"] or lib.glm_categorical_chains_per_tile(k, n_cols) != cpt:
                raise RuntimeError(f"{who}: the tile plan disagrees with the kernel's layout")
            partials = torch.empty((plan["row_blocks"], m), dtype=torch.float32, device=x.device)
            err = lib.glm_categorical_launch(
                y.data_ptr(), x.data_ptr(), alpha.data_ptr(), beta.data_ptr(), partials.data_ptr(), out.data_ptr(),
                n, d, c, k, plan["wgs"], plan["mt"], cpt, stages, plan["row_blocks"], stream,
            )
            counter = LAUNCHES
        else:
            mt, rb1, rb2 = plan["mt"], plan["row_blocks_lse"], plan["row_blocks"]
            stages, whole_x = plan["stages"], int(plan["whole_x"])
            if (lib.glm_categorical_tiled_smem_bytes(1, plan["cpb"], 0, 0, 0, d) != plan["smem_lse"]
                    or lib.glm_categorical_tiled_smem_bytes(2, mt, plan["nch"], stages, whole_x, d) != plan["smem"]):
                raise RuntimeError(f"{who}: the tiled plan disagrees with the kernels' layouts")
            lse = torch.empty((c, n), dtype=torch.float32, device=x.device)
            partials = torch.empty((rb1 * c + rb2 * (m - c),), dtype=torch.float32, device=x.device)
            packed = torch.empty((sum(categorical_packed_floats(n, d, c, k, plan["cpb"])),), dtype=torch.float32,
                                 device=x.device)
            err = lib.glm_categorical_tiled_launch(
                y.data_ptr(), x.data_ptr(), alpha.data_ptr(), beta.data_ptr(), lse.data_ptr(), packed.data_ptr(),
                partials.data_ptr(), out.data_ptr(), n, d, c, k, mt, plan["groups"], plan["cpb"], rb1, rb2, stages, whole_x,
                stream,
            )
            counter = LAUNCHES_TILED
    if err != 0:
        raise RuntimeError(f"glm_categorical kernel launch failed ({plan['kernel']} kernel): CUDA error {err}")
    counter[CATEGORICAL] += 1
    return out[:c], out[c : c + c * k].view(c, k), out[c + c * k :].view(c, d, k)


class CategoricalGlmFused(torch.autograd.Function):
    """``(logp (C,), galpha, gbeta)`` of the categorical-logit GLM, the
    partials not differentiable.  First-order gradients for ``alpha`` and
    ``beta`` are read off the partials (ref: pallas_glm.py:792-805), the ``x``
    cotangent is computed in plain PyTorch only when asked for.  Under a
    second order the partials come from the differentiable plain version
    (pallas_glm.py:769-778).  ``jvp``: ``sum galpha ta + sum gbeta tb`` plus
    the ``x`` tangent (``_categorical_fused_jvp``, pallas_glm.py:781-808);
    ``vmap`` folds a vmapped ``alpha`` / ``beta`` into the chains."""

    @staticmethod
    def forward(y, x, alpha, beta):
        return categorical_logit_glm_parts(y, x, alpha, beta)

    @staticmethod
    def setup_context(ctx, inputs, output):
        y, x, alpha, beta = inputs
        ctx.mark_non_differentiable(*output[1:])
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(y, x, alpha, beta, *output[1:])
        ctx.save_for_forward(y, x, alpha, beta, *output[1:])

    @staticmethod
    def backward(ctx, g, *_):
        y, x, alpha, beta, ga, gb = ctx.saved_tensors
        if g is None:
            return None, None, None, None
        if differentiated_again(y, x, alpha, beta):  # a second order: the partials must carry their derivative
            _, ga, gb = categorical_logit_glm_parts_reference(y, x, alpha, beta)
        gx = None
        if ctx.needs_input_grad[1]:
            _, _, thetap = _categorical_thetap(y, x, alpha, beta)
            gx = torch.einsum("cnk,cdk->nd", thetap * g[:, None, None], beta)
        g_alpha = g[:, None] * ga if ctx.needs_input_grad[2] else None
        g_beta = g[:, None, None] * gb if ctx.needs_input_grad[3] else None
        return None, gx, g_alpha, g_beta

    @staticmethod
    def jvp(ctx, _, tx, ta, tb):
        y, x, alpha, beta, ga, gb = ctx.saved_tensors
        if differentiated_again(x, alpha, beta):
            _, ga, gb = categorical_logit_glm_parts_reference(y, x, alpha, beta)
        tan = None
        if ta is not None:
            tan = (ga * ta).sum(-1)
        if tb is not None:
            tan = _plus(tan, (gb * tb).sum((-2, -1)))
        if tx is not None:
            _, _, thetap = _categorical_thetap(y, x, alpha, beta)
            tan = _plus(tan, torch.einsum("cnk,nd,cdk->c", thetap, tx, beta))
        if tan is None:
            tan = torch.zeros(ga.shape[:1], dtype=ga.dtype, device=ga.device)
        return tan, None, None

    @staticmethod
    def vmap(info, in_dims, y, x, alpha, beta):
        yd, xd, ad, bd = in_dims
        if yd is not None or xd is not None:
            return _vmap_over_data(CategoricalGlmFused.apply, info, in_dims, (y, x, alpha, beta))
        v = info.batch_size
        outs = CategoricalGlmFused.apply(y, x, _lanes(alpha, ad, v, 0), _lanes(beta, bd, v, 0))
        return tuple(_unfold(o, v, 0) for o in outs), (0, 0, 0)


def categorical_logit_glm_lpmf_chains(y, x, alpha, beta):
    """y (N,) int 1..K, x (N, D), alpha (C, K), beta (C, D, K) -> (C,).
    Mirrors dists.categorical_logit_glm_lpmf(..., propto=True) per chain.
    ref: pallas_glm.py:885-905."""
    x, y = _for_kernel(CATEGORICAL, x, y)
    return CategoricalGlmFused.apply(y, x, alpha.contiguous(), beta.contiguous())[0]
