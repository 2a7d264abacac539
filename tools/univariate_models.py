"""The univariate slice's user program and sweep tables, written with the
PyTorch port's public API; imports no JAX.  ``chip_smoke.py`` (phases
``censored_nb_path`` and ``univariate_sweep``) and the CPU tests import it.

- ``censored NB``: a negative-binomial regression whose large counts are
  top-coded ("U or more"), the Stan User's Guide's censored-data pattern (an
  ``_lccdf`` term for each censored observation) applied to counts.  The
  exact rows go through the chain-batched NB-2 GLM
  (``neg_binomial_2_log_glm_lpmf_chains``: the fused GLM kernel on the card),
  the top-coded rows through ``neg_binomial_2_lccdf(U - 1, mu, phi)``, which
  is ``log(1 - I_x(phi, U))`` with ``x = phi / (phi + mu)``: ``inc_beta``
  with its partials in ``a = phi`` and in ``x``.  Priors: ``alpha ~
  normal(0, 5)``, ``beta ~ student_t(3, 0, 1)``, ``phi ~ gamma(2, 0.1)``
  with ``phi`` a ``LowerBound(0)``.
- ``SWEEP``: one valid row per family of ``dists/{continuous,discrete,more}.py``
  (the rows of ``tests/dist_fixtures.py`` ``FAMS`` / ``CDFS``, copied: that
  file imports JAX), broadcast to ``(rows, cols)`` with a seeded jitter;
  ``sweep_cases`` lists every density and cdf evaluated on them, and
  ``SPECIAL`` the special functions' inputs.
- ``RNG_ROWS``: every ``_rng`` with the closed-form mean and variance of its
  draws (or of a statistic of them).

Run from the repository root (``tools`` is a directory, not a package:
``sys.path`` gets it, as ``chip_smoke.py`` and the tests do).
"""

from __future__ import annotations

import math

import numpy as np
import scipy.special as sps
import scipy.stats as st
import torch

from math_tpu_torch import dists, special
from math_tpu_torch.model import make_log_density
from math_tpu_torch.ops import glm_fused
from math_tpu_torch.transforms import Identity, LowerBound

# --- the censored negative-binomial regression ---------------------------------

ALPHA_TRUE, PHI_TRUE, BETA_SD = 1.5, 5.0, 0.1
TOP_SHARE = 0.05


def top_code(y, share=TOP_SHARE):
    """``U``: the largest integer with at least ``share`` of the rows at
    ``y >= U`` (so the top-coded share is ``share`` or a little more)."""
    y = np.asarray(y)
    values = np.unique(y)
    shares = np.array([np.mean(y >= u) for u in values])
    return int(values[shares >= share].max())


def censored_nb_data(x, seed=0, share=TOP_SHARE):
    """Counts for the design ``x (N, K)``: ``beta_true ~ normal(0, 0.1)``,
    ``alpha_true = 1.5``, ``phi_true = 5``, ``y ~ NB2(exp(alpha + x beta),
    phi)`` drawn with numpy from ``seed``, top-coded at ``U = top_code(y)``.
    Returns a dict: ``x_u, y_u`` (the exact rows, contiguous float32),
    ``x_c`` (the top-coded rows), ``U``, ``share``, ``y``, ``y_topcoded``
    (``min(y, U)``: what the naive fit takes as exact) and the truth."""
    rng = np.random.default_rng(seed)
    k = x.shape[1]
    beta = rng.normal(0.0, BETA_SD, size=k)
    mu = np.exp(ALPHA_TRUE + x.astype(np.float64) @ beta)
    y = rng.negative_binomial(PHI_TRUE, PHI_TRUE / (PHI_TRUE + mu))
    u = top_code(y, share)
    cens = y >= u
    return {
        "x_u": np.ascontiguousarray(x[~cens], dtype=np.float32), "y_u": y[~cens].astype(np.float32),
        "x_c": np.ascontiguousarray(x[cens], dtype=np.float32), "U": u, "share": float(cens.mean()), "y": y,
        "y_topcoded": np.minimum(y, u), "alpha": ALPHA_TRUE, "beta": beta, "phi": PHI_TRUE,
    }


def censored_args(data, device="cuda", dtype=torch.float32, naive=False):
    """``(x_u, y_u, x_c, U)`` as the model's data tensors, each made once
    (contiguous: no layout copy on the card).  ``naive``: every row exact,
    the top-coded ones at ``U`` (no censored term)."""
    if naive:
        x = np.concatenate([data["x_u"], data["x_c"]])
        y = np.concatenate([data["y_u"], np.full(len(data["x_c"]), data["U"], np.float32)])
        xc = np.zeros((0, x.shape[1]), np.float32)
    else:
        x, y, xc = data["x_u"], data["y_u"], data["x_c"]
    t = lambda a: torch.tensor(a, dtype=dtype, device=device).contiguous()  # noqa: E731
    return t(x), t(y), t(xc), float(data["U"])


def make_censored_nb(k):
    """The model: ``logp(z, x_u, y_u, x_c, U)``, dimension ``k + 2``, packed
    ``alpha, beta, phi`` (``phi`` unconstrained as ``log phi``)."""
    params = {"alpha": Identity(()), "beta": Identity((k,)), "phi": LowerBound((), 0.0)}

    def log_prob(v, x_u, y_u, x_c, u):
        alpha, beta, phi = v["alpha"], v["beta"], v["phi"]  # (C,), (C, k), (C,)
        lp = dists.normal_lpdf(alpha, 0.0, 5.0, batch_ndims=1)
        lp = lp + dists.student_t_lpdf(beta, 3.0, 0.0, 1.0, batch_ndims=1)
        lp = lp + dists.gamma_lpdf(phi, 2.0, 0.1, batch_ndims=1)
        lp = lp + glm_fused.neg_binomial_2_log_glm_lpmf_chains(y_u, x_u, alpha, beta.T, phi)
        mu = torch.exp(alpha[:, None] + beta @ x_c.T)  # (C, N_c)
        return lp + dists.neg_binomial_2_lccdf(u - 1.0, mu, phi[:, None], batch_ndims=1)

    return make_log_density(params, log_prob)


# --- the sweep: one row per family ---------------------------------------------

Y = np.array([0.7, 1.3, 2.9])
YP = np.array([0.1, 0.5, 0.9])
YI = np.array([0, 2, 5])
CUTS = np.array([-0.5, 0.8, 2.0])
THETA3 = np.array([0.2, 0.3, 0.5])

# name -> (args, kinds): the FAMS / CDFS row and which of _lpdf/_lpmf, _cdf,
# _lcdf, _lccdf exist for it.  Integer arrays are data (not jittered).
SWEEP = {
    "normal": ((Y, 0.5, 1.3), "lpdf cdf lcdf lccdf"),
    "std_normal": ((Y,), "lpdf"),
    "normal_sufficient": ((1.1, 4.2, np.array(10), 0.5, 1.3), "lpdf"),
    "lognormal": ((Y, 0.2, 0.8), "lpdf cdf lcdf lccdf"),
    "cauchy": ((Y, 0.5, 2.0), "lpdf cdf lcdf lccdf"),
    "student_t": ((Y, 4.0, 0.5, 2.0), "lpdf cdf lcdf lccdf"),
    "double_exponential": ((Y, 0.5, 2.0), "lpdf cdf lcdf lccdf"),
    "logistic": ((Y, 0.5, 2.0), "lpdf cdf lcdf lccdf"),
    "gumbel": ((Y, 0.5, 2.0), "lpdf cdf lcdf lccdf"),
    "exponential": ((Y, 1.7), "lpdf cdf lcdf lccdf"),
    "gamma": ((Y, 2.0, 1.5), "lpdf cdf lcdf lccdf"),
    "inv_gamma": ((Y, 2.0, 1.5), "lpdf cdf lcdf lccdf"),
    "chi_square": ((Y, 3.0), "lpdf cdf lcdf lccdf"),
    "inv_chi_square": ((Y, 3.0), "lpdf cdf lcdf lccdf"),
    "scaled_inv_chi_square": ((Y, 3.0, 1.5), "lpdf cdf lcdf lccdf"),
    "weibull": ((Y, 2.0, 1.5), "lpdf cdf lcdf lccdf"),
    "frechet": ((Y, 2.0, 1.5), "lpdf cdf lcdf lccdf"),
    "rayleigh": ((Y, 1.5), "lpdf cdf lcdf lccdf"),
    "pareto": ((Y, 0.5, 2.0), "lpdf cdf lcdf lccdf"),
    "pareto_type_2": ((Y, 0.0, 1.5, 2.0), "lpdf cdf lcdf lccdf"),
    "beta": ((YP, 2.0, 3.0), "lpdf cdf lcdf lccdf"),
    "beta_proportion": ((YP, 0.4, 5.0), "lpdf lcdf lccdf"),
    "uniform": ((Y, 0.0, 5.0), "lpdf cdf lcdf lccdf"),
    "von_mises": ((np.array([-1.0, 0.3, 2.0]), 0.5, 2.0), "lpdf"),
    "skew_normal": ((Y, 0.5, 2.0, 3.0), "lpdf cdf lcdf lccdf"),
    "exp_mod_normal": ((Y, 0.5, 1.2, 0.7), "lpdf cdf lcdf lccdf"),
    "wiener": ((np.array([0.8, 1.2, 2.5]), 1.5, 0.15, 0.5, 0.5), "lpdf"),
    "bernoulli": ((np.array([0]), 0.3), "lpmf cdf lcdf lccdf"),  # y = 1 has lccdf -inf
    "bernoulli_logit": ((np.array([0, 1, 1]), 0.4), "lpmf"),
    "binomial": ((YI, np.array(8), 0.3), "lpmf cdf lcdf lccdf"),
    "binomial_logit": ((YI, np.array(8), -0.4), "lpmf"),
    "beta_binomial": ((YI, np.array(8), 2.0, 3.0), "lpmf cdf lcdf lccdf"),
    "poisson": ((YI, 2.5), "lpmf cdf lcdf lccdf"),
    "poisson_log": ((YI, 0.9), "lpmf"),
    "neg_binomial": ((YI, 3.0, 2.0), "lpmf cdf lcdf lccdf"),
    "neg_binomial_2": ((YI, 2.5, 3.0), "lpmf cdf lcdf lccdf"),
    "neg_binomial_2_log": ((YI, math.log(2.5), 3.0), "lpmf"),
    "hypergeometric": ((np.array([1, 2, 3]), np.array(5), np.array(6), np.array(8)), "lpmf"),
}
# families whose parameter is a vector a chain (one simplex / cut vector per chain)
VECTOR_SWEEP = {
    "categorical": (np.array([1, 3, 2, 3]), THETA3),
    "categorical_logit": (np.array([1, 3, 2, 3]), np.log(THETA3)),
    "ordered_logistic": (np.array([2, 1, 4]), 0.3, CUTS),
    "ordered_probit": (np.array([2, 1, 4]), 0.3, CUTS),
    "dirichlet": None,  # dirichlet_lpmf: a simplex a chain under alpha
}
MATRIX_SWEEP = ("gaussian_dlm_obs", "multi_gp", "multi_gp_cholesky", "matrix_normal_prec", "lkj_cov")
JITTER = 0.03


def _jitter(rng, rows, cols):
    return 1.0 + JITTER * (2.0 * rng.uniform(size=(rows, cols)) - 1.0)


def _spread(arg, rng, rows, cols):
    """One argument of a row as a ``(rows, cols)`` array: its values cycled
    over the columns, times a seeded jitter for a float."""
    a = np.resize(np.asarray(arg), cols)[None, :].repeat(rows, 0)
    if np.asarray(arg).dtype.kind == "f":
        return a * _jitter(rng, rows, cols)
    return a


def _chain_vector(v, rng, rows, kind):
    v = np.asarray(v, dtype=np.float64)
    if kind == "simplex":
        w = v[None, :] * _jitter(rng, rows, v.size)
        return w / w.sum(-1, keepdims=True)
    if kind == "ordered":
        return v[None, :] + JITTER * (2.0 * rng.uniform(size=(rows, 1)) - 1.0)
    return v[None, :] * _jitter(rng, rows, v.size)


def _matrix_case(name, rows, rng):
    """``(args, float argnums)`` of a matrix density with a chain axis of
    ``rows`` (batch_ndims=1) on its jittered argument."""
    r = np.random.default_rng(11)
    if name == "gaussian_dlm_obs":
        n, rr, t = 3, 2, 8
        F = r.normal(size=(n, rr))
        G = 0.8 * np.eye(n) + 0.05 * r.normal(size=(n, n))
        y = r.normal(size=(rr, t))[None] * _jitter(rng, rows, rr * t).reshape(rows, rr, t)
        return (y, F, G, np.eye(rr) * 0.4, np.eye(n) * 0.3, np.zeros(n), np.eye(n)), (0,)
    a = r.normal(size=(5, 5))
    sigma = a @ a.T + 5.0 * np.eye(5)
    y = r.normal(size=(3, 5))[None] * _jitter(rng, rows, 15).reshape(rows, 3, 5)
    w = np.array([0.5, 1.0, 2.0])[None] * _jitter(rng, rows, 3)
    if name == "multi_gp":
        return (y, sigma, w), (0, 2)
    if name == "multi_gp_cholesky":
        return (y, np.linalg.cholesky(sigma), w), (0, 2)
    if name == "matrix_normal_prec":
        b = r.normal(size=(2, 2))
        return (y[:, :, :2], r.normal(size=(3, 2)), sigma[:3, :3], b @ b.T + 2.0 * np.eye(2)), (0,)
    sds = np.array([1.2, 0.8, 2.0])[None] * _jitter(rng, rows, 3)
    corr = np.array([[1.0, 0.3, 0.1], [0.3, 1.0, -0.2], [0.1, -0.2, 1.0]])
    cov = sds[:, :, None] * corr[None] * sds[:, None, :]
    return (cov, np.array([0.5, -1.0, 2.0]), np.array([0.5, 0.7, 0.9]), 1.7 * _jitter(rng, rows, 1)[:, 0]), (0, 3)


def sweep_cases(rows=1024, cols=64, seed=0):
    """``[(label, function name, args (numpy), float argnums)]``: every
    density and cdf of the sweep with ``batch_ndims=1`` (one value a row)."""
    rng = np.random.default_rng(seed)
    cases = []
    for fam, (row, kinds) in SWEEP.items():
        args = [_spread(a, rng, rows, cols) for a in row]
        floats = tuple(i for i, a in enumerate(row) if np.asarray(a).dtype.kind == "f")
        for kind in kinds.split():
            cases.append((f"{fam}_{kind}", f"{fam}_{kind}", args, floats))
    for fam, row in VECTOR_SWEEP.items():
        if fam == "dirichlet":
            theta = _chain_vector(THETA3, rng, rows, "simplex")
            alpha = _chain_vector(np.array([1.5, 2.0, 3.0]), rng, rows, "scale")
            cases.append(("dirichlet_lpmf", "dirichlet_lpmf", [theta, alpha], (1,)))
            continue
        y = np.resize(row[0], cols)
        if fam.startswith("categorical"):
            beta = _chain_vector(row[1], rng, rows, "simplex" if fam == "categorical" else "scale")
            cases.append((f"{fam}_lpmf", f"{fam}_lpmf", [y, beta], (1,)))
        else:
            eta = row[1] * _jitter(rng, rows, cols)
            cases.append((f"{fam}_lpmf", f"{fam}_lpmf", [y, eta, _chain_vector(row[2], rng, rows, "ordered")], (1, 2)))
    for fam in MATRIX_SWEEP:
        args, floats = _matrix_case(fam, rows, rng)
        cases.append((f"{fam}_lpdf", f"{fam}_lpdf", list(args), floats))
    return cases


def special_inputs(rows=1024, cols=64, seed=1):
    """``{name: args (numpy float64 arrays of (rows, cols))}`` of the special
    functions' sweep, over the ranges the densities reach."""
    rng = np.random.default_rng(seed)
    u = lambda: rng.uniform(size=(rows, cols))  # noqa: E731
    n = rng.integers(0, 6, size=(rows, cols)).astype(np.float64)
    z = 0.1 + 30.0 * u()
    return {
        "inc_beta": (0.5 + 20.0 * u(), 0.5 + 20.0 * u(), u()),
        "gamma_p": (0.5 + 30.0 * u(), 40.0 * u()),
        "gamma_q": (0.5 + 30.0 * u(), 40.0 * u()),
        "owens_t": (3.0 * rng.normal(size=(rows, cols)), 2.0 * rng.normal(size=(rows, cols))),
        "bessel_first_kind": (n, z),
        "bessel_second_kind": (n, z),
        "modified_bessel_first_kind": (n, 0.1 + 20.0 * u()),
        "modified_bessel_second_kind": (n, z),
    }


# scipy's float64 values of the functions the port computes itself
SCIPY_SPECIAL = {"inc_beta": lambda a, b, x: sps.betainc(a, b, x), "gamma_p": sps.gammainc, "gamma_q": sps.gammaincc}
# float argnums differentiated in the special sweep (the Bessel order is an integer)
SPECIAL_FLOATS = {"inc_beta": (0, 1, 2), "gamma_p": (0, 1), "gamma_q": (0, 1), "owens_t": (0, 1),
                  "bessel_first_kind": (1,), "bessel_second_kind": (1,), "modified_bessel_first_kind": (1,),
                  "modified_bessel_second_kind": (1,)}


def evaluate(fn_name, args, floats, device, dtype):
    """``(value (rows,) float64 on the CPU, [gradient of value.sum() in each
    float argument])`` of ``dists.<fn_name>`` (or ``special.<fn_name>``) with
    ``batch_ndims=1`` (the special functions elementwise, summed by row)."""
    tensors = []
    for i, a in enumerate(args):
        a = np.asarray(a)
        kind = dtype if a.dtype.kind == "f" else torch.int64
        t = torch.tensor(a, dtype=kind, device=device)
        tensors.append(t.requires_grad_(i in floats))
    if hasattr(dists, fn_name):
        value = getattr(dists, fn_name)(*tensors, batch_ndims=1)
    else:
        value = getattr(special, fn_name)(*tensors).sum(-1)
    if not floats:
        return value.detach().double().cpu(), []
    grads = torch.autograd.grad(value.sum(), [tensors[i] for i in floats], allow_unused=True)
    grads = [torch.zeros_like(tensors[i]) if g is None else g for i, g in zip(floats, grads)]
    return value.detach().double().cpu(), [g.double().cpu() for g in grads]


# --- every _rng with its closed-form moments -----------------------------------


def _ordered_moments(eta, cuts, cdf):
    edges = np.concatenate([[-np.inf], cuts, [np.inf]])
    p = cdf(edges[1:] - eta) - cdf(edges[:-1] - eta)
    k = np.arange(1, len(p) + 1)
    m = np.sum(k * p)
    return m, np.sum(k * k * p) - m * m


def _categorical_moments(theta):
    k = np.arange(1, len(theta) + 1)
    m = np.sum(k * theta)
    return m, np.sum(k * k * theta) - m * m


def _mv(dist):
    m, v = dist.stats("mv")
    return float(m), float(v)


_VM_KAPPA, _VM_MU = 2.0, 0.5
_VM_A1 = sps.i1(_VM_KAPPA) / sps.i0(_VM_KAPPA)
_VM_A2 = sps.iv(2, _VM_KAPPA) / sps.i0(_VM_KAPPA)
_GLM_X = np.random.default_rng(5).normal(size=(64, 3))
_GLM_BETA = np.array([0.5, -1.0, 0.2])
_GLM_P = sps.expit(_GLM_X @ _GLM_BETA + 0.3)

# name -> (args, statistic of the draws or None, mean, variance).  Heavy tails
# get shapes with a finite fourth moment (student_t 9, pareto 5, ...), so the
# variance's Monte-Carlo error is finite; cauchy is checked by its median.
RNG_ROWS = {
    "normal": ((0.5, 1.3), None, *_mv(st.norm(0.5, 1.3))),
    "std_normal": ((), None, 0.0, 1.0),
    "lognormal": ((0.2, 0.5), None, *_mv(st.lognorm(0.5, scale=math.exp(0.2)))),
    "cauchy": ((0.5, 2.0), "median", 0.5, None),
    "student_t": ((9.0, 1.0, 2.0), None, *_mv(st.t(9.0, 1.0, 2.0))),
    "double_exponential": ((0.5, 1.0), None, *_mv(st.laplace(0.5, 1.0))),
    "logistic": ((0.0, 1.0), None, *_mv(st.logistic(0.0, 1.0))),
    "gumbel": ((0.0, 1.0), None, *_mv(st.gumbel_r(0.0, 1.0))),
    "exponential": ((2.0,), None, 0.5, 0.25),
    "gamma": ((2.0, 1.5), None, *_mv(st.gamma(2.0, scale=1 / 1.5))),
    "inv_gamma": ((5.0, 1.5), None, *_mv(st.invgamma(5.0, scale=1.5))),
    "chi_square": ((3.0,), None, 3.0, 6.0),
    "inv_chi_square": ((10.0,), None, *_mv(st.invgamma(5.0, scale=0.5))),
    "scaled_inv_chi_square": ((10.0, 1.5), None, *_mv(st.invgamma(5.0, scale=10.0 * 1.5**2 / 2))),
    "weibull": ((2.0, 1.5), None, *_mv(st.weibull_min(2.0, scale=1.5))),
    "frechet": ((5.0, 1.0), None, *_mv(st.invweibull(5.0, scale=1.0))),
    "rayleigh": ((1.5,), None, *_mv(st.rayleigh(scale=1.5))),
    "pareto": ((0.5, 5.0), None, *_mv(st.pareto(5.0, scale=0.5))),
    "pareto_type_2": ((0.0, 1.5, 5.0), None, *_mv(st.lomax(5.0, scale=1.5))),
    "beta": ((2.0, 3.0), None, *_mv(st.beta(2.0, 3.0))),
    "beta_proportion": ((0.4, 5.0), None, *_mv(st.beta(2.0, 3.0))),
    "uniform": ((1.0, 3.0), None, 2.0, 4.0 / 12.0),
    "von_mises": ((_VM_MU, _VM_KAPPA), "cos", _VM_A1, 0.5 * (1.0 + _VM_A2) - _VM_A1**2),
    "skew_normal": ((0.0, 1.0, 4.0), None, *_mv(st.skewnorm(4.0))),
    "exp_mod_normal": ((0.5, 1.2, 0.7), None, *_mv(st.exponnorm(1 / (0.7 * 1.2), 0.5, 1.2))),
    "bernoulli": ((0.3,), None, 0.3, 0.21),
    "bernoulli_logit": ((0.4,), None, *_mv(st.bernoulli(sps.expit(0.4)))),
    "binomial": ((8, 0.3), None, *_mv(st.binom(8, 0.3))),
    "binomial_logit": ((8, -0.4), None, *_mv(st.binom(8, sps.expit(-0.4)))),
    "beta_binomial": ((8, 2.0, 3.0), None, *_mv(st.betabinom(8, 2.0, 3.0))),
    "poisson": ((2.5,), None, 2.5, 2.5),
    "poisson_log": ((0.9,), None, math.exp(0.9), math.exp(0.9)),
    "neg_binomial": ((3.0, 2.0), None, *_mv(st.nbinom(3.0, 2.0 / 3.0))),
    "neg_binomial_2": ((2.5, 3.0), None, *_mv(st.nbinom(3.0, 3.0 / 5.5))),
    "neg_binomial_2_log": ((0.9, 3.0), None, *_mv(st.nbinom(3.0, 3.0 / (3.0 + math.exp(0.9))))),
    "hypergeometric": ((5, 6, 8), None, *_mv(st.hypergeom(14, 6, 5))),
    "categorical": ((THETA3,), None, *_categorical_moments(THETA3)),
    "categorical_logit": ((np.log(THETA3),), None, *_categorical_moments(THETA3)),
    "ordered_logistic": ((0.3, CUTS), None, *_ordered_moments(0.3, CUTS, sps.expit)),
    "ordered_probit": ((0.3, CUTS), None, *_ordered_moments(0.3, CUTS, sps.ndtr)),
    "bernoulli_logit_glm": ((_GLM_X, 0.3, _GLM_BETA), "rows", _GLM_P, _GLM_P * (1 - _GLM_P)),
}


def rng_draws(name, generator, n, dtype=torch.float64):
    """``n`` draws of ``<name>_rng`` from ``generator`` on its device, as a
    float64 tensor ``(n, ...)``, parameters in ``dtype``."""
    args, stat, _, _ = RNG_ROWS[name]
    device = generator.device
    targs = [torch.tensor(np.asarray(a), dtype=dtype, device=device) for a in args]
    fn = getattr(dists, name + "_rng")
    if name == "std_normal":
        out = fn(generator, (n,))
    elif name.startswith(("categorical", "ordered")):
        out = fn(generator, *targs, shape=(n,))
    elif name == "bernoulli_logit_glm":
        out = fn(generator, *targs, shape=(n, _GLM_X.shape[0]))
    else:
        out = fn(generator, *targs, shape=(n,))
    return out.double()


def rng_z_scores(name, draws):
    """``{"mean": z, "var": z}``: the draws' (statistic's) mean and variance
    against the closed forms, in Monte-Carlo standard errors (estimated from
    the draws: sd / sqrt(n), and sqrt((m4 - s^4) / n) for the variance); the
    median for cauchy (its error 1 / (2 f(m) sqrt(n)))."""
    _, stat, mean, var = RNG_ROWS[name]
    x = draws
    n = x.shape[0]
    if stat == "median":
        scale = RNG_ROWS[name][0][1]
        se = math.pi * scale / (2.0 * math.sqrt(n))
        return {"median": float((x.median() - mean) / se)}
    if stat == "cos":
        x = torch.cos(x - _VM_MU)
    mean_t = torch.as_tensor(mean, dtype=x.dtype, device=x.device)
    m = x.mean(0)
    c = x - m
    s2 = (c * c).mean(0)
    out = {"mean": float(((m - mean_t) / torch.sqrt(s2 / n)).abs().max())}
    if var is not None:
        var_t = torch.as_tensor(var, dtype=x.dtype, device=x.device)
        m4 = (c**4).mean(0)
        out["var"] = float(((s2 - var_t) / torch.sqrt((m4 - s2 * s2) / n)).abs().max())
    return out
