"""CmdStan-format CSV output (ecosystem interop).

Counterpart: ``math_tpu/io/stan_csv.py``: the same files byte for byte for
the same arrays (the same header, the same ``%.9g`` rows), from numpy arrays
or tensors on any device (taken to the host once, as float64).

Writes posterior draws in the CmdStan output CSV dialect — ``#`` comment
header, ``lp__``/sampler ``*__`` columns, dot-flattened parameter names
(``theta.1``, ``Sigma.2.3``), one file per chain — so the Stan
ecosystem's downstream tooling (``stansummary``, ``arviz.from_cmdstan``,
the ``posterior`` R package) reads math_tpu output unchanged.  The
reference C++ library itself has no output layer; this fills CmdStan's
``writer`` role the way ``infer``/``diagnostics`` fill the services'.

Host-side, analysis-time IO — the hot path for crash-safe draw streaming
is the native append-only ``draw_store``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["write_stan_csv", "read_stan_csv"]

_SAMPLER_COLS = (
    ("lp__", "lp"),
    ("accept_stat__", "accept_prob"),
    ("stepsize__", "step_size"),
    ("treedepth__", "tree_depth"),
    ("n_leapfrog__", "n_leapfrog"),
    ("divergent__", "diverging"),
    ("energy__", "energy"),
)


def _flat_names(name: str, shape) -> List[str]:
    """CmdStan dot-flattening, COLUMN-major (Fortran) index order like
    Stan's container output: ``m`` (2,3) -> m.1.1, m.2.1, m.1.2, ..."""
    if not shape:
        return [name]
    idx = np.stack(
        np.meshgrid(*[np.arange(1, s + 1) for s in shape], indexing="ij"),
        axis=-1,
    ).reshape(-1, len(shape))
    # Stan emits containers column-major (FIRST index fastest); lexsort's
    # primary key is the last one passed, so feeding the index columns in
    # order makes the LAST index slowest and the first fastest
    order = np.lexsort(idx.T)
    return [name + "." + ".".join(str(i) for i in idx[o]) for o in order]


def _flat_values(v: np.ndarray) -> np.ndarray:
    """(draws, *shape) -> (draws, prod(shape)) matching ``_flat_names``
    (first index fastest == Fortran order)."""
    return v.reshape(v.shape[0], -1, order="F") if v.ndim > 1 else v[:, None]


def _host(v):
    """A numpy array of ``v`` (a tensor is detached and copied to the host)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def write_stan_csv(
    basepath: str,
    constrained: Dict[str, np.ndarray],
    *,
    sampler_stats: Optional[Dict[str, np.ndarray]] = None,
    step_size=None,
    inv_mass=None,
    model_name: str = "math_tpu_model",
    seed: int = 0,
) -> List[str]:
    """Write draws as ``{basepath}_{chain+1}.csv`` in CmdStan format.

    ``constrained``: dict of (chains, draws, *shape) arrays or tensors — the
    output of ``LogDensity.transform_draws``.  ``sampler_stats``: optional dict
    with any of lp, accept_prob, tree_depth, n_leapfrog, diverging,
    energy as (chains, draws) arrays (e.g. from ``PooledResult`` /
    ``ChainResult.stats``); missing columns are written as 0 the way
    CmdStan's fixed-param writer does.  ``step_size``: scalar or
    (chains,); ``inv_mass``: (dim,) or (chains, dim) — emitted in the
    adaptation comment block ``stansummary`` expects.  Returns the paths.
    """
    items = [(k, _host(v)) for k, v in constrained.items()]
    if not items:
        raise ValueError("constrained is empty")
    n_chains, n_draws = items[0][1].shape[:2]
    for k, v in items:
        if v.shape[:2] != (n_chains, n_draws):
            raise ValueError(
                f"parameter {k!r} has leading shape {v.shape[:2]}, expected "
                f"{(n_chains, n_draws)}"
            )
    stats = {k: _host(v) for k, v in (sampler_stats or {}).items()}

    names: List[str] = [c for c, _ in _SAMPLER_COLS]
    for k, v in items:
        names.extend(_flat_names(k, v.shape[2:]))

    paths = []
    for c in range(n_chains):
        cols = []
        for _, key in _SAMPLER_COLS:
            if key == "step_size" and step_size is not None:
                eps = _host(step_size)
                val = float(eps if eps.ndim == 0 else eps.reshape(-1)[c])
                cols.append(np.full(n_draws, val))
            elif key in stats:
                cols.append(np.asarray(stats[key][c], dtype=np.float64))
            else:
                cols.append(np.zeros(n_draws))
        for k, v in items:
            cols.append(_flat_values(v[c]).astype(np.float64))
        mat = np.column_stack(cols)

        path = f"{basepath}_{c + 1}.csv"
        with open(path, "w") as f:
            f.write(f"# stan_version_major = 2\n")
            f.write(f"# model = {model_name}\n")
            f.write(f"# method = sample (math_tpu NUTS)\n")
            f.write(f"# id = {c + 1}\n")
            f.write(f"# seed = {seed}\n")
            f.write(",".join(names) + "\n")
            if step_size is not None or inv_mass is not None:
                f.write("# Adaptation terminated\n")
                if step_size is not None:
                    eps = _host(step_size)
                    val = float(eps if eps.ndim == 0 else eps.reshape(-1)[c])
                    f.write(f"# Step size = {val:.6g}\n")
                if inv_mass is not None:
                    im = _host(inv_mass)
                    im_c = im if im.ndim == 1 else im[c]
                    f.write("# Diagonal elements of inverse mass matrix:\n")
                    f.write("# " + ", ".join(f"{x:.6g}" for x in im_c) + "\n")
            np.savetxt(f, mat, delimiter=",", fmt="%.9g")
        paths.append(path)
    return paths


def read_stan_csv(path: str):
    """(column names, (draws, cols) array) from a CmdStan-format CSV —
    the minimal reader CmdStan's own tools implement (comment lines
    skipped anywhere in the file)."""
    names: Optional[Sequence[str]] = None
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if names is None:
                names = line.split(",")
            else:
                rows.append([float(x) for x in line.split(",")])
    if names is None:
        raise ValueError(f"{path} has no header row")
    return list(names), np.asarray(rows)
