"""Collectives over a named mesh axis, on ``torch.distributed``.

Counterpart: the ``jax.lax`` collectives that ``math_tpu/infer/pooled.py``,
``math_tpu/infer/smc.py`` and ``math_tpu/parallel/mesh.py`` call inside
``shard_map``.  JAX runs one program over many devices; the port runs one
process per device (SPMD), every rank calling the same function on its own
shard.  A mesh axis name resolves to the process group of that dimension of
a ``DeviceMesh`` (``bind_mesh``; ``parallel.chain_mesh`` binds the mesh it
makes), and

- ``psum`` / ``pmean`` / ``pmax`` are ``dist.all_reduce`` (SUM or MAX) over
  that group, ``pmean`` the sum over the group's size;
- ``all_gather`` (``tiled=True``) is ``dist.all_gather_into_tensor``;
- ``rotate`` (a ``ppermute`` by an offset) is one ``dist.batch_isend_irecv``.

This module sits below ``infer/`` (``utils``), so that the samplers take an
``axis_name`` without importing ``parallel/``.  Callers keep ``axis_name=None``
for the one-device code, which then calls nothing here.  ``COUNTS`` counts
each kind of collective as ``LAUNCHES`` counts kernel launches, and
``SECONDS`` sums the host's time inside them (an NCCL call returns once it is
enqueued; a host read of its result waits for it).

Every rank must enter every collective the same number of times and in the
same order, or the group hangs (until the timeout given to
``init_process_group``).  All-reduce gives every rank the same result bits
(NCCL and gloo alike), so a decision read from a reduced value is the same on
every rank.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

COUNTS = {"all_reduce": 0, "all_gather": 0, "rotate": 0}
SECONDS = {"all_reduce": 0.0, "all_gather": 0.0, "rotate": 0.0}
_AXES: dict = {}  # mesh axis name -> process group


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0
        SECONDS[k] = 0.0


def _counted(kind, t0):
    COUNTS[kind] += 1
    SECONDS[kind] += time.perf_counter() - t0


def bind_mesh(mesh):
    """Make every dimension name of the ``DeviceMesh`` ``mesh`` an axis name
    for the functions below (a later mesh with the same name replaces it)."""
    for name in mesh.mesh_dim_names or ():
        _AXES[name] = mesh.get_group(name)


def mesh_device(mesh):
    """This rank's device of the ``DeviceMesh`` ``mesh``: the current CUDA
    device or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_group(axis_name):
    if not dist.is_initialized() or axis_name not in _AXES:
        raise ValueError(f"no mesh axis named {axis_name!r}: make one with parallel.chain_mesh(axis={axis_name!r})")
    return _AXES[axis_name]


def axis_size(axis_name):
    return dist.get_world_size(axis_group(axis_name))


def axis_index(axis_name):
    """This rank's index along the axis (``jax.lax.axis_index``)."""
    return dist.get_rank(axis_group(axis_name))


def _all_reduce(x, op, axis_name):
    t0 = time.perf_counter()
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=axis_group(axis_name))
    _counted("all_reduce", t0)
    return out


def psum(x, axis_name):
    """The sum of ``x`` over the axis's ranks, on every rank."""
    return _all_reduce(x, dist.ReduceOp.SUM, axis_name)


def pmean(x, axis_name):
    return psum(x, axis_name) / axis_size(axis_name)


def pmax(x, axis_name):
    return _all_reduce(x, dist.ReduceOp.MAX, axis_name)


def _int_all_reduce(n, op, axis_name, device):
    """``n`` reduced over the axis, as an int (one all-reduce of a
    one-element tensor on ``device`` and the host read that waits for it)."""
    out = _all_reduce(torch.tensor([n], dtype=torch.int64, device=device), op, axis_name)
    t0 = time.perf_counter()
    value = int(out[0])
    SECONDS["all_reduce"] += time.perf_counter() - t0
    return value


def psum_int(n, axis_name, device):
    return _int_all_reduce(n, dist.ReduceOp.SUM, axis_name, device)


def pmax_int(n, axis_name, device):
    return _int_all_reduce(n, dist.ReduceOp.MAX, axis_name, device)


def all_gather(x, axis_name):
    """The ranks' ``x`` concatenated along the first axis in rank order
    (``all_gather(tiled=True)``); every rank's ``x`` has the same shape.  A
    bool tensor travels as uint8."""
    group = axis_group(axis_name)
    src = (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()
    out = src.new_empty((dist.get_world_size(group) * src.shape[0],) + tuple(src.shape[1:]))
    t0 = time.perf_counter()
    dist.all_gather_into_tensor(out, src, group=group)
    _counted("all_gather", t0)
    return out.bool() if x.dtype == torch.bool else out


def rotate(x, d, axis_name):
    """The block of rank ``(r + d) % R`` on rank ``r`` (a ``ppermute`` by
    ``d``): this rank sends ``x`` to ``(r - d) % R`` and receives from
    ``(r + d) % R``, one ``batch_isend_irecv``."""
    group = axis_group(axis_name)
    ranks = dist.get_process_group_ranks(group)
    size, r = len(ranks), dist.get_rank(group)
    src = x.contiguous()
    out = torch.empty_like(src)
    t0 = time.perf_counter()
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, src, ranks[(r - d) % size], group),
        dist.P2POp(dist.irecv, out, ranks[(r + d) % size], group),
    ])
    for req in reqs:
        req.wait()
    _counted("rotate", t0)
    return out


def rank_generator(shared, rank, device):
    """A ``torch.Generator`` of ``device`` for one rank's stream, derived from
    the shared generator ``shared`` (the analog of the reference's split keys
    and ``fold_in``, math_tpu/infer/smc.py:246-256): one 63-bit integer drawn
    from ``shared`` (every rank draws the same, so the shared streams stay
    equal), combined with ``rank`` by ``numpy.random.SeedSequence``, whose
    first 64-bit word, shifted to 63 bits, seeds the rank's generator."""
    draw = int(torch.randint(0, 2**63 - 1, (1,), generator=shared, device=shared.device)[0])
    word = np.random.SeedSequence([draw, int(rank)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(word >> np.uint64(1)))
