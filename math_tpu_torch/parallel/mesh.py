"""Sharding inference over devices, one process per device.

Counterpart: ``math_tpu/parallel/mesh.py``.  JAX's ``shard_map`` is one
controller over many devices; PyTorch's counterpart is SPMD with one process
per device, joined in a ``torch.distributed`` process group (NCCL on GPUs,
gloo on the CPU).  The reference's mesh axis names are the dimension names
of a 1-D ``DeviceMesh`` over the world, and its collectives are those of
``utils/_collectives.py``:

- thread-pool / ``vmap`` over chains  ->  a ``(chains, dim)`` batch a rank;
- ``shard_map`` over a named axis  ->  every rank runs the same function on
  its own block of chains (or of observations); ``psum`` / ``pmean`` /
  ``pmax`` are all-reduces over the axis's group;
- placing sharded data once (``jax.device_put``)  ->  each rank keeps its
  contiguous slice of the observation axis on its device.

NCCL takes one rank a GPU (it refuses two ranks on one card), so a machine
with one GPU runs a group of one there; several ranks on one host run on the
CPU over gloo.
"""

from __future__ import annotations

import datetime
import os
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from math_tpu_torch.config import get_config
from math_tpu_torch.infer.pooled import PooledResult, gather_pooled, run_pooled_chains
from math_tpu_torch.utils import _collectives as coll

def _backend(device_type):
    return "nccl" if device_type == "cuda" else "gloo"


def chain_mesh(n_devices: Optional[int] = None, axis: str = "chain", *, device=None):
    """1-D ``DeviceMesh`` over every rank of the world, its one dimension
    named ``axis``, for chain (or observation) data parallelism.

    ``device``: ``"cuda"`` (NCCL; the default, ``get_config().device``) or
    ``"cpu"`` (gloo).  Where no process group exists yet it forms a group of
    one (an in-process ``HashStore``, world size 1), so that ``chain_mesh()``
    works in a plain process as the reference's does.  ``n_devices`` must be
    the world size where it is given: a rank belongs to one device.
    """
    from torch.distributed.device_mesh import init_device_mesh  # 1.6 s to import: only where a mesh is made

    device_type = torch.device(get_config().device if device is None else device).type
    if not dist.is_initialized():
        dist.init_process_group(_backend(device_type), store=dist.HashStore(), world_size=1, rank=0)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"chain_mesh: n_devices={n_devices} but the process group has {world} ranks (one a device)")
    mesh = init_device_mesh(device_type, (world,), mesh_dim_names=(axis,))
    coll.bind_mesh(mesh)
    return mesh


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
    timeout: Optional[datetime.timedelta] = None,
):
    """Join this process to a group of ``num_processes`` over TCP (the
    boost.mpi ``mpi_cluster`` successor); returns the world's devices, rank
    by rank.

    ``coordinator_address`` is ``"host:port"`` of rank 0's store.  Omitted
    arguments are read from the launcher's environment (``MASTER_ADDR`` /
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as ``torchrun`` sets them; the
    reference detects a TPU slice instead).  ``device``: ``"cuda"`` (NCCL, and
    ``torch.cuda.set_device`` to the process's local rank: ``LOCAL_RANK`` or
    ``process_id`` modulo the host's GPUs) or ``"cpu"`` (gloo); the default is
    ``get_config().device``.  ``timeout`` (PyTorch's default where None) bounds
    every collective of the group, so that a rank that never arrives fails the
    others instead of hanging them.
    """
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    num_processes = int(env["WORLD_SIZE"]) if num_processes is None and "WORLD_SIZE" in env else num_processes
    process_id = int(env["RANK"]) if process_id is None and "RANK" in env else process_id
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize_multihost: give coordinator_address, num_processes and process_id "
                         "(or set MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK)")
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(f"initialize_multihost: process_id={process_id} is not a rank of {num_processes} processes")
    if dist.is_initialized():
        raise RuntimeError("initialize_multihost: this process already belongs to a process group")
    device_type = torch.device(get_config().device if device is None else device).type
    if device_type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", process_id % torch.cuda.device_count())))
        local = str(torch.device("cuda", torch.cuda.current_device()))
    else:
        local = device_type
    dist.init_process_group(_backend(device_type), init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, timeout=timeout)
    devices = [None] * num_processes
    dist.all_gather_object(devices, local)
    return [torch.device(d) for d in devices]


def sharded_inits(key, num_chains: int, dim: int, *, rank: int, init_radius: float = 2.0,
                  dtype=torch.float32, device=None):
    """``(z0 (num_chains, dim), generator)``: the global initial positions,
    uniform in ``(-init_radius, init_radius)`` and the same on every rank,
    and this rank's chain-noise generator (``_collectives.rank_generator``),
    both drawn from ``key``: a ``torch.Generator`` (consumed) or an int seed
    of a generator on ``device``."""
    device = torch.device(get_config().device if device is None else device)
    gen = key if isinstance(key, torch.Generator) else torch.Generator(device=device).manual_seed(int(key))
    u = torch.rand((num_chains, dim), generator=gen, device=gen.device, dtype=dtype)
    z0 = (-init_radius + 2.0 * init_radius * u).to(device)
    return z0, coll.rank_generator(gen, rank, device)


def sample_nuts_sharded(
    logdensity_fn: Callable,
    key,
    dim: int,
    *,
    args=(),
    num_chains: int,
    num_warmup: int = 1000,
    num_samples: int = 1000,
    max_depth: int = 10,
    target_accept: float = 0.8,
    init_radius: float = 2.0,
    mesh=None,
    dtype=torch.float32,
) -> PooledResult:
    """NUTS with chains sharded over the mesh and pooled cross-chain warmup.

    Every rank calls this with the same arguments.  ``key`` (a
    ``torch.Generator`` or an int seed) gives every rank the same global
    ``z0``, and each rank's chain noise comes from a generator derived from
    ``key`` and its rank (``sharded_inits``).  Each rank keeps its contiguous
    block of ``num_chains / R`` chains and runs ``run_pooled_chains`` with
    ``axis_name`` the mesh's axis: dual-averaging acceptance statistics and
    Welford metric moments are all-reduced, so all chains share one step size
    and one metric, whatever the number of ranks.  Returns the **global**
    result on every rank: draws and statistics all-gathered (chains in rank
    order), ``step_size`` and ``inv_mass`` replicated; ``n_grad_calls`` is
    this rank's (the ranks' trees differ).  ``args`` are replicated.
    """
    mesh = mesh if mesh is not None else chain_mesh()
    coll.bind_mesh(mesh)
    (axis,) = mesh.mesh_dim_names
    size, rank = mesh.size(), mesh.get_local_rank(axis)
    if num_chains % size:
        raise ValueError(f"num_chains={num_chains} not divisible by mesh size {size}")
    device = coll.mesh_device(mesh)
    z0, gen = sharded_inits(key, num_chains, dim, rank=rank, init_radius=init_radius, dtype=dtype, device=device)
    local = run_pooled_chains(
        gen, z0.chunk(size)[rank], logdensity_fn, args=args, num_warmup=num_warmup, num_samples=num_samples,
        max_depth=max_depth, target_accept=target_accept, axis_name=axis, device=device,
    )
    return gather_pooled(local, axis)


def _shard_bounds(n, size, rank):
    """``[lo, hi)`` of rank's contiguous slice of ``n`` rows (the first
    ``n % size`` ranks take one row more)."""
    base, extra = divmod(n, size)
    lo = rank * base + min(rank, extra)
    return lo, lo + base + (rank < extra)


class _Replicated(torch.autograd.Function):
    """A replicated value entering rank-local work: identity forward, the sum
    of the ranks' cotangents backward (Megatron's f)."""

    @staticmethod
    def forward(x, axis_name):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis_name = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _SumOverRanks.apply(g, ctx.axis_name), None


class _SumOverRanks(torch.autograd.Function):
    """The sum of the ranks' local values, replicated: all-reduce forward,
    the replicated cotangent passed to the local value backward (Megatron's
    g, the transpose of ``_Replicated``)."""

    @staticmethod
    def forward(x, axis_name):
        return coll.psum(x, axis_name)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis_name = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _Replicated.apply(g, ctx.axis_name), None


def sharded_data_logdensity(
    logdensity_term_fn: Callable,
    data,
    mesh,
    axis: str = "obs",
):
    """Observation-sharded log density: the ``map_rect`` successor.

    ``logdensity_term_fn(theta, data_shard)`` evaluates the likelihood
    contribution of a shard of observations: a scalar for ``theta (dim,)``,
    ``(C,)`` for a chain batch ``theta (C, dim)``.  ``data`` is a pytree of
    arrays or tensors with the observation axis first; each rank keeps its
    contiguous slice (ragged where ``R`` does not divide ``n``), placed once on
    its device here.  Returns ``(lp, data_local)``: ``lp(theta)`` is the sum
    of the ranks' contributions, the same on every rank, with ``theta``
    replicated, and its gradient is the sum of the ranks' local gradients
    (one all-reduce forward, one backward).

    Every rank calls ``lp`` the same number of times.  Sampling on it keeps
    every rank in lockstep when every rank draws the same noise (one
    generator from one seed on every rank): the all-reduced value and
    gradient carry the same bits on every rank, so every rank builds the same
    trees.
    """
    coll.bind_mesh(mesh)
    size, rank = mesh.size(), mesh.get_local_rank(axis)
    device = coll.mesh_device(mesh)

    def place(a):
        t = torch.as_tensor(a)
        lo, hi = _shard_bounds(t.shape[0], size, rank)
        return t[lo:hi].to(device).contiguous()

    data_local = tree_map(place, data)

    def lp(theta):
        return _SumOverRanks.apply(logdensity_term_fn(_Replicated.apply(theta, axis), data_local), axis)

    return lp, data_local
