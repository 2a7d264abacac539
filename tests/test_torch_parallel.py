"""PyTorch port: ``parallel/`` and the ``axis_name`` / ``mesh`` branches of
``infer/pooled.py`` against ``math_tpu`` (CPU, gloo).

The port runs one process a device, joined by ``torch.distributed``; here
the ranks are CPU processes over gloo, started once for the module: four
ranks (``start_ranks``, one ``subprocess`` a rank, each pinned to one
OpenMP thread: four fresh imports of torch that each spin a pool of threads
took 33 s together on an 8-core host, 1.5 s with one), which run every
four-rank scenario, then split into two groups of two that run the
two-rank scenarios side by side.  Each rank writes its results as numpy arrays; every
group has a timeout at ``init_process_group`` (``GROUP_TIMEOUT``) and the
ranks a join timeout (``JOIN_TIMEOUT_S``), so that a hang fails instead of
holding the run.  The JAX side runs on the conftest's eight virtual devices
(the reference's ``chain_mesh(R)``) under ``jax.jit``, in float64.

- ``_welford_merge_batch`` over four ranks equals the reference's under
  ``shard_map`` and one merge of the whole batch, 1e-12 relative;
- ``sharded_data_logdensity`` on the reference test's GLM (n = 64, k = 3)
  and on ragged shards (n = 67): value at rtol 1e-10 and gradient at rtol
  1e-9 at R = 2 and 4, for one theta and for a ``(C, dim)`` batch, against
  the unsharded density and (n = 64: the reference places only even shards)
  the reference's ``sharded_data_logdensity``; every rank's bits equal;
- chains sharded over two ranks against local pooling, statistically as the
  reference's ``tests/test_parallel.py:48-89`` does;
- ``run_pooled_chains_chunked(mesh=...)`` equals the monolithic sharded run
  bit for bit at R = 2 with uneven chunks; with ``auto_depth`` both ranks
  run the same caps;
- ``sample_nuts_sharded`` on eight schools at R = 2: the same global draws
  on both ranks, the posterior of ``tests/test_parallel.py:24-45``;
- at world size 1 (a group of one in this process) ``axis_name`` changes no
  bit of ``run_pooled_chains``, and ``sample_nuts_sharded`` is
  ``run_pooled_chains`` from the derived generator;
- argument errors of ``chain_mesh`` and ``initialize_multihost``;
- the twin of ``tests/test_multihost.py`` (``slow``, as its reference).
"""

import datetime
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from math_tpu_torch import dists as tdists
from math_tpu_torch.infer import pooled as tpooled
from math_tpu_torch.infer import adapt as tadapt
from math_tpu_torch.models import eight_schools
from math_tpu_torch.parallel import chain_mesh, initialize_multihost, mesh as tmesh, sample_nuts_sharded
from math_tpu_torch.parallel import sharded_data_logdensity
from math_tpu_torch.utils import _collectives as coll
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
GROUP_TIMEOUT = datetime.timedelta(seconds=60)
JOIN_TIMEOUT_S = 300
F64 = torch.float64


# --- the ranks ---------------------------------------------------------------


def free_ports(n):
    """``n`` distinct free TCP ports of localhost (all held until each is
    chosen, so that two groups never share a store)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def start_ranks(module, world, out_dir, *extra, entry="_rank_main", port=None):
    """``world`` processes running ``module.<entry>(rank, world, port,
    out_dir, *extra)``; returns them with their output pipes."""
    port = free_ports(1)[0] if port is None else port
    # os._exit once the results are written: at interpreter exit a rank
    # aborted now and then ("terminate called without an active exception",
    # from the store's or gloo's threads being destroyed)
    code = (f"import os, sys; sys.path[:0] = [{TESTS!r}, {ROOT!r}]; import {module} as m; m.{entry}(*sys.argv[1:]); "
            "sys.stdout.flush(); os._exit(0)")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, "-c", code, str(r), str(world), str(port), out_dir, *map(str, extra)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env) for r in range(world)]


def join_ranks(procs):
    """Wait for every rank (``JOIN_TIMEOUT_S``), kill what is left, and fail
    with a rank's output where one failed."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=JOIN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed (exit code {p.returncode}):\n{out[-4000:]}"


def join_group(rank, world, port):
    torch.set_num_threads(1)
    initialize_multihost(f"127.0.0.1:{port}", world, rank, device="cpu", timeout=GROUP_TIMEOUT)


def leave_group():
    dist.barrier()
    dist.destroy_process_group()


def glm_data(n, seed):
    """The reference test's GLM (tests/test_parallel.py:92-100) at ``n`` rows."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3))
    beta = np.array([0.5, -1.0, 0.3])
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-(x @ beta)))).astype(np.float64)
    return x, y


GLM_CASES = {"n64": (64, 0), "n67": (67, 1)}
THETA = np.array([0.2, -0.5, 0.1])
THETA_BATCH = np.random.default_rng(4).normal(size=(5, 3)) * 0.5
WELFORD_LOCAL, WELFORD_DIM = 8, 3


def welford_inputs(world):
    rng = np.random.default_rng(7)
    zs = rng.normal(size=(world * WELFORD_LOCAL, WELFORD_DIM)) * np.array([1.0, 2.0, 0.5]) + 1.0
    return zs, 5.0, rng.normal(size=WELFORD_DIM), 5.0 * rng.uniform(size=WELFORD_DIM)


def glm_term(theta, shard):
    x, y = shard
    return tdists.bernoulli_logit_glm_lpmf(y, x, 0.0, theta, propto=True, batch_ndims=theta.ndim - 1)


def _obs_sharded(world, res):
    mesh = chain_mesh(world, axis="obs", device="cpu")
    for name, (n, seed) in GLM_CASES.items():
        lp, (x_local, _) = sharded_data_logdensity(glm_term, glm_data(n, seed), mesh, axis="obs")
        res[f"obs{world}_{name}_rows"] = np.array(x_local.shape[0])
        for kind, theta in (("one", THETA), ("batch", THETA_BATCH)):
            th = torch.tensor(theta, requires_grad=True)
            val = lp(th)
            (g,) = torch.autograd.grad(val.sum(), th)
            res[f"obs{world}_{name}_{kind}_value"] = val.detach().numpy()
            res[f"obs{world}_{name}_{kind}_grad"] = g.numpy()


def es_inits(n_chains, seed, radius=2.0):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.uniform(-radius, radius, size=(n_chains, 10)))


STAT_KW = dict(num_warmup=100, num_samples=50, device="cpu")
CHUNK_KW = dict(num_warmup=25, num_samples=14, max_depth=5, target_accept=0.85, device="cpu")
SHARDED_ES = dict(num_chains=16, num_warmup=200, num_samples=150, max_depth=8, target_accept=0.9, dtype=F64)


def _chains_sharded(rank, res):
    model = eight_schools.make()
    mesh = chain_mesh(2, axis="chain", device="cpu")
    # against local pooling: each rank's block of the same 8 inits
    z0 = es_inits(8, 1)
    gen = coll.rank_generator(torch.Generator().manual_seed(1), rank, "cpu")
    out = tpooled.gather_pooled(tpooled.run_pooled_chains(gen, z0.chunk(2)[rank], model.logp, axis_name="chain",
                                                          **STAT_KW), "chain")
    res.update(stat_position=out.position.numpy(), stat_step=out.step_size.numpy(), stat_inv_mass=out.inv_mass.numpy())
    # the chunked driver over the mesh against the monolithic sharded run
    z0 = es_inits(16, 6, radius=1.0)
    mono = tpooled.gather_pooled(tpooled.run_pooled_chains(
        coll.rank_generator(torch.Generator().manual_seed(5), rank, "cpu"), z0.chunk(2)[rank], model.logp,
        axis_name="chain", **CHUNK_KW), "chain")
    chunked = tpooled.run_pooled_chains_chunked(
        coll.rank_generator(torch.Generator().manual_seed(5), rank, "cpu"), z0, model.logp, mesh=mesh,
        warmup_chunk=6, sample_chunk=5, **CHUNK_KW)
    res.update(mono_position=mono.position.numpy(), mono_leapfrog=mono.n_leapfrog.numpy(),
               mono_step=mono.step_size.numpy(), chunked_position=chunked.position.numpy(),
               chunked_leapfrog=chunked.n_leapfrog.numpy(), chunked_step=chunked.step_size.numpy())
    auto = tpooled.run_pooled_chains_chunked(
        coll.rank_generator(torch.Generator().manual_seed(5), rank, "cpu"), z0, model.logp, mesh=mesh,
        num_warmup=60, num_samples=120, max_depth=8, warmup_chunk=20, sample_chunk=50, auto_depth=True,
        warmup_start_cap=3, device="cpu")
    res.update(auto_caps=np.array(auto.chunk_caps), auto_position=auto.position.numpy())
    errors = []  # both raise before their first collective
    for run in (lambda: sample_nuts_sharded(model.logp, 0, model.dim, num_chains=7, mesh=mesh, num_warmup=1, num_samples=1),
                lambda: tpooled.run_pooled_chains_chunked(torch.Generator(), es_inits(7, 0), model.logp, mesh=mesh,
                                                          num_warmup=1, num_samples=1, device="cpu")):
        try:
            run()
        except ValueError as e:
            errors.append(str(e))
    res["divisibility_errors"] = np.array(errors)


def _sample_nuts_sharded(res):
    model = eight_schools.make()
    sh = sample_nuts_sharded(model.logp, 0, model.dim, mesh=chain_mesh(2, device="cpu"), **SHARDED_ES)
    res.update(es_position=sh.position.numpy(), es_step=sh.step_size.numpy(), es_inv_mass=sh.inv_mass.numpy())


def _welford_on_ranks(rank, world, res):
    chain_mesh(world, axis="chain", device="cpu")
    zs, count, mean, m2 = welford_inputs(world)
    wf = tadapt.WelfordState(torch.tensor(count, dtype=F64), torch.tensor(mean), torch.tensor(m2))
    block = torch.tensor(zs[rank * WELFORD_LOCAL:(rank + 1) * WELFORD_LOCAL])
    got = tpooled._welford_merge_batch(wf, block, "chain")
    res.update(welford_count=got.count.numpy(), welford_mean=got.mean.numpy(), welford_m2=got.m2.numpy())


def _rank_main(rank, world, port, out_dir, port_a, port_b):
    """The four-rank scenarios, then two groups of two side by side: ranks 0
    and 1 the two-rank scenarios, ranks 2 and 3 ``sample_nuts_sharded``."""
    rank, world = int(rank), int(world)
    res = {}
    join_group(rank, world, int(port))
    _welford_on_ranks(rank, world, res)
    _obs_sharded(world, res)
    leave_group()
    join_group(rank % 2, 2, int(port_a if rank < 2 else port_b))
    if rank < 2:
        _obs_sharded(2, res)
        _chains_sharded(rank, res)
    else:
        _sample_nuts_sharded(res)
    leave_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ranks"))
    port, port_a, port_b = free_ports(3)
    return start_ranks("test_torch_parallel", 4, out, port_a, port_b, port=port), out


@pytest.fixture(scope="module")
def ranks(started, jax_refs):
    """Every rank's results: ``[dict of arrays] * 4`` (ranks 0 and 1 also
    hold the two-rank scenarios, 2 and 3 ``sample_nuts_sharded``'s); the JAX
    references are computed while the ranks run."""
    procs, out = started
    join_ranks(procs)
    return [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(4)]


# --- the JAX side ------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_refs():
    """The reference's sharded Welford merge at R = 4 and its observation-
    sharded GLM at R = 2 and 4, value and gradient in one jit each."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from math_tpu import dists as jdists
    from math_tpu.infer import adapt as jadapt
    from math_tpu.infer import pooled as jpooled
    from math_tpu.parallel import chain_mesh as jchain_mesh, sharded_data_logdensity as jsharded

    refs = {}
    zs, count, mean, m2 = welford_inputs(4)
    merge = jax.jit(jax.shard_map(
        lambda wf, z: jpooled._welford_merge_batch(wf, z, "chain"), mesh=jchain_mesh(4),
        in_specs=(P(), P("chain")), out_specs=P()))
    got = merge(jadapt.WelfordState(jnp.asarray(count), jnp.asarray(mean), jnp.asarray(m2)), jnp.asarray(zs))
    refs["welford"] = [np.asarray(a) for a in got]

    def full(theta, x, y):
        return jdists.bernoulli_logit_glm_lpmf(y, x, 0.0, theta, propto=True)

    for name, (n, seed) in GLM_CASES.items():
        x, y = glm_data(n, seed)
        vg = jax.jit(jax.vmap(jax.value_and_grad(full), in_axes=(0, None, None)))
        for kind, theta in (("one", THETA[None]), ("batch", THETA_BATCH)):
            v, g = vg(jnp.asarray(theta), x, y)
            refs[f"{name}_{kind}"] = (np.asarray(v).reshape(np.shape(theta)[:-1] if kind == "batch" else ()),
                                      np.asarray(g).reshape(np.shape(theta) if kind == "batch" else (3,)))
        if n % 4 == 0:  # the reference places even shards only
            for world in (2, 4):
                lp, _ = jsharded(lambda t, s: jdists.bernoulli_logit_glm_lpmf(s[1], s[0], 0.0, t, propto=True),
                                 (x, y), jchain_mesh(world, axis="obs"), axis="obs")
                v, g = jax.jit(jax.value_and_grad(lp))(jnp.asarray(THETA))
                refs[f"sharded{world}_{name}"] = (np.asarray(v), np.asarray(g))
    return refs


# --- the tests ---------------------------------------------------------------


@pytest.mark.parametrize("part", [0, 1, 2])
def test_welford_merge_across_ranks(ranks, jax_refs, part):
    field = ("welford_count", "welford_mean", "welford_m2")[part]
    for r in range(1, 4):
        np.testing.assert_array_equal(ranks[r][field], ranks[0][field])
    np.testing.assert_allclose(ranks[0][field], jax_refs["welford"][part], rtol=1e-12)
    zs, count, mean, m2 = welford_inputs(4)
    wf = tadapt.WelfordState(torch.tensor(count, dtype=F64), torch.tensor(mean), torch.tensor(m2))
    whole = tpooled._welford_merge_batch(wf, torch.tensor(zs))
    np.testing.assert_allclose(ranks[0][field], whole[part].numpy(), rtol=1e-12)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", list(GLM_CASES))
@pytest.mark.parametrize("kind", ["one", "batch"])
def test_sharded_data_logdensity_value_and_grad(ranks, jax_refs, world, case, kind):
    key = f"obs{world}_{case}_{kind}"
    n = GLM_CASES[case][0]
    assert sum(int(ranks[r][f"obs{world}_{case}_rows"]) for r in range(world)) == n
    for r in range(1, world):
        np.testing.assert_array_equal(ranks[r][key + "_value"], ranks[0][key + "_value"])
        np.testing.assert_array_equal(ranks[r][key + "_grad"], ranks[0][key + "_grad"])
    value, grad = ranks[0][key + "_value"], ranks[0][key + "_grad"]
    theta = torch.tensor(THETA if kind == "one" else THETA_BATCH, requires_grad=True)
    want = glm_term(theta, tuple(torch.tensor(a) for a in glm_data(*GLM_CASES[case])))
    (want_g,) = torch.autograd.grad(want.sum(), theta)
    np.testing.assert_allclose(value, want.detach().numpy(), rtol=1e-10)
    np.testing.assert_allclose(grad, want_g.numpy(), rtol=1e-9)
    jv, jg = jax_refs[f"{case}_{kind}"]
    np.testing.assert_allclose(value, jv, rtol=1e-10)
    np.testing.assert_allclose(grad, jg, rtol=1e-9)
    if kind == "one" and f"sharded{world}_{case}" in jax_refs:
        jv, jg = jax_refs[f"sharded{world}_{case}"]
        np.testing.assert_allclose(value, jv, rtol=1e-10)
        np.testing.assert_allclose(grad, jg, rtol=1e-9)


def test_sharded_matches_local_pooled(ranks):
    """Pooling over two ranks of four chains against one local batch of
    eight (tests/test_parallel.py:48-89): NUTS is chaotic and the pooled
    sums run in another order, so adaptation and moments statistically."""
    model = eight_schools.make()
    local = tpooled.run_pooled_chains(torch.Generator().manual_seed(1), es_inits(8, 1), model.logp, **STAT_KW)
    np.testing.assert_array_equal(ranks[1]["stat_position"], ranks[0]["stat_position"])
    np.testing.assert_allclose(ranks[0]["stat_step"], local.step_size.numpy(), rtol=0.3)
    np.testing.assert_allclose(ranks[0]["stat_inv_mass"], local.inv_mass.numpy(), rtol=0.6)
    sp = ranks[0]["stat_position"].reshape(-1, model.dim)
    lp = local.position.numpy().reshape(-1, model.dim)
    assert ranks[0]["stat_position"].shape == (8, 50, model.dim)
    assert np.abs(sp.mean(0) - lp.mean(0)).max() < 0.8


def test_chunked_mesh_equals_monolithic_sharded(ranks):
    """tests/test_parallel.py:154-194: uneven chunks (25 = 6+6+6+6+1, 14 =
    5+5+4) over the mesh give the monolithic sharded run's draws."""
    for r in range(2):
        np.testing.assert_array_equal(ranks[r]["chunked_position"], ranks[r]["mono_position"])
        np.testing.assert_array_equal(ranks[r]["chunked_leapfrog"], ranks[r]["mono_leapfrog"])
        assert float(ranks[r]["chunked_step"]) == float(ranks[r]["mono_step"])
    assert ranks[0]["chunked_position"].shape == (16, 14, 10)
    np.testing.assert_array_equal(ranks[0]["chunked_position"], ranks[1]["chunked_position"])


def test_chunked_mesh_auto_depth_caps_agree(ranks):
    caps = ranks[0]["auto_caps"]
    np.testing.assert_array_equal(caps, ranks[1]["auto_caps"])
    assert caps[0] == 3 and len(caps) >= 5
    np.testing.assert_array_equal(ranks[0]["auto_position"], ranks[1]["auto_position"])


def test_sample_nuts_sharded_eight_schools(ranks):
    """tests/test_parallel.py:24-45 at 16 chains, 200 + 150: both ranks hold
    the same global draws."""
    model = eight_schools.make()
    pos = ranks[2]["es_position"]
    np.testing.assert_array_equal(ranks[3]["es_position"], pos)
    assert pos.shape == (16, 150, model.dim)
    cons = model.constrain(torch.tensor(pos.reshape(-1, model.dim)))
    mu, tau = cons["mu"].numpy(), cons["tau"].numpy()
    assert abs(mu.mean() - 4.4) < 0.6, mu.mean()
    assert abs(tau.mean() - 3.6) < 0.8, tau.mean()
    assert np.ndim(ranks[2]["es_step"]) == 0 and ranks[2]["es_inv_mass"].shape == (model.dim,)


def test_indivisible_chains_raise(ranks):
    errors = list(ranks[0]["divisibility_errors"])
    assert len(errors) == 2 and all("not divisible by mesh size 2" in e for e in errors), errors


# --- world size 1, in this process --------------------------------------------


@pytest.fixture(scope="module")
def group_of_one():
    """``chain_mesh()`` in a plain process: a group of one over gloo, taken
    down after the module."""
    made = not dist.is_initialized()
    mesh = chain_mesh(axis="chain", device="cpu")
    yield mesh
    if made:
        dist.destroy_process_group()


def test_world_size_one_is_the_local_run(group_of_one):
    model = eight_schools.make()
    z0 = es_inits(8, 2)
    kw = dict(num_warmup=40, num_samples=20, max_depth=6)
    a = tpooled.run_pooled_chains(torch.Generator().manual_seed(3), z0, model.logp, device="cpu", **kw)
    coll.reset_counts()
    b = tpooled.run_pooled_chains(torch.Generator().manual_seed(3), z0, model.logp, axis_name="chain", device="cpu", **kw)
    assert coll.COUNTS["all_reduce"] > 0 and coll.COUNTS["all_gather"] == 0
    for f in ("position", "n_leapfrog", "accept_prob", "step_size", "inv_mass"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    sh = sample_nuts_sharded(model.logp, 11, model.dim, num_chains=8, mesh=group_of_one, dtype=F64, **kw)
    z0s, gen = tmesh.sharded_inits(11, 8, model.dim, rank=0, dtype=F64, device="cpu")
    want = tpooled.run_pooled_chains(gen, z0s, model.logp, device="cpu", **kw)
    assert torch.equal(sh.position, want.position) and torch.equal(sh.step_size, want.step_size)
    assert coll.COUNTS["all_gather"] == 10  # the draws and five statistics, the final state's four fields


def test_argument_errors(group_of_one):
    with pytest.raises(ValueError, match="n_devices"):
        chain_mesh(2, device="cpu")
    for args in ((None, 2, 0), ("127.0.0.1:1", 2, 2), ("127.0.0.1:1", 0, 0), ("127.0.0.1:1", 2, -1)):
        with pytest.raises(ValueError, match="initialize_multihost"):
            initialize_multihost(*args, device="cpu")
    with pytest.raises(RuntimeError, match="already belongs"):
        initialize_multihost("127.0.0.1:1", 1, 0, device="cpu")
    with pytest.raises(ValueError, match="no mesh axis"):
        coll.psum(torch.ones(2), "nowhere")


# --- the twin of tests/test_multihost.py ---------------------------------------


def _multihost_main(rank, world, port, out_dir):
    """One of two processes joined by ``initialize_multihost`` over TCP: the
    chain-sharded sampler of the reference's WORKER, its global draws saved."""
    rank, world = int(rank), int(world)
    join_group(rank, world, int(port))
    model = eight_schools.make()
    res = sample_nuts_sharded(model.logp, 0, model.dim, num_chains=8, num_warmup=50, num_samples=50, max_depth=6,
                              mesh=chain_mesh(world, device="cpu"), dtype=F64)
    leave_group()
    np.save(os.path.join(out_dir, f"pos_{rank}.npy"), res.position.numpy())


@pytest.mark.slow
def test_two_process_sharded_nuts(tmp_path):
    join_ranks(start_ranks("test_torch_parallel", 2, str(tmp_path), entry="_multihost_main"))
    pos0, pos1 = np.load(tmp_path / "pos_0.npy"), np.load(tmp_path / "pos_1.npy")
    assert pos0.shape == (8, 50, 10)
    # both processes hold the identical global draw stream
    np.testing.assert_array_equal(pos0, pos1)
    mu = float(np.mean(pos0[:, :, 0]))
    assert 2.0 < mu < 7.0, mu
