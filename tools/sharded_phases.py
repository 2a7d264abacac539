#!/usr/bin/env python3
"""The ``sharded`` phases of ``chip_smoke.py``: ``parallel/`` over NCCL on the GPU.

Run from the repository root on a machine with one GPU and nvcc:

    python3 tools/sharded_phases.py

``chip_smoke.py`` runs it beside its worker's last phases, as a process of
its own, so that its NCCL group never lives in the script's process, and
prints its lines; the last line,
``{"sharded_result": ...}``, carries B1's launches into the script's
``kernels`` line.  NCCL takes one rank a GPU (it refuses two ranks on one
card), so the card runs a group of one, where every collective is a real
NCCL call over one rank and an all-reduce is the identity: the strongest
check the card can make is bit equality with the one-device code.

- ``sharded_group``: ``initialize_multihost`` over TCP to a group of one over
  NCCL on ``cuda:0``, then ``chain_mesh(1)`` (axis ``chain``) and an ``obs``
  mesh;
- ``sharded_data``: ``sharded_data_logdensity`` on BASELINE config 2's
  likelihood (100,000 x 50, 256 chains, float32): value and gradient equal
  to the unsharded B1 call bit for bit; one B1 launch an evaluation and no
  plain call; two all-reduces a value and gradient; each one's ms and the
  ms of one NCCL all-reduce of the value and of the gradient alone (CUDA
  events);
- ``sharded_nuts``: ``sample_nuts_sharded`` of config 2 at ``main_path``'s
  settings (256 chains, 150 + 50, depth 6, float32) equal bit for bit to
  ``run_pooled_chains`` from the derived generator and the same ``z0``; B1
  launches equal to gradient calls, no plain call; recovery as
  ``main_path``'s; wall and ms a gradient call of both runs, the
  collectives counted and their share of the wall (the host's seconds
  inside them over the run's);
- ``sharded_chunked``: ``run_pooled_chains_chunked(mesh=...)`` of the same
  run in chunks of 40 (in its own NCCL group of one), equal to
  ``sharded_nuts``'s draws bit for bit.  The local and the chunked run each
  run in a helper process of this script (``--helper``) beside the sharded
  one, and send their draws back through a temporary file: three host-bound
  samplers side by side take the time of one;
- ``sharded_smc``: ``smc_tempered(axis_name=...)`` on the 2-D Gaussian of
  ``tests/test_torch_smc_sharded.py`` with 2,048 particles (float32): the
  moments and the log evidence within that test's tolerances, equal bit for
  bit to the local run from the same two streams; ``ancestor_exchange`` at
  world size 1 is ``z[idx]`` with no collective;
- ``gloo_cuda``: two more processes of this script share the card over
  gloo (started first, so that their start-up runs beside the phases above;
  NCCL refuses two ranks on one GPU): ``sharded_data_logdensity`` with the
  observations split 50,000 + 50,000 (B1 at N = 50,000 on each rank) against
  the unsharded call within float32 reduction-order tolerance.

``python3 tools/sharded_phases.py --gloo-cuda`` runs only ``gloo_probe``:
which collectives gloo takes on CUDA tensors, each kind tried by its own two
processes that share the card (a refused one ends them).  With the card's
PyTorch it takes the all-reduce and the all-gather, not the point-to-point
rotation, so ``ancestor_exchange`` has no two-rank run on one card.

Every line stands beside ``nvidia-smi``'s name and power limit (the
``device`` line).  No failure is caught: a failed gate ends the run with a
non-zero exit code.  Without a GPU it exits 2 and prints no result.
"""

import datetime
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

from math_tpu_torch.infer import run_pooled_chains, run_pooled_chains_chunked, smc_tempered  # noqa: E402
from math_tpu_torch.infer import smc as smc_mod  # noqa: E402
from math_tpu_torch.models import glm_logistic  # noqa: E402
from math_tpu_torch.ops import glm_fused  # noqa: E402
from math_tpu_torch.parallel import chain_mesh, initialize_multihost, sample_nuts_sharded, sharded_data_logdensity  # noqa: E402
from math_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from math_tpu_torch.utils import _collectives as coll  # noqa: E402

# BASELINE config 2 at main_path's chains (chip_smoke.N_MAIN, K_MAIN, C_MAIN;
# main() checks that they agree).  The helper processes do not import
# chip_smoke.py: five processes importing it together lengthened this
# script's start-up on a slow host.
N_MAIN, K_MAIN, C_MAIN = 100_000, 50, 256
GROUP_TIMEOUT = datetime.timedelta(seconds=120)
SEED = 0
NUTS = dict(num_warmup=150, num_samples=50, max_depth=6)  # main_path's
SMC_PARTICLES = 2048
GAUSS_MU = (1.5, -0.5)
JOIN_S = 240
REPS = 20


START = time.perf_counter()


def require(cond, what):
    """A check of this script (as ``chip_smoke.require``)."""
    if not cond:
        raise RuntimeError(f"sharded_phases check failed: {what}")


def emit(phase, **fields):
    """One JSON line a phase; ``script_s``: seconds since this script started."""
    print(json.dumps({"phase": phase, **fields, "script_s": time.perf_counter() - START}), flush=True)


def free_ports(n):
    """``n`` distinct free TCP ports of localhost (all held until each is
    chosen, so that two groups started together never share a store)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def glm_term(z, shard):
    """Config 2's likelihood of a shard for chains ``z (C, 51)``: one B1 call."""
    x, y = shard
    return glm_fused.bernoulli_logit_glm_lpmf_chains(y, x, z[:, 0], z[:, 1:].T)


def value_and_grad(fn, z):
    zz = z.detach().clone().requires_grad_(True)
    v = fn(zz)
    (g,) = torch.autograd.grad(v.sum(), zz)
    return v.detach(), g


def event_ms(fn, reps=REPS):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def chain_points(c, dim, device):
    return torch.tensor(np.random.default_rng(3).normal(size=(c, dim)) * 0.1, dtype=torch.float32, device=device)


def phase_group(port):
    devices = initialize_multihost(f"127.0.0.1:{port}", 1, 0, timeout=GROUP_TIMEOUT)
    chain, obs = chain_mesh(1), chain_mesh(1, axis="obs")
    require(dist.get_backend() == "nccl" and chain.device_type == "cuda", f"backend {dist.get_backend()}")
    emit("sharded_group", backend=dist.get_backend(), world_size=dist.get_world_size(), devices=[str(d) for d in devices],
         nccl_version=".".join(map(str, torch.cuda.nccl.version())), meshes=[str(chain), str(obs)])
    return chain, obs


def phase_data(obs, x, y, xt, yt):
    lp, (x_local, _) = sharded_data_logdensity(glm_term, (x, y), obs, axis="obs")
    z = chain_points(C_MAIN, x.shape[1] + 1, "cuda")
    glm_fused.reset_counts()
    coll.reset_counts()
    v_sh, g_sh = value_and_grad(lp, z)
    torch.cuda.synchronize()
    launches, plain, collectives = dict(glm_fused.LAUNCHES), dict(glm_fused.PLAIN_CALLS), dict(coll.COUNTS)
    host_ms = sum(coll.SECONDS.values()) * 1e3
    v_un, g_un = value_and_grad(lambda q: glm_term(q, (xt, yt)), z)
    require(x_local.shape == x.shape and x_local.device.type == "cuda", f"the shard {tuple(x_local.shape)}")
    require(torch.equal(v_sh, v_un) and torch.equal(g_sh, g_un), "sharded_data: value or gradient differs from the unsharded call")
    require(launches["bernoulli_logit"] == 1 and sum(launches.values()) == 1, f"sharded_data: launches {launches}")
    require(all(v == 0 for v in plain.values()), f"sharded_data: plain calls {plain}")
    require(collectives == {"all_reduce": 2, "all_gather": 0, "rotate": 0}, f"sharded_data: collectives {collectives}")
    ms_sh = event_ms(lambda: value_and_grad(lp, z))
    ms_un = event_ms(lambda: value_and_grad(lambda q: glm_term(q, (xt, yt)), z))
    ms_sh2 = event_ms(lambda: value_and_grad(lp, z))
    allreduce_value_ms = event_ms(lambda: coll.psum(v_un, "obs"))
    allreduce_grad_ms = event_ms(lambda: coll.psum(g_un, "obs"))
    emit("sharded_data", n=x.shape[0], k=x.shape[1], chains=z.shape[0], equal_bits=True, b1_launches_per_evaluation=1,
         plain_calls=plain, collectives_per_value_and_grad=collectives, value_and_grad_ms_sharded=[ms_sh, ms_sh2],
         value_and_grad_ms_unsharded=ms_un, allreduce_ms_value=allreduce_value_ms, allreduce_ms_gradient=allreduce_grad_ms,
         collectives_host_ms_first_call=host_ms)


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


RUN_FIELDS = ("position", "n_leapfrog", "step_size", "inv_mass")


def helper_main(kind, out_path, port):
    """``--helper local`` / ``--helper chunked``: one of the runs that
    ``sharded_nuts`` holds its draws against, in a process of its own beside
    it (three host-bound samplers side by side instead of one after another):
    ``run_pooled_chains`` from the derived generator and the same ``z0``, or
    ``run_pooled_chains_chunked`` over a mesh (its own NCCL group of one) in
    chunks of 40.  Saves the draws' fields to ``out_path`` and prints its
    counts."""
    x, y, _, _ = glm_logistic.synthetic_data(N_MAIN, K_MAIN)
    xt = torch.tensor(x, dtype=torch.float32, device="cuda")
    yt = torch.tensor(y, dtype=torch.float32, device="cuda")
    model = glm_logistic.make(x.shape[1])
    mesh = None
    if kind == "chunked":
        initialize_multihost(f"127.0.0.1:{port}", 1, 0, timeout=GROUP_TIMEOUT)
        mesh = chain_mesh(1)
    z0, gen = pmesh.sharded_inits(SEED, C_MAIN, model.dim, rank=0, dtype=torch.float32, device="cuda")
    glm_fused.reset_counts()
    coll.reset_counts()
    if kind == "local":
        res, wall = timed(lambda: run_pooled_chains(gen, z0, model.logp, args=(xt, yt), device="cuda", **NUTS))
    else:
        res, wall = timed(lambda: run_pooled_chains_chunked(gen, z0, model.logp, args=(xt, yt), mesh=mesh, warmup_chunk=40,
                                                           sample_chunk=40, **NUTS))
    np.savez(out_path, **{f: getattr(res, f).cpu().numpy() for f in RUN_FIELDS})
    print(json.dumps({"helper": {
        "kind": kind, "wall_s": wall, "grad_calls": res.n_grad_calls, "b1_launches": glm_fused.LAUNCHES["bernoulli_logit"],
        "plain_calls": sum(glm_fused.PLAIN_CALLS.values()), "collectives": dict(coll.COUNTS),
        "collectives_host_s": dict(coll.SECONDS), "chunk_caps": list(res.chunk_caps)}}), flush=True)
    if mesh is not None:
        dist.barrier()
        dist.destroy_process_group()


def start_helpers(out_dir, chunked_port, gloo_port):
    """The ``local`` and ``chunked`` helpers and the two gloo ranks, started
    first so that their start-up runs beside this process's phases; one
    OpenMP thread each (the samplers are host-bound on one Python thread)."""
    script, env = os.path.abspath(__file__), dict(os.environ, OMP_NUM_THREADS="1")
    helpers = {kind: subprocess.Popen([sys.executable, script, "--helper", kind, os.path.join(out_dir, kind + ".npz"),
                                       str(port)], stdout=subprocess.PIPE, text=True, env=env)
               for kind, port in (("local", 0), ("chunked", chunked_port))}
    gloo = [subprocess.Popen([sys.executable, script, "--gloo-rank", str(r), str(gloo_port)], stdout=subprocess.PIPE,
                             text=True, env=env) for r in range(2)]
    return helpers, gloo


def join(procs, key):
    """Each process's JSON line under ``key``; every process must end with
    exit code 0 within ``JOIN_S``."""
    outs = []
    try:
        outs = [p.communicate(timeout=JOIN_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    require(all(p.returncode == 0 for p in procs), f"{key}: exit codes {[p.returncode for p in procs]}")
    return [json.loads(next(line for line in o.splitlines() if line.startswith('{"' + key + '"')))[key] for o in outs]


def same_draws(res, path):
    saved = np.load(path)
    return all(torch.equal(getattr(res, f).cpu(), torch.from_numpy(saved[f])) for f in RUN_FIELDS)


def phase_nuts(chain, x, y, beta_true, xt, yt, helpers, out_dir):
    """``sample_nuts_sharded`` here, the local and the chunked run in the
    helpers beside it; then the three draws compared bit for bit."""
    model = glm_logistic.make(x.shape[1])
    glm_fused.reset_counts()
    coll.reset_counts()
    sh, wall_sh = timed(lambda: sample_nuts_sharded(model.logp, SEED, model.dim, args=(xt, yt), num_chains=C_MAIN,
                                                    mesh=chain, dtype=torch.float32, **NUTS))
    launches_sh, plain = glm_fused.LAUNCHES["bernoulli_logit"], dict(glm_fused.PLAIN_CALLS)
    collectives, seconds = dict(coll.COUNTS), dict(coll.SECONDS)
    loc, ch = join([helpers["local"], helpers["chunked"]], "helper")
    require(same_draws(sh, os.path.join(out_dir, "local.npz")),
            "sharded_nuts: sample_nuts_sharded differs from run_pooled_chains from the derived generator")
    require(launches_sh == sh.n_grad_calls == loc["grad_calls"] == loc["b1_launches"] > 0,
            f"sharded_nuts: B1 launches {launches_sh} / {loc['b1_launches']} for {sh.n_grad_calls} gradient calls")
    require(sum(plain.values()) == 0 and loc["plain_calls"] == 0, f"sharded_nuts: plain calls {plain}, {loc['plain_calls']}")
    draws = model.transform_draws(sh.position)
    beta = draws["beta"].double().reshape(-1, x.shape[1]).cpu().numpy()
    beta_err = float(np.max(np.abs(beta.mean(0) - beta_true)))
    require(beta_err < 0.05, f"sharded_nuts: max |mean(beta) - beta_true| = {beta_err}")
    div = float(sh.diverging.double().mean())
    require(div < 0.05, f"sharded_nuts: divergence rate {div}")
    emit("sharded_nuts", chains=C_MAIN, **NUTS, equal_bits=True, grad_calls=sh.n_grad_calls, b1_launches=launches_sh,
         plain_calls=plain, collectives=collectives, collectives_host_s=seconds, wall_s_sharded=wall_sh,
         wall_s_local=loc["wall_s"], ms_per_grad_call_sharded=wall_sh / sh.n_grad_calls * 1e3,
         ms_per_grad_call_local=loc["wall_s"] / loc["grad_calls"] * 1e3, collectives_share=sum(seconds.values()) / wall_sh,
         runs_side_by_side=3, max_abs_beta_err=beta_err, divergence_rate=div, step_size=float(sh.step_size),
         mean_tree_depth=float(sh.tree_depth.double().mean()))
    require(same_draws(sh, os.path.join(out_dir, "chunked.npz")), "sharded_chunked: the chunked run differs from sample_nuts_sharded")
    require(ch["b1_launches"] == ch["grad_calls"] and ch["plain_calls"] == 0,
            f"sharded_chunked: {ch['b1_launches']} launches, {ch['plain_calls']} plain calls for {ch['grad_calls']} gradient calls")
    require(ch["chunk_caps"] == [NUTS["max_depth"]] * len(ch["chunk_caps"]), f"sharded_chunked: caps {ch['chunk_caps']}")
    emit("sharded_chunked", equal_bits=True, chunks=len(ch["chunk_caps"]), wall_s=ch["wall_s"], grad_calls=ch["grad_calls"],
         b1_launches=ch["b1_launches"], collectives=ch["collectives"], collectives_host_s=ch["collectives_host_s"])
    return launches_sh + ch["b1_launches"]


def gaussian_ld(z):
    return -0.5 * torch.sum(torch.square(z - torch.tensor(GAUSS_MU, dtype=z.dtype, device=z.device)) / 0.25, -1)


def phase_smc():
    kw = dict(num_particles=SMC_PARTICLES, mutation_steps=3, dtype=torch.float32, device="cuda")
    coll.reset_counts()
    res, wall = timed(lambda: smc_tempered(gaussian_ld, torch.Generator(device="cuda").manual_seed(SEED), 2, axis_name="chain", **kw))
    collectives = dict(coll.COUNTS)
    noise = smc_mod._sharded_noise(torch.Generator(device="cuda").manual_seed(SEED), 0, "cuda", torch.float32)
    loc = smc_tempered(gaussian_ld, noise, 2, **kw)
    require(torch.equal(res.particles, loc.particles) and torch.equal(res.log_evidence, loc.log_evidence),
            "sharded_smc: differs from the local run from the same streams")
    p = res.particles.double().cpu().numpy()
    mean_err = float(np.abs(p.mean(0) - np.array(GAUSS_MU)).max())
    var_err = float(np.abs(p.var(0) / 0.25 - 1.0).max())
    logz_err = abs(float(res.log_evidence) - np.log(0.25))
    require(mean_err < 0.1 and var_err < 0.35 and logz_err < 0.2, f"sharded_smc: mean {mean_err}, var {var_err}, logz {logz_err}")
    z = torch.randn((64, 2), device="cuda")
    idx = torch.sort(torch.randint(0, 64, (64,), device="cuda")).values
    coll.reset_counts()
    require(torch.equal(smc_mod.ancestor_exchange(z, idx, "chain"), z[idx]), "sharded_smc: ancestor_exchange at world size 1")
    require(coll.COUNTS == {"all_reduce": 0, "all_gather": 0, "rotate": 0}, f"ancestor_exchange at world size 1: {coll.COUNTS}")
    emit("sharded_smc", particles=SMC_PARTICLES, stages=res.num_stages, wall_s=wall, equal_bits=True, collectives=collectives,
         ladder=list(res.temperatures),
         max_abs_mean_err=mean_err, max_rel_var_err=var_err, abs_log_evidence_err=logz_err)


def gloo_rank_main(rank, port):
    """A rank of a group of two over gloo on ``cuda:0``: its half of config
    2's observations (50,000 rows, B1 at N = 50,000), the all-reduced value
    and gradient at ``chain_points``; one JSON line."""
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank, timeout=GROUP_TIMEOUT)
    mesh = init_device_mesh("cuda", (2,), mesh_dim_names=("obs",))
    x, y, _, _ = glm_logistic.synthetic_data(N_MAIN, K_MAIN)
    lp, (x_local, _) = sharded_data_logdensity(glm_term, (x, y), mesh, axis="obs")
    glm_fused.reset_counts()
    v, g = value_and_grad(lp, chain_points(C_MAIN, x.shape[1] + 1, "cuda"))
    out = {"rows": x_local.shape[0], "device": str(x_local.device), "value": v.double().cpu().tolist(),
           "grad": g.double().cpu().tolist(), "b1_launches": glm_fused.LAUNCHES["bernoulli_logit"],
           "plain_calls": glm_fused.PLAIN_CALLS["bernoulli_logit"], "collectives": dict(coll.COUNTS)}
    dist.barrier()
    dist.destroy_process_group()
    print(json.dumps({"gloo_rank": out}), flush=True)


def phase_gloo(procs, xt, yt):
    """Two processes share the card over gloo (NCCL refuses two ranks on one
    GPU): value and gradient against the unsharded B1 call within float32
    reduction order (each half rounded to float32, then added: 1e-5 of the
    largest entry), the two ranks' bits equal, one B1 launch each."""
    ranks = join(procs, "gloo_rank")
    v_un, g_un = value_and_grad(lambda q: glm_term(q, (xt, yt)), chain_points(C_MAIN, xt.shape[1] + 1, "cuda"))
    v_un, g_un = v_un.double().cpu(), g_un.double().cpu()
    v0, g0 = torch.tensor(ranks[0]["value"]), torch.tensor(ranks[0]["grad"])
    require(torch.equal(v0, torch.tensor(ranks[1]["value"])) and torch.equal(g0, torch.tensor(ranks[1]["grad"])),
            "gloo_cuda: the ranks' results differ")
    v_err = float(((v0 - v_un).abs() / v_un.abs()).max())
    g_err = float((g0 - g_un).abs().max() / g_un.abs().max())
    require(v_err <= 1e-5 and g_err <= 1e-5, f"gloo_cuda: value {v_err}, gradient {g_err} against the unsharded call")
    require([(r["rows"], r["device"], r["b1_launches"], r["plain_calls"]) for r in ranks] == [(50_000, "cuda:0", 1, 0)] * 2,
            f"gloo_cuda: {[(r['rows'], r['device'], r['b1_launches'], r['plain_calls']) for r in ranks]}")
    emit("gloo_cuda", ranks=2, backend="gloo", rows=[r["rows"] for r in ranks], b1_launches=[r["b1_launches"] for r in ranks],
         collectives=ranks[0]["collectives"], max_rel_value_err=v_err, max_grad_err_normalized=g_err)
    return 2


def gloo_probe_main(kind, rank, port):
    """A rank of a group of two over gloo on ``cuda:0`` that runs one
    collective (``kind``) on a CUDA tensor and prints its result."""
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank, timeout=GROUP_TIMEOUT)
    coll.bind_mesh(init_device_mesh("cuda", (2,), mesh_dim_names=("obs",)))
    t = torch.arange(4.0, device="cuda") + rank
    out = {"all_reduce": lambda: coll.psum(t, "obs"), "all_gather": lambda: coll.all_gather(t, "obs"),
           "rotate": lambda: coll.rotate(t, 1, "obs")}[kind]()
    print(json.dumps({"gloo_probe": out.cpu().tolist()}), flush=True)
    dist.barrier()
    dist.destroy_process_group()


def phase_gloo_probe():
    """Which collectives gloo takes on CUDA tensors: each kind in a pair of
    processes of this script (``--gloo-probe``) that share the card."""
    takes = {}
    for kind, port in zip(("all_reduce", "all_gather", "rotate"), free_ports(3)):
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--gloo-probe", kind, str(r), str(port)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
        outs = []
        try:
            outs = [p.communicate(timeout=JOIN_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ok = all(p.returncode == 0 and '{"gloo_probe"' in o for p, (o, _) in zip(procs, outs))
        errs = [line for _, e in outs for line in e.splitlines() if "what()" in line or "Error" in line]
        takes[kind] = True if ok else {"exit_codes": [p.returncode for p in procs], "error": errs[:2]}
    emit("gloo_probe", torch=torch.__version__, takes=takes)


def main():
    if not torch.cuda.is_available():
        print("sharded_phases: torch.cuda.is_available() is False; this script needs one GPU", file=sys.stderr)
        sys.exit(2)
    out_dir = tempfile.mkdtemp()
    group_port, chunked_port, gloo_port = free_ports(3)
    helpers, gloo = start_helpers(out_dir, chunked_port, gloo_port)  # first, so that their start-up runs beside this one's
    try:
        import chip_smoke

        chip_smoke.phase_device()
        require((N_MAIN, K_MAIN, C_MAIN) == (chip_smoke.N_MAIN, chip_smoke.K_MAIN, chip_smoke.C_MAIN), "config 2's sizes")
        glm_fused._library()
        x, y, beta_true, _ = glm_logistic.synthetic_data(N_MAIN, K_MAIN)
        xt = torch.tensor(x, dtype=torch.float32, device="cuda")
        yt = torch.tensor(y, dtype=torch.float32, device="cuda")
        t0 = time.perf_counter()
        chain, obs = phase_group(group_port)
        phase_data(obs, x, y, xt, yt)
        # B1's launches on the sharded paths (not those of the comparisons and timings)
        launches = 1 + phase_nuts(chain, x, y, beta_true, xt, yt, helpers, out_dir)
        phase_smc()
        dist.barrier()
        dist.destroy_process_group()
        launches += phase_gloo(gloo, xt, yt)
    finally:
        for p in list(helpers.values()) + gloo:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(out_dir)
    print(json.dumps({"sharded_result": {"b1_launches": launches, "seconds": time.perf_counter() - t0}}), flush=True)


if __name__ == "__main__":
    if "--helper" in sys.argv[1:]:
        i = sys.argv.index("--helper")
        helper_main(sys.argv[i + 1], sys.argv[i + 2], int(sys.argv[i + 3]))
    elif "--gloo-rank" in sys.argv[1:]:
        i = sys.argv.index("--gloo-rank")
        gloo_rank_main(int(sys.argv[i + 1]), int(sys.argv[i + 2]))
    elif "--gloo-probe" in sys.argv[1:]:
        i = sys.argv.index("--gloo-probe")
        gloo_probe_main(sys.argv[i + 1], int(sys.argv[i + 2]), int(sys.argv[i + 3]))
    elif "--gloo-cuda" in sys.argv[1:]:
        import chip_smoke

        chip_smoke.phase_device()
        phase_gloo_probe()
    else:
        main()
    # every result is printed: skip the interpreter's teardown, where a
    # process of a destroyed group aborted now and then ("terminate called
    # without an active exception", from the store's or gloo's threads)
    sys.stdout.flush()
    os._exit(0)
