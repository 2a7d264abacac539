"""Resumable, checkpointed NUTS sampling.

Counterpart: ``math_tpu/infer/resume.py``.  Runs per-chain Stan warmup
(``infer/sample.py``'s, chain-batched: a ``(C,)`` step size and a ``(C, D)``
diagonal metric), whole or in segments of ``warmup_chunk_size`` steps, then
samples in chunks of ``chunk_size``.  After each warmup segment and each
sampling chunk the full sampler state (positions with their cached logp and
gradient, the adaptation state, the generator's state, the draws so far) is
persisted through ``math_tpu_torch.io.checkpoint``.  A killed run restarted
with the same arguments continues from the last checkpoint and reproduces
the uninterrupted run bit for bit: all of its noise comes from the one
``torch.Generator`` whose state is checkpointed, and nothing on the path
reduces by atomics.

Where it differs from the reference on purpose:

- the reference checkpoints after sampling chunks only; here a segmented
  warmup is checkpointed after each segment too, so a kill during a long
  warmup resumes inside it;
- the last sampling chunk runs only the transitions it keeps (the reference
  runs a whole chunk and drops the rest, so a later resume to a larger
  ``num_samples`` would not continue the stream);
- ``info["resumed"]`` says whether this call started from a checkpoint (the
  reference reports whether one exists at the end, true after any run), and
  ``info`` also carries ``n_grad_calls`` and the seconds spent writing
  checkpoints.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from math_tpu_torch.config import get_config
from math_tpu_torch.infer import adapt
from math_tpu_torch.infer.nuts import ChainNoise, IntegratorState, LogpGrad, Metric
from math_tpu_torch.infer.sample import (
    WarmupCarry,
    _bad_mask,
    _draw_init,
    _raise_on_bad,
    _sample_chains,
    _warmup_chains,
    _warmup_init,
    _warmup_segment,
    _warmup_step_size,
)
from math_tpu_torch.io.checkpoint import checkpoint_exists, load_checkpoint, save_checkpoint

_STATE_KEYS = ("z", "r", "logp", "grad", "rng_state", "max_depth_used")
_SAMPLE_KEYS = _STATE_KEYS + ("eps", "inv_mass", "draws", "divs", "done")
_WARMUP_KEYS = _STATE_KEYS + (
    "warmup_done", "da_log_eps", "da_log_eps_bar", "da_h_bar", "da_mu", "da_count",
    "wf_count", "wf_mean", "wf_m2", "inv_mass", "acc_sum", "probe_depths",
)


def _state_dict(state, noise, cap):
    return {"z": state.z, "r": state.r, "logp": state.logp, "grad": state.grad,
            "rng_state": noise.generator.get_state(), "max_depth_used": cap}


def _warmup_state_dict(carry, noise, cap, warmup_done, probe_depths):
    da, wf = carry.da, carry.wf
    return {
        **_state_dict(carry.state, noise, cap), "phase": "warmup", "warmup_done": warmup_done,
        "da_log_eps": da.log_eps, "da_log_eps_bar": da.log_eps_bar, "da_h_bar": da.h_bar, "da_mu": da.mu,
        "da_count": da.count, "wf_count": wf.count, "wf_mean": wf.mean, "wf_m2": wf.m2,
        "inv_mass": carry.metric.inv_mass, "acc_sum": carry.acc_sum, "probe_depths": probe_depths,
    }


def _check_keys(ck, required, path):
    missing = [k for k in required if k not in ck]
    if missing:
        raise ValueError(
            f"checkpoint at {path} is incomplete (missing {missing}); delete it to restart from scratch"
        )


def _restore_state(ck, device):
    return IntegratorState(*(ck[k].to(device) for k in ("z", "r", "logp", "grad")))


def _restore_warmup(ck, device):
    t = {k: v.to(device) if isinstance(v, torch.Tensor) else v for k, v in ck.items()}
    da = adapt.DualAveragingState(t["da_log_eps"], t["da_log_eps_bar"], t["da_h_bar"], t["da_mu"], t["da_count"])
    wf = adapt.WelfordState(t["wf_count"], t["wf_mean"], t["wf_m2"])
    return WarmupCarry(_restore_state(ck, device), da, wf, Metric(t["inv_mass"], False), t["acc_sum"])


def sample_nuts_checkpointed(
    logdensity_fn: Callable,
    key,
    dim: int,
    *,
    checkpoint_path: str,
    num_warmup: int = 1000,
    num_samples: int = 1000,
    num_chains: int = 4,
    chunk_size: int = 200,
    warmup_chunk_size: Optional[int] = None,
    max_depth: int = 10,
    target_accept: float = 0.8,
    init_radius: float = 2.0,
    dtype=None,
    draw_store_path: Optional[str] = None,
    auto_depth: bool = False,
    depth_probe: Optional[int] = None,
    depth_margin: int = 2,
    treedepth_warn_threshold: float = 0.05,
    args=(),
    device=None,
):
    """NUTS with periodic checkpointing; restarts resume automatically.

    ``logdensity_fn(z, *args)`` maps ``(C, dim) -> (C,)``; ``key`` is a
    ``torch.Generator`` of ``device`` (default ``get_config().device``, the
    GPU); its state is checkpointed, and a resumed run sets it to the saved
    state.  ``dtype`` defaults to ``get_config().default_dtype``.

    ``draw_store_path``: also stream each chunk to the native append-only
    draw log (``math_tpu_torch.io.draw_store``) — crash-safe output that
    survives even if the checkpoint directory is lost.

    ``auto_depth=True``: the first ``depth_probe`` warmup steps run at the
    ``max_depth`` ceiling; the cap for the rest of warmup (segmented path)
    and all of sampling is auto-sized from the probe tail's tree-depth
    distribution (``adapt.choose_depth_cap``).  The chosen cap persists in
    the checkpoint so a resumed run continues bit-identically; the sampling
    saturation rate is reported in ``info`` and warned on above
    ``treedepth_warn_threshold``.

    Returns (positions (chains, num_samples, dim), diverging, info dict), as
    numpy arrays (the draws are gathered on the host for the checkpoint).
    """
    if not isinstance(key, torch.Generator):
        raise TypeError("key must be a torch.Generator: its state is part of the checkpoint")
    cfg = get_config()
    device = torch.device(cfg.device if device is None else device)
    dtype = cfg.default_dtype if dtype is None else dtype
    args = tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in args)
    noise = ChainNoise(key, device, dtype)
    logp_grad = LogpGrad(logdensity_fn, args)
    cap = max_depth
    ckpt_seconds, ckpt_count = 0.0, 0

    def checkpoint(state):
        nonlocal ckpt_seconds, ckpt_count
        t0 = time.perf_counter()
        save_checkpoint(checkpoint_path, state)
        ckpt_seconds += time.perf_counter() - t0
        ckpt_count += 1

    resumed = checkpoint_exists(checkpoint_path)
    ck = load_checkpoint(checkpoint_path) if resumed else None
    warming = ck is not None and ck.get("phase") == "warmup"
    with torch.no_grad():
        if ck is not None:
            _check_keys(ck, _WARMUP_KEYS if warming else _SAMPLE_KEYS, checkpoint_path)
            cap = int(ck["max_depth_used"])
        if ck is not None and not warming:
            if ck["draws"].shape[1] != int(ck["done"]):
                raise ValueError(
                    f"checkpoint at {checkpoint_path} is corrupt: 'done'={int(ck['done'])} but draws hold "
                    f"{ck['draws'].shape[1]} samples; delete it to restart from scratch"
                )
            key.set_state(ck["rng_state"])
            states = _restore_state(ck, device)
            eps = ck["eps"].to(device)
            metric = Metric(ck["inv_mass"].to(device), False)
            draws, divs = [ck["draws"].numpy()], [ck["divs"].numpy()]
            done = int(ck["done"])
        else:
            if warming:
                key.set_state(ck["rng_state"])
                carry, s = _restore_warmup(ck, device), int(ck["warmup_done"])
                probe_depths = [ck["probe_depths"].to(device)]
            else:
                z0 = _draw_init(noise, logp_grad, num_chains, dim, init_radius, max_retries=100)
                _raise_on_bad(*_bad_mask(logp_grad, z0))
                carry, s, probe_depths = None, 0, []
            if warmup_chunk_size is None and not warming:
                states, eps, metric, _, wdepths = _warmup_chains(noise, logp_grad, z0, num_warmup, max_depth, target_accept)
                if auto_depth:
                    # monolithic warmup runs whole at the ceiling; the cap
                    # applies to the sampling phase only
                    cap = adapt.choose_depth_cap(wdepths[:, num_warmup // 2:].cpu().numpy(), max_depth, depth_margin)
            else:
                # segmented warmup: the same steps as _warmup_chains, with a
                # checkpoint after each segment
                seg = num_warmup if warmup_chunk_size is None else warmup_chunk_size
                in_slow, window_end = adapt.warmup_schedule(num_warmup)
                if carry is None:
                    carry = _warmup_init(noise, logp_grad, z0)
                probe, probe_tail = (
                    adapt.depth_probe_window(window_end, num_warmup, depth_probe) if auto_depth else (0, 0)
                )
                while s < num_warmup:
                    e = min(s + seg, num_warmup)
                    if auto_depth and s < probe < e:
                        e = probe  # split the segment at the probe boundary
                    carry, seg_depths = _warmup_segment(
                        noise, logp_grad, carry, in_slow[s:e], window_end[s:e], cap, target_accept
                    )
                    if auto_depth and s < probe:
                        probe_depths.append(seg_depths)
                    s = e
                    if auto_depth and s == probe:
                        # tail only: pre-first-metric-window depths reflect the
                        # identity metric and read too deep (adapt.depth_probe_window)
                        d = torch.cat(probe_depths, 1).cpu().numpy()
                        cap = adapt.choose_depth_cap(d[:, -probe_tail:], max_depth, depth_margin)
                    if s < num_warmup:
                        pd = torch.cat(probe_depths, 1) if probe_depths else torch.zeros((num_chains, 0), dtype=torch.int32)
                        checkpoint(_warmup_state_dict(carry, noise, cap, s, pd))
                states, metric = carry.state, carry.metric
                eps = _warmup_step_size(carry.da, num_warmup)
            draws, divs, done = [], [], 0

        store = None
        if draw_store_path is not None:
            from math_tpu_torch.io.draw_store import DrawStore

            store = DrawStore(draw_store_path, num_chains, dim, np.float64 if dtype == torch.float64 else np.float32)

        n_leapfrog = 0
        sat_hits, sat_total = 0, 0
        pilot_pending = auto_depth and done == 0 and num_samples > chunk_size
        try:
            while done < num_samples:
                n = min(chunk_size, num_samples - done)
                states, zs, stats = _sample_chains(noise, logp_grad, states, eps, metric, n, cap)
                zs, div, td_np = zs.cpu().numpy(), stats.diverging.cpu().numpy(), stats.tree_depth.cpu().numpy()
                n_leapfrog += int(stats.n_leapfrog.sum())
                sat_hits += int((td_np >= cap).sum())
                sat_total += td_np.size
                if pilot_pending:
                    # sampling-phase pilot re-size (as the reference): a pilot
                    # that saturates its own cap past the warn threshold
                    # escalates the cap and the next chunk re-checks
                    sat = float((td_np >= cap).mean())
                    if sat > treedepth_warn_threshold and cap < max_depth:
                        new_cap = max(cap + 1, adapt.choose_depth_cap(td_np, max_depth, depth_margin))
                    else:
                        new_cap = min(cap, adapt.choose_depth_cap(td_np, cap, depth_margin))
                        pilot_pending = False
                    cap = new_cap
                draws.append(zs)
                divs.append(div)
                done += n
                if store is not None:
                    store.append(zs.transpose(1, 0, 2))  # (n, chains, dim)
                checkpoint({
                    **_state_dict(states, noise, cap), "phase": "sample", "eps": eps, "inv_mass": metric.inv_mass,
                    "draws": np.concatenate(draws, axis=1), "divs": np.concatenate(divs, axis=1), "done": done,
                })
        finally:
            if store is not None:
                store.close()

    if draws:
        positions = np.concatenate(draws, axis=1)[:, :num_samples]
        diverging = np.concatenate(divs, axis=1)[:, :num_samples]
    else:
        positions = np.zeros((num_chains, 0, dim), np.float64 if dtype == torch.float64 else np.float32)
        diverging = np.zeros((num_chains, 0), bool)
    info = {
        "step_size": eps.cpu().numpy(),
        "inv_mass": metric.inv_mass.cpu().numpy(),
        # sampling-phase leapfrogs executed by this call (telemetry only; not
        # checkpointed, so a resumed run counts from its restart)
        "n_leapfrog": n_leapfrog,
        "n_grad_calls": logp_grad.calls,  # chain-batched gradient evaluations of this call
        "resumed": resumed,
        "max_depth_used": cap,
        "treedepth_hit_rate": sat_hits / sat_total if sat_total else 0.0,
        "checkpoint_seconds": ckpt_seconds,
        "checkpoints_written": ckpt_count,
    }
    if auto_depth and sat_total:
        adapt.warn_on_saturation_rate(sat_hits / sat_total, cap, treedepth_warn_threshold)
    return positions, diverging, info
