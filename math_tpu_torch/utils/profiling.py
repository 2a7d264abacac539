"""Profiling / tracing hooks.

Counterpart: ``math_tpu/utils/profiling.py``.  The reference has no built-in
profiler (SURVEY.md §5.1); here, as in the JAX package, tracing is
first-class: a named range in ``torch.profiler``'s trace (a
``record_function``, which a ``torch.profiler`` trace shows beside the CUDA
kernels it launched) plus a wall-clock span registry for host-side telemetry.
A span adds no ``torch.cuda.synchronize()``: on the card its wall time is the
host's enqueue time unless the code inside waits for the device itself.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

_spans: Dict[str, list] = defaultdict(list)


@contextlib.contextmanager
def span(name: str):
    """Wall-clock span; also a ``torch.profiler.record_function`` range."""
    with torch.profiler.record_function(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _spans[name].append(time.perf_counter() - t0)


def span_stats() -> Dict[str, dict]:
    out = {}
    for name, times in _spans.items():
        out[name] = {
            "count": len(times),
            "total_s": sum(times),
            "mean_s": sum(times) / len(times),
        }
    return out


def reset_spans():
    _spans.clear()


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Capture a ``torch.profiler`` trace of the host and, where there is a
    GPU, the CUDA kernels, written into ``log_dir`` (a Chrome trace that
    TensorBoard's profiler plugin and ``chrome://tracing`` open); the default
    directory is ``math_tpu_torch_trace`` under the temporary directory.
    Yields the directory."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "math_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield log_dir
