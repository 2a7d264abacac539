"""Checkpoint / resume for long sampling runs.

Counterpart: ``math_tpu/io/checkpoint.py``, which saves a pytree with orbax.
Here a checkpoint is a directory holding one file, ``state.pt``: a
``torch.save`` of a plain dict whose values are tensors (moved to the CPU),
numpy arrays (stored as tensors) and Python numbers, with the sampler's
generator state among them (``torch.Generator.get_state()``, a CUDA
generator's too).  It loads with ``weights_only=True`` on any machine.

Writes are atomic: the new state goes to a temporary name beside the old one
and is renamed over it with ``os.replace``, and a first checkpoint is written
into a temporary directory that is renamed into place.  A kill mid-write
leaves the last checkpoint whole, and ``checkpoint_exists`` (the directory
exists, as in the JAX package) never sees a directory without its state.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict

import numpy as np
import torch

STATE_FILE = "state.pt"


def _plain(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    if isinstance(v, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(v))  # a contiguous copy; 0-d stays 0-d
    return v


def save_checkpoint(path: str, state: Dict[str, Any]) -> None:
    """Atomically persist a dict of tensors, numpy arrays and numbers."""
    path = os.path.abspath(path)
    plain = {k: _plain(v) for k, v in state.items()}
    tag = f".tmp{os.getpid()}"
    if os.path.isdir(path):
        tmp = os.path.join(path, STATE_FILE + tag)
        torch.save(plain, tmp)
        os.replace(tmp, os.path.join(path, STATE_FILE))
        return
    tmp_dir = path + tag
    shutil.rmtree(tmp_dir, ignore_errors=True)
    os.makedirs(tmp_dir)
    torch.save(plain, os.path.join(tmp_dir, STATE_FILE))
    os.replace(tmp_dir, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The dict ``save_checkpoint`` wrote (arrays come back as CPU tensors)."""
    path = os.path.abspath(path)
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)


def checkpoint_exists(path: str) -> bool:
    return os.path.isdir(os.path.abspath(path))
