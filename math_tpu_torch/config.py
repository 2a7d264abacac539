"""Typed runtime configuration (counterpart: ``math_tpu/config.py``).

One typed object, no compile-time forks.  The JAX package's
``KernelThresholds`` (plain-XLA versus Pallas dispatch) has no twin yet: on a
CUDA tensor a dispatcher always launches its hand-written kernel, and
thresholds come back only once they have been measured on the GPU the port
runs on.  The sampling, mesh and profiling fields of the JAX ``Config`` come
with the modules that read them.
"""

from __future__ import annotations

import dataclasses
import os
import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Config:
    # numerics
    default_dtype: torch.dtype = torch.float32
    # where entry points run unless the caller says otherwise
    device: str = "cuda"
    # kernels: the CUDA sources under ``csrc/`` are compiled at first use
    # into this directory (git-ignored)
    kernel_build_dir: str = os.environ.get(
        "MATH_TPU_TORCH_BUILD_DIR", os.path.join(_PKG_DIR, "_build")
    )
    # diagonal-block size of the blocked Cholesky (``ops/chol_blocked.py``).
    # The block kernel keeps one (B, B) float32 residual/U and one W per thread
    # block in shared memory: 2 * 64 KB at B = 128, inside the 227 KB a Hopper
    # block may use.  The JAX package's 256 (2 * 256 KB) does not fit; 170 is
    # the most that does.  There is no size threshold below which another
    # factorization is taken: a smaller matrix is one block of its own size.
    cholesky_block_size: int = 128


_config = Config()


def get_config() -> Config:
    return _config


def update_config(**kwargs) -> Config:
    global _config
    _config = dataclasses.replace(_config, **kwargs)
    return _config
