"""Build and load the CUDA kernels under ``math_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is compiled
with ``nvcc`` for ``sm_90a`` into a shared library in the (git-ignored) build
directory of ``get_config().kernel_build_dir`` and loaded with ``ctypes``; the
library's name carries a hash of the source, so an edited source is rebuilt.
Nothing is built when a module is imported, and nothing here falls back to
another implementation: without ``nvcc`` the load raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

from math_tpu_torch.config import get_config

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict = {}
BUILD_SECONDS: dict = {}


class KernelCompileError(RuntimeError):
    """The CUDA source could not be compiled or loaded."""


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, the PATH, then /usr/local/cuda."""
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise KernelCompileError(
        "nvcc not found (looked in $CUDA_HOME/bin, the PATH and /usr/local/cuda/bin): "
        "the CUDA kernels of math_tpu_torch are compiled from csrc/*.cu at first use "
        "and have no substitute on a CUDA tensor"
    )


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, name + ".cu")


def library_path(name: str) -> str:
    with open(source_path(name), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(get_config().kernel_build_dir, f"lib{name}_{digest}.so")


def start_build(name: str):
    """Start ``nvcc`` for one source; returns ``(process, tmp_path, lib_path,
    t0)`` or None when the library is already built.  Several sources can be
    started together and collected with ``finish_build``."""
    lib = library_path(name)
    if os.path.exists(lib):
        return None
    nvcc = find_nvcc()
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, source_path(name)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib, time.perf_counter()


def finish_build(name: str, started) -> str:
    if started is None:
        return library_path(name)
    proc, tmp, lib, t0 = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise KernelCompileError(f"nvcc failed on {source_path(name)} (exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    return lib


def load_library(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built if need be."""
    if name not in _loaded:
        lib = finish_build(name, start_build(name))
        try:
            _loaded[name] = ctypes.CDLL(lib)
        except OSError as e:
            raise KernelCompileError(f"cannot load {lib}: {e}") from e
    return _loaded[name]
