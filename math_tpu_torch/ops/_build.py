"""Build and load the CUDA kernels under ``math_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is compiled
with ``nvcc`` for ``sm_90a`` into a shared library in the (git-ignored) build
directory of ``get_config().kernel_build_dir`` and loaded with ``ctypes``; the
library's name carries a hash of the source and of every header it includes
(``#include "x.cuh"``, recursively), so an edited source or header is rebuilt.
``nvcc`` runs with ``-Xptxas -v``; its report of each kernel's registers,
shared memory and spills is kept in ``BUILD_LOG``.
Nothing is built when a module is imported, and nothing here falls back to
another implementation: without ``nvcc`` the load raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

from math_tpu_torch.config import get_config

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.M)

_loaded: dict = {}
BUILD_SECONDS: dict = {}
BUILD_LOG: dict = {}


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


def sources_of(path: str, seen=None) -> list:
    """``path`` and the files it includes by a quoted name, recursively, each once."""
    seen = [] if seen is None else seen
    path = os.path.abspath(path)
    if path in seen:
        return seen
    seen.append(path)
    with open(path, encoding="utf-8") as f:
        text = f.read()
    for inc in _INCLUDE.findall(text):
        sources_of(os.path.join(os.path.dirname(path), inc), seen)
    return seen


def library_path(name: str) -> str:
    h = hashlib.sha256()
    for path in sources_of(source_path(name)):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(get_config().kernel_build_dir, f"lib{name}_{h.hexdigest()[:16]}.so")


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
    BUILD_LOG[name] = out
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
