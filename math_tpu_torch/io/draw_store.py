"""ctypes bindings for the native C++ draw store (``native/draw_store.cc``).

Counterpart: ``math_tpu/io/draw_store.py``, with the same on-disk format
byte for byte, so a file written by either package reads in the other.

The shared library is built at first use (never at import) from the repo's
one source, ``native/draw_store.cc``, with ``g++`` into the git-ignored build
directory of the port's kernels (``MATH_TPU_TORCH_BUILD_DIR``, else
``get_config().kernel_build_dir``); its name carries a hash of the source and
the flags, so an edited source is rebuilt.  Where there is no C++ compiler or
no source, a numpy writer and reader implement the same format, as in the JAX
package, so the API always works; ``native_available()`` says which runs.

Format (little-endian): a header ``"MTDS" | u32 version | u32 element size
(4 or 8) | u32 pad | u64 n_chains | u64 dim``, then records ``u64 n_draws |
payload (n_draws * n_chains * dim elements, draw-major) | u32 crc32(payload)``.
A torn or corrupt final record is dropped on read.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import zlib
from typing import Optional

import numpy as np

from math_tpu_torch.config import get_config

_SOURCE = os.path.abspath(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "native", "draw_store.cc")
)
_CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")

_MAGIC = b"MTDS"
_HEADER = np.dtype(
    [
        ("magic", "S4"),
        ("version", "<u4"),
        ("dtype", "<u4"),
        ("pad", "<u4"),
        ("n_chains", "<u8"),
        ("dim", "<u8"),
    ]
)

_libs: dict = {}  # library path -> CDLL, or None where it could not be built


def _build_dir() -> str:
    return os.environ.get("MATH_TPU_TORCH_BUILD_DIR") or get_config().kernel_build_dir


def _library_path() -> str:
    h = hashlib.sha256()
    with open(_SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_CXX_FLAGS).encode())
    return os.path.join(_build_dir(), f"libdraw_store_{h.hexdigest()[:16]}.so")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.mtds_writer_open.restype = ctypes.c_void_p
    lib.mtds_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint32]
    lib.mtds_writer_append.restype = ctypes.c_int
    lib.mtds_writer_append.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
    lib.mtds_writer_close.restype = None
    lib.mtds_writer_close.argtypes = [ctypes.c_void_p]
    lib.mtds_read_meta.restype = ctypes.c_int
    lib.mtds_read_meta.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.mtds_read_all.restype = ctypes.c_int64
    lib.mtds_read_all.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    return lib


def _build(lib_path: str) -> Optional[ctypes.CDLL]:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None or not os.path.isfile(_SOURCE):
        return None
    if not os.path.exists(lib_path):
        os.makedirs(os.path.dirname(lib_path), exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        done = subprocess.run([cxx, *_CXX_FLAGS, "-o", tmp, _SOURCE], capture_output=True)
        if done.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            return None
        os.replace(tmp, lib_path)
    try:
        return _bind(ctypes.CDLL(lib_path))
    except OSError:
        return None


def _native() -> Optional[ctypes.CDLL]:
    """The native library, built at first use; None where it cannot be."""
    if not os.path.isfile(_SOURCE):
        return None
    lib_path = _library_path()
    if lib_path not in _libs:
        _libs[lib_path] = _build(lib_path)
    return _libs[lib_path]


def native_available() -> bool:
    return _native() is not None


class DrawStore:
    """Append-only crash-safe draw log: (n_draws, n_chains, dim) arrays."""

    def __init__(self, path: str, n_chains: int, dim: int, dtype=np.float32):
        self.path = path
        self.n_chains = int(n_chains)
        self.dim = int(dim)
        self.dtype = np.dtype(dtype)
        if self.dtype.itemsize not in (4, 8):
            raise ValueError("dtype must be float32 or float64")
        self._lib = _native()
        self._handle = None
        self._file = None
        if self._lib is not None:
            self._handle = self._lib.mtds_writer_open(path.encode(), self.n_chains, self.dim, self.dtype.itemsize)
            if not self._handle:
                raise OSError(f"cannot open draw store {path}")
        else:
            self._file = open(path, "ab")
            if self._file.tell() == 0:
                h = np.zeros((), _HEADER)
                h["magic"] = _MAGIC
                h["version"] = 1
                h["dtype"] = self.dtype.itemsize
                h["n_chains"] = self.n_chains
                h["dim"] = self.dim
                self._file.write(h.tobytes())
                self._file.flush()

    @property
    def native(self) -> bool:
        """Whether this store writes through the native library."""
        return self._handle is not None

    def append(self, draws) -> None:
        """draws: (n_draws, n_chains, dim) array."""
        arr = np.ascontiguousarray(draws, dtype=self.dtype)
        if arr.ndim != 3 or arr.shape[1:] != (self.n_chains, self.dim):
            raise ValueError(f"expected (n, {self.n_chains}, {self.dim}), got {arr.shape}")
        n = arr.shape[0]
        if self._handle is not None:
            rc = self._lib.mtds_writer_append(self._handle, arr.ctypes.data_as(ctypes.c_void_p), n)
            if rc != 0:
                raise OSError(f"draw store append failed rc={rc}")
        else:
            payload = arr.tobytes()
            self._file.write(np.uint64(n).tobytes())
            self._file.write(payload)
            self._file.write(np.uint32(zlib.crc32(payload)).tobytes())
            self._file.flush()

    def close(self) -> None:
        if self._handle is not None:
            self._lib.mtds_writer_close(self._handle)
            self._handle = None
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _read_native(lib, path: str) -> np.ndarray:
    nc, dim, es, nd = ctypes.c_uint64(), ctypes.c_uint64(), ctypes.c_uint32(), ctypes.c_uint64()
    rc = lib.mtds_read_meta(path.encode(), ctypes.byref(nc), ctypes.byref(dim), ctypes.byref(es), ctypes.byref(nd))
    if rc != 0:
        raise OSError(f"cannot read draw store {path} rc={rc}")
    dt = np.float32 if es.value == 4 else np.float64
    out = np.empty((nd.value, nc.value, dim.value), dtype=dt)
    got = lib.mtds_read_all(path.encode(), out.ctypes.data_as(ctypes.c_void_p))
    if got < 0:
        raise OSError(f"draw store read failed rc={got}")
    return out[: int(got)]


def _read_numpy(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        h = np.frombuffer(f.read(_HEADER.itemsize), _HEADER)[0]
        if bytes(h["magic"]) != _MAGIC:
            raise OSError("bad draw store header")
        dt = np.float32 if h["dtype"] == 4 else np.float64
        n_chains, dim = int(h["n_chains"]), int(h["dim"])
        rec = n_chains * dim * int(h["dtype"])
        chunks = []
        while True:
            head = f.read(8)
            if len(head) < 8:
                break
            n = int(np.frombuffer(head, "<u8")[0])
            payload = f.read(n * rec)
            crc_b = f.read(4)
            if len(payload) < n * rec or len(crc_b) < 4:
                break
            if zlib.crc32(payload) != int(np.frombuffer(crc_b, "<u4")[0]):
                break
            chunks.append(np.frombuffer(payload, dt).reshape(n, n_chains, dim))
        if not chunks:
            return np.empty((0, n_chains, dim), dt)
        return np.concatenate(chunks, axis=0)


def read_draws(path: str) -> np.ndarray:
    """Read all complete chunks; returns (n_draws, n_chains, dim)."""
    lib = _native()
    return _read_native(lib, path) if lib is not None else _read_numpy(path)
