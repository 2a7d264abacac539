"""PyTorch port: ``io/draw_store.py``, the twins of ``tests/test_draw_store.py``
(round trip, reopen, torn record, corrupt CRC, shape validation,
native/numpy parity), and the format across the two packages: a file the
port writes is read by ``math_tpu.io.draw_store.read_draws`` and the reverse,
with equal arrays.  The native library is built with ``g++`` into a
temporary directory named by ``MATH_TPU_TORCH_BUILD_DIR``, so the tests leave
nothing in the tree.
"""

import os

import numpy as np
import pytest

from math_tpu.io import draw_store as jds

from math_tpu_torch.io import draw_store as ds
from torch_threads import one_torch_thread  # noqa: F401,E402  (one torch thread a module)


@pytest.fixture(scope="module", autouse=True)
def build_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("draw_store_build"))
    old = os.environ.get("MATH_TPU_TORCH_BUILD_DIR")
    os.environ["MATH_TPU_TORCH_BUILD_DIR"] = d
    try:
        yield d
    finally:
        if old is None:
            del os.environ["MATH_TPU_TORCH_BUILD_DIR"]
        else:
            os.environ["MATH_TPU_TORCH_BUILD_DIR"] = old


def test_native_library_builds_into_the_build_dir(build_dir):
    assert ds.native_available(), "g++ build of native/draw_store.cc failed"
    assert os.path.dirname(ds._library_path()) == build_dir
    assert os.path.isfile(ds._library_path())
    with ds.DrawStore(os.path.join(build_dir, "probe.mtds"), 1, 1) as w:
        assert w.native


def test_round_trip(tmp_path):
    path = str(tmp_path / "draws.mtds")
    rng = np.random.default_rng(0)
    a = rng.normal(size=(10, 4, 3)).astype(np.float32)
    b = rng.normal(size=(5, 4, 3)).astype(np.float32)
    with ds.DrawStore(path, 4, 3, np.float32) as w:
        w.append(a)
        w.append(b)
    np.testing.assert_array_equal(ds.read_draws(path), np.concatenate([a, b], axis=0))


def test_append_reopen(tmp_path):
    path = str(tmp_path / "draws.mtds")
    a = np.ones((3, 2, 2), np.float64)
    with ds.DrawStore(path, 2, 2, np.float64) as w:
        w.append(a)
    with ds.DrawStore(path, 2, 2, np.float64) as w:
        w.append(2 * a)
    out = ds.read_draws(path)
    assert out.shape == (6, 2, 2) and out.dtype == np.float64
    np.testing.assert_array_equal(out[3:], 2 * a)


def test_torn_record_recovery(tmp_path):
    """A crash mid-write must not lose earlier chunks."""
    path = str(tmp_path / "draws.mtds")
    a = np.full((4, 2, 2), 7.0, np.float32)
    with ds.DrawStore(path, 2, 2, np.float32) as w:
        w.append(a)
    with open(path, "ab") as f:  # a torn final record: says 10 draws, payload cut
        f.write(np.uint64(10).tobytes())
        f.write(b"\x00" * 13)
    np.testing.assert_array_equal(ds.read_draws(path), a)


def test_corrupt_crc_dropped(tmp_path):
    path = str(tmp_path / "draws.mtds")
    a = np.full((2, 1, 2), 1.0, np.float32)
    with ds.DrawStore(path, 1, 2, np.float32) as w:
        w.append(a)
        w.append(3 * a)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:  # flip a payload byte of the second record
        f.seek(size - 8)
        f.write(b"\xff")
    np.testing.assert_array_equal(ds.read_draws(path), a)  # only the first chunk survives


def test_shape_validation(tmp_path):
    with ds.DrawStore(str(tmp_path / "draws.mtds"), 2, 3) as w:
        with pytest.raises(ValueError):
            w.append(np.zeros((1, 3, 2)))


def test_python_fallback_format_parity(tmp_path, monkeypatch):
    """Files written natively read through the numpy reader and the reverse,
    and both writers give the same bytes."""
    a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    path1 = str(tmp_path / "n.mtds")
    with ds.DrawStore(path1, 3, 4, np.float32) as w:
        assert w.native
        w.append(a)
    monkeypatch.setattr(ds, "_native", lambda: None)
    np.testing.assert_array_equal(ds.read_draws(path1), a)
    path2 = str(tmp_path / "p.mtds")
    with ds.DrawStore(path2, 3, 4, np.float32) as w:
        assert not w.native
        w.append(a)
    monkeypatch.undo()
    np.testing.assert_array_equal(ds.read_draws(path2), a)
    with open(path1, "rb") as f1, open(path2, "rb") as f2:
        assert f1.read() == f2.read()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_files_cross_packages(tmp_path, dtype):
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(3, 5, 2)).astype(dtype), rng.normal(size=(4, 5, 2)).astype(dtype)
    ours, theirs = str(tmp_path / "port.mtds"), str(tmp_path / "ref.mtds")
    with ds.DrawStore(ours, 5, 2, dtype) as w:
        w.append(a)
        w.append(b)
    with jds.DrawStore(theirs, 5, 2, dtype) as w:
        w.append(a)
        w.append(b)
    want = np.concatenate([a, b])
    np.testing.assert_array_equal(jds.read_draws(ours), want)
    np.testing.assert_array_equal(ds.read_draws(theirs), want)
    with open(ours, "rb") as f1, open(theirs, "rb") as f2:
        assert f1.read() == f2.read()
