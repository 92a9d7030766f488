"""The port's native data reader (``data/native_io.py`` over the repo's
``native/dataio.cpp``, built into ``build/native/``) against the NumPy
path and against the JAX package's reader on the same files: the cases of
JAX's ``tests/test_native_io.py``, bitwise for the parsers, the JAX test's
tolerances for the normalization (the library's FMA contraction)."""

import gzip
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from byzantine_aircomp_tpu.data import native_io as jnative
from byzantine_aircomp_tpu_torch.data import datasets as tdata
from byzantine_aircomp_tpu_torch.data import native_io

REPO = Path(__file__).resolve().parents[1]


def _write_idx(path, arr: np.ndarray):
    with open(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, 0x08, arr.ndim))
        for d in arr.shape:
            f.write(struct.pack(">I", d))
        f.write(arr.astype(np.uint8).tobytes())


def _write_cifar(path, images, labels):
    with open(path, "wb") as f:
        for i in range(len(labels)):
            f.write(bytes([labels[i]]))
            f.write(images[i].tobytes())


@pytest.fixture
def lib():
    lib = native_io.library()
    assert lib is not None, native_io.describe()  # g++ and zlib are here
    return lib


def test_the_library_is_built_into_build_native(lib):
    so = native_io.lib_path()
    assert so.exists() and so.parent == REPO / "build" / "native"
    assert so.name.startswith("libaircomp_dataio.") and so.name.endswith(".so")
    assert native_io.describe().startswith("native C++ (build/native/libaircomp_dataio.")
    # never into the pre-port native/ directory's build rule
    assert native_io.BUILD_DIR == REPO / "build" / "native"


def test_read_idx_roundtrip(lib, tmp_path):
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 256, size=(17, 28, 28), dtype=np.uint8)
    p = str(tmp_path / "images-idx3-ubyte")
    _write_idx(p, arr)
    out = native_io.read_idx(p)
    assert out is not None and out.shape == arr.shape
    np.testing.assert_array_equal(out, arr)
    np.testing.assert_array_equal(out, jnative.read_idx(p))


def test_read_idx_gzip(lib, tmp_path):
    rng = np.random.default_rng(1)
    arr = rng.integers(0, 256, size=(9,), dtype=np.uint8)
    raw = struct.pack(">HBB", 0, 0x08, 1) + struct.pack(">I", 9) + arr.tobytes()
    p = str(tmp_path / "labels-idx1-ubyte.gz")
    with gzip.open(p, "wb") as f:
        f.write(raw)
    out = native_io.read_idx(p)
    assert out is not None
    np.testing.assert_array_equal(out, arr)
    np.testing.assert_array_equal(out, jnative.read_idx(p))


def test_read_idx_corrupt(lib, tmp_path):
    p = str(tmp_path / "bad")
    with open(p, "wb") as f:
        f.write(b"\xff\xff\xff\xff garbage")
    assert native_io.read_idx(p) is None
    assert native_io.read_idx(str(tmp_path / "missing")) is None


def test_read_idx_overflow_dims(lib, tmp_path):
    """Dims whose product overflows int64 must fail cleanly, not wrap."""
    p = str(tmp_path / "overflow")
    with open(p, "wb") as f:
        f.write(struct.pack(">HBB", 0, 0x08, 4))
        for _ in range(4):
            f.write(struct.pack(">I", 65536))
    assert native_io.read_idx(p) is None
    p2 = str(tmp_path / "zerodim")
    with open(p2, "wb") as f:
        f.write(struct.pack(">HBB", 0, 0x08, 2))
        f.write(struct.pack(">I", 0))
        f.write(struct.pack(">I", 10))
    assert native_io.read_idx(p2) is None


def test_read_cifar_bin(lib, tmp_path):
    rng = np.random.default_rng(2)
    n = 11
    labels = rng.integers(0, 10, size=n, dtype=np.uint8)
    images = rng.integers(0, 256, size=(n, 3, 32, 32), dtype=np.uint8)
    p = str(tmp_path / "data_batch_1.bin")
    _write_cifar(p, images, labels)
    out = native_io.read_cifar_bin(p)
    assert out is not None
    np.testing.assert_array_equal(out[0], images)
    np.testing.assert_array_equal(out[1], labels)
    want = jnative.read_cifar_bin(p)
    np.testing.assert_array_equal(out[0], want[0])
    np.testing.assert_array_equal(out[1], want[1])


def test_normalize_scalar_matches_numpy(lib):
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, size=(100, 28, 28), dtype=np.uint8)
    native = native_io.normalize_u8(x, 0.1307, 0.3081)
    ref = ((x.astype(np.float32) / 255.0) - 0.1307) / 0.3081
    assert native is not None
    np.testing.assert_allclose(native, ref, rtol=1e-6)
    np.testing.assert_array_equal(native, jnative.normalize_u8(x, 0.1307, 0.3081))


def test_normalize_per_channel_matches_numpy(lib):
    rng = np.random.default_rng(4)
    x = rng.integers(0, 256, size=(50, 32, 32, 3), dtype=np.uint8)
    mean = (0.4914, 0.4822, 0.4465)
    std = (0.2470, 0.2435, 0.2616)
    native = native_io.normalize_u8(x, mean, std)
    ref = ((x.astype(np.float32) / 255.0) - np.asarray(mean, np.float32)) / np.asarray(
        std, np.float32)
    assert native is not None
    # the library's FMA contraction against NumPy's strict order: ~1e-7 abs
    np.testing.assert_allclose(native, ref, rtol=2e-4, atol=1e-6)


def test_normalize_shape_mismatch_returns_none(lib):
    x = np.zeros((4, 32, 32, 3), np.uint8)
    assert native_io.normalize_u8(x, (0.5, 0.5), (0.2, 0.2)) is None


def test_datasets_use_native_when_available(lib, tmp_path, monkeypatch):
    """``_read_idx`` and ``_read_cifar_bin`` give the same bytes through
    either path."""
    rng = np.random.default_rng(5)
    arr = rng.integers(0, 256, size=(7, 28, 28), dtype=np.uint8)
    p = str(tmp_path / "f-idx3-ubyte")
    _write_idx(p, arr)
    labels = rng.integers(0, 10, size=5, dtype=np.uint8)
    images = rng.integers(0, 256, size=(5, 3, 32, 32), dtype=np.uint8)
    c = str(tmp_path / "data_batch_1.bin")
    _write_cifar(c, images, labels)
    via_native = tdata._read_idx(p), tdata._read_cifar_bin(c)
    monkeypatch.setenv("AIRCOMP_NO_NATIVE", "1")
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_lib_attempted", False)
    via_python = tdata._read_idx(p), tdata._read_cifar_bin(c)
    assert native_io.library() is None
    assert native_io.describe() == "numpy (AIRCOMP_NO_NATIVE is set)"
    np.testing.assert_array_equal(via_native[0], via_python[0])
    for a, b in zip(via_native[1], via_python[1]):
        np.testing.assert_array_equal(a, b)


def test_a_disk_data_set_names_its_reader(lib, tmp_path, monkeypatch):
    """MNIST from IDX files under a data root loads through the native
    reader, equal to the JAX package's load, and says so; the synthetic
    set reads no file."""
    from byzantine_aircomp_tpu.data import datasets as jdata

    rng = np.random.default_rng(6)
    root = tmp_path / "dataset"
    root.mkdir()
    for split, n in (("train", 20), ("t10k", 10)):
        _write_idx(str(root / f"{split}-images-idx3-ubyte"),
                   rng.integers(0, 256, size=(n, 28, 28), dtype=np.uint8))
        _write_idx(str(root / f"{split}-labels-idx1-ubyte"),
                   rng.integers(0, 10, size=(n,), dtype=np.uint8))
    monkeypatch.setattr(tdata, "DATA_ROOTS", (str(root),))
    monkeypatch.setattr(jdata, "DATA_ROOTS", (str(root),))
    port, want = tdata.load("mnist"), jdata.load("mnist")
    assert port.source == "disk" and port.reader.startswith("native C++")
    for key in ("x_train", "y_train", "x_val", "y_val", "x_train_raw"):
        np.testing.assert_array_equal(getattr(port, key), getattr(want, key))
    assert tdata.load("mnist_hard", synthetic_train=20, synthetic_val=10).reader.startswith(
        "none")


def test_a_run_logs_its_reader(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "byzantine_aircomp_tpu_torch", "--device", "cpu", "--agg",
         "gm2", "--K", "4", "--rounds", "1", "--interval", "1", "--no-eval-train",
         "--dataset", "mnist_hard"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[data reader ]   none (synthetic data, no file read)" in proc.stdout
    assert "[kernels     ]   aggImpl=xla (plain torch versions)" in proc.stdout


def test_a_compiler_without_openmp_builds_it_serial(tmp_path, monkeypatch):
    """A g++ with no OpenMP runtime (it cannot read libgomp.spec) fails the
    Makefile's -fopenmp build: the library is built without it, reads the
    same bytes, and says so; a compiler that cannot build at all leaves the
    NumPy path, with the reason."""
    cxx = tmp_path / "g++-no-openmp"
    cxx.write_text('#!/bin/sh\nfor a in "$@"; do [ "$a" = -fopenmp ] && '
                   '{ echo "fatal error: cannot read spec file libgomp.spec" >&2; exit 1; }; '
                   'done\nexec g++ "$@"\n')
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(native_io, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_lib_attempted", False)
    assert native_io.library() is not None
    assert native_io.describe().endswith("without OpenMP)")
    assert native_io.lib_path(openmp=False).exists() and not native_io.lib_path().exists()
    rng = np.random.default_rng(7)
    arr = rng.integers(0, 256, size=(5, 28, 28), dtype=np.uint8)
    p = str(tmp_path / "x-idx3-ubyte")
    _write_idx(p, arr)
    np.testing.assert_array_equal(native_io.read_idx(p), arr)
    x = rng.integers(0, 256, size=(9, 28, 28), dtype=np.uint8)
    np.testing.assert_allclose(native_io.normalize_u8(x, 0.1307, 0.3081),
                               ((x.astype(np.float32) / 255.0) - 0.1307) / 0.3081, rtol=1e-6)
    monkeypatch.setenv("CXX", "/bin/false")
    monkeypatch.setattr(native_io, "BUILD_DIR", tmp_path / "none")
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_lib_attempted", False)
    assert native_io.library() is None
    assert native_io.describe().startswith("numpy (/bin/false exited 1")
