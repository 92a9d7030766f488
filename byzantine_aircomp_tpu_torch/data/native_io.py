"""ctypes bindings for the repository's native C++ data reader.

The port's copy of ``byzantine_aircomp_tpu/data/native_io.py``: the same
entry points (:func:`read_idx`, :func:`read_cifar_bin`,
:func:`normalize_u8`) over the same C ABI of ``native/dataio.cpp`` (an
OpenMP C++ library that parses IDX, plain or gzip, and CIFAR-10 binary
batches, and does the uint8 -> normalized float32 transform).

The port builds its own copy of the library with ``g++`` and the flags of
``native/Makefile`` into ``build/native/`` at the repository root (never
into ``native/``), at first use.  Where the compiler has no OpenMP runtime
it builds the same source without ``-fopenmp`` (its loops then run on one
thread; the results are the same).  The file's name carries a digest of
the source, the flags and the host's CPU (``-march=native`` code does not
run on another CPU), so an edited source or a checkout copied to another
machine builds afresh.

Every entry point returns None when the library cannot be built or loaded
(no compiler, no zlib, a read-only checkout), and the callers in
:mod:`.datasets` then take their NumPy path, the JAX package's own
fallback; ``AIRCOMP_NO_NATIVE=1`` forces that path.  :func:`describe`
names the reader a run used, for its log.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "dataio.cpp"
BUILD_DIR = ROOT / "build" / "native"
SO_NAME = "libaircomp_dataio.so"
# native/Makefile's CXXFLAGS and LDFLAGS
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-fopenmp", "-Wall", "-Wextra")
LDFLAGS = ("-shared", "-fopenmp", "-lz")

_lib: Optional[ctypes.CDLL] = None
_lib_attempted = False
# why the library is not loaded (None while it is, or before a try)
_why_not: Optional[str] = None
# whether the loaded library was built without OpenMP
_serial = False


def _host_cpu() -> str:
    """The host CPU's model and feature flags, as ``-march=native`` sees
    them (the machine name where /proc/cpuinfo is not there)."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
        return "".join(sorted(set(lines)))
    except OSError:
        return platform.machine()


def lib_path(openmp: bool = True) -> Path:
    """Where the library for this source, these flags and this CPU lives."""
    key = hashlib.sha256(SOURCE.read_bytes() + repr((CXXFLAGS, LDFLAGS, openmp)).encode()
                         + _host_cpu().encode()).hexdigest()[:12]
    return BUILD_DIR / f"{SO_NAME[:-3]}.{key}.so"


def _compile(so_path: Path, openmp: bool) -> Optional[str]:
    """Build ``so_path``; None on success, else why not."""
    drop = () if openmp else ("-fopenmp",)
    cxxflags = [f for f in CXXFLAGS if f not in drop]
    ldflags = [f for f in LDFLAGS if f not in drop]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private name, then an atomic rename: concurrent builders never load
    # a half-written library
    tmp = BUILD_DIR / f".{so_path.name}.{os.getpid()}"
    cmd = [os.environ.get("CXX", "g++"), *cxxflags, str(SOURCE), *ldflags, "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        return f"{cmd[0]} failed to run: {e}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"{cmd[0]} exited {proc.returncode}: {proc.stderr.strip()[-300:]}"
    os.replace(tmp, so_path)
    return None


def _build() -> Optional[Path]:
    """Compile ``native/dataio.cpp`` into ``build/native/`` unless this
    host's copy is there (with OpenMP, else without); the library's path,
    or None."""
    global _why_not, _serial
    if not SOURCE.exists():
        _why_not = f"{SOURCE} is missing"
        return None
    errors = []
    for openmp in (True, False):
        so_path = lib_path(openmp)
        if so_path.exists() or (err := _compile(so_path, openmp)) is None:
            _serial = not openmp
            return so_path
        errors.append(err)
    _why_not = "; ".join(errors)
    return None


def library() -> Optional[ctypes.CDLL]:
    """The loaded native library, building it on first use; None if
    unavailable."""
    global _lib, _lib_attempted, _why_not
    if _lib is not None or _lib_attempted:
        return _lib
    _lib_attempted = True
    if os.environ.get("AIRCOMP_NO_NATIVE"):
        _why_not = "AIRCOMP_NO_NATIVE is set"
        return None
    so_path = _build()
    if so_path is None:
        return None
    try:
        lib = ctypes.CDLL(str(so_path))
    except OSError as e:
        _why_not = f"loading {so_path} failed: {e}"
        return None

    lib.aircomp_read_idx.restype = ctypes.c_int
    lib.aircomp_read_idx.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.aircomp_read_cifar_bin.restype = ctypes.c_int
    lib.aircomp_read_cifar_bin.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.aircomp_normalize_u8.restype = ctypes.c_int
    lib.aircomp_normalize_u8.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
    ]
    lib.aircomp_free.restype = None
    lib.aircomp_free.argtypes = [ctypes.c_void_p]
    _lib, _why_not = lib, None
    return _lib


def describe() -> str:
    """Which reader the data layer uses, for the run's log."""
    if library() is not None:
        path = os.path.relpath(lib_path(openmp=not _serial), ROOT)
        serial = ", without OpenMP" if _serial else ""
        return f"native C++ ({path}, from native/dataio.cpp{serial})"
    return f"numpy ({_why_not})"


def _take_buffer(lib, ptr, shape, dtype=np.uint8) -> np.ndarray:
    """Copy a malloc'd native buffer into a NumPy array and free it."""
    n = int(np.prod(shape))
    arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy().reshape(shape)
    lib.aircomp_free(ptr)
    return arr.astype(dtype, copy=False)


def read_idx(path: str) -> Optional[np.ndarray]:
    """Parse an IDX (optionally .gz) file natively; None on any failure."""
    lib = library()
    if lib is None:
        return None
    data = ctypes.POINTER(ctypes.c_uint8)()
    dims = (ctypes.c_int64 * 4)()
    ndim = ctypes.c_int()
    rc = lib.aircomp_read_idx(path.encode(), ctypes.byref(data), dims, ctypes.byref(ndim))
    if rc != 0:
        return None
    shape = tuple(int(dims[i]) for i in range(ndim.value))
    return _take_buffer(lib, data, shape)


def read_cifar_bin(path: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Parse a CIFAR-10 binary batch natively -> (images [N,3,32,32] u8,
    labels [N] u8); None on any failure."""
    lib = library()
    if lib is None:
        return None
    img = ctypes.POINTER(ctypes.c_uint8)()
    lbl = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_int64()
    rc = lib.aircomp_read_cifar_bin(
        path.encode(), ctypes.byref(img), ctypes.byref(lbl), ctypes.byref(n)
    )
    if rc != 0:
        return None
    images = _take_buffer(lib, img, (int(n.value), 3, 32, 32))
    labels = _take_buffer(lib, lbl, (int(n.value),))
    return images, labels


def normalize_u8(x: np.ndarray, mean, std) -> Optional[np.ndarray]:
    """(x/255 - mean)/std in parallel C++; None if the library is missing.

    Scalar stats normalize every element; sequence stats of length C apply
    per channel with C the trailing axis (HWC layout).
    """
    lib = library()
    if lib is None:
        return None
    means = np.atleast_1d(np.asarray(mean, np.float32))
    stds = np.atleast_1d(np.asarray(std, np.float32))
    if means.shape != stds.shape or means.ndim != 1:
        return None
    if len(means) > 1 and (x.ndim == 0 or x.shape[-1] != len(means)):
        return None
    src = np.ascontiguousarray(x, np.uint8)
    dst = np.empty(src.shape, np.float32)
    rc = lib.aircomp_normalize_u8(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        src.size,
        means.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        stds.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(means),
    )
    return dst if rc == 0 else None
