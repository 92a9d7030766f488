"""Crash-safe file writes.

Copies of ``atomic_write`` and ``open_append`` from ``byzantine_aircomp_tpu/utils/io.py``: the
port keeps its own so that it imports nothing of the JAX package.  A run
killed mid-write must never leave a truncated file under the final name,
because a later resume or analysis pass would load garbage: the bytes go
to a temporary file in the destination directory, which ``os.replace``
(atomic on one file system) then renames over the final name.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from typing import Any, Callable


def atomic_write(path: str, write_fn: Callable, mode: str = "wb") -> str:
    """Write ``path`` atomically: ``write_fn(file_obj)`` runs against a temp
    file in the same directory, which is renamed over ``path`` only after
    the write completes (and the ``os.fdopen`` context has flushed/closed).
    On ANY failure the temp file is removed and the previous ``path``
    content — if any — is left untouched."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, mode) as f:
            write_fn(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def atomic_pickle(path: str, obj: Any) -> str:
    """Atomically pickle ``obj`` to ``path``."""
    return atomic_write(path, lambda f: pickle.dump(obj, f))


def open_append(path: str):
    """Open ``path`` for line-buffered text append, creating parent dirs:
    the append-safe counterpart of :func:`atomic_write` for growing files
    (event streams, log tees), where one line per ``write()`` never tears a
    line and POSIX append keeps concurrent writers from interleaving
    within one."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    return open(path, "a", buffering=1)
