"""Crash-safe file writes.

Copies of ``atomic_write``, ``open_append`` and ``iter_jsonl`` from ``byzantine_aircomp_tpu/utils/io.py``: the
port keeps its own so that it imports nothing of the JAX package.  A run
killed mid-write must never leave a truncated file under the final name,
because a later resume or analysis pass would load garbage: the bytes go
to a temporary file in the destination directory, which ``os.replace``
(atomic on one file system) then renames over the final name.
"""

from __future__ import annotations

import json
import os
import pickle
import tempfile
from typing import Any, Callable, Iterator, Optional


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


def iter_jsonl(
    path: str,
    warn: Optional[Callable[[str], None]] = None,
    max_warn: int = 10,
) -> Iterator[dict]:
    """Yield parsed objects from a JSONL file, skipping undecodable lines.

    The read-side counterpart to :func:`open_append`: line-buffered
    appends mean a kill can tear AT MOST the final line (a partial write
    the OS flushed on process death) — but disk corruption, a crashed
    writer without line buffering, or a hostile file can damage INTERIOR
    lines too, and journal/event-stream replay must survive both: every
    torn/garbage/non-object line is skipped, never raised.  Skips are
    COUNTED: the first ``max_warn`` report per line through ``warn``,
    the rest are silent (a corrupt 100k-line stream must not flood the
    operator's terminal), and when any skips went UNREPORTED a summary
    line with the total closes the iteration — the caller always learns
    HOW MUCH is missing even past the cap; below the cap every skip was
    already reported individually, so no summary is added.  Byte
    truncation that splits a multibyte character is absorbed
    by ``errors="replace"``.  A missing file yields nothing — callers
    distinguish empty from absent with ``os.path.exists`` if they
    care."""
    if not os.path.exists(path):
        return
    skipped = 0

    def _skip(i: int, why: str) -> None:
        nonlocal skipped
        skipped += 1
        if warn is not None and skipped <= max_warn:
            warn(f"skipping {why} line {i + 1} of {path}")

    with open(path, "r", errors="replace") as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except (json.JSONDecodeError, ValueError):
                _skip(i, "malformed")
                continue
            if isinstance(obj, dict):
                yield obj
            else:
                _skip(i, "non-object")
    if skipped > max_warn and warn is not None:
        warn(
            f"{path}: skipped {skipped} unreadable line(s) total"
            f" ({skipped - max_warn} unreported)"
        )
