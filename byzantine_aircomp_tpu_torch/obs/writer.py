"""The writer thread: checkpoint writes and the record pickle off the
dispatch loop.

The port's own copy of ``resolve_async`` and ``WriterThread`` from
``byzantine_aircomp_tpu/obs/writer.py`` (the port imports nothing of the
JAX package).  One daemon consumer drains one bounded FIFO queue, so tasks
run in exactly the order they were submitted; a full queue blocks the
producer (backpressure, never loss).  A task that raises is recorded
(the first error on ``.error``, one warning on stderr) and the consumer
keeps draining.  ``drain()`` waits for every task submitted so far;
``close()`` drains and joins the thread, after which ``submit`` runs a task
inline.  A caller hands the writer host data only: whatever a task reads
must be copied off the device before it is submitted, since the trainer
goes on writing its device buffers.
"""

from __future__ import annotations

import queue
import sys
import threading
from typing import Callable, Optional

_STOP = object()


def resolve_async(cfg) -> bool:
    """Whether a run of ``cfg`` writes through a writer thread:
    ``--async-writer on`` forces it, ``off`` forbids it, and ``auto``
    (default) turns it on exactly when ``rounds_per_dispatch > 1``."""
    if cfg.async_writer == "auto":
        return cfg.rounds_per_dispatch > 1
    return cfg.async_writer == "on"


class WriterThread:
    """Bounded single-consumer task queue on a daemon thread.

    ``submit(fn)`` enqueues a zero-argument callable (blocking at the
    bound), ``drain()`` waits for everything submitted so far, ``close()``
    drains and joins the thread.  After ``close`` a late ``submit`` runs
    the task inline."""

    def __init__(self, maxsize: int = 256) -> None:
        self._q: "queue.Queue" = queue.Queue(maxsize)
        self._error: Optional[BaseException] = None
        self._warned = False
        self._closed = False
        self._thread = threading.Thread(target=self._loop, name="obs-writer", daemon=True)
        self._thread.start()

    @property
    def error(self) -> Optional[BaseException]:
        """The first task failure, if any."""
        return self._error

    def submit(self, fn: Callable[[], None]) -> None:
        """Enqueue ``fn``; blocks while the queue is at its bound."""
        if self._closed:
            self._run(fn)
            return
        self._q.put(fn)

    def _run(self, fn: Callable[[], None]) -> None:
        try:
            fn()
        except BaseException as exc:  # noqa: BLE001 - recorded, the consumer goes on
            if self._error is None:
                self._error = exc
            if not self._warned:
                self._warned = True
                print(
                    f"[obs] WARNING: async writer task failed ({type(exc).__name__}: "
                    f"{exc}); the writer keeps draining and the run continues",
                    file=sys.stderr,
                )

    def _loop(self) -> None:
        while True:
            fn = self._q.get()
            try:
                if fn is _STOP:
                    return
                self._run(fn)
            finally:
                self._q.task_done()

    def drain(self) -> None:
        """Block until every task submitted so far has run."""
        self._q.join()

    def close(self) -> None:
        """Drain and stop the consumer.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._q.put(_STOP)
        self._thread.join()
