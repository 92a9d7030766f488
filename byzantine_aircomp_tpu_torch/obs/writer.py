"""The writer thread: checkpoint writes, the record pickle and the event
stream's appends off the dispatch loop.

The port's own copy of ``resolve_async``, ``WriterThread`` and
``AsyncSink`` from ``byzantine_aircomp_tpu/obs/writer.py`` (the port
imports nothing of the JAX package).  One daemon consumer drains one bounded FIFO queue, so tasks
run in exactly the order they were submitted; a full queue blocks the
producer (backpressure, never loss).  A task that raises is recorded
(the first error on ``.error``, one warning on stderr) and the consumer
keeps draining.  ``drain()`` waits for every task submitted so far;
``close()`` drains and joins the thread, after which ``submit`` runs a task
inline.  A caller hands the writer host data only: whatever a task reads
must be copied off the device before it is submitted, since the trainer
goes on writing its device buffers.

:class:`AsyncSink` rides an event sink on the same thread: the inner sink
stamps its ``seq`` on the writer thread, so the drained stream is
seq-ordered whatever producer threads raced on ``emit``, and JSONL appends,
checkpoint writes and the record pickle land in submission order.
"""

from __future__ import annotations

import queue
import sys
import threading
import time
from typing import Any, Callable, Dict, Optional

from . import trace as trace_lib
from .sinks import EventSink, MultiSink

_STOP = object()


def _sync_sinks(sink):
    """The synchronous leaves under ``sink`` (an AsyncSink unwrapped, a
    MultiSink fanned out): a span about a writer task is emitted on the
    writer thread itself, which must not enqueue onto its own queue."""
    if isinstance(sink, AsyncSink):
        return _sync_sinks(sink.inner)
    if isinstance(sink, MultiSink):
        out = []
        for s in sink.sinks:
            out.extend(_sync_sinks(s))
        return out
    return [sink]


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

    def submit_traced(self, fn: Callable[[], None], task: str,
                      sink: Optional[EventSink] = None, **fields: Any) -> None:
        """``submit``, plus a ``writer_task`` span when a trace context is
        active at submit time (``--trace on``): ``ms`` is the task's time
        on the thread, ``queued_ms`` its wait in the queue, and
        ``parent_span_id`` the span that submitted it.  The span goes to
        ``sink``'s synchronous leaves.  With no active context this is
        ``submit``."""
        ctx = trace_lib.current()
        if ctx is None or sink is None:
            self.submit(fn)
            return
        from .events import make_event

        trace_id, parent = ctx
        leaves = _sync_sinks(sink)
        t_submit = time.perf_counter()

        def wrapped() -> None:
            t0 = time.perf_counter()
            try:
                fn()
            finally:
                extra = dict(fields, trace_id=trace_id, span_id=trace_lib.new_span_id())
                if parent is not None:
                    extra["parent_span_id"] = parent
                ev = make_event("span", name="writer_task",
                                ms=round((time.perf_counter() - t0) * 1e3, 3), task=task,
                                queued_ms=round((t0 - t_submit) * 1e3, 3), **extra)
                for leaf in leaves:
                    try:
                        leaf.emit(ev)
                    except Exception:  # noqa: BLE001 - the span is best effort
                        pass

        self.submit(wrapped)

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


class AsyncSink(EventSink):
    """An inner sink ridden on a :class:`WriterThread`: ``emit`` enqueues
    the inner emit, ``flush`` and ``close`` drain first, so a closed stream
    is complete and seq-monotonic with no lost events."""

    def __init__(self, inner: EventSink, writer: WriterThread) -> None:
        self.inner = inner
        self._writer = writer

    def emit(self, event: Dict[str, Any]) -> None:
        inner = self.inner
        self._writer.submit(lambda: inner.emit(event))

    def flush(self) -> None:
        self._writer.drain()
        self.inner.flush()

    def close(self) -> None:
        self._writer.drain()
        self.inner.close()
