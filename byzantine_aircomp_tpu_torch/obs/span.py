"""``span()`` — wall-clock timing of named phases, emitted as events.

The port's counterpart of ``byzantine_aircomp_tpu/obs/span.py``.  The
training loop's phases (rounds, eval, checkpointing, set-up) each get a
``span`` event with a monotonic-clock duration.  CUDA launches are
asynchronous, so a span that should charge device work to itself must end
on a barrier: ``sync=`` takes a ``torch.device`` (``torch.cuda.synchronize``
of it), a recorded ``torch.cuda.Event`` (its ``synchronize()``, which waits
for the work queued before it and nothing after), a tensor (its device's
synchronize), or a thunk returning one of those.  A CPU device or tensor
needs no barrier.  A span given no ``sync=`` costs two clock reads and no
sync, so a round span around work that already ends on its own barrier
(the trainer's) adds none.

The context manager yields a mutable dict: fields set on it inside the
body land on the emitted event (e.g. the round span's ``compiled`` flag,
known only after the body has run).

With ``traced`` set (``--trace on``), every span mints a 16-hex
``span_id``, inherits ``trace_id`` from the ambient context (minting a
fresh trace when it is the first span), records the enclosing span as
``parent_span_id`` and pushes itself onto the context-local parent stack
for the body's duration (:mod:`.trace`).  Untraced (the default), none of
that runs.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Iterator, Optional

from . import trace as trace_lib
from .events import make_event


def barrier(sync: Any) -> None:
    """Wait for the device work ``sync`` names (see the module docstring)."""
    import torch

    if callable(sync):
        sync = sync()
    if isinstance(sync, torch.cuda.Event):
        sync.synchronize()
        return
    if isinstance(sync, torch.Tensor):
        sync = sync.device
    if isinstance(sync, torch.device) and sync.type == "cuda":
        torch.cuda.synchronize(sync)


class SpanTimer:
    def __init__(self, sink) -> None:
        self._sink = sink
        # flipped by Observability.from_config under --trace on; an
        # output-only knob, so it never forks config_hash or records
        self.traced = False

    @contextlib.contextmanager
    def span(
        self, name: str, sync: Optional[Any] = None, **fields: Any
    ) -> Iterator[Dict[str, Any]]:
        extra: Dict[str, Any] = dict(fields)
        token = None
        if self.traced:
            ctx = trace_lib.current()
            if "trace_id" not in extra:
                extra["trace_id"] = (
                    ctx[0] if ctx is not None else trace_lib.new_trace_id()
                )
            if (
                "parent_span_id" not in extra
                and ctx is not None
                and ctx[1] is not None
                and ctx[0] == extra["trace_id"]
            ):
                extra["parent_span_id"] = ctx[1]
            extra["span_id"] = trace_lib.new_span_id()
            token = trace_lib.push(extra["trace_id"], extra["span_id"])
        t0 = time.perf_counter()
        try:
            yield extra
            if sync is not None:
                barrier(sync)
        except BaseException:
            # a span interrupted by an exception still reports, flagged —
            # the tail of a crashed run is exactly when timing data matters
            extra.setdefault("error", True)
            ms = (time.perf_counter() - t0) * 1e3
            if token is not None:
                trace_lib.pop(token)
                token = None
            self._sink.emit(make_event("span", name=name, ms=round(ms, 3), **extra))
            raise
        finally:
            if token is not None:
                trace_lib.pop(token)
        ms = (time.perf_counter() - t0) * 1e3
        self._sink.emit(make_event("span", name=name, ms=round(ms, 3), **extra))
