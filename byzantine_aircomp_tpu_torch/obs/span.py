"""Spans: named regions of the program on the profiler's clock.

A span is a named region with a start and an end on the clock that
torch.profiler's host events carry (``time.time_ns()``, Unix-epoch ns),
inside the span that encloses it.  :func:`span` is the ambient form,
used at the layer boundaries of the training path (:data:`SPANS`) with
no :class:`Observability` in hand.  It costs one flag read while no
profiler runs and no CUDA graph is being captured: no range is entered
and nothing is allocated.  While a profiler runs it opens a
``torch.profiler.record_function`` range of its name, so a trace nests
the regions as the code does.  While ``fed/graphs.py`` captures a round,
it reports its entry and exit to the capture's node marker
(:func:`capture_marks`), which notes how many graph nodes the capture
holds at each, so that a replay's device records can be put down to the
stages that launched them.

:meth:`SpanTimer.span` runs one and emits it as an event: the port's
counterpart of ``byzantine_aircomp_tpu/obs/span.py``.  The training
loop's phases (rounds, eval, checkpointing, set-up) each get a ``span``
event with its duration ``ms`` and its ``start_ns`` / ``end_ns`` on the
profiler's clock.  CUDA launches are
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
from typing import Any, Callable, Dict, Iterator, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

from . import trace as trace_lib
from .events import make_event

#: the spans of the stages of Trainer.iteration, in the order they run
STAGES = ("batch", "client_step", "attack", "channel", "aggregate", "server_step", "variance")
#: the spans at the layer boundaries of the training path
SPANS = (
    # Trainer.run_round and Trainer.run_rounds_stacked; inside the latter,
    # RoundGraph.run's state copy-in, each replay and each replay's copies
    "dispatch", "graph.prepare", "graph.replay", "graph.outputs",
    # RoundGraph.capture: the eager warm-up round, and the capture with its
    # instantiation
    "graph.warmup", "graph.capture",
) + STAGES

#: the node marker of the CUDA-graph capture in progress, or None
#: (:func:`capture_marks`)
_marker: Optional[Callable[[str, bool], None]] = None
#: what :func:`span` returns while nothing reads spans
_NULL = contextlib.nullcontext()


class Span:
    """One span, timed whether or not a profiler runs: ``start_ns`` and
    ``end_ns`` on the profiler's clock once it has closed.  With
    ``ranged`` (the default) it opens a profiler range of its name while
    a profiler runs, and reports to a capture's node marker."""

    __slots__ = ("name", "ranged", "start_ns", "end_ns", "_range")

    def __init__(self, name: str, ranged: bool = True) -> None:
        self.name = name
        self.ranged = ranged
        self.start_ns = self.end_ns = 0
        self._range = None

    def __enter__(self) -> "Span":
        if self.ranged:
            if _marker is not None:
                _marker(self.name, True)
            if _autograd_profiler._is_profiler_enabled:
                self._range = torch.profiler.record_function(self.name)
                self._range.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        if self.ranged and _marker is not None:
            _marker(self.name, False)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def span(name: str):
    """The ambient span ``name`` (a context manager): a :class:`Span` while
    a profiler runs or a capture marks its nodes, else a shared no-op."""
    if _autograd_profiler._is_profiler_enabled or _marker is not None:
        return Span(name)
    return _NULL


@contextlib.contextmanager
def capture_marks(marker: Callable[[str, bool], None]) -> Iterator[None]:
    """Within the block every span calls ``marker(name, True)`` at its entry
    and ``marker(name, False)`` at its exit (``fed/graphs.py`` counts the
    nodes of the graph it captures at each)."""
    global _marker
    prev, _marker = _marker, marker
    try:
        yield
    finally:
        _marker = prev


def barrier(sync: Any) -> None:
    """Wait for the device work ``sync`` names (see the module docstring)."""
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
        self, name: str, sync: Optional[Any] = None, ranged: bool = True, **fields: Any
    ) -> Iterator[Dict[str, Any]]:
        """Time the body as the span ``name`` and emit it; ``ranged=False``
        where the profiler range comes from the call the body makes."""
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
        region = Span(name, ranged)
        try:
            with region:
                yield extra
                if sync is not None:
                    barrier(sync)
        except BaseException:
            # a span interrupted by an exception still reports, flagged —
            # the tail of a crashed run is exactly when timing data matters
            extra.setdefault("error", True)
            if token is not None:
                trace_lib.pop(token)
                token = None
            self._emit(region, extra)
            raise
        finally:
            if token is not None:
                trace_lib.pop(token)
        self._emit(region, extra)

    def _emit(self, region: Span, extra: Dict[str, Any]) -> None:
        ms = (region.end_ns - region.start_ns) / 1e6
        self._sink.emit(make_event("span", name=region.name, ms=round(ms, 3),
                                   start_ns=region.start_ns, end_ns=region.end_ns, **extra))
