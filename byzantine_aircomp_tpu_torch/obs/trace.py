"""Trace context — W3C-``traceparent``-style ids for the event stream.

The port's own copy of ``byzantine_aircomp_tpu/obs/trace.py`` (the port
imports nothing of the JAX package); only ``--trace on`` activates it.

A trace is a 32-hex id shared by every event a single logical request
touches, across processes (server, lane group, edges, root, writer
rim).  A span is a 16-hex id naming one timed phase inside the trace;
spans nest via ``parent_span_id``.  This module owns the ambient
context: a context-local ``(trace_id, span_id)`` pair that
``events.make_event`` stamps onto every event emitted while it is
active, and that ``span.SpanTimer`` pushes/pops as spans open and
close.

The context lives in a ``contextvars.ContextVar``: new threads start
with no context, so a traced tenant on one lane never bleeds ids into
a neighbour's stream, and with tracing off nothing ever activates the
context — emission stays byte-identical to the untraced schema.

``span_id`` may be ``None`` in an active context: "this trace, no
parent span yet" — events then carry only ``trace_id`` and spans
opened under it become trace roots rather than orphans.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import re
from typing import Iterator, Optional, Tuple

# (trace_id, span_id-or-None); None default == tracing inactive
_ctx: contextvars.ContextVar[Optional[Tuple[str, Optional[str]]]] = (
    contextvars.ContextVar("aircomp_trace", default=None)
)

_TRACEPARENT_RE = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$"
)


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


def current() -> Optional[Tuple[str, Optional[str]]]:
    """The active ``(trace_id, span_id)`` pair, or None when untraced."""
    return _ctx.get()


def push(trace_id: str, span_id: Optional[str]):
    """Activate a context; returns the token for ``pop``."""
    return _ctx.set((trace_id, span_id))


def pop(token) -> None:
    _ctx.reset(token)


@contextlib.contextmanager
def activate(
    trace_id: str, span_id: Optional[str] = None
) -> Iterator[None]:
    token = push(trace_id, span_id)
    try:
        yield
    finally:
        pop(token)


def traceparent() -> Optional[str]:
    """The active context as a ``traceparent`` header value, or None.

    A context with no span id is not representable on the wire (the
    header requires a parent id), so it also returns None.
    """
    ctx = _ctx.get()
    if ctx is None or ctx[1] is None:
        return None
    return f"00-{ctx[0]}-{ctx[1]}-01"


def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"00-{trace_id}-{span_id}-01"


def parse_traceparent(header: Optional[str]) -> Optional[Tuple[str, str]]:
    """``(trace_id, span_id)`` from a ``traceparent`` value, else None.

    Tolerant of case and surrounding whitespace; rejects the all-zero
    ids the W3C spec reserves as invalid.
    """
    if not header:
        return None
    m = _TRACEPARENT_RE.match(str(header).strip().lower())
    if not m:
        return None
    trace_id, span_id = m.group(1), m.group(2)
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id
