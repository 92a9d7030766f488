"""Observability of the port: the run's event stream, spans, forensics,
profiler and memory model.

The port of the core of ``byzantine_aircomp_tpu/obs/``:

* :mod:`.sinks`   — where events go (JSONL file / stdout / memory / fan-out)
* :mod:`.events`  — the schema-versioned event shapes (the JAX package's
  schema v10, verbatim) and the reference-record field mapping
* :mod:`.span`    — phase timing (rounds, eval, checkpoint, set-up)
* :mod:`.trace`   — the context-local trace and span ids (``--trace on``)
* :mod:`.retrace` — counts of the programs the trainer builds (CUDA-graph
  captures, the eager round's set-up)
* :mod:`.hbm`     — the aggregation's traffic model and the peak model on
  the card
* :mod:`.forensics` — per-client flag provenance (top-M in the round,
  ``client_flag`` events) and the flight recorder
* :mod:`.profile` — ``torch.profiler`` traces and memory watermarks
* :mod:`.ledger`  — the perf ledger with noise-robust verdicts
* :mod:`.writer`  — the writer thread and :class:`AsyncSink`
* :mod:`.metrics` — the live metrics registry, fed by the event stream
* :mod:`.exporter` — Prometheus-text ``/metrics`` and ``/healthz``
* :mod:`.alerts`  — declarative SLO rules evaluated each round on the
  registry

:class:`Observability` is the façade the harness and the trainer use:
``obs.span(...)`` / ``obs.round(...)`` / ``obs.emit(...)``.  The disabled
path is :data:`NULL` (a null sink): with ``--obs-dir`` / ``--obs-stdout``
unset no file is touched, and the records, params and random streams are
bitwise those of a run without this package.  ``span_event`` and
``trace_root`` serve the experiment server (``serve/``): retrospectively
timed spans (queue wait, a lane's slice of a group round) hung off a
tenant's pre-minted root span.
"""

from __future__ import annotations

import os
from typing import Optional

from .events import (  # noqa: F401
    REFERENCE_KEY_MAP,
    SCHEMA_VERSION,
    Collector,
    make_event,
    validate_event,
)
from .alerts import AlertEngine, load_rules  # noqa: F401
from .exporter import MetricsExporter  # noqa: F401
from .forensics import FlightRecorder, emit_round_flags  # noqa: F401
from .ledger import PerfLedger, config_key, robust_stats  # noqa: F401
from .metrics import LabeledRegistry, MetricsRegistry, MetricsSink  # noqa: F401
from .profile import (  # noqa: F401
    NULL_PROFILER,
    Profiler,
    device_memory,
    parse_rounds,
)
from .retrace import RetraceDetector, RetraceError  # noqa: F401
from .sinks import (  # noqa: F401
    EventSink,
    JsonlSink,
    MemorySink,
    MultiSink,
    NullSink,
    StdoutSink,
)
from .span import SpanTimer
from . import trace  # noqa: F401
from .writer import AsyncSink, WriterThread, resolve_async  # noqa: F401


class Observability:
    """Façade bundling a sink with the span timer and round collector.

    The live-telemetry attachments are host-side only: ``registry`` and
    ``metrics_sink`` when ``--metrics`` is on (the sink rides in the fan-out,
    synchronously), ``alert_engine`` when ``--alerts`` is set (evaluated
    after every round event, on every path: eager, dispatched, graphed),
    and ``exporter`` when the harness opened a scrape port (closed here, so
    run end and crash both release it)."""

    def __init__(self, sink: EventSink, registry=None, metrics_sink=None,
                 alert_engine=None) -> None:
        self.sink = sink
        self.enabled = not isinstance(sink, NullSink)
        self._spans = SpanTimer(sink)
        self.collector = Collector(sink)
        self.registry = registry
        self.metrics_sink = metrics_sink
        self.alert_engine = alert_engine
        self.exporter = None
        # (trace_id, root_span_id) under --trace on for serve-managed runs:
        # the identity every retrospective span_event hangs off
        self.trace_root = None

    @property
    def traced(self) -> bool:
        return self._spans.traced

    @traced.setter
    def traced(self, value: bool) -> None:
        self._spans.traced = bool(value)

    def emit(self, kind: str, **fields) -> None:
        self.sink.emit(make_event(kind, **fields))

    def span(self, name: str, sync=None, **fields):
        return self._spans.span(name, sync=sync, **fields)

    def span_event(self, name: str, ms: float, **fields) -> None:
        """Emit a span timed outside a context manager (queue wait, a
        lane's slice of a group round; JAX ``obs/__init__.py:118-150``).

        A no-op unless the façade is traced, so ``--trace off`` streams
        stay as they were.  ``trace_id``/``span_id``/``parent_span_id`` in
        ``fields`` win; otherwise the ids come from :attr:`trace_root` (the
        span id minted fresh, the parent defaulting to the root span, so a
        run's spans assemble into one tree)."""
        if not self._spans.traced:
            return
        if "trace_id" not in fields:
            if self.trace_root is not None:
                fields["trace_id"] = self.trace_root[0]
            else:
                ctx = trace.current()
                fields["trace_id"] = ctx[0] if ctx is not None else trace.new_trace_id()
        fields.setdefault("span_id", trace.new_span_id())
        if ("parent_span_id" not in fields and self.trace_root is not None
                and self.trace_root[0] == fields["trace_id"]
                and self.trace_root[1] is not None
                and fields["span_id"] != self.trace_root[1]):
            fields["parent_span_id"] = self.trace_root[1]
        self.sink.emit(make_event("span", name=name, ms=round(float(ms), 3), **fields))

    def round(self, round_idx: int, **metrics) -> None:
        self.collector.round_event(round_idx, **metrics)
        if self.alert_engine is not None:
            # after the round event folded into the registry, so a rule at
            # round r sees the state through r
            self.alert_engine.evaluate(round_idx, self.sink)

    def close(self) -> None:
        if self.exporter is not None:
            self.exporter.close()
            self.exporter = None
        self.sink.close()


#: the disabled singleton — shared, stateless, close() is a no-op
NULL = Observability(NullSink())


def events_path(obs_dir: str, title: str) -> str:
    """The run's event-stream file, keyed on the checkpoint title (run
    title + config hash), so a resumed run appends to its own stream and
    two configs never share one file."""
    return os.path.join(obs_dir, f"{title}.events.jsonl")


def from_config(cfg, title: str, writer: Optional[WriterThread] = None) -> Observability:
    """The run's Observability (:data:`NULL` when no obs knob is set).
    ``writer`` (the writer thread) moves the JSONL and stdout sinks behind
    :class:`AsyncSink`, so their appends leave the round loop.
    ``--metrics-port`` and ``--alerts`` imply the metrics registry; the
    registry implies nothing else (a metrics-only run writes no file).  The
    metrics sink stays synchronous, outside the writer: the alert engine
    reads the registry right after each round event, in
    :meth:`Observability.round`."""
    sinks = []
    if getattr(cfg, "obs_dir", ""):
        sinks.append(JsonlSink(events_path(cfg.obs_dir, title),
                               rotate_mb=getattr(cfg, "obs_rotate_mb", 0.0)))
    if getattr(cfg, "obs_stdout", False):
        sinks.append(StdoutSink())
    if writer is not None:
        sinks = [AsyncSink(s, writer) for s in sinks]
    registry = metrics_sink = alert_engine = None
    if cfg.metrics == "on" or cfg.metrics_port > 0 or cfg.alerts != "off":
        registry = MetricsRegistry()
        metrics_sink = MetricsSink(registry)
        sinks.append(metrics_sink)
        if cfg.alerts != "off":
            alert_engine = AlertEngine(load_rules(cfg.alerts), registry)
    if not sinks:
        return NULL
    out = Observability(sinks[0] if len(sinks) == 1 else MultiSink(sinks),
                        registry=registry, metrics_sink=metrics_sink,
                        alert_engine=alert_engine)
    # output-only: spans mint ids, the training program is untouched
    out.traced = getattr(cfg, "trace", "off") == "on"
    return out
