"""Live metrics: an in-process registry fed by the event stream.

The port's copy of ``byzantine_aircomp_tpu/obs/metrics.py``.  The port's
training code carries no telemetry branch: every live health signal is
derived from the schema-versioned events (``obs/events.py``) the run
already emits.  :class:`MetricsSink` is one more
:class:`~.sinks.EventSink` beside the stream's: it folds each event into a
:class:`MetricsRegistry` of counters, gauges and bounded-bucket
histograms, which the scrape endpoint (``obs/exporter.py``) renders and
the SLO engine (``obs/alerts.py``) evaluates.  Derived state only:
turning the metrics off changes no event, no record byte, no random draw.
The sink is synchronous, also under ``--async-writer``: the alert engine
reads the registry right after each round's events (``obs/__init__.py``).

Thread-safety: the harness thread writes (one ``emit`` per event) while
the exporter's HTTP thread reads (``render``/``snapshot``).  One
registry-wide lock covers both sides, so a scrape can never observe a
torn histogram (bucket counts that do not sum to the series count).

Cardinality is bounded twice: histograms use FIXED bucket edges (no
per-value growth), and each metric family holds at most
:data:`MAX_SERIES` label-sets — overflow label values fold into
``"__overflow__"`` so a hostile/buggy label (e.g. a per-client id) can
never grow the registry without bound on an always-on service run.

All metric names carry the ``aircomp_`` prefix.  ``aircomp_events_total
{kind=...}`` counts every event seen, which is the scrape-vs-stream
parity anchor the tests pin: at quiesce the scraped counter equals the
event-stream line count.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, List, Optional, Tuple

from .sinks import EventSink

#: per-family label-set cap; the overflow fold keeps scrapes bounded
MAX_SERIES = 64

#: fixed bucket upper bounds for round-duration histograms (seconds);
#: the +Inf bucket is implicit
ROUND_SECONDS_BUCKETS = (
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

#: fixed bucket upper bounds for HTTP request-latency histograms
#: (seconds) — server handling is sub-second in the common case, so the
#: grid starts finer than the round grid
HTTP_SECONDS_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
)

#: run-phase gauge values (aircomp_run_phase)
PHASE_STARTING, PHASE_RUNNING, PHASE_DONE = 0, 1, 2


def _labelkey(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Family:
    """One metric family: name, type, help text, and its label series.

    NOT self-locking — the registry's lock guards every touch, so a
    family never needs (and never takes) its own.
    """

    def __init__(self, name: str, kind: str, help_text: str,
                 buckets: Optional[Tuple[float, ...]] = None) -> None:
        self.name = name
        self.kind = kind  # "counter" | "gauge" | "histogram"
        self.help = help_text
        self.buckets = tuple(buckets) if buckets else ()
        # label-key tuple -> float (counter/gauge) or
        # [bucket_counts list, sum, count] (histogram)
        self.series: Dict[Tuple[Tuple[str, str], ...], Any] = {}

    def _key(self, labels: Dict[str, str]):
        key = _labelkey(labels)
        if key not in self.series and len(self.series) >= MAX_SERIES:
            key = _labelkey({k: "__overflow__" for k, _ in key}) or key
        return key

    def inc(self, amount: float, labels: Dict[str, str]) -> None:
        key = self._key(labels)
        self.series[key] = self.series.get(key, 0.0) + amount

    def set(self, value: float, labels: Dict[str, str]) -> None:
        self.series[self._key(labels)] = float(value)

    def observe(self, value: float, labels: Dict[str, str]) -> None:
        key = self._key(labels)
        if key not in self.series:
            self.series[key] = [[0] * len(self.buckets), 0.0, 0]
        counts, total, n = self.series[key]
        for i, edge in enumerate(self.buckets):
            if value <= edge:
                counts[i] += 1
                break
        self.series[key] = [counts, total + value, n + 1]


class MetricsRegistry:
    """Thread-safe counter/gauge/histogram registry with a Prometheus
    text renderer.  Families are created lazily on first touch; a
    name reused with a different type raises (the drift would render
    an invalid exposition)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _family(self, name: str, kind: str, help_text: str,
                buckets: Optional[Tuple[float, ...]] = None) -> _Family:
        fam = self._families.get(name)
        if fam is None:
            fam = _Family(name, kind, help_text, buckets)
            self._families[name] = fam
        elif fam.kind != kind:
            raise ValueError(
                f"metric {name!r} registered as {fam.kind}, used as {kind}"
            )
        return fam

    def inc(self, name: str, amount: float = 1.0, help_text: str = "",
            **labels: str) -> None:
        with self._lock:
            self._family(name, "counter", help_text).inc(amount, labels)

    def set(self, name: str, value: float, help_text: str = "",
            **labels: str) -> None:
        with self._lock:
            self._family(name, "gauge", help_text).set(value, labels)

    def observe(self, name: str, value: float,
                buckets: Tuple[float, ...] = ROUND_SECONDS_BUCKETS,
                help_text: str = "", **labels: str) -> None:
        with self._lock:
            self._family(name, "histogram", help_text,
                         buckets).observe(value, labels)

    def value(self, name: str, **labels: str) -> Optional[float]:
        """Current scalar of a counter/gauge series (None when the family
        or series does not exist yet — the alert engine treats absent as
        rule-specific).  Histograms return their observation count."""
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return None
            v = fam.series.get(_labelkey(labels))
            if v is None:
                return None
            return float(v[2]) if fam.kind == "histogram" else float(v)

    def quantile(self, name: str, q: float,
                 **labels: str) -> Optional[float]:
        """Bucket-resolution quantile of a histogram series: the
        smallest bucket upper bound whose cumulative count reaches the
        nearest-rank position — a conservative (upper-bound) estimate,
        which is the right bias for an SLO ceiling.  ``math.inf`` when
        the rank lands in the implicit +Inf bucket; None when the
        family/series is absent or empty (the alert engine skips, same
        as ``value``)."""
        with self._lock:
            fam = self._families.get(name)
            if fam is None or fam.kind != "histogram":
                return None
            v = fam.series.get(_labelkey(labels))
            if v is None:
                return None
            counts, _total, n = v
            if n <= 0:
                return None
            rank = max(1, math.ceil(float(q) * n))
            cum = 0
            for edge, c in zip(fam.buckets, counts):
                cum += c
                if cum >= rank:
                    return float(edge)
            return math.inf

    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time copy of every series, taken under the lock so a
        histogram's bucket counts always sum to its count."""
        out: Dict[str, Any] = {}
        with self._lock:
            for name, fam in sorted(self._families.items()):
                series = []
                for key, v in sorted(fam.series.items()):
                    entry: Dict[str, Any] = {"labels": dict(key)}
                    if fam.kind == "histogram":
                        counts, total, n = v
                        entry.update(
                            buckets=list(counts), sum=total, count=n
                        )
                    else:
                        entry["value"] = v
                    series.append(entry)
                out[name] = {"type": fam.kind, "series": series}
        return out

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        with self._lock:
            for name, fam in sorted(self._families.items()):
                if fam.help:
                    lines.append(f"# HELP {name} {fam.help}")
                lines.append(f"# TYPE {name} {fam.kind}")
                for key, v in sorted(fam.series.items()):
                    lbl = _render_labels(dict(key))
                    if fam.kind == "histogram":
                        counts, total, n = v
                        cum = 0
                        for edge, c in zip(fam.buckets, counts):
                            cum += c
                            le = _render_labels({**dict(key), "le": _fmt(edge)})
                            lines.append(f"{name}_bucket{le} {cum}")
                        inf = _render_labels({**dict(key), "le": "+Inf"})
                        lines.append(f"{name}_bucket{inf} {n}")
                        lines.append(f"{name}_sum{lbl} {_fmt(total)}")
                        lines.append(f"{name}_count{lbl} {n}")
                    else:
                        lines.append(f"{name}{lbl} {_fmt(v)}")
        return "\n".join(lines) + "\n"


class LabeledRegistry:
    """A write-through view of a :class:`MetricsRegistry` that stamps a
    fixed label set (e.g. ``run_id``) onto every series it touches.

    The multi-tenant control plane gives each run a
    ``MetricsSink(LabeledRegistry(shared, run_id=...))`` so one scrape
    endpoint exposes every tenant's counters side by side —
    ``aircomp_events_total{kind="round",run_id="r42"}`` — without the
    per-kind fold methods knowing anything about tenancy.  Explicit
    labels win over the fixed ones on collision (none of the built-in
    folds uses ``run_id``, so in practice they merge).  Reads
    (``render``/``snapshot``) go straight to the base registry; ``value``
    merges the fixed labels so per-run alert engines query their own
    series."""

    def __init__(self, base: MetricsRegistry, **labels: str) -> None:
        self.base = base
        self.labels = {k: str(v) for k, v in labels.items()}

    def inc(self, name: str, amount: float = 1.0, help_text: str = "",
            **labels: str) -> None:
        self.base.inc(name, amount, help_text, **{**self.labels, **labels})

    def set(self, name: str, value: float, help_text: str = "",
            **labels: str) -> None:
        self.base.set(name, value, help_text, **{**self.labels, **labels})

    def observe(self, name: str, value: float,
                buckets: Tuple[float, ...] = ROUND_SECONDS_BUCKETS,
                help_text: str = "", **labels: str) -> None:
        self.base.observe(name, value, buckets, help_text,
                          **{**self.labels, **labels})

    def value(self, name: str, **labels: str) -> Optional[float]:
        return self.base.value(name, **{**self.labels, **labels})

    def quantile(self, name: str, q: float,
                 **labels: str) -> Optional[float]:
        return self.base.quantile(name, q, **{**self.labels, **labels})

    def snapshot(self) -> Dict[str, Any]:
        return self.base.snapshot()

    def render(self) -> str:
        return self.base.render()


def _fmt(v: float) -> str:
    if isinstance(v, float) and math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _render_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    parts = []
    for k, v in sorted(labels.items()):
        escaped = str(v).replace("\\", "\\\\").replace('"', '\\"')
        parts.append(f'{k}="{escaped}"')
    return "{" + ",".join(parts) + "}"


def _finite(v) -> bool:
    try:
        return math.isfinite(float(v))
    except (TypeError, ValueError):
        return False


class MetricsSink(EventSink):
    """Folds the event stream into a :class:`MetricsRegistry`.

    Joins the ordinary sink fan-out, so it sees exactly what the JSONL
    stream records — including the ``alert`` events the rule engine
    emits back through the same fan-out (counted like any other kind;
    no recursion, because counting never emits).
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        self.registry = registry if registry is not None else MetricsRegistry()
        # byz count of the run being folded (from run_start): a client
        # flag raised on a byz=0 run is by construction a false flag —
        # the signal the benign_false_flag_rate SLO pages on
        self._byz: Optional[int] = None

    # EventSink interface ------------------------------------------------
    def emit(self, event: Dict[str, Any]) -> None:
        reg = self.registry
        kind = event.get("kind", "unknown")
        reg.inc("aircomp_events_total",
                help_text="events seen by the metrics sink, by kind",
                kind=kind)
        handler = getattr(self, f"_on_{kind}", None)
        if handler is not None:
            handler(event)

    # per-kind folds -----------------------------------------------------
    def _on_run_start(self, e: Dict[str, Any]) -> None:
        reg = self.registry
        reg.set("aircomp_run_phase", PHASE_RUNNING,
                help_text="0=starting 1=running 2=done")
        reg.set("aircomp_run_start_ts", e.get("ts", 0.0),
                help_text="run_start wall-clock epoch seconds")
        if e.get("k") is not None:
            reg.set("aircomp_clients_k", e["k"],
                    help_text="configured round size K")
        self._byz = e.get("byz")
        if e.get("byz") is not None:
            reg.set("aircomp_clients_byz", e["byz"],
                    help_text="configured Byzantine count B")
        if e.get("rounds") is not None:
            reg.set("aircomp_rounds_scheduled", e["rounds"],
                    help_text="scheduled round horizon")

    def _on_span(self, e: Dict[str, Any]) -> None:
        # stage-latency histograms: every span folds into
        # aircomp_stage_seconds{stage=<name>} (span names are a small
        # closed set — setup/round/dispatch/eval/checkpoint/run/
        # queue_wait/writer_task/... — so cardinality stays bounded even
        # before the MAX_SERIES fold), and queue_wait additionally feeds
        # the dedicated admission-wait histogram the SLO rule samples
        reg = self.registry
        ms = e.get("ms")
        if ms is None or not _finite(ms):
            return
        secs = float(ms) / 1e3
        stage = str(e.get("name", "unknown"))
        reg.observe("aircomp_stage_seconds", secs,
                    help_text="span-derived stage latency, by span name",
                    stage=stage)
        if stage == "queue_wait":
            reg.observe("aircomp_queue_wait_seconds", secs,
                        help_text="admission queue wait "
                        "(run_submitted to lane seat)")

    def _on_round(self, e: Dict[str, Any]) -> None:
        reg = self.registry
        reg.inc("aircomp_rounds_total", help_text="completed rounds")
        reg.set("aircomp_round", e.get("round", -1),
                help_text="last completed round index")
        reg.set("aircomp_last_round_ts", e.get("ts", 0.0),
                help_text="last round event wall-clock epoch seconds")
        for field, gauge in (
            ("train_loss", "aircomp_train_loss"),
            ("val_loss", "aircomp_val_loss"),
            ("val_acc", "aircomp_val_acc"),
            ("variance", "aircomp_variance"),
            ("rounds_per_sec", "aircomp_rounds_per_sec"),
            ("effective_k", "aircomp_effective_k"),
        ):
            v = e.get(field)
            if v is not None and _finite(v):
                reg.set(gauge, float(v))
        if any(
            e.get(f) is not None and not _finite(e.get(f))
            for f in ("train_loss", "val_loss", "variance")
        ):
            reg.inc("aircomp_nonfinite_loss_total",
                    help_text="rounds with a non-finite loss/variance")
        if e.get("round_secs") is not None:
            reg.observe("aircomp_round_seconds", float(e["round_secs"]),
                        help_text="wall-clock seconds per round")
        for field, counter in (
            ("dropped", "aircomp_fault_dropped_total"),
            ("erased", "aircomp_fault_erased_total"),
            ("corrupt", "aircomp_fault_corrupt_total"),
        ):
            v = e.get(field)
            if v is not None and _finite(v):
                reg.inc(counter, float(v),
                        help_text=f"fault-injection {field} clients, summed")
        # device-allocator watermarks only: host RSS includes the
        # interpreter/compiler and must never drive the HBM SLO
        if str(e.get("mem_source", "")).startswith("device"):
            if _finite(e.get("bytes_in_use")):
                reg.set("aircomp_bytes_in_use", float(e["bytes_in_use"]),
                        help_text="device bytes in use at round end")
            if _finite(e.get("peak_bytes_in_use")):
                reg.set("aircomp_peak_bytes_in_use",
                        float(e["peak_bytes_in_use"]),
                        help_text="device peak bytes in use")

    def _on_participation(self, e: Dict[str, Any]) -> None:
        reg = self.registry
        for field, gauge in (
            ("available", "aircomp_participation_available"),
            ("absent", "aircomp_participation_absent"),
            ("late", "aircomp_participation_late"),
            ("effective_k", "aircomp_effective_k"),
        ):
            if _finite(e.get(field)):
                reg.set(gauge, float(e[field]),
                        help_text=f"per-round service {field}")
        if _finite(e.get("late")):
            reg.inc("aircomp_late_total", float(e["late"]),
                    help_text="deadline-missing clients, summed over rounds")

    def _on_rollback(self, e: Dict[str, Any]) -> None:
        reg = self.registry
        reg.inc("aircomp_rollbacks_total",
                help_text="warm-rollback restores (divergence guard trips)")
        if _finite(e.get("epoch")):
            reg.set("aircomp_rollback_epoch", float(e["epoch"]),
                    help_text="current rollback epoch (key salt)")

    def _on_defense(self, e: Dict[str, Any]) -> None:
        reg = self.registry
        if _finite(e.get("rung")):
            reg.set("aircomp_defense_rung", float(e["rung"]),
                    help_text="current escalation-ladder rung")
        if _finite(e.get("flagged")):
            reg.set("aircomp_defense_flagged", float(e["flagged"]),
                    help_text="clients flagged by the detector this round")

    def _on_client_flag(self, e: Dict[str, Any]) -> None:
        if e.get("flagged"):
            self.registry.inc("aircomp_client_flags_total",
                              help_text="client_flag events with flagged=true")
            if self._byz == 0:
                # on a byz=0 run EVERY flag is a false positive — the
                # dedicated counter gives the benign_false_flag_rate rule
                # crisp semantics (a byz>0 run's genuine detections never
                # touch it)
                self.registry.inc(
                    "aircomp_benign_flags_total",
                    help_text="client flags raised on byz=0 runs "
                              "(every one is a false positive)",
                )

    def _on_retrace(self, e: Dict[str, Any]) -> None:
        reg = self.registry
        counts = e.get("counts") or {}
        if _finite(counts.get("round_fn")):
            reg.set("aircomp_retrace_round_lowerings",
                    float(counts["round_fn"]),
                    help_text="round_fn lowerings this run (SLO: exactly 1)")
        reg.set("aircomp_retrace_steady_state_ok",
                1.0 if e.get("steady_state_ok") else 0.0,
                help_text="1 when the steady-state retrace audit passed")

    def _on_run_end(self, e: Dict[str, Any]) -> None:
        reg = self.registry
        reg.set("aircomp_run_phase", PHASE_DONE,
                help_text="0=starting 1=running 2=done")
        if _finite(e.get("rounds_per_sec")):
            reg.set("aircomp_rounds_per_sec", float(e["rounds_per_sec"]))
        mem = e.get("memory") or {}
        if _finite(mem.get("modeled_peak_bytes")):
            reg.set("aircomp_hbm_modeled_peak_bytes",
                    float(mem["modeled_peak_bytes"]),
                    help_text="obs/hbm.py analytic peak model")
            # the watermark SLO ratio only exists for device-sourced
            # measurements — host RSS would trip it on every CPU run.  The
            # port's block carries the run's own peak (the card's watermark
            # less what the caller held before the run,
            # fed/harness.py::_memory_block), which is what the model
            # predicts; a block without it uses the device peak, as JAX does
            peak = mem.get("run_peak_bytes", mem.get("peak_bytes_in_use"))
            if (str(mem.get("source", "")).startswith("device")
                    and _finite(peak)
                    and float(mem["modeled_peak_bytes"]) > 0):
                reg.set(
                    "aircomp_hbm_watermark_ratio",
                    float(peak) / float(mem["modeled_peak_bytes"]),
                    help_text="measured device peak / modeled peak",
                )

    def _on_alert(self, e: Dict[str, Any]) -> None:
        if e.get("firing"):
            self.registry.inc(
                "aircomp_alerts_total",
                help_text="alert rule rising edges",
                rule=str(e.get("rule", "?")),
                severity=str(e.get("severity", "?")),
            )

    # crash-safe serving (serve/runs.py events, previously journal-only):
    # terminal failures by machine-readable cause, watchdog requeues, and
    # journal re-adoptions — the counters operators alert on without
    # tailing the journal

    @staticmethod
    def _failure_cause(reason: str) -> str:
        if reason.startswith("quarantined"):
            return "quarantine"
        if "wedged" in reason:
            return "wedged"
        return "error"

    def _on_run_failed(self, e: Dict[str, Any]) -> None:
        reg = self.registry
        reason = str(e.get("reason", ""))
        cause = self._failure_cause(reason)
        reg.inc("aircomp_run_failures_total",
                help_text="terminal run failures, by cause",
                cause=cause)
        if cause == "quarantine":
            reg.inc("aircomp_quarantines_total",
                    help_text="lane quarantines (run-level containment)")

    def _on_run_requeued(self, e: Dict[str, Any]) -> None:
        self.registry.inc(
            "aircomp_requeues_total",
            help_text="watchdog bounded-backoff requeues",
        )

    def _on_journal_replay(self, e: Dict[str, Any]) -> None:
        self.registry.inc(
            "aircomp_journal_replays_total",
            help_text="runs re-adopted from the durable journal on boot",
            status=str(e.get("status", "?")),
        )

    # elastic lane scheduling (serve/runs.py group loop): per-round
    # occupancy samples — the >90% acceptance bar, and the series the
    # lane_occupancy_floor alert windows over — plus the refill counter

    def _on_lane_group(self, e: Dict[str, Any]) -> None:
        reg = self.registry
        if _finite(e.get("occupancy")):
            reg.set("aircomp_lane_occupancy", float(e["occupancy"]),
                    help_text="live lanes / group width, sampled per round")
        if _finite(e.get("live")):
            reg.set("aircomp_lanes_live", float(e["live"]),
                    help_text="lanes with a seated live tenant")
        if _finite(e.get("lanes")):
            reg.set("aircomp_lanes_total", float(e["lanes"]),
                    help_text="lane-group width (vmapped batch size)")
        if _finite(e.get("queue_depth")):
            reg.set("aircomp_admission_queue_depth", float(e["queue_depth"]),
                    help_text="runs queued for admission to a lane group")

    def _on_lane_refill(self, e: Dict[str, Any]) -> None:
        self.registry.inc(
            "aircomp_lane_refills_total",
            help_text="drained lane slots reseated from the admission queue",
        )

    # 2-tier aggregation (serve/root.py events): the root's zero-trust
    # counters — ingress volume, rejections by reason, containment, and
    # degraded-round visibility (obs/alerts.py pages on quarantine rate)

    def _on_edge_partial(self, e: Dict[str, Any]) -> None:
        reg = self.registry
        reg.inc("aircomp_edge_partials_total",
                help_text="accepted HMAC-verified edge partials")
        if _finite(e.get("bytes")):
            reg.inc("aircomp_edge_ingress_bytes_total", float(e["bytes"]),
                    help_text="raw wire bytes accepted by the root")

    def _on_edge_reject(self, e: Dict[str, Any]) -> None:
        self.registry.inc(
            "aircomp_edge_rejects_total",
            help_text="rejected edge submissions, by reason",
            reason=str(e.get("reason", "?")),
        )

    def _on_edge_quarantine(self, e: Dict[str, Any]) -> None:
        reg = self.registry
        # unlabeled total first: the edge_quarantine_rate alert samples
        # it directly (registry.value with no labels reads the unlabeled
        # series), with the per-reason breakdown alongside for operators
        reg.inc("aircomp_edge_quarantines_total",
                help_text="edges contained by the root")
        reg.inc("aircomp_edge_quarantine_reasons_total",
                help_text="edge quarantines, by reason",
                reason=str(e.get("reason", "?")))

    def _on_edge_round(self, e: Dict[str, Any]) -> None:
        reg = self.registry
        reg.inc("aircomp_edge_rounds_total",
                help_text="2-tier rounds closed over the live set")
        if e.get("degraded"):
            reg.inc("aircomp_edge_degraded_rounds_total",
                    help_text="rounds folded over a surviving edge subset")
        if _finite(e.get("edges")):
            reg.set("aircomp_edge_live", float(e["edges"]),
                    help_text="live (non-quarantined) edges")
        if _finite(e.get("ingress_bytes")):
            reg.set("aircomp_edge_round_ingress_bytes",
                    float(e["ingress_bytes"]),
                    help_text="root ingress bytes for the last closed round")

    # health -------------------------------------------------------------

    #: seconds without a completed round before a "running" run reports
    #: itself wedged (/healthz flips to 503 through the exporter's
    #: ok-keyed status).  0 disables the check — wedge detection is
    #: opt-in (`--wedge-secs` arms the serve-side watchdog, which sets
    #: this on the sinks it owns); a standalone sink never flips its
    #: health on wall-clock alone.  The age only exists once a first
    #: round has completed, so a long initial compile never trips it.
    wedge_secs: float = 0.0

    def health(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The /healthz body: run phase, last-round age, rollback epoch.

        ``ok`` goes False — and the exporter's ``/healthz`` returns 503,
        so k8s-style probes work without parsing the body — when the run
        claims to be running but no round has completed for longer than
        :attr:`wedge_secs`; a ``reason`` key is added only then (the
        healthy body shape is unchanged)."""
        import time as _time

        reg = self.registry
        phase_num = reg.value("aircomp_run_phase")
        phase = {None: "starting", float(PHASE_STARTING): "starting",
                 float(PHASE_RUNNING): "running",
                 float(PHASE_DONE): "done"}.get(phase_num, "running")
        last_ts = reg.value("aircomp_last_round_ts")
        age = None
        if last_ts is not None:
            age = round((now if now is not None else _time.time()) - last_ts, 3)
        last_round = reg.value("aircomp_round")
        epoch = reg.value("aircomp_rollback_epoch")
        wedged = (
            phase == "running"
            and self.wedge_secs > 0
            and age is not None
            and age > self.wedge_secs
        )
        body = {
            "ok": not wedged,
            "phase": phase,
            "last_round": None if last_round is None else int(last_round),
            "last_round_age_secs": age,
            "rollback_epoch": 0 if epoch is None else int(epoch),
            "alerts_firing": int(reg.value("aircomp_alerts_firing") or 0),
        }
        if wedged:
            body["reason"] = (
                f"wedged: no completed round in {age:.0f}s "
                f"(threshold {self.wedge_secs:g}s)"
            )
        return body
