"""Event schema: one versioned shape for every runner's telemetry.

The port's copy of ``byzantine_aircomp_tpu/obs/events.py``: the schema
(``SCHEMA_VERSION``, ``REFERENCE_KEY_MAP``, ``_REQUIRED``) is the JAX
package's verbatim, so the JAX package's stream readers and its golden
fingerprint (``tests/test_schema.py``) hold the port's streams too.

Before this module each tool invented its own JSON: the harness pickled
reference-format path lists, the sweep printed ad-hoc cell rows, and each
benchmark hand-rolled its emission.  Now every event is a flat JSON object
with three reserved keys —

* ``v``    — integer schema version (:data:`SCHEMA_VERSION`), bumped on any
  breaking field change so downstream loaders can dispatch;
* ``kind`` — the event type (``run_start``, ``round``, ``span``, ``retrace``,
  ``run_end``, ``bench``, ``sweep_cell``, ``fault_cell``, ...);
* ``ts``   — wall-clock epoch seconds at emission (gap analysis only;
  NEVER used for metrics — durations come from span events — and NEVER
  used for ordering: wall-clock is non-monotonic under resume/append).

Sinks additionally stamp a fourth envelope key at emission time:

* ``seq``  — per-sink monotonic sequence number (``obs/sinks.py``).  A
  JSONL sink reopened in append mode continues from the existing line
  count, so ``seq`` is the total order analysis tools sort by even when a
  resumed run interleaves wall-clock timestamps.  It is stamped by the
  sink (on a copy — sinks never mutate events), so events validated
  before emission legitimately lack it; ``validate_event`` treats it as
  optional.

A fourth reserved key is stamped at ``make_event`` time:

* ``host_id`` — the emitting process's ``torch.distributed`` rank (0
  when no process group is up).  ``seq`` is only
  per-SINK monotonic; on a multi-host population mesh each process
  appends its own stream, and the analysis loaders merge them into one
  total order by ``(host_id, seq)`` (``analysis/obs_report.py``,
  ``analysis/tail.py``).  Old v<5 streams lack the key; loaders default
  it to 0.

The per-round ``round`` event mirrors — field for field — the reference
pickled record the harness still writes (bitwise untouched; the event
stream is written ALONGSIDE it).  :data:`REFERENCE_KEY_MAP` is the
machine-readable statement of that mapping, including the intentional
``variencePath`` spelling the reference's draw.ipynb consumes.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from . import trace

# v2: added the sink-stamped ``seq`` envelope key and the forensics kinds
# ``client_flag`` / ``forensic_dump`` (obs/forensics.py).
# v3: added the live-telemetry kinds ``alert`` (obs/alerts.py SLO rule
# transitions) and ``metrics_snapshot`` (end-of-run registry dump from
# obs/metrics.py).  Any change to a kind's required fields MUST bump this
# — tests/test_schema.py pins a golden fingerprint per version and fails
# CI on silent drift (``python tests/test_schema.py --regen`` prints the
# new golden row and the doc table stubs a bump requires).
# v4: added the multi-tenant serving kinds ``run_submitted`` /
# ``run_cancelled`` / ``knob_swap`` (serve/runs.py control-plane audit
# trail — every tenant-visible state change lands in the run's own
# event stream).
# v5: added the ``host_id`` envelope key (the JAX package's ``jax.process_index()``, the port's rank, at
# emission, 0 off-mesh) so multi-host population-sharded runs whose
# processes each append their own stream can be merged into one total
# order by ``(host_id, seq)`` — ``seq`` alone is only per-sink monotonic,
# and two hosts' sinks both start at 0.
# v6: added the crash-safety serving kinds ``run_failed`` (a lane
# quarantined by the BatchRunner health guards, or a run whose retries
# are exhausted — exactly one per failed run), ``run_requeued`` (the
# watchdog cancelled a wedged run and scheduled a bounded-backoff
# retry), and ``journal_replay`` (a restarted server re-adopted this run
# from the durable journal — ``status`` says resumed/restarted and
# ``round`` the checkpoint it resumes from).
# v7: added the 2-tier aggregation kinds (serve/root.py): ``edge_partial``
# (one accepted, HMAC-verified wire partial — ``bytes`` is its raw
# ingress size, the quantity the perf ledger's bytes/round row sums),
# ``edge_reject`` (a zero-trust rejection: ``reason`` is bad_mac /
# replay — attacker-producible, never contained — or bad_round /
# bad_seq, authenticated violations that accrue strikes),
# ``edge_quarantine`` (an edge contained — partial_timeout,
# bad_payload, nonfinite_partial, result_mismatch, strike_limit), and
# ``edge_round`` (a round closed over the live set; ``degraded`` marks
# a surviving-edge fold).
# v8: added the defense auto-tuner kinds (tune/tuner.py): ``tune_candidate``
# (one scored candidate — its knob params, the paired-lane fold's
# precision/recall/benign false-flag rate, and the scalar objective),
# ``tune_generation`` (one successive-halving generation closed:
# population, per-generation round budget, promoted survivor count), and
# ``tune_result`` (the tune's winner — exactly one per completed tune,
# carrying the tuned constants the artifact file persists).
# v9: added the elastic-scheduling kinds (serve/runs.py + serve/elastic.py):
# ``lane_group`` (one per group round boundary, scheduler-scoped — group
# width, live-lane count, the occupancy ratio the >90% acceptance gauge
# reads, and the admission-queue depth behind it) and ``lane_refill`` (a
# drained lane's slot reseated from the admission queue mid-group: which
# lane, the incoming tenant's own resume round, and the group round the
# splice landed at — the journal's ``refill`` op is the durable twin).
# v10: added the optional trace-context envelope keys ``trace_id`` (32-hex,
# shared by every event one logical request touches, across processes),
# ``span_id`` (16-hex — on a ``span`` event the span's own id, on any
# other event the enclosing span at emission), and ``parent_span_id``
# (the span this one nests under; absent on trace roots).  Stamped by
# ``make_event`` only while an ``obs.trace`` context is active — with
# ``--trace off`` (the default) nothing activates the context, so
# streams stay byte-identical to v9 modulo this version bump.  No kind's
# required fields changed, so the fingerprint matches v9's (the v5
# precedent: envelope-only additions).
SCHEMA_VERSION = 10

# round-event field -> reference pickled-record key it mirrors
# (round r's event carries metrics the record stores at index r+1 for the
# eval paths — index 0 is the pre-training eval — and index r for the
# per-round paths; see docs/OBSERVABILITY.md)
REFERENCE_KEY_MAP = {
    "train_loss": "trainLossPath",
    "train_acc": "trainAccPath",
    "val_loss": "valLossPath",
    "val_acc": "valAccPath",
    "variance": "variencePath",  # sic — reference spelling, kept verbatim
    "rounds_per_sec": "roundsPerSec",
    "dropped": "faultDroppedPath",
    "erased": "faultErasedPath",
    "corrupt": "faultCorruptPath",
    "effective_k": "effectiveKPath",
    # service-round fields (kind "round" under --service on; the round
    # closes at its deadline, so these are per-round participation
    # telemetry — see fed/train.py service_metrics)
    "available": "serviceAvailPath",
    "absent": "serviceAbsentPath",
    "late": "serviceLatePath",
    # defense-event fields (kind "defense"; defense/events.PATH_KEYS is the
    # authoritative copy — tests/test_defense.py pins the two in sync)
    "rung": "defenseRungPath",
    "flagged": "defenseFlaggedPath",
    "suspicious_iters": "defenseSuspiciousPath",
    "score_max": "defenseScorePath",
    "cusum_max": "defenseCusumPath",
    "transitions": "defenseTransitionsPath",
}

# per-kind required fields (beyond the reserved v/kind/ts trio); kinds not
# listed here are free-form carriers (bench rows keep their historical keys)
_REQUIRED: Dict[str, tuple] = {
    "run_start": ("title", "backend", "rounds", "start_round"),
    "round": ("round", "val_loss", "val_acc", "variance"),
    "span": ("name", "ms"),
    "retrace": ("counts", "steady_state_ok"),
    "run_end": ("elapsed_secs", "rounds_run"),
    "defense": ("round", "rung", "flagged"),
    # service rounds (fed/train.py): per-round participation summary and
    # the (rare) warm-rollback restore event
    "participation": ("round", "available", "absent", "late", "effective_k"),
    "rollback": ("round", "restored_round", "reason", "epoch"),
    # measurement layer (obs/profile.py, obs/ledger.py)
    "profile": ("dir",),
    "perf": ("metric", "value", "platform"),
    # client-level forensics (obs/forensics.py): one event per suspicious
    # client per round (``client`` is the stable population id under
    # --service on, the stack row otherwise), and the flight-recorder
    # dump notice pointing at the flight_<round>.json artifact
    "client_flag": ("round", "client", "score", "rung", "flagged"),
    "forensic_dump": ("round", "path", "reason", "window"),
    # live telemetry (obs/metrics.py, obs/alerts.py): an SLO rule edge
    # (``firing`` True on breach, False on clear — steady state is NOT
    # re-emitted every round) and the end-of-run metrics-registry dump
    "alert": ("round", "rule", "severity", "value", "firing"),
    "metrics_snapshot": ("round", "metrics"),
    # multi-tenant serving (serve/runs.py): control-plane audit events in
    # the run's own stream — submission (with the batch-group signature),
    # cancellation (at which round the lane went dark), and each accepted
    # between-rounds knob hot-swap
    "run_submitted": ("run_id", "title", "signature"),
    "run_cancelled": ("run_id", "round"),
    "knob_swap": ("run_id", "round", "knob", "value"),
    # crash-safe serving (serve/runs.py, serve/journal.py): quarantine /
    # watchdog terminal failure (exactly one per failed run, with the
    # machine-readable reason), the watchdog's bounded-backoff requeue
    # notice, and the journal-replay adoption marker a restarted server
    # writes into each re-adopted run's stream
    "run_failed": ("run_id", "round", "reason"),
    "run_requeued": ("run_id", "round", "retries", "reason"),
    "journal_replay": ("run_id", "status", "round"),
    # elastic lane scheduling (serve/runs.py group loop): the per-round
    # group occupancy sample the >90% acceptance gauge reads, and the
    # mid-group reseat of a drained lane from the admission queue
    "lane_group": ("round", "lanes", "live", "occupancy", "queue_depth"),
    "lane_refill": ("run_id", "lane", "round", "group_round"),
    # 2-tier aggregation (serve/root.py): the root's zero-trust audit
    # trail — accepted partials (with wire bytes for the ingress ledger),
    # rejections (reason: bad_mac/replay/...), edge containment, and the
    # per-round fleet close (degraded marks a surviving-edge fold)
    "edge_partial": ("round", "edge", "seq", "bytes"),
    "edge_reject": ("edge", "reason"),
    "edge_quarantine": ("edge", "reason"),
    "edge_round": ("round", "epoch", "edges", "degraded", "ingress_bytes"),
    # defense auto-tuner (tune/tuner.py): one event per scored candidate
    # (paired benign+attacked lane fold), one per closed generation, and
    # exactly one tune_result carrying the winning constants
    "tune_candidate": ("gen", "candidate", "objective", "precision",
                       "recall", "benign_flag_rate"),
    "tune_generation": ("gen", "population", "rounds", "survivors"),
    "tune_result": ("generations", "objective", "params"),
}


def _host_id() -> int:
    """The emitting process's rank: ``torch.distributed.get_rank()`` when a
    process group is up, else 0.  Resolved per event, so a process group
    started after import is still reflected."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:  # noqa: BLE001 - emission never depends on it
        pass
    return 0


def make_event(kind: str, **fields: Any) -> Dict[str, Any]:
    """Stamp ``fields`` into a schema-versioned event dict.

    While a trace context is active (``obs.trace`` — only ever under
    ``--trace on``) the envelope additionally carries ``trace_id`` and,
    when the context names an enclosing span, ``span_id``.  Explicit
    ``fields`` win — a span event's own ids are never overwritten.
    """
    event: Dict[str, Any] = {
        "v": SCHEMA_VERSION,
        "kind": kind,
        "ts": time.time(),
        "host_id": _host_id(),
    }
    ctx = trace.current()
    if ctx is not None:
        event["trace_id"] = ctx[0]
        if ctx[1] is not None:
            event["span_id"] = ctx[1]
    event.update(fields)
    return event


def validate_event(event: Dict[str, Any]) -> Dict[str, Any]:
    """Raise ``ValueError`` unless ``event`` is schema-valid; returns it."""
    for key in ("v", "kind", "ts"):
        if key not in event:
            raise ValueError(f"event missing reserved key {key!r}: {event}")
    if event["v"] != SCHEMA_VERSION:
        raise ValueError(
            f"schema version {event['v']} != {SCHEMA_VERSION}: {event}"
        )
    missing = [
        k for k in _REQUIRED.get(event["kind"], ()) if k not in event
    ]
    if missing:
        raise ValueError(
            f"{event['kind']} event missing fields {missing}: {event}"
        )
    return event


class Collector:
    """Turns the trainer's per-round metrics (the host floats of the
    round's evals, variance and fault/service rows) into ``round`` events
    on a sink.

    The trainer hands over exactly what it appends to the
    reference-compatible path lists, so the two streams cannot drift:
    one code path computes the numbers, the collector only reshapes.
    """

    def __init__(self, sink) -> None:
        self._sink = sink

    def round_event(
        self,
        round_idx: int,
        *,
        train_loss: float,
        train_acc: float,
        val_loss: float,
        val_acc: float,
        variance: float,
        round_secs: Optional[float] = None,
        rounds_per_sec: Optional[float] = None,
        compiled: Optional[bool] = None,
        fault_metrics: Optional[Dict[str, float]] = None,
        service_metrics: Optional[Dict[str, float]] = None,
        memory: Optional[Dict[str, Any]] = None,
    ) -> None:
        fields: Dict[str, Any] = dict(
            round=round_idx,
            train_loss=train_loss,
            train_acc=train_acc,
            val_loss=val_loss,
            val_acc=val_acc,
            variance=variance,
        )
        if round_secs is not None:
            fields["round_secs"] = round_secs
        if rounds_per_sec is not None:
            fields["rounds_per_sec"] = rounds_per_sec
        if compiled is not None:
            fields["compiled"] = compiled
        if fault_metrics:
            fields.update(fault_metrics)
        if service_metrics:
            fields.update(service_metrics)
        if memory:
            # watermark trio from obs.profile.device_memory — flat fields,
            # with mem_source labeling the CUDA allocator's stats vs host RSS
            fields["bytes_in_use"] = memory.get("bytes_in_use")
            fields["peak_bytes_in_use"] = memory.get("peak_bytes_in_use")
            fields["mem_source"] = memory.get("source")
        self._sink.emit(make_event("round", **fields))
