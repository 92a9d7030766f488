"""Declarative SLO rules evaluated live on the metrics registry.

The port's copy of ``byzantine_aircomp_tpu/obs/alerts.py``, with the same
default pack, so the two packages fire the same alerts on the same stream.
A long run cannot learn it diverged by reading files after the run: the
health signals the service rounds emit (rollback trips, effective-K,
deadline misses, rounds/sec) need a standing machine-checked bar.  This
module is that bar, kept config-as-data: a rule is a plain dict —

    {"name": "rollback_rate", "metric": "aircomp_rollbacks_total",
     "window": 8, "reduce": "delta", "op": "ge", "value": 1,
     "severity": "page", "absent": 0.0, "min_samples": 2}

— sample the metric each round into a sliding window, reduce
(``last``/``mean``/``min``/``max``/``delta`` = newest-oldest), compare
(``gt``/``ge``/``lt``/``le``) against a threshold (a constant ``value``,
optionally scaled off another metric via ``value_metric``/``value_scale``
— e.g. the effective-K floor is ``0.5 * aircomp_clients_k``).  ``absent``
gives the sample to record while the metric does not exist yet (counters
that are only created on their first increment sample as 0.0); rules
without it simply skip until the metric appears, so e.g. the HBM
watermark rule stays silent on CPU runs where no device watermark exists.

The engine emits schema-versioned ``alert`` events on EDGES only —
``firing=true`` when a rule starts breaching, ``firing=false`` when it
clears — through the same sink fan-out every other event uses, so alerts
land in the JSONL stream, the live tail, and the metrics registry
(``aircomp_alerts_total``) without a second pipeline.  ``--gate`` turns
a finished stream's alert events into a CI exit code, the same shape as
``analysis/perf_gate.py``; ``--self-check`` proves every default rule
fires on a synthetic breach and stays quiet on a healthy trace.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .events import make_event
from .metrics import MetricsRegistry, MetricsSink

SEVERITIES = ("info", "warn", "page")
REDUCES = ("last", "mean", "min", "max", "delta")
OPS = {
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
}

_RULE_KEYS = {
    "name", "metric", "labels", "window", "reduce", "op", "value",
    "value_metric", "value_scale", "severity", "min_samples", "absent",
    "quantile",
}


@dataclass
class Rule:
    """One SLO: a windowed predicate over a registry metric."""

    name: str
    metric: str
    op: str
    value: Optional[float] = None
    labels: Dict[str, str] = field(default_factory=dict)
    window: int = 1
    reduce: str = "last"
    value_metric: Optional[str] = None
    value_scale: float = 1.0
    severity: str = "warn"
    min_samples: int = 1
    absent: Optional[float] = None
    # when set (0 < q < 1), the metric must be a histogram and each
    # round's sample is its bucket-resolution q-quantile instead of the
    # scalar/count ``value`` returns — the shape span-derived latency
    # SLOs need (queue-wait p99, round critical-path ceiling)
    quantile: Optional[float] = None

    def __post_init__(self) -> None:
        if self.quantile is not None and not (0.0 < self.quantile < 1.0):
            raise ValueError(
                f"rule {self.name!r}: quantile must be in (0, 1), "
                f"got {self.quantile!r}"
            )
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"rule {self.name!r}: severity must be one of {SEVERITIES}, "
                f"got {self.severity!r}"
            )
        if self.reduce not in REDUCES:
            raise ValueError(
                f"rule {self.name!r}: reduce must be one of {REDUCES}, "
                f"got {self.reduce!r}"
            )
        if self.op not in OPS:
            raise ValueError(
                f"rule {self.name!r}: op must be one of {tuple(OPS)}, "
                f"got {self.op!r}"
            )
        if self.value is None and self.value_metric is None:
            raise ValueError(
                f"rule {self.name!r}: needs value or value_metric"
            )
        if self.window < 1 or self.min_samples < 1:
            raise ValueError(
                f"rule {self.name!r}: window/min_samples must be >= 1"
            )
        if self.reduce == "delta" and self.min_samples < 2:
            self.min_samples = 2  # a one-sample delta is always 0

    @classmethod
    def from_dict(cls, spec: Dict[str, Any]) -> "Rule":
        unknown = set(spec) - _RULE_KEYS
        if unknown:
            raise ValueError(
                f"rule {spec.get('name', '?')!r}: unknown keys {sorted(unknown)}"
            )
        return cls(**spec)


# the default SLO pack for always-on service rounds.  Thresholds are
# deliberately loose — these page on "the run is broken", not "the run
# is slow today"; tune per-deployment via --alerts <rules.json>.
DEFAULT_RULES: List[Dict[str, Any]] = [
    # any divergence-guard trip inside the window pages (delta over a
    # counter that samples 0.0 until its first increment)
    {"name": "rollback_rate", "metric": "aircomp_rollbacks_total",
     "window": 8, "reduce": "delta", "op": "ge", "value": 1,
     "severity": "page", "absent": 0.0, "min_samples": 2},
    # effective-K floor: any round's contributing cohort below K/2
    {"name": "effective_k_floor", "metric": "aircomp_effective_k",
     "window": 4, "reduce": "min", "op": "lt",
     "value_metric": "aircomp_clients_k", "value_scale": 0.5,
     "severity": "warn"},
    # sustained deadline misses: mean late clients above K/2
    {"name": "straggler_rate", "metric": "aircomp_participation_late",
     "window": 8, "reduce": "mean", "op": "gt",
     "value_metric": "aircomp_clients_k", "value_scale": 0.5,
     "severity": "warn", "min_samples": 4},
    # throughput floor: sustained sub-0.01 rounds/sec means wedged
    {"name": "rounds_per_sec_floor", "metric": "aircomp_rounds_per_sec",
     "window": 8, "reduce": "mean", "op": "lt", "value": 0.01,
     "severity": "warn", "min_samples": 8},
    # measured device peak vs the obs/hbm.py model (ratio gauge only
    # exists for device-sourced watermarks — silent on CPU hosts)
    {"name": "hbm_watermark", "metric": "aircomp_hbm_watermark_ratio",
     "reduce": "last", "op": "gt", "value": 2.0, "severity": "warn"},
    # steady-state rebuilds: more than one set-up of the eager round
    # (obs/retrace.py; the gauge lands at run end, finalize catches it)
    {"name": "retrace_lowerings",
     "metric": "aircomp_retrace_round_lowerings",
     "reduce": "last", "op": "gt", "value": 1, "severity": "page"},
    # non-finite train/val loss or variance reached the record
    {"name": "nonfinite_loss", "metric": "aircomp_nonfinite_loss_total",
     "window": 8, "reduce": "delta", "op": "ge", "value": 1,
     "severity": "page", "absent": 0.0, "min_samples": 2},
    # 2-tier containment: ANY edge quarantined inside the window pages —
    # an evicted edge is lost capacity AND a possible compromise
    # (bogus payload, result dissent, repeated authenticated
    # violations); see docs/RUNBOOK.md
    {"name": "edge_quarantine_rate",
     "metric": "aircomp_edge_quarantines_total",
     "window": 8, "reduce": "delta", "op": "ge", "value": 1,
     "severity": "page", "absent": 0.0, "min_samples": 2},
    # false-flag guard for honest deployments: on a byz=0 run every
    # client flag is by construction a false positive (the failure mode
    # IID-tuned detector constants hit on non-IID honest clients —
    # docs/DESIGN.md "Tuning the defense").  The metric only counts
    # flags folded from byz=0 streams, so a byz>0 run's genuine
    # detections never fire this
    {"name": "benign_false_flag_rate",
     "metric": "aircomp_benign_flags_total",
     "window": 8, "reduce": "delta", "op": "ge", "value": 1,
     "severity": "warn", "absent": 0.0, "min_samples": 2},
    # elastic lane groups: occupancy (live lanes / width, sampled per
    # round by the scheduler's lane_group events) sagging below 90% for
    # 4 straight samples means the refill path is not keeping lanes fed
    # despite a queue (or the queue itself ran dry under churn).  No
    # ``absent`` stand-in: runs without a lane group stay silent.
    {"name": "lane_occupancy_floor", "metric": "aircomp_lane_occupancy",
     "window": 4, "reduce": "max", "op": "lt", "value": 0.9,
     "severity": "warn", "min_samples": 4},
    # span-derived latency SLOs.  Both sample histograms the
    # MetricsSink folds from span events at bucket-resolution quantiles;
    # no ``absent`` stand-in, so runs that never emit the span (no
    # admission queue / no round spans folded yet) stay silent.
    # admission wait: a tenant queued more than 30s at p99 means the
    # scheduler is starved or the group is wedged behind a slow lane
    {"name": "queue_wait_p99", "metric": "aircomp_queue_wait_seconds",
     "reduce": "last", "op": "gt", "value": 30.0, "quantile": 0.99,
     "severity": "warn"},
    # round critical-path ceiling: the server-measured round span (the
    # whole dispatch critical path, not just device time) above 60s at
    # p99 — loose on purpose; tune per-deployment
    {"name": "round_critical_path", "metric": "aircomp_stage_seconds",
     "labels": {"stage": "round"}, "reduce": "last", "op": "gt",
     "value": 60.0, "quantile": 0.99, "severity": "warn"},
]


def load_rules(spec: str) -> List[Rule]:
    """``"default"`` -> the built-in pack; anything else is a path to a
    JSON list of rule dicts."""
    if spec == "default":
        dicts = DEFAULT_RULES
    else:
        with open(spec) as f:
            dicts = json.load(f)
        if not isinstance(dicts, list):
            raise ValueError(f"alert rules file {spec}: expected a JSON list")
    return [Rule.from_dict(dict(d)) for d in dicts]


class _RuleState:
    __slots__ = ("samples", "firing", "fired", "last_value")

    def __init__(self, window: int) -> None:
        self.samples: deque = deque(maxlen=window)
        self.firing = False
        self.fired = 0
        self.last_value: Optional[float] = None


class AlertEngine:
    """Evaluates a rule list against a registry, once per round.

    Edge-triggered: one ``alert`` event when a rule starts firing, one
    (``firing=false``) when it clears.  The per-rule sliding windows are
    owned by the harness thread — the exporter thread only reads the
    registry, never the engine.
    """

    def __init__(self, rules: List[Rule], registry: MetricsRegistry) -> None:
        self.rules = list(rules)
        self.registry = registry
        self._state = {r.name: _RuleState(r.window) for r in self.rules}

    def evaluate(self, round_idx: int, sink) -> List[Dict[str, Any]]:
        """Sample + reduce + compare every rule; emit edge events on
        ``sink``.  Returns the alert events emitted this call."""
        emitted: List[Dict[str, Any]] = []
        for rule in self.rules:
            st = self._state[rule.name]
            if rule.quantile is not None:
                sample = self.registry.quantile(
                    rule.metric, rule.quantile, **rule.labels
                )
            else:
                sample = self.registry.value(rule.metric, **rule.labels)
            if sample is None:
                if rule.absent is None:
                    continue  # metric not born yet and no stand-in
                sample = rule.absent
            st.samples.append(float(sample))
            if len(st.samples) < rule.min_samples:
                continue
            reduced = _reduce(rule.reduce, st.samples)
            st.last_value = reduced
            threshold = rule.value
            if rule.value_metric is not None:
                ref = self.registry.value(rule.value_metric)
                if ref is None:
                    continue  # no reference metric -> rule not in force
                threshold = ref * rule.value_scale
            breach = OPS[rule.op](reduced, threshold)
            if breach != st.firing:
                st.firing = breach
                if breach:
                    st.fired += 1
                event = make_event(
                    "alert",
                    round=round_idx,
                    rule=rule.name,
                    severity=rule.severity,
                    metric=rule.metric,
                    value=reduced,
                    threshold=threshold,
                    firing=breach,
                )
                sink.emit(event)
                emitted.append(event)
        self.registry.set(
            "aircomp_alerts_firing",
            float(sum(1 for s in self._state.values() if s.firing)),
            help_text="alert rules currently in breach",
        )
        return emitted

    def finalize(self, round_idx: int, sink) -> Dict[str, Any]:
        """One last evaluation (run-end gauges — retrace count, HBM
        watermark ratio — only exist now) plus the run summary."""
        self.evaluate(round_idx, sink)
        rules_out = {}
        worst = None
        total = 0
        for rule in self.rules:
            st = self._state[rule.name]
            rules_out[rule.name] = {
                "fired": st.fired,
                "firing": st.firing,
                "severity": rule.severity,
                "last_value": st.last_value,
            }
            total += st.fired
            if st.fired and (
                worst is None
                or SEVERITIES.index(rule.severity) > SEVERITIES.index(worst)
            ):
                worst = rule.severity
        return {"rules": rules_out, "total_fired": total, "worst": worst}


def _reduce(how: str, samples: deque) -> float:
    if how == "last":
        return samples[-1]
    if how == "mean":
        return sum(samples) / len(samples)
    if how == "min":
        return min(samples)
    if how == "max":
        return max(samples)
    return samples[-1] - samples[0]  # delta: newest - oldest in window


# --------------------------------------------------------------------------
# CLI: --self-check scenario table and --gate (stream -> exit code)
# --------------------------------------------------------------------------


def _mk(kind: str, **fields) -> Dict[str, Any]:
    return make_event(kind, **fields)


def _scenarios() -> Dict[str, Dict[str, List[Dict[str, Any]]]]:
    """Per-rule synthetic traces: ``breach`` must fire the rule,
    ``healthy`` must leave the whole engine quiet.  Events are fed
    through a real MetricsSink so the scenarios exercise the same fold
    the harness uses."""
    K = 8

    def rounds(n, start=0, **over):
        out = []
        for r in range(start, start + n):
            fields = dict(round=r, train_loss=0.5, train_acc=0.8,
                          val_loss=0.5, val_acc=0.8, variance=1.0,
                          round_secs=0.02, rounds_per_sec=50.0)
            fields.update(over)
            out.append(_mk("round", **fields))
        return out

    def participation(r, late=0, absent=0):
        eff = K - late
        return _mk("participation", round=r, available=K - absent,
                   absent=absent, late=late, effective_k=eff)

    start = [_mk("run_start", title="t", backend="cpu", rounds=16,
                 start_round=0, k=K)]
    healthy_service = start + [
        e for r in range(10)
        for e in (participation(r), rounds(1, start=r)[0])
    ]
    return {
        "rollback_rate": {
            "healthy": healthy_service,
            "breach": start + rounds(4) + [
                _mk("rollback", round=4, restored_round=3,
                    reason="non_finite", epoch=1),
            ] + rounds(2, start=4),
        },
        "effective_k_floor": {
            "healthy": healthy_service,
            "breach": start + [participation(0, late=K - 3)] + rounds(1),
        },
        "straggler_rate": {
            "healthy": healthy_service,
            "breach": start + [
                e for r in range(6)
                for e in (participation(r, late=K - 3), rounds(1, start=r)[0])
            ],
        },
        "rounds_per_sec_floor": {
            "healthy": healthy_service,
            "breach": start + rounds(10, rounds_per_sec=0.001),
        },
        "hbm_watermark": {
            "healthy": start + rounds(2) + [
                _mk("run_end", elapsed_secs=1.0, rounds_run=2,
                    memory={"source": "device:0", "peak_bytes_in_use": 90,
                            "modeled_peak_bytes": 100}),
            ],
            "breach": start + rounds(2) + [
                _mk("run_end", elapsed_secs=1.0, rounds_run=2,
                    memory={"source": "device:0", "peak_bytes_in_use": 300,
                            "modeled_peak_bytes": 100}),
            ],
        },
        "retrace_lowerings": {
            "healthy": start + rounds(2) + [
                _mk("retrace", counts={"round_fn": 1}, steady_state_ok=True),
            ],
            "breach": start + rounds(2) + [
                _mk("retrace", counts={"round_fn": 3}, steady_state_ok=False),
            ],
        },
        "nonfinite_loss": {
            "healthy": healthy_service,
            "breach": start + rounds(2) + rounds(
                1, start=2, val_loss=float("nan")
            ) + rounds(1, start=3),
        },
        "edge_quarantine_rate": {
            "healthy": healthy_service,
            "breach": start + rounds(2) + [
                _mk("edge_quarantine", edge=2, reason="partial_timeout"),
            ] + rounds(2, start=2),
        },
        "benign_false_flag_rate": {
            # healthy is deliberately NOT flag-free: a byz=2 run's genuine
            # detection must leave the benign counter (and the whole pack)
            # untouched — only byz=0 streams feed it
            "healthy": [
                _mk("run_start", title="t", backend="cpu", rounds=16,
                    start_round=0, k=K, byz=2),
            ] + rounds(2) + [
                _mk("client_flag", round=2, client=7, score=9.0, rung=1,
                    flagged=True),
            ] + rounds(2, start=2),
            "breach": [
                _mk("run_start", title="t", backend="cpu", rounds=16,
                    start_round=0, k=K, byz=0),
            ] + rounds(2) + [
                _mk("client_flag", round=2, client=3, score=4.0, rung=0,
                    flagged=True),
            ] + rounds(2, start=2),
        },
        "queue_wait_p99": {
            # a tenant seated in 50ms: p99 resolves to a sub-second
            # bucket edge, far under the 30s ceiling
            "healthy": start + [
                _mk("span", name="queue_wait", ms=50.0, run_id="r1"),
            ] + rounds(4),
            # 90s in the admission queue lands in the +Inf bucket; the
            # quantile saturates and the ceiling fires
            "breach": start + [
                _mk("span", name="queue_wait", ms=90_000.0, run_id="r1"),
            ] + rounds(4),
        },
        "round_critical_path": {
            "healthy": start + [
                _mk("span", name="round", ms=20.0, round=0),
            ] + rounds(4),
            "breach": start + [
                _mk("span", name="round", ms=120_000.0, round=0),
            ] + rounds(4),
        },
        "lane_occupancy_floor": {
            # a single-round sag (one lane draining before its refill
            # lands) must NOT fire: the window max sees the recovery
            "healthy": start + [
                e for r in range(6)
                for e in (
                    _mk("lane_group", round=r, lanes=8,
                        live=7 if r == 3 else 8,
                        occupancy=0.875 if r == 3 else 1.0,
                        queue_depth=0),
                    rounds(1, start=r)[0],
                )
            ],
            # sustained half-empty group: refill starved for 5 rounds
            "breach": start + [
                e for r in range(5)
                for e in (
                    _mk("lane_group", round=r, lanes=8, live=4,
                        occupancy=0.5, queue_depth=0),
                    rounds(1, start=r)[0],
                )
            ],
        },
    }


def _run_scenario(events: List[Dict[str, Any]]):
    """Feed a synthetic trace through MetricsSink + AlertEngine the way
    the harness does: fold each event, evaluate after each round event,
    finalize at the end.  Returns {rule name: rising edges}."""
    from .sinks import MemorySink

    registry = MetricsRegistry()
    msink = MetricsSink(registry)
    out = MemorySink()
    engine = AlertEngine(load_rules("default"), registry)
    last_round = 0
    for e in events:
        msink.emit(e)
        if e["kind"] == "round":
            last_round = e["round"]
            engine.evaluate(e["round"], out)
    summary = engine.finalize(last_round, out)
    return {
        name: info["fired"] for name, info in summary["rules"].items()
    }


def self_check() -> int:
    """Every default rule fires on its breach trace and the WHOLE pack
    stays quiet on its healthy trace.  Prints the scenario table."""
    failures = 0
    names = {r["name"] for r in DEFAULT_RULES}
    scen = _scenarios()
    missing = sorted(names - set(scen))
    if missing:
        print(f"FAIL: default rules without a scenario: {missing}")
        failures += 1
    print(f"{'rule':<22} {'breach':>8} {'healthy':>8}  verdict")
    for name in sorted(scen):
        fired_breach = _run_scenario(scen[name]["breach"])
        fired_healthy = _run_scenario(scen[name]["healthy"])
        ok = fired_breach.get(name, 0) >= 1 and sum(
            fired_healthy.values()
        ) == 0
        verdict = "ok" if ok else "FAIL"
        if not ok:
            failures += 1
            noisy = {k: v for k, v in fired_healthy.items() if v}
            if noisy:
                verdict += f" (healthy trace fired {noisy})"
            if fired_breach.get(name, 0) < 1:
                verdict += " (breach trace did not fire)"
        print(
            f"{name:<22} {fired_breach.get(name, 0):>8} "
            f"{sum(fired_healthy.values()):>8}  {verdict}"
        )
    print("self-check:", "FAIL" if failures else "ok")
    return 1 if failures else 0


def gate(events_path: str, fail_on: str = "page") -> int:
    """Exit code from a finished stream's alert events: 1 when any
    rising edge at or above ``fail_on`` severity fired."""
    from ..analysis.defense_trace import load_events

    floor = SEVERITIES.index(fail_on)
    bad = [
        e for e in load_events(events_path)
        if e.get("kind") == "alert" and e.get("firing")
        and SEVERITIES.index(e.get("severity", "info")) >= floor
    ]
    for e in bad:
        print(
            f"ALERT {e.get('severity')}: {e.get('rule')} at round "
            f"{e.get('round')} (value={e.get('value')}, "
            f"threshold={e.get('threshold')})"
        )
    print(
        f"alert gate: {len(bad)} firing alert(s) at severity >= {fail_on}"
        + ("" if bad else " — ok")
    )
    return 1 if bad else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="SLO alert engine: self-check scenarios or gate a "
        "finished event stream"
    )
    ap.add_argument("--self-check", action="store_true",
                    help="run the default-rule scenario table")
    ap.add_argument("--gate", metavar="EVENTS_JSONL",
                    help="exit 1 if the stream has firing alerts at or "
                    "above --fail-on severity")
    ap.add_argument("--fail-on", choices=SEVERITIES, default="page")
    args = ap.parse_args(argv)
    if args.self_check:
        return self_check()
    if args.gate:
        return gate(args.gate, args.fail_on)
    ap.error("nothing to do: pass --self-check or --gate")
    return 2


if __name__ == "__main__":
    sys.exit(main())
