"""Persisted performance ledger: bench rows as an enforced trajectory.

The port's copy of ``byzantine_aircomp_tpu/obs/ledger.py``:

* one JSONL file of ``perf`` rows — ``{metric, value, unit, platform, key,
  note, ts}`` — appended through :class:`..sinks.JsonlSink`.  The port's
  default file is ``chiprun_out/perf_ledger_cuda.jsonl`` (its
  ``platform: "cuda"`` rows, each with the card's name and power limit);
  the JAX package's ``docs/perf_ledger.jsonl`` is read as any other path;
* baselines keyed on ``(metric, platform, key)``, where ``key`` encodes
  the config-relevant knobs (:func:`config_key`);
* noise-robust statistics: median + MAD over the last N same-platform
  rows;
* a :func:`PerfLedger.compare` verdict: ``ok`` / ``regression`` /
  ``improvement`` / ``new_metric`` / ``platform_mismatch``.  The platform
  gate is absolute: a row of one platform is never scored against
  another's history.
"""

from __future__ import annotations

import json
import sys
from typing import Any, Dict, List

from .events import make_event
from .sinks import JsonlSink

#: the port's default on-disk location, relative to the repo root
DEFAULT_LEDGER_PATH = "chiprun_out/perf_ledger_cuda.jsonl"

#: row fields that define a comparable configuration (sorted into ``key``);
#: deliberately excludes output-only knobs and per-run facts (timed_rounds,
#: ts, value) — mirrors the config_hash philosophy at bench granularity
CONFIG_KEY_FIELDS = ("k", "b", "agg", "attack", "dataset", "model",
                     "pop_shards")

#: descriptive row fields worth carrying INTO the ledger when present —
#: not part of the config key, but they make a row self-describing (the
#: stream_ksweep rows' peak-bytes columns live here: measured watermark
#: plus the obs/hbm.py streamed and resident models)
LEDGER_EXTRA_FIELDS = (
    "cohort_size",
    "d",
    "peak_measured_bytes",
    "peak_source",
    "peak_streamed_modeled_bytes",
    "peak_resident_modeled_bytes",
    # packed one-bit sign channel (ops/aggregators.pack_signs): modeled
    # wire/reduce traffic of the row's realization vs the f32 baseline it
    # replaces, and the payload width that produced it — the columns the
    # ~32x bandwidth acceptance gate reads (analysis/perf_gate.py)
    "bytes_moved",
    "bytes_moved_f32",
    "sign_bits",
    # service-mode stream_ksweep rows (BENCH_KSWEEP_SERVICE): rows record
    # k = population (the id space the round draws from), and carry the
    # per-host streamed model from obs/hbm.py when the round ran sharded
    # over the population mesh (pop_shards > 1 is part of the config key)
    "population",
    "peak_per_host_modeled_bytes",
    # multi-round dispatch tier (BENCH_MULTIROUND): how many rounds each
    # device dispatch scanned — the R axis of the dispatch-rim sweep the
    # ≥10x acceptance gate reads (the R value is also baked into the
    # metric name, so same-R rows regression-test against each other)
    "rounds_per_dispatch",
    # heterogeneity sweep rows (BENCH_HETERO): the Dirichlet level and
    # quantity-skew spec behind the row — the alpha label is also baked
    # into the metric name, so same-level rows regression-test against
    # each other while the columns keep the row self-describing
    "dirichlet_alpha",
    "size_skew",
)

#: relative band half-width tolerated as noise (±10%)
DEFAULT_REL_TOL = 0.10
#: MAD multiples folded into the band (1.4826 * MAD ~ sigma for normals)
DEFAULT_MAD_SIGMAS = 4.0
#: baseline window: last N same-(metric, platform, key) rows
DEFAULT_WINDOW = 10


def config_key(row: Dict[str, Any]) -> str:
    """Canonical config-knob key for a row: ``k=1000|b=100|agg=gm2|...``
    over whichever :data:`CONFIG_KEY_FIELDS` the row carries (sorted).
    Rows without any config fields (legacy ``BENCH_r*.json`` snapshots)
    key to ``""`` — treated as a wildcard by :meth:`PerfLedger.compare`
    so history predating the keying scheme stays comparable."""
    parts = [
        f"{f}={row[f]}"
        for f in sorted(CONFIG_KEY_FIELDS)
        if row.get(f) is not None
    ]
    return "|".join(parts)


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def robust_stats(values: List[float]) -> Dict[str, float]:
    """Median + MAD (median absolute deviation) of ``values``."""
    med = _median(values)
    mad = _median([abs(v - med) for v in values])
    return {"median": med, "mad": mad, "n": len(values)}


class PerfLedger:
    """Read/append/compare interface over one perf-ledger JSONL file."""

    def __init__(self, path: str = DEFAULT_LEDGER_PATH) -> None:
        self.path = path

    def rows(self) -> List[Dict[str, Any]]:
        """All parseable rows, in file order; malformed lines are skipped
        with a stderr note (a killed append may truncate the tail)."""
        out: List[Dict[str, Any]] = []
        try:
            fh = open(self.path)
        except OSError:
            return out
        with fh:
            for i, line in enumerate(fh):
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    print(
                        f"[ledger] skipping malformed line {i + 1} in "
                        f"{self.path}",
                        file=sys.stderr,
                    )
                    continue
                if isinstance(row, dict) and "metric" in row:
                    out.append(row)
        return out

    def append(
        self,
        metric: str,
        value: float,
        *,
        unit: str = "",
        platform: str = "",
        key: str = "",
        **extra: Any,
    ) -> Dict[str, Any]:
        """Append one ``perf`` row through a :class:`JsonlSink` (same
        append-one-line-and-flush durability as every event stream)."""
        event = make_event(
            "perf",
            metric=metric,
            value=value,
            unit=unit,
            platform=platform,
            key=key,
            **extra,
        )
        sink = JsonlSink(self.path)
        try:
            sink.emit(event)
        finally:
            sink.close()
        return event

    def history(
        self, metric: str, platform: str, key: str = ""
    ) -> List[float]:
        """Same-(metric, platform, key) values, file order (oldest first)."""
        return [
            float(r["value"])
            for r in self._candidates(metric, key)
            if r.get("platform") == platform and "value" in r
        ]

    def _candidates(self, metric: str, key: str) -> List[Dict[str, Any]]:
        rows = [r for r in self.rows() if r.get("metric") == metric]
        if not key:
            return rows
        # legacy rows with no key act as wildcards; a NON-empty key that
        # differs means a genuinely different config under the same metric
        # name — excluded from the baseline
        return [r for r in rows if r.get("key", "") in ("", key)]

    def compare(
        self,
        metric: str,
        value: float,
        *,
        platform: str,
        key: str = "",
        window: int = DEFAULT_WINDOW,
        rel_tol: float = DEFAULT_REL_TOL,
        mad_sigmas: float = DEFAULT_MAD_SIGMAS,
        higher_is_better: bool = True,
    ) -> Dict[str, Any]:
        """Verdict for a fresh measurement against the ledger.

        The noise band is ``max(rel_tol, mad_sigmas * 1.4826 * MAD /
        |median|)`` — at least ±``rel_tol`` relative (so a quiet
        synthetic history still tolerates ±10% jitter), widened when the
        recorded history is itself noisy.  ``ratio`` is value/median
        oriented so that < 1 is worse regardless of
        ``higher_is_better``.
        """
        verdict: Dict[str, Any] = {
            "metric": metric,
            "value": value,
            "platform": platform,
            "key": key,
        }
        candidates = self._candidates(metric, key)
        if not candidates:
            verdict["verdict"] = "new_metric"
            return verdict
        same_platform = [
            r for r in candidates if r.get("platform") == platform
        ]
        if not same_platform:
            # the BENCH_r05 blind spot: a cpu-fallback row must never be
            # scored against an accelerator baseline
            verdict["verdict"] = "platform_mismatch"
            verdict["baseline_platforms"] = sorted(
                {str(r.get("platform")) for r in candidates}
            )
            return verdict
        hist = [
            float(r["value"]) for r in same_platform if "value" in r
        ][-window:]
        stats = robust_stats(hist)
        med, mad = stats["median"], stats["mad"]
        verdict["baseline"] = {**stats, "window": window}
        if med == 0:
            verdict["verdict"] = "ok"  # degenerate baseline: nothing to scale
            return verdict
        raw_ratio = value / med
        ratio = raw_ratio if higher_is_better else 1.0 / raw_ratio
        band = max(rel_tol, mad_sigmas * 1.4826 * mad / abs(med))
        verdict["ratio"] = ratio
        verdict["band"] = band
        if ratio < 1.0 - band:
            verdict["verdict"] = "regression"
        elif ratio > 1.0 + band:
            verdict["verdict"] = "improvement"
        else:
            verdict["verdict"] = "ok"
        return verdict
