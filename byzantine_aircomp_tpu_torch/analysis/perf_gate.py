"""Performance gate: a measurement row + the perf ledger -> a CI exit code.

The port's copy of ``byzantine_aircomp_tpu/analysis/perf_gate.py``, over
the port's ledger: its default is ``chiprun_out/perf_ledger_cuda.jsonl``,
which ``chip_smoke.py`` fills with ``platform: "cuda"`` rows (each with the
card's name and power limit)::

    python -m byzantine_aircomp_tpu_torch.analysis.perf_gate \\
        --metric METRIC --value VALUE --platform cuda --expect-platform cuda

* loads the measurement row (a bare row, a snapshot with a
  ``parsed`` field, or JSONL — last parseable object wins; or spell it
  out with ``--metric/--value/--platform``);
* compares against the ledger's ``(metric, platform, config-key)``
  baseline (median + MAD over the last N rows —
  :meth:`obs.ledger.PerfLedger.compare`);
* exits **1 on regression**, 0 on ``ok`` / ``improvement`` /
  ``new_metric``.  ``platform_mismatch`` exits 0 with a loud warning by
  default or 3 under ``--strict-platform``; ``--expect-platform cuda``
  forces the verdict when the row's platform differs.  A ``cuda`` row is
  never scored against a TPU or CPU baseline: the ledger keys baselines
  on the platform, and a row whose platform has no history comes back
  ``platform_mismatch``.

``--append`` records the gated row into the ledger after an ``ok`` /
``improvement`` / ``new_metric`` verdict; ``--self-check`` runs the
synthetic scenarios (2x slowdown must fail, ±10% noise must pass, a CPU
or TPU row against CUDA history must refuse) against a throwaway ledger.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Any, Dict, Optional

from ..obs.ledger import (
    DEFAULT_LEDGER_PATH,
    DEFAULT_MAD_SIGMAS,
    DEFAULT_REL_TOL,
    DEFAULT_WINDOW,
    LEDGER_EXTRA_FIELDS,
    PerfLedger,
    config_key,
)

EXIT_OK = 0
EXIT_REGRESSION = 1
EXIT_USAGE = 2
EXIT_PLATFORM = 3


def extract_row(obj: Any) -> Optional[Dict[str, Any]]:
    """Pull the bench measurement out of whatever shape the caller has:
    a bare row (has ``metric``), a snapshot (``parsed`` holds the
    row), or a list (last row wins)."""
    if isinstance(obj, list):
        for item in reversed(obj):
            row = extract_row(item)
            if row is not None:
                return row
        return None
    if not isinstance(obj, dict):
        return None
    if "metric" in obj and "value" in obj:
        return obj
    if isinstance(obj.get("parsed"), (dict, list)):
        return extract_row(obj["parsed"])
    return None


def load_row(path: str) -> Optional[Dict[str, Any]]:
    """Row from a JSON file, or JSONL (last parseable object wins)."""
    text = open(path).read()
    try:
        return extract_row(json.loads(text))
    except json.JSONDecodeError:
        pass
    row = None
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            candidate = extract_row(json.loads(line))
        except json.JSONDecodeError:
            continue
        if candidate is not None:
            row = candidate
    return row


def gate(
    row: Dict[str, Any],
    ledger: PerfLedger,
    *,
    expect_platform: str = "",
    window: int = DEFAULT_WINDOW,
    rel_tol: float = DEFAULT_REL_TOL,
    mad_sigmas: float = DEFAULT_MAD_SIGMAS,
) -> Dict[str, Any]:
    """The verdict dict for one row (no I/O beyond the ledger read)."""
    platform = str(row.get("platform", "unknown"))
    if expect_platform and platform != expect_platform:
        return {
            "verdict": "platform_mismatch",
            "metric": row.get("metric"),
            "value": row.get("value"),
            "platform": platform,
            "expected_platform": expect_platform,
            "fallback_reason": row.get("fallback_reason") or row.get("error"),
        }
    verdict = ledger.compare(
        str(row["metric"]),
        float(row["value"]),
        platform=platform,
        key=config_key(row),
        window=window,
        rel_tol=rel_tol,
        mad_sigmas=mad_sigmas,
    )
    # bandwidth rows (the packed sign channel): surface the modeled
    # bytes_moved ratio in the verdict so the ~32x claim is in the gate
    # output, not just a JSON field nobody reads
    if row.get("bytes_moved") is not None and row.get("bytes_moved_f32"):
        verdict["bytes_moved"] = row["bytes_moved"]
        verdict["bytes_moved_f32"] = row["bytes_moved_f32"]
        verdict["bytes_ratio"] = round(
            row["bytes_moved"] / row["bytes_moved_f32"], 4
        )
    return verdict


def _exit_code(verdict: str, strict_platform: bool) -> int:
    if verdict == "regression":
        return EXIT_REGRESSION
    if verdict == "platform_mismatch" and strict_platform:
        return EXIT_PLATFORM
    return EXIT_OK


def self_check() -> int:
    """Synthetic acceptance scenarios against a throwaway CUDA ledger.

    Deterministic by construction (fixed pseudo-noise values, no RNG):
    the gate must flag a 2x slowdown, tolerate ±10% jitter, refuse a CPU
    or TPU row against CUDA history, and call an unknown metric new."""
    fd, path = tempfile.mkstemp(suffix=".jsonl")
    os.close(fd)
    os.unlink(path)
    led = PerfLedger(path)
    # ±10%-jittered history around 100 (fixed values, median 100.5)
    for v in [100.0, 92.0, 107.0, 98.0, 103.0, 95.0, 109.0, 101.0]:
        led.append("rps_synth", v, unit="rounds/sec", platform="cuda")
    led.append("ms_synth", 40.0, unit="ms", platform="cuda")
    scenarios = [
        ("2x slowdown -> regression",
         {"metric": "rps_synth", "value": 50.0, "platform": "cuda"},
         "regression"),
        ("+8% jitter -> ok",
         {"metric": "rps_synth", "value": 108.5, "platform": "cuda"},
         "ok"),
        ("-9% jitter -> ok",
         {"metric": "rps_synth", "value": 91.5, "platform": "cuda"},
         "ok"),
        ("cpu row vs cuda-only history -> platform_mismatch",
         {"metric": "rps_synth", "value": 0.6, "platform": "cpu"},
         "platform_mismatch"),
        ("tpu row vs cuda-only history -> platform_mismatch",
         {"metric": "rps_synth", "value": 100.0, "platform": "tpu"},
         "platform_mismatch"),
        ("unknown metric -> new_metric",
         {"metric": "rps_never_seen", "value": 1.0, "platform": "cuda"},
         "new_metric"),
    ]
    failures = 0
    for name, row, expected in scenarios:
        got = gate(row, led)["verdict"]
        status = "PASS" if got == expected else "FAIL"
        if got != expected:
            failures += 1
        print(f"[perf_gate] self-check {status}: {name} (got {got})")
    os.unlink(path)
    if failures:
        print(f"[perf_gate] self-check: {failures} scenario(s) FAILED",
              file=sys.stderr)
        return EXIT_REGRESSION
    print("[perf_gate] self-check: all scenarios passed")
    return EXIT_OK


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ledger", default=DEFAULT_LEDGER_PATH,
                    help="perf ledger JSONL (obs/ledger.py)")
    ap.add_argument("--row", default=None,
                    help="measurement file: a row as JSON, a snapshot "
                    "(its 'parsed' row), or JSONL (last row wins)")
    ap.add_argument("--metric", default=None, help="inline row: metric name")
    ap.add_argument("--value", type=float, default=None,
                    help="inline row: measured value")
    ap.add_argument("--platform", default=None,
                    help="inline row: platform the value was measured on")
    ap.add_argument("--expect-platform", default="",
                    help="require the row's platform to be this; anything "
                    "else is platform_mismatch (catches silent CPU fallback)")
    ap.add_argument("--strict-platform", action="store_true",
                    help="exit 3 (not 0) on platform_mismatch")
    ap.add_argument("--window", type=int, default=DEFAULT_WINDOW)
    ap.add_argument("--rel-tol", type=float, default=DEFAULT_REL_TOL)
    ap.add_argument("--mad-sigmas", type=float, default=DEFAULT_MAD_SIGMAS)
    ap.add_argument("--append", action="store_true",
                    help="append the row to the ledger on an ok/"
                    "improvement/new_metric verdict")
    ap.add_argument("--json", action="store_true",
                    help="emit the verdict as JSON on stdout")
    ap.add_argument("--self-check", action="store_true",
                    help="run the synthetic scenarios and exit")
    args = ap.parse_args(argv)

    if args.self_check:
        return self_check()

    if args.row:
        row = load_row(args.row)
        if row is None:
            print(f"[perf_gate] no bench row found in {args.row}",
                  file=sys.stderr)
            return EXIT_USAGE
    elif args.metric is not None and args.value is not None:
        row = {"metric": args.metric, "value": args.value,
               "platform": args.platform or "unknown"}
    else:
        ap.print_usage(sys.stderr)
        print("[perf_gate] need --row FILE or --metric/--value[/--platform]",
              file=sys.stderr)
        return EXIT_USAGE

    ledger = PerfLedger(args.ledger)
    verdict = gate(
        row, ledger,
        expect_platform=args.expect_platform,
        window=args.window,
        rel_tol=args.rel_tol,
        mad_sigmas=args.mad_sigmas,
    )
    code = _exit_code(verdict["verdict"], args.strict_platform)
    # append only verdicts that extend a trustworthy baseline: a
    # platform_mismatch row would seed the ledger with exactly the
    # cross-platform history --expect-platform exists to keep out
    if args.append and verdict["verdict"] in ("ok", "improvement",
                                              "new_metric"):
        # descriptive columns (the stream_ksweep peak-bytes fields) ride
        # along so a gated append is as self-describing as a direct one
        extra = {
            f: row[f] for f in LEDGER_EXTRA_FIELDS if row.get(f) is not None
        }
        ledger.append(
            str(row["metric"]), float(row["value"]),
            unit=str(row.get("unit", "")),
            platform=str(row.get("platform", "unknown")),
            key=config_key(row),
            note=str(row.get("note", "")) or "perf_gate --append",
            **extra,
        )
    if args.json:
        print(json.dumps(verdict, indent=2))
    else:
        base = verdict.get("baseline")
        detail = ""
        if base:
            detail = (
                f" (baseline median {base['median']:.4g} over {base['n']} "
                f"rows, ratio {verdict.get('ratio', 0):.3f}, band "
                f"±{verdict.get('band', 0):.0%})"
            )
        elif verdict.get("baseline_platforms"):
            detail = (
                f" (history only on platforms "
                f"{verdict['baseline_platforms']})"
            )
        elif verdict.get("expected_platform"):
            detail = (
                f" (expected {verdict['expected_platform']}, measured on "
                f"{verdict['platform']}"
                + (f"; fallback: {verdict['fallback_reason']}"
                   if verdict.get("fallback_reason") else "")
                + ")"
            )
        if verdict.get("bytes_ratio") is not None:
            detail += (
                f" [bytes_moved {verdict['bytes_moved']} vs f32 "
                f"{verdict['bytes_moved_f32']} = {verdict['bytes_ratio']}x]"
            )
        print(
            f"[perf_gate] {verdict['verdict']}: {verdict.get('metric')} = "
            f"{verdict.get('value')} on {verdict.get('platform')}{detail}"
        )
    return code


if __name__ == "__main__":
    raise SystemExit(main())
