"""Defense-trace report: reconstruct the escalation history of a run from
its observability event stream.

The port's copy of ``byzantine_aircomp_tpu/analysis/defense_trace.py``.

A ``--defense`` run with ``--obs-dir`` set appends one ``defense`` event
per round (``defense/events.emit_round``) next to the ``round`` events.
This tool replays that JSONL into the escalation story the acceptance
criteria are written against: a per-round table (rung, active aggregator,
flagged clients, score/CUSUM maxima), the transition log (round N:
``mean -> trimmed_mean``), and summary facts — rounds-to-first-escalation,
time spent per rung, whether the run de-escalated:

    python -m byzantine_aircomp_tpu_torch.analysis.defense_trace runs/events.jsonl

Works on any JSONL containing ``defense`` events; other kinds are skipped,
and ``round`` events (matched on the round index) contribute the val-acc
column when present.  ``--forensics top|full`` runs additionally append
``client_flag`` events — when found, the per-round table gains the ids
the detector actually accused (population ids under ``--service on``,
client slots otherwise; the ids are whatever the round fn published, no
translation happens here), and the summary counts distinct accused
clients.  :mod:`.audit` scores that same stream against ground truth.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional


def load_events(path: str) -> List[dict]:
    """All schema-valid JSON objects in the stream, in order; malformed
    lines are skipped with a note (a killed run may truncate its tail).

    ``path`` names the LIVE file of a stream; when ``--obs-rotate-mb``
    rotation produced ``<path>.NNNN`` segments alongside it, they are
    read first (oldest to newest) so the concatenation preserves the
    sink's monotonic ``seq`` envelope — every downstream consumer
    (obs_report / audit / this tool) sees a rotated run as one stream.
    """
    from ..obs.sinks import rotated_segments
    from ..utils.io import iter_jsonl

    def note(msg: str) -> None:
        print(f"[defense_trace] {msg}", file=sys.stderr)

    events: List[dict] = []
    for p in rotated_segments(path) + [path]:
        # torn-tail tolerant: a SIGKILLed run tears at most the final
        # line, and a stream with no run_end is still a valid prefix
        events.extend(iter_jsonl(p, warn=note))
    return events


def trace(events: List[dict]) -> Dict[str, object]:
    """The escalation story from an event list.

    Returns ``rows`` (one dict per defense event, val_acc joined from the
    round events, flagged client/population ids joined from any
    ``client_flag`` events), ``transitions`` (the rung-change log), and
    ``summary`` (mode, first escalation round, per-rung round counts,
    de-escalation, distinct clients flagged)."""
    acc_by_round = {
        e["round"]: e.get("val_acc")
        for e in events
        if e.get("kind") == "round"
    }
    flags_by_round: Dict[int, List[int]] = {}
    for e in events:
        if e.get("kind") == "client_flag" and e.get("flagged"):
            flags_by_round.setdefault(e["round"], []).append(
                int(e["client"])
            )
    rows = []
    transitions = []
    rung_rounds: Dict[int, int] = {}
    first_escalation: Optional[int] = None
    deescalated = False
    mode = None
    for e in events:
        if e.get("kind") != "defense":
            continue
        mode = e.get("mode", mode)
        r, rung = e["round"], e["rung"]
        rung_rounds[rung] = rung_rounds.get(rung, 0) + 1
        rows.append(
            {
                "round": r,
                "rung": rung,
                "agg": e.get("agg"),
                "flagged": e.get("flagged"),
                "suspicious_iters": e.get("suspicious_iters"),
                "score_max": e.get("score_max"),
                "cusum_max": e.get("cusum_max"),
                "val_acc": acc_by_round.get(r),
                "flagged_clients": sorted(flags_by_round.get(r, [])) or None,
            }
        )
        if e.get("transition"):
            transitions.append(
                {
                    "round": r,
                    "direction": e["transition"],
                    "from_rung": e.get("prev_rung"),
                    "to_rung": rung,
                    "agg": e.get("agg"),
                }
            )
            if e["transition"] == "escalate" and first_escalation is None:
                first_escalation = r
            if e["transition"] == "deescalate":
                deescalated = True
    return {
        "rows": rows,
        "transitions": transitions,
        "summary": {
            "mode": mode,
            "rounds": len(rows),
            "first_escalation_round": first_escalation,
            "rung_rounds": rung_rounds,
            "deescalated": deescalated,
            "final_rung": rows[-1]["rung"] if rows else None,
            "clients_flagged": sorted(
                {c for ids in flags_by_round.values() for c in ids}
            ),
        },
    }


def markdown_report(result: Dict[str, object]) -> str:
    rows: List[dict] = result["rows"]  # type: ignore[assignment]
    transitions: List[dict] = result["transitions"]  # type: ignore[assignment]
    summary: Dict = result["summary"]  # type: ignore[assignment]
    out = [
        "| round | rung | agg | flagged | susp | score_max | cusum_max "
        "| val_acc | flagged ids |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        acc = "-" if r["val_acc"] is None else f"{r['val_acc']:.4f}"
        ids = (
            "-" if not r.get("flagged_clients")
            else ",".join(str(c) for c in r["flagged_clients"])
        )
        out.append(
            f"| {r['round']} | {r['rung']} | {r['agg']} | "
            f"{r['flagged']:.0f} | {r['suspicious_iters']:.0f} | "
            f"{r['score_max']:.3g} | {r['cusum_max']:.3g} | {acc} | "
            f"{ids} |"
        )
    out.append("")
    if transitions:
        out.append("**transitions**")
        for t in transitions:
            out.append(
                f"- round {t['round']}: {t['direction']} "
                f"rung {t['from_rung']} -> {t['to_rung']} ({t['agg']})"
            )
    else:
        out.append("**transitions**: none (steady on rung 0)")
    out.append("")
    out.append(f"**summary**: {json.dumps(summary)}")
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("events", help="events JSONL path (from --obs-dir)")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable trace instead of markdown")
    args = ap.parse_args(argv)
    result = trace(load_events(args.events))
    if not result["rows"]:
        print("[defense_trace] no defense events found", file=sys.stderr)
        raise SystemExit(1)
    if args.json:
        print(json.dumps(result, indent=2))
    else:
        print(markdown_report(result))


if __name__ == "__main__":
    main()
