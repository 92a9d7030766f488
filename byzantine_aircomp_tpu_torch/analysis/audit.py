"""Forensic audit: score the flag stream of a run against ground truth.

The port's copy of ``byzantine_aircomp_tpu/analysis/audit.py``.

A ``--forensics top|full`` run with ``--obs-dir`` set appends one
``client_flag`` event per suspicious client per round next to the
``round``/``defense`` events.  This tool replays that JSONL into the
accountability story the forensics acceptance criteria are written
against:

* per-client **timelines** — every round a client surfaced in the top-M,
  with its score, z, CUSUM, margin-to-threshold, and the rung at flag
  time;
* the **confusion ledger** — the run's ``run_start`` event carries the
  cohort geometry (``k``/``byz``/``population``), which pins down the
  ground-truth byzantine id set without any side channel: the last
  ``byz`` of ``k`` client slots in resident runs, the last ``byz``
  population shards (ids ``>= (population // k) * (k - byz)``) under
  ``--service on``;
* headline metrics — flag **precision** (flagged events naming a true
  byzantine / all flagged events), cumulative **recall** (distinct true
  byzantines ever flagged / byzantine population), and
  **time-to-detect** (first round any true byzantine is flagged).

::

    python -m byzantine_aircomp_tpu_torch.analysis.audit runs/events.jsonl
    python -m byzantine_aircomp_tpu_torch.analysis.audit runs/events.jsonl --json

Only ``client_flag`` rows with ``flagged == True`` count toward the
confusion ledger — ``--forensics full`` also records the *unflagged*
top-M tail each round (provenance for near-misses), and treating those
as accusations would charge the detector with flags it never raised.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Set

from .defense_trace import load_events


def ground_truth(events: List[dict]) -> Optional[Dict[str, object]]:
    """The byzantine id set implied by the run's ``run_start`` geometry.

    Returns ``None`` when no ``run_start`` event is present (the stream
    was truncated before the header, or is not a harness run)."""
    start = next((e for e in events if e.get("kind") == "run_start"), None)
    if start is None:
        return None
    k = start.get("k")
    byz = start.get("byz", 0) or 0
    population = start.get("population")
    if k is None:
        return None
    explicit = start.get("byz_ids")
    if explicit is not None:
        # the harness emits the trainer's actual mask; trust it over any
        # layout re-derivation — Dirichlet/size-skewed partitions are free
        # to place byzantine clients off the last-byz-slots assumption
        ids = {int(i) for i in explicit}
        assert len(ids) == byz, (
            f"run_start byz_ids carries {len(ids)} ids but byz={byz}; "
            f"the stream header is inconsistent"
        )
        universe = population if population else k
        return {"byz_ids": ids, "universe": universe, "k": k, "byz": byz,
                "population": population}
    if population:
        # service mode: ids are population shards; the harness assigns the
        # byzantine populations the top of the id space (fed/service.py).
        per = population // k
        first_byz = per * (k - byz)
        ids: Set[int] = set(range(first_byz, population)) if byz else set()
        universe = population
    else:
        ids = set(range(k - byz, k)) if byz else set()
        universe = k
    return {"byz_ids": ids, "universe": universe, "k": k, "byz": byz,
            "population": population}


def audit(events: List[dict]) -> Dict[str, object]:
    """Replay the ``client_flag`` stream into timelines + the confusion
    ledger.

    Returns ``timelines`` (client id -> ordered flag rows), ``rounds``
    (per-round TP/FP/precision), and ``summary`` (overall precision,
    cumulative recall, time-to-detect, per-client verdicts)."""
    truth = ground_truth(events)
    byz_ids: Set[int] = truth["byz_ids"] if truth else set()

    timelines: Dict[int, List[dict]] = {}
    per_round: Dict[int, Dict[str, object]] = {}
    detected: Set[int] = set()
    time_to_detect: Optional[int] = None
    tp_total = fp_total = 0

    for e in events:
        if e.get("kind") != "client_flag":
            continue
        client = int(e["client"])
        r = int(e["round"])
        row = {
            "round": r,
            "score": e.get("score"),
            "z": e.get("z"),
            "cusum": e.get("cusum"),
            "margin_z": e.get("margin_z"),
            "margin_cusum": e.get("margin_cusum"),
            "rung": e.get("rung"),
            "flagged": bool(e.get("flagged")),
        }
        timelines.setdefault(client, []).append(row)
        if not row["flagged"]:
            continue
        stats = per_round.setdefault(r, {"tp": 0, "fp": 0, "flagged": []})
        stats["flagged"].append(client)
        if truth is None:
            continue
        if client in byz_ids:
            stats["tp"] += 1
            tp_total += 1
            detected.add(client)
            if time_to_detect is None or r < time_to_detect:
                time_to_detect = r
        else:
            stats["fp"] += 1
            fp_total += 1

    rounds = []
    for r in sorted(per_round):
        stats = per_round[r]
        n = stats["tp"] + stats["fp"]
        rounds.append({
            "round": r,
            "tp": stats["tp"],
            "fp": stats["fp"],
            "flagged": sorted(stats["flagged"]),
            "precision": (stats["tp"] / n) if (truth and n) else None,
        })

    clients = []
    for client in sorted(timelines):
        rows = timelines[client]
        flagged_rows = [x for x in rows if x["flagged"]]
        clients.append({
            "client": client,
            "byz": (client in byz_ids) if truth else None,
            "appearances": len(rows),
            "flagged_rounds": len(flagged_rows),
            "first_flag_round": (flagged_rows[0]["round"]
                                 if flagged_rows else None),
            "max_score": max((x["score"] for x in rows
                              if x["score"] is not None), default=None),
        })

    n_flagged = tp_total + fp_total
    summary = {
        "ground_truth": (None if truth is None else {
            "byz": truth["byz"], "k": truth["k"],
            "population": truth["population"],
            "byz_ids": sorted(byz_ids),
        }),
        "flag_events": n_flagged,
        "precision": (tp_total / n_flagged
                      if (truth and n_flagged) else None),
        "recall": (len(detected) / len(byz_ids)
                   if (truth and byz_ids) else None),
        "time_to_detect": time_to_detect,
        "clients_seen": len(timelines),
    }
    return {"timelines": timelines, "rounds": rounds, "clients": clients,
            "summary": summary}


def markdown_report(result: Dict[str, object]) -> str:
    rounds: List[dict] = result["rounds"]  # type: ignore[assignment]
    clients: List[dict] = result["clients"]  # type: ignore[assignment]
    summary: Dict = result["summary"]  # type: ignore[assignment]
    out = ["# forensic audit", ""]
    p = summary["precision"]
    rec = summary["recall"]
    out.append(
        f"**precision**: {'-' if p is None else f'{p:.3f}'}   "
        f"**recall**: {'-' if rec is None else f'{rec:.3f}'}   "
        f"**time_to_detect**: "
        f"{'-' if summary['time_to_detect'] is None else summary['time_to_detect']}   "
        f"**flag_events**: {summary['flag_events']}"
    )
    out.append("")
    out.append("| round | tp | fp | precision | flagged clients |")
    out.append("|---|---|---|---|---|")
    for r in rounds:
        pr = "-" if r["precision"] is None else f"{r['precision']:.2f}"
        out.append(
            f"| {r['round']} | {r['tp']} | {r['fp']} | {pr} | "
            f"{', '.join(str(c) for c in r['flagged'])} |"
        )
    out.append("")
    out.append("| client | byz | appearances | flagged | first_flag "
               "| max_score |")
    out.append("|---|---|---|---|---|---|")
    for c in clients:
        byz = "-" if c["byz"] is None else ("yes" if c["byz"] else "no")
        first = "-" if c["first_flag_round"] is None else c["first_flag_round"]
        score = ("-" if c["max_score"] is None
                 else f"{c['max_score']:.3g}")
        out.append(
            f"| {c['client']} | {byz} | {c['appearances']} | "
            f"{c['flagged_rounds']} | {first} | {score} |"
        )
    out.append("")
    out.append(f"**summary**: {json.dumps(summary)}")
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("events", help="events JSONL path (from --obs-dir)")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable audit instead of markdown")
    args = ap.parse_args(argv)
    result = audit(load_events(args.events))
    if not result["timelines"]:
        print("[audit] no client_flag events found (run with "
              "--forensics top|full and --obs-dir)", file=sys.stderr)
        raise SystemExit(1)
    if args.json:
        # timelines keys are ints; stringify for JSON round-tripping
        result = dict(result,
                      timelines={str(k): v
                                 for k, v in result["timelines"].items()})
        print(json.dumps(result, indent=2))
    else:
        print(markdown_report(result))


if __name__ == "__main__":
    main()
