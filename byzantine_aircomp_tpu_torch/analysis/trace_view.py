"""Cross-process trace assembly: join per-process event streams into
per-trace span trees with critical-path accounting.

The port's copy of ``byzantine_aircomp_tpu/analysis/trace_view.py``.

Every process in a traced deployment (``--trace on``) writes ordinary
JSONL event streams — the run manager's per-tenant stream, the solo
harness appending to the same file, edge shards (``edge<N>.events.jsonl``)
and the aggregation root (``root.events.jsonl``).  Correlation rides the
envelope: spans carry ``trace_id``/``span_id``/``parent_span_id``, plain
events at most ``trace_id``/``span_id``.  This tool recursively loads
every ``*.events.jsonl`` under a directory, groups spans by trace, and
answers the questions a latency investigation starts with:

* **where did the time go** — a per-stage self-time table (a span's
  duration minus the time its children cover), so a slow round points at
  queue vs compile vs device vs edge-exchange vs root-fold rather than
  "somewhere in 40s of wall-clock";
* **per-round timelines** — spans carrying a ``round`` field are grouped
  per round with wall-clock, interval-union coverage (how much of the
  round the trace actually explains) and the dominant stage;
* **is the tree sound** — orphan spans (a ``parent_span_id`` no stream
  contains) and never-closed roots are flagged loudly; remote parents
  (``remote_parent_span_id``, a CLIENT's span) are exempt by design.

Outputs: a markdown report (``--out``) and a Chrome trace-event JSON
(``--trace-out``) loadable in Perfetto / ``chrome://tracing``, one
"process" track per source stream.

    python -m byzantine_aircomp_tpu_torch.analysis.trace_view <obs_root> \
        --out trace_report.md --trace-out trace.json --assert-no-orphans

Exit code 1 under ``--assert-no-orphans`` when any trace has orphan
spans (the CI trace-smoke gate).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

from .defense_trace import load_events

#: stage names ordered for report tables (anything else appends after)
_STAGE_ORDER = (
    "run_request", "queue_wait", "lane_install", "run", "setup",
    "compile", "round", "dispatch", "eval", "checkpoint", "writer_task",
    "edge_round", "edge_exchange", "root_round", "root_fold",
)


def find_streams(root: str) -> List[str]:
    """Every live event stream under ``root``, recursively (rotation
    segments ``*.events.jsonl.NNNN`` are folded in by the loader)."""
    pattern = os.path.join(root, "**", "*.events.jsonl")
    return sorted(glob.glob(pattern, recursive=True))


def load_streams(paths: List[str], root: str = "") -> List[dict]:
    """Concatenate streams, tagging each event with its source stream
    (relative path when ``root`` is given) as ``_stream`` — an analysis
    annotation, never part of the on-disk schema."""
    events: List[dict] = []
    for path in paths:
        name = os.path.relpath(path, root) if root else path
        for e in load_events(path):
            e["_stream"] = name
            events.append(e)
    return events


def assemble(events: List[dict]) -> Dict[str, Dict[str, Any]]:
    """Group by trace: ``{trace_id: {"spans", "events", "orphans",
    "streams"}}``.

    A span is any ``kind == "span"`` event with a ``trace_id``; an
    orphan is a span whose ``parent_span_id`` matches no span id in the
    SAME trace (remote parents are carried in ``remote_parent_span_id``
    precisely so a client-side span can never look like a broken tree).
    """
    traces: Dict[str, Dict[str, Any]] = {}
    for e in events:
        tid = e.get("trace_id")
        if tid is None:
            continue
        t = traces.setdefault(
            tid, {"spans": [], "events": [], "streams": set()}
        )
        t["streams"].add(e.get("_stream", "?"))
        if e.get("kind") == "span" and e.get("span_id") is not None:
            t["spans"].append(e)
        else:
            t["events"].append(e)
    for t in traces.values():
        ids = {s["span_id"] for s in t["spans"]}
        t["orphans"] = [
            s for s in t["spans"]
            if s.get("parent_span_id") is not None
            and s["parent_span_id"] not in ids
        ]
    return traces


def _interval(span: dict) -> Tuple[float, float]:
    """A span's ``[start, end]`` in epoch seconds: ``ts`` is stamped at
    emission (the END of the measured window), ``ms`` is the duration."""
    end = float(span.get("ts", 0.0))
    return end - float(span.get("ms", 0.0)) / 1e3, end


def _union_ms(intervals: List[Tuple[float, float]]) -> float:
    """Total coverage of an interval set (overlap counted once), ms."""
    total = 0.0
    cur_s: Optional[float] = None
    cur_e = 0.0
    for start, end in sorted(intervals):
        if cur_s is None:
            cur_s, cur_e = start, end
        elif start <= cur_e:
            cur_e = max(cur_e, end)
        else:
            total += cur_e - cur_s
            cur_s, cur_e = start, end
    if cur_s is not None:
        total += cur_e - cur_s
    return total * 1e3


def self_times(spans: List[dict]) -> Dict[str, float]:
    """Per-span self time: duration minus the interval-union of its
    children (clipped to the parent's window), keyed by ``span_id``."""
    children: Dict[str, List[dict]] = {}
    for s in spans:
        p = s.get("parent_span_id")
        if p is not None:
            children.setdefault(p, []).append(s)
    out: Dict[str, float] = {}
    for s in spans:
        start, end = _interval(s)
        kid_ivals = []
        for c in children.get(s["span_id"], []):
            cs, ce = _interval(c)
            cs, ce = max(cs, start), min(ce, end)
            if ce > cs:
                kid_ivals.append((cs, ce))
        covered = _union_ms(kid_ivals)
        out[s["span_id"]] = max(float(s.get("ms", 0.0)) - covered, 0.0)
    return out


def stage_table(spans: List[dict]) -> List[Dict[str, Any]]:
    """Aggregate by span name: count, total ms, self ms — sorted by the
    canonical stage order then by self time."""
    selfs = self_times(spans)
    agg: Dict[str, Dict[str, Any]] = {}
    for s in spans:
        row = agg.setdefault(
            s.get("name", "?"), {"count": 0, "total_ms": 0.0, "self_ms": 0.0}
        )
        row["count"] += 1
        row["total_ms"] += float(s.get("ms", 0.0))
        row["self_ms"] += selfs[s["span_id"]]
    total_self = sum(r["self_ms"] for r in agg.values()) or 1.0

    def key(item):
        name = item[0]
        try:
            rank = _STAGE_ORDER.index(name)
        except ValueError:
            rank = len(_STAGE_ORDER)
        return (rank, -item[1]["self_ms"])

    return [
        {"stage": name, **row, "share": row["self_ms"] / total_self}
        for name, row in sorted(agg.items(), key=key)
    ]


def round_table(spans: List[dict]) -> List[Dict[str, Any]]:
    """Per-round critical path: wall-clock (earliest start to latest end
    across every stream), interval-union coverage, and the dominant
    stage by self time."""
    selfs = self_times(spans)
    per_round: Dict[int, List[dict]] = {}
    for s in spans:
        rnd = s.get("round")
        if isinstance(rnd, int):
            per_round.setdefault(rnd, []).append(s)
    rows = []
    for rnd in sorted(per_round):
        group = per_round[rnd]
        ivals = [_interval(s) for s in group]
        wall_ms = (
            max(e for _, e in ivals) - min(s for s, _ in ivals)
        ) * 1e3
        covered = _union_ms(ivals)
        by_stage: Dict[str, float] = {}
        for s in group:
            by_stage[s.get("name", "?")] = (
                by_stage.get(s.get("name", "?"), 0.0) + selfs[s["span_id"]]
            )
        top = max(by_stage.items(), key=lambda kv: kv[1]) if by_stage else ("-", 0.0)
        rows.append({
            "round": rnd,
            "spans": len(group),
            "wall_ms": wall_ms,
            "coverage": min(covered / wall_ms, 1.0) if wall_ms > 0 else 1.0,
            "top_stage": top[0],
            "top_ms": top[1],
            "stages": by_stage,
        })
    return rows


def markdown_report(traces: Dict[str, Dict[str, Any]]) -> str:
    lines = ["# Trace report", ""]
    if not traces:
        lines.append("No traced events found (was the run `--trace on`?).")
        return "\n".join(lines) + "\n"
    for tid in sorted(traces):
        t = traces[tid]
        spans, orphans = t["spans"], t["orphans"]
        lines.append(f"## Trace `{tid}`")
        lines.append("")
        lines.append(
            f"- spans: {len(spans)} across {len(t['streams'])} stream(s) "
            f"({', '.join(f'`{s}`' for s in sorted(t['streams']))})"
        )
        lines.append(f"- correlated events: {len(t['events'])}")
        if orphans:
            lines.append(
                f"- **ORPHAN SPANS: {len(orphans)}** — "
                + ", ".join(
                    f"`{s.get('name')}`:{s['span_id']}"
                    f"→missing:{s['parent_span_id']}"
                    for s in orphans[:8]
                )
            )
        else:
            lines.append("- orphan spans: 0")
        lines.append("")
        lines.append("### Stage self-time")
        lines.append("")
        lines.append("| stage | count | total ms | self ms | share |")
        lines.append("|---|---:|---:|---:|---:|")
        for row in stage_table(spans):
            lines.append(
                f"| {row['stage']} | {row['count']} "
                f"| {row['total_ms']:.1f} | {row['self_ms']:.1f} "
                f"| {row['share'] * 100:.1f}% |"
            )
        rounds = round_table(spans)
        if rounds:
            lines.append("")
            lines.append("### Per-round critical path")
            lines.append("")
            lines.append(
                "| round | spans | wall ms | attributed | top stage |"
            )
            lines.append("|---:|---:|---:|---:|---|")
            for r in rounds:
                lines.append(
                    f"| {r['round']} | {r['spans']} | {r['wall_ms']:.1f} "
                    f"| {r['coverage'] * 100:.1f}% "
                    f"| {r['top_stage']} ({r['top_ms']:.1f} ms) |"
                )
        lines.append("")
    return "\n".join(lines) + "\n"


def perfetto_events(traces: Dict[str, Dict[str, Any]]) -> List[dict]:
    """Chrome trace-event JSON (``ph:"X"`` complete events, µs), one
    "process" per source stream — loads in Perfetto / chrome://tracing."""
    streams = sorted({
        s for t in traces.values() for s in t["streams"]
    })
    pid_of = {s: i + 1 for i, s in enumerate(streams)}
    out: List[dict] = [
        {
            "ph": "M", "name": "process_name", "pid": pid,
            "args": {"name": stream},
        }
        for stream, pid in pid_of.items()
    ]
    starts = [
        _interval(s)[0] for t in traces.values() for s in t["spans"]
    ]
    base = min(starts) if starts else 0.0
    for tid, t in sorted(traces.items()):
        for s in t["spans"]:
            start, _ = _interval(s)
            args = {
                k: v for k, v in s.items()
                if k in ("round", "lane", "edge", "run_id", "status",
                         "span_id", "parent_span_id", "task", "compiled")
                and v is not None
            }
            args["trace_id"] = tid
            out.append({
                "ph": "X",
                "name": s.get("name", "span"),
                "cat": "span",
                "pid": pid_of[s.get("_stream", streams[0] if streams else "?")],
                "tid": s.get("lane", s.get("edge", 0)) or 0,
                "ts": (start - base) * 1e6,
                "dur": float(s.get("ms", 0.0)) * 1e3,
                "args": args,
            })
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "byzantine_aircomp_tpu_torch trace_view",
        description="assemble per-process event streams into trace trees",
    )
    p.add_argument("root", help="obs directory to scan recursively "
                                "(or a single .events.jsonl file)")
    p.add_argument("--trace-id", default=None,
                   help="restrict the report to one trace id")
    p.add_argument("--out", default=None,
                   help="write the markdown report here (default stdout)")
    p.add_argument("--trace-out", default=None,
                   help="write Chrome trace-event JSON here (Perfetto)")
    p.add_argument("--assert-no-orphans", action="store_true",
                   help="exit 1 when any trace contains orphan spans")
    args = p.parse_args(argv)

    if os.path.isfile(args.root):
        paths = [args.root]
        events = load_streams(paths)
    else:
        paths = find_streams(args.root)
        events = load_streams(paths, root=args.root)
    if not paths:
        print(f"[trace_view] no event streams under {args.root}",
              file=sys.stderr)
    traces = assemble(events)
    if args.trace_id is not None:
        traces = {
            k: v for k, v in traces.items() if k == args.trace_id
        }
    report = markdown_report(traces)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(report)
        print(f"[trace_view] wrote {args.out}")
    else:
        print(report, end="")
    if args.trace_out:
        with open(args.trace_out, "w") as fh:
            json.dump({"traceEvents": perfetto_events(traces)}, fh)
        print(f"[trace_view] wrote {args.trace_out}")
    orphans = sum(len(t["orphans"]) for t in traces.values())
    if orphans:
        print(f"[trace_view] {orphans} orphan span(s)", file=sys.stderr)
        if args.assert_no_orphans:
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
