"""Run report: render an observability event stream into one summary.

The port's copy of ``byzantine_aircomp_tpu/analysis/obs_report.py``.

Any ``*.events.jsonl`` produced with ``--obs-dir`` (training harness,
sweep, fault matrix, benchmarks) renders into a single markdown (or
``--json``) digest of what the run did and what it cost:

    python -m byzantine_aircomp_tpu_torch.analysis.obs_report runs/x.events.jsonl

Sections (each present only when the stream carries the events):

* **run** — title/backend/rounds from ``run_start``, wall-clock and
  final metrics from ``run_end``;
* **phases** — span breakdown by name (count, total/mean ms), with the
  ``round`` spans split compile vs steady state (the ``compiled`` flag
  set by the trainer — no warmup-pass guessing);
* **retrace audit** — lowering counts per jitted fn and the
  steady-state verdict;
* **memory** — watermark trajectory from the ``round`` events'
  ``bytes_in_use`` / ``peak_bytes_in_use`` plus the ``run_end`` summary
  against the analytic model;
* **defense** — escalations and final rung (``defense`` events;
  ``analysis/defense_trace.py`` is the per-round deep dive);
* **forensics** — ``client_flag`` / ``forensic_dump`` tallies from a
  ``--forensics`` run (``analysis/audit.py`` scores the stream against
  ground truth);
* **faults** — dropped/erased/corrupt totals and minimum effective K;
* **bench/perf** — any ``bench`` or ``perf`` rows in the stream.

Pointing the CLI at a DIRECTORY instead of a file reports every
``*.events.jsonl`` in it: one overview row per run (title, rounds,
wall-clock, final acc, retrace verdict, flag count) plus the per-run
sections beneath.  Streams whose sinks stamped the per-sink ``seq``
counter are re-sorted by it before summarizing, so a stream assembled
from a resumed run (append mode continues the counter) digests in true
emission order even if tail lines landed out of order.
"""

from __future__ import annotations

import argparse
import glob as glob_lib
import json
import os
import sys
from typing import Any, Dict, List, Optional

from .defense_trace import load_events


def order_events(events: List[dict]) -> List[dict]:
    """Stable-sort by ``(host_id, seq)`` when every event carries a
    ``seq`` stamp (v2 sinks); otherwise file order is the only order
    there is.  ``seq`` is only per-SINK monotonic — on a multi-host
    population mesh each process appends its own stream and both start
    at 0, so a concatenated multi-host stream needs the v5 ``host_id``
    envelope key as the major sort key.  v<5 events lack it and default
    to host 0, which reproduces the old pure-``seq`` order exactly."""
    if events and all("seq" in e for e in events):
        return sorted(events, key=lambda e: (e.get("host_id", 0), e["seq"]))
    return events


def _fmt_bytes(n: Optional[float]) -> str:
    if n is None:
        return "-"
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.1f} TiB"  # pragma: no cover - loop always returns


def summarize(events: List[dict]) -> Dict[str, Any]:
    """The machine-readable digest the markdown renders."""
    out: Dict[str, Any] = {}

    starts = [e for e in events if e.get("kind") == "run_start"]
    ends = [e for e in events if e.get("kind") == "run_end"]
    if starts:
        s = starts[-1]
        out["run"] = {
            k: s.get(k)
            for k in ("title", "backend", "rounds", "start_round", "k",
                      "byz", "dim", "agg", "attack", "fault", "defense")
        }
    if ends:
        e = ends[-1]
        out["run_end"] = {
            k: e.get(k)
            for k in ("elapsed_secs", "rounds_run", "rounds_per_sec",
                      "final_val_acc", "final_val_loss")
        }

    # phase breakdown; round spans split by the compiled flag
    phases: Dict[str, Dict[str, Any]] = {}
    for e in events:
        if e.get("kind") != "span" or "ms" not in e:
            continue
        name = str(e.get("name"))
        if name == "round":
            name = "round[compile]" if e.get("compiled") else "round[steady]"
        p = phases.setdefault(name, {"count": 0, "total_ms": 0.0})
        p["count"] += 1
        p["total_ms"] += float(e["ms"])
    for p in phases.values():
        p["total_ms"] = round(p["total_ms"], 3)
        p["mean_ms"] = round(p["total_ms"] / p["count"], 3)
    if phases:
        out["phases"] = phases
        comp = phases.get("round[compile]", {}).get("total_ms", 0.0)
        steady = phases.get("round[steady]", {}).get("total_ms", 0.0)
        out["compile_vs_steady"] = {
            "compile_ms": comp,
            "steady_ms": steady,
            "compile_fraction": round(comp / (comp + steady), 4)
            if comp + steady else None,
        }

    # traced streams (--trace on): stage self-time + per-round critical
    # path via the cross-process assembler (analysis/trace_view.py)
    tspans = [
        e for e in events
        if e.get("kind") == "span"
        and e.get("trace_id") is not None
        and e.get("span_id") is not None
    ]
    if tspans:
        from .trace_view import round_table, stage_table

        out["trace"] = {
            "trace_ids": sorted({e["trace_id"] for e in tspans}),
            "stages": stage_table(tspans),
            "rounds": [
                {k: r[k] for k in
                 ("round", "spans", "wall_ms", "coverage",
                  "top_stage", "top_ms")}
                for r in round_table(tspans)
            ],
        }

    retraces = [e for e in events if e.get("kind") == "retrace"]
    if retraces:
        r = retraces[-1]
        out["retrace"] = {
            "counts": r.get("counts"),
            "steady_state_ok": r.get("steady_state_ok"),
        }

    rounds = [e for e in events if e.get("kind") == "round"]
    peaks = [e["peak_bytes_in_use"] for e in rounds
             if e.get("peak_bytes_in_use") is not None]
    if peaks or (ends and ends[-1].get("memory")):
        mem: Dict[str, Any] = {}
        if peaks:
            mem["rounds_with_watermarks"] = len(peaks)
            mem["max_peak_bytes_in_use"] = max(peaks)
            mem["source"] = next(
                (e.get("mem_source") for e in rounds if e.get("mem_source")),
                None,
            )
        if ends and isinstance(ends[-1].get("memory"), dict):
            mem["run_end"] = ends[-1]["memory"]
        out["memory"] = mem

    defenses = [e for e in events if e.get("kind") == "defense"]
    if defenses:
        transitions = [e for e in defenses if e.get("transition")]
        out["defense"] = {
            "mode": defenses[-1].get("mode"),
            "rounds": len(defenses),
            "escalations": sum(
                1 for e in transitions if e["transition"] == "escalate"
            ),
            "deescalations": sum(
                1 for e in transitions if e["transition"] == "deescalate"
            ),
            "final_rung": defenses[-1].get("rung"),
            "final_agg": defenses[-1].get("agg"),
        }

    flags = [e for e in events if e.get("kind") == "client_flag"]
    dumps = [e for e in events if e.get("kind") == "forensic_dump"]
    if flags or dumps:
        out["forensics"] = {
            "flag_events": len(flags),
            "flagged": sum(1 for e in flags if e.get("flagged")),
            "clients_seen": len({e.get("client") for e in flags}),
            "dumps": [
                {k: e.get(k) for k in ("round", "reason", "path", "window")}
                for e in dumps
            ],
        }

    faulted = [e for e in rounds if e.get("effective_k") is not None]
    if faulted:
        out["faults"] = {
            "dropped": sum(e.get("dropped", 0) for e in faulted),
            "erased": sum(e.get("erased", 0) for e in faulted),
            "corrupt": sum(e.get("corrupt", 0) for e in faulted),
            "min_effective_k": min(e["effective_k"] for e in faulted),
        }

    perf_rows = [
        e for e in events if e.get("kind") in ("bench", "perf")
        and e.get("metric") is not None
    ]
    if perf_rows:
        out["perf_rows"] = [
            {k: e.get(k) for k in ("kind", "metric", "value", "unit",
                                   "platform", "fallback_reason")}
            for e in perf_rows
        ]

    profiles = [e for e in events if e.get("kind") == "profile"]
    if profiles:
        out["profile"] = {
            "dir": profiles[-1].get("dir"),
            "rounds": profiles[-1].get("rounds"),
        }
    return out


def markdown_report(summary: Dict[str, Any]) -> str:
    out: List[str] = ["# run report", ""]
    run = summary.get("run")
    if run:
        out.append(
            f"**{run.get('title')}** — backend `{run.get('backend')}`, "
            f"K={run.get('k')} (byz {run.get('byz')}), d={run.get('dim')}, "
            f"agg `{run.get('agg')}`, attack `{run.get('attack')}`, "
            f"fault `{run.get('fault')}`, defense `{run.get('defense')}`"
        )
    end = summary.get("run_end")
    if end:
        rps = end.get("rounds_per_sec")
        out.append(
            f"{end.get('rounds_run')} rounds in "
            f"{end.get('elapsed_secs')}s"
            + (f" ({rps} rounds/sec)" if rps is not None else "")
            + (f", final val acc {end.get('final_val_acc'):.4f}"
               if end.get("final_val_acc") is not None else "")
        )
    out.append("")

    phases = summary.get("phases")
    if phases:
        out += ["## phases", "",
                "| phase | count | total ms | mean ms |", "|---|---|---|---|"]
        for name in sorted(phases):
            p = phases[name]
            out.append(
                f"| {name} | {p['count']} | {p['total_ms']} | {p['mean_ms']} |"
            )
        cvs = summary.get("compile_vs_steady")
        if cvs and cvs.get("compile_fraction") is not None:
            out += ["", f"compile {cvs['compile_ms']} ms vs steady "
                    f"{cvs['steady_ms']} ms — "
                    f"{cvs['compile_fraction']:.1%} of round time compiling"]
        out.append("")

    tr = summary.get("trace")
    if tr:
        out += ["## critical path (traced spans)", "",
                "trace id(s): "
                + ", ".join(f"`{t}`" for t in tr["trace_ids"]), "",
                "| stage | count | total ms | self ms | share |",
                "|---|---:|---:|---:|---:|"]
        for row in tr["stages"]:
            out.append(
                f"| {row['stage']} | {row['count']} "
                f"| {row['total_ms']:.1f} | {row['self_ms']:.1f} "
                f"| {row['share'] * 100:.1f}% |"
            )
        if tr["rounds"]:
            out += ["", "| round | wall ms | attributed | top stage |",
                    "|---:|---:|---:|---|"]
            for r in tr["rounds"]:
                out.append(
                    f"| {r['round']} | {r['wall_ms']:.1f} "
                    f"| {r['coverage'] * 100:.1f}% "
                    f"| {r['top_stage']} ({r['top_ms']:.1f} ms) |"
                )
        out += ["",
                "full cross-process assembly (orphan check, Perfetto "
                "export): `python -m byzantine_aircomp_tpu_torch.analysis."
                "trace_view <obs_root>`", ""]

    rt = summary.get("retrace")
    if rt:
        ok = "OK" if rt.get("steady_state_ok") else "**FAILED**"
        out += ["## retrace audit", "",
                f"steady state {ok}; lowerings: {json.dumps(rt.get('counts'))}",
                ""]

    mem = summary.get("memory")
    if mem:
        out += ["## memory watermarks", ""]
        if "max_peak_bytes_in_use" in mem:
            out.append(
                f"peak over {mem['rounds_with_watermarks']} rounds: "
                f"{_fmt_bytes(mem['max_peak_bytes_in_use'])} "
                f"(source `{mem.get('source')}`)"
            )
        re_mem = mem.get("run_end")
        if isinstance(re_mem, dict):
            flag = (" — **exceeds model**"
                    if re_mem.get("exceeds_model") else "")
            out.append(
                f"run end: {_fmt_bytes(re_mem.get('peak_bytes_in_use'))} peak"
                f" vs modeled {_fmt_bytes(re_mem.get('modeled_peak_bytes'))}"
                f" (warn factor {re_mem.get('warn_factor')}){flag}"
            )
        out.append("")

    d = summary.get("defense")
    if d:
        out += ["## defense", "",
                f"mode `{d.get('mode')}`: {d.get('escalations')} escalation(s),"
                f" {d.get('deescalations')} de-escalation(s); final rung "
                f"{d.get('final_rung')} (`{d.get('final_agg')}`)", ""]

    fo = summary.get("forensics")
    if fo:
        out += ["## forensics", "",
                f"{fo['flag_events']} client_flag event(s) "
                f"({fo['flagged']} flagged) over {fo['clients_seen']} "
                f"client(s) — `analysis/audit.py` scores them against "
                f"ground truth"]
        for d_ev in fo.get("dumps", []):
            out.append(
                f"- flight dump round {d_ev.get('round')} "
                f"({d_ev.get('reason')}): `{d_ev.get('path')}` "
                f"(window {d_ev.get('window')})"
            )
        out.append("")

    f = summary.get("faults")
    if f:
        out += ["## faults", "",
                f"dropped {f['dropped']:.0f}, erased {f['erased']:.0f}, "
                f"corrupt {f['corrupt']:.0f}; min effective K "
                f"{f['min_effective_k']:.0f}", ""]

    rows = summary.get("perf_rows")
    if rows:
        out += ["## bench/perf rows", "",
                "| kind | metric | value | unit | platform | fallback |",
                "|---|---|---|---|---|---|"]
        for r in rows:
            out.append(
                f"| {r.get('kind')} | {r.get('metric')} | {r.get('value')} | "
                f"{r.get('unit') or '-'} | {r.get('platform') or '-'} | "
                f"{r.get('fallback_reason') or '-'} |"
            )
        out.append("")

    prof = summary.get("profile")
    if prof:
        out += [f"device trace captured in `{prof.get('dir')}` "
                f"(rounds {prof.get('rounds')})", ""]
    return "\n".join(out)


def summarize_dir(paths: List[str]) -> Dict[str, Any]:
    """Per-run digests for every stream in a directory, keyed by file."""
    runs = []
    for p in sorted(paths):
        events = order_events(load_events(p))
        if not events:
            continue
        runs.append({"path": p, "summary": summarize(events)})
    return {"runs": runs}


def markdown_dir_report(digest: Dict[str, Any]) -> str:
    runs: List[dict] = digest["runs"]  # type: ignore[assignment]
    out = [f"# obs report — {len(runs)} run(s)", "",
           "| run | backend | rounds | secs | final acc | retrace "
           "| flags |",
           "|---|---|---|---|---|---|---|"]
    for r in runs:
        s = r["summary"]
        run = s.get("run") or {}
        end = s.get("run_end") or {}
        rt = s.get("retrace")
        fo = s.get("forensics")
        acc = end.get("final_val_acc")
        out.append(
            f"| {os.path.basename(r['path'])} | {run.get('backend', '-')} |"
            f" {end.get('rounds_run', '-')} | {end.get('elapsed_secs', '-')}"
            f" | {'-' if acc is None else f'{acc:.4f}'} | "
            f"{'-' if rt is None else ('OK' if rt.get('steady_state_ok') else 'FAILED')}"
            f" | {'-' if fo is None else fo.get('flagged')} |"
        )
    out.append("")
    for r in runs:
        out += [f"---", "", f"## {os.path.basename(r['path'])}", "",
                markdown_report(r["summary"])]
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("events",
                    help="events JSONL path, or a directory of them "
                         "(an --obs-dir) for a multi-run report")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable summary instead")
    args = ap.parse_args(argv)
    if os.path.isdir(args.events):
        paths = glob_lib.glob(os.path.join(args.events, "*.events.jsonl"))
        digest = summarize_dir(paths)
        if not digest["runs"]:
            print(f"[obs_report] no *.events.jsonl with events under "
                  f"{args.events}", file=sys.stderr)
            return 1
        print(json.dumps(digest, indent=2) if args.json
              else markdown_dir_report(digest))
        return 0
    events = order_events(load_events(args.events))
    if not events:
        print("[obs_report] no events found", file=sys.stderr)
        return 1
    summary = summarize(events)
    if args.json:
        print(json.dumps(summary, indent=2))
    else:
        print(markdown_report(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
