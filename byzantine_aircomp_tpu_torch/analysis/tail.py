"""Live tail: the operator's console view of a running (or finished) run.

Follows the newest ``*.events.jsonl`` stream under an ``--obs-dir`` and
renders the event flow as one line per round — validation loss/acc,
rounds/sec, effective-K and deadline misses under ``--service on``, the
current defense rung and the clients it flagged — with loud interleaved
lines for the events an operator must not miss: rollback restores,
alert edges (``obs/alerts.py``), and a failed retrace audit:

    python -m byzantine_aircomp_tpu_torch.analysis.tail runs/          # follow
    python -m byzantine_aircomp_tpu_torch.analysis.tail runs/ --once   # replay

The port's copy of ``byzantine_aircomp_tpu/analysis/tail.py``.  ``--run
RUN_ID`` tails one tenant of an experiment server's obs root
(``serve/``): it narrows the target to ``<target>/<run_id>/``, the run's
private subtree.

Append-aware and seq-ordered: rotated ``.NNNN`` segments (from
``--obs-rotate-mb``) are replayed oldest-first before the live file, the
live file is followed across rotations (the open handle drains before
switching to the freshly-created live file), and a newer stream
appearing in the directory switches the tail to it.  Reading only — the
tail shares nothing with the run's process and can attach/detach freely.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from typing import Dict, List, Optional


def discover_stream(target: str) -> Optional[str]:
    """``target`` is a live stream file or a directory of them; returns
    the most recently modified live stream (None when none exists)."""
    if os.path.isfile(target):
        return target
    candidates = glob.glob(os.path.join(target, "*.events.jsonl"))
    if not candidates:
        return None
    return max(candidates, key=os.path.getmtime)


class Renderer:
    """Stateful event -> console-line folding.

    Per-round context events (participation, defense, client_flag)
    arrive BEFORE their round event in the stream, so the renderer
    buffers them and flushes one line when the round event lands.
    """

    def __init__(self, out=None, slow_factor: float = 4.0) -> None:
        self.out = out or sys.stdout
        self.k: Optional[int] = None
        self.rung: Optional[int] = None
        self.agg: Optional[str] = None
        self.flagged_ids: List[int] = []
        self.late: Optional[int] = None
        self.effective_k: Optional[float] = None
        self.firing: Dict[str, str] = {}  # rule -> severity
        self.rollbacks = 0
        self.lines = 0
        # --trace on streams: per-round span durations.  Arrival order
        # differs by path (batched lanes emit the round span BEFORE the
        # round event, the resident harness after), so durations attach
        # to the round line when already known and otherwise flag late —
        # a slow round is loud either way.
        self.slow_factor = slow_factor
        self.span_ms: Dict[int, float] = {}
        self.writer_ms: Dict[int, float] = {}
        self.printed_rounds: set = set()
        self.slow_rounds: set = set()
        self._span_history: List[float] = []

    def _print(self, line: str) -> None:
        self.out.write(line + "\n")
        self.out.flush()
        self.lines += 1

    def feed(self, e: Dict) -> None:
        kind = e.get("kind")
        handler = getattr(self, f"_on_{kind}", None)
        if handler is not None:
            handler(e)

    def _on_run_start(self, e: Dict) -> None:
        self.k = e.get("k")
        self._print(
            f"== run {e.get('title', '?')} | backend={e.get('backend', '?')} "
            f"K={e.get('k', '?')} byz={e.get('byz', 0)} "
            f"rounds={e.get('rounds', '?')} agg={e.get('agg', '?')} "
            f"defense={e.get('defense', 'off')} "
            f"service={e.get('service', 'off')}"
        )

    def _on_participation(self, e: Dict) -> None:
        self.late = e.get("late")
        self.effective_k = e.get("effective_k")

    def _on_defense(self, e: Dict) -> None:
        self.rung = e.get("rung")
        self.agg = e.get("agg") or self.agg

    def _on_client_flag(self, e: Dict) -> None:
        if e.get("flagged") and e.get("client") is not None:
            self.flagged_ids.append(int(e["client"]))

    def _on_span(self, e: Dict) -> None:
        name = e.get("name")
        rnd = e.get("round")
        if not isinstance(rnd, int):
            return
        ms = float(e.get("ms", 0.0) or 0.0)
        if name == "round":
            self.span_ms[rnd] = ms
            if self._slow(ms):
                self.slow_rounds.add(rnd)
                if rnd in self.printed_rounds:
                    # resident path: the span lands after its round line
                    # already printed — still make the outlier loud
                    self._print(
                        f"!! SLOW round {rnd}: {_num(ms)} ms "
                        f"(> {_num(self.slow_factor)}x running median)"
                    )
        elif name == "writer_task":
            self.writer_ms[rnd] = self.writer_ms.get(rnd, 0.0) + ms

    def _slow(self, ms: float) -> bool:
        """Is this round span an outlier vs the running median?"""
        hist = sorted(self._span_history)
        self._span_history.append(ms)
        if len(hist) < 3:
            return False
        median = hist[len(hist) // 2]
        return median > 0 and ms > self.slow_factor * median

    def _on_round(self, e: Dict) -> None:
        r = e.get("round", "?")
        parts = [f"r {r:>5}"]
        if e.get("val_loss") is not None:
            parts.append(f"loss {_num(e['val_loss'])} acc {_num(e.get('val_acc'))}")
        if e.get("rounds_per_sec") is not None:
            parts.append(f"{_num(e['rounds_per_sec'])} r/s")
        eff = e.get("effective_k", self.effective_k)
        if eff is not None:
            k = f"/{self.k}" if self.k else ""
            parts.append(f"effK {_num(eff)}{k}")
        late = e.get("late", self.late)
        if late is not None:
            parts.append(f"late {_num(late)}")
        if self.rung is not None:
            rung = f"rung {self.rung}"
            if self.agg:
                rung += f"({self.agg})"
            parts.append(rung)
        if self.flagged_ids:
            shown = ",".join(str(i) for i in sorted(set(self.flagged_ids))[:8])
            parts.append(f"flags [{shown}]")
        if self.firing:
            parts.append(
                "ALERTS " + ",".join(
                    f"{rule}[{sev}]" for rule, sev in sorted(self.firing.items())
                )
            )
        if isinstance(r, int):
            if r in self.span_ms:
                parts.append(f"span {_num(self.span_ms[r])}ms")
            if r in self.writer_ms:
                parts.append(f"wr {_num(self.writer_ms[r])}ms")
            if r in self.slow_rounds:
                parts.append(
                    f"!! SLOW (> {_num(self.slow_factor)}x median)"
                )
            self.printed_rounds.add(r)
        self._print(" | ".join(parts))
        # per-round context consumed; sticky state (rung, alerts) remains
        self.flagged_ids = []
        self.late = None
        self.effective_k = None

    def _on_rollback(self, e: Dict) -> None:
        self.rollbacks += 1
        self._print(
            f"!! ROLLBACK at round {e.get('round', '?')}: restored round "
            f"{e.get('restored_round', '?')} (reason={e.get('reason', '?')}, "
            f"epoch={e.get('epoch', '?')})"
        )

    def _on_alert(self, e: Dict) -> None:
        rule = str(e.get("rule", "?"))
        if e.get("firing"):
            self.firing[rule] = str(e.get("severity", "?"))
            self._print(
                f"!! ALERT {e.get('severity', '?')}: {rule} "
                f"(value={_num(e.get('value'))}, "
                f"threshold={_num(e.get('threshold'))}) at round "
                f"{e.get('round', '?')}"
            )
        else:
            self.firing.pop(rule, None)
            self._print(f"ok ALERT cleared: {rule} at round {e.get('round', '?')}")

    def _on_retrace(self, e: Dict) -> None:
        if not e.get("steady_state_ok", True):
            self._print(f"!! RETRACE audit failed: counts={e.get('counts')}")

    def _on_run_end(self, e: Dict) -> None:
        rps = e.get("rounds_per_sec")
        self._print(
            f"== run end: {e.get('rounds_run', '?')} rounds in "
            f"{e.get('elapsed_secs', '?')}s"
            + (f" ({_num(rps)} r/s)" if rps is not None else "")
            + f" | final acc {_num(e.get('final_val_acc'))}"
            + (f" | {self.rollbacks} rollback(s)" if self.rollbacks else "")
        )


def _num(v) -> str:
    if v is None:
        return "?"
    try:
        f = float(v)
    except (TypeError, ValueError):
        return str(v)
    if f != f:
        return "nan"
    if f == int(f) and abs(f) < 1e9:
        return str(int(f))
    return f"{f:.4f}"


def _feed_line(renderer: Renderer, line: str) -> None:
    line = line.strip()
    if not line:
        return
    try:
        event = json.loads(line)
    except json.JSONDecodeError:
        return  # torn tail of a live write; the next poll completes it
    if isinstance(event, dict):
        renderer.feed(event)


def replay(path: str, renderer: Renderer) -> None:
    """Replay rotated segments then the live file, oldest first.

    When every buffered event carries a ``seq`` stamp, the replay is
    re-sorted by ``(host_id, seq)`` before feeding the renderer: a
    multi-host population-sharded run's processes each append their own
    stream (both ``seq`` counters start at 0), and a stream assembled by
    concatenating them only interleaves correctly under the v5
    ``host_id`` major key (v<5 events default to host 0, reproducing the
    old pure-``seq`` order).  Live ``follow`` output past the backfill
    stays in arrival order — a tail cannot sort the future."""
    from ..obs.sinks import rotated_segments

    events: List[Dict] = []
    for p in rotated_segments(path) + [path]:
        if not os.path.exists(p):
            continue
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    event = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail of a live write
                if isinstance(event, dict):
                    events.append(event)
    if events and all("seq" in e for e in events):
        events.sort(key=lambda e: (e.get("host_id", 0), e["seq"]))
    for event in events:
        renderer.feed(event)


def follow(target: str, renderer: Renderer, interval: float = 0.5,
           max_seconds: Optional[float] = None) -> None:
    """Follow the newest stream under ``target`` until interrupted (or
    ``max_seconds``, for tests).  Survives rotation: the open handle is
    drained to EOF before switching to the recreated live path."""
    deadline = None if max_seconds is None else time.monotonic() + max_seconds
    path = None
    fh = None
    buf = ""
    try:
        while deadline is None or time.monotonic() < deadline:
            if fh is None:
                newest = discover_stream(target)
                if newest is None:
                    time.sleep(interval)
                    continue
                path = newest
                # backfill everything already on disk, then tail the end
                replay(path, renderer)
                fh = open(path)
                fh.seek(0, os.SEEK_END)
            chunk = fh.read()
            if chunk:
                buf += chunk
                *complete, buf = buf.split("\n")
                for line in complete:
                    _feed_line(renderer, line)
                continue
            # EOF: rotated away (inode changed), superseded, or just idle
            try:
                same = os.fstat(fh.fileno()).st_ino == os.stat(path).st_ino
            except OSError:
                same = False
            newest = discover_stream(target)
            if newest is not None and newest != path:
                # a newer stream appeared: rediscover + backfill it
                fh.close()
                fh = None
                continue
            if not same:
                # rotation renamed the drained handle's file and
                # recreated the live path: its content is all new, so
                # resume from offset 0 (no re-backfill — that would
                # replay the whole stream again)
                fh.close()
                fh = open(path) if os.path.exists(path) else None
                continue
            time.sleep(interval)
    except KeyboardInterrupt:
        pass
    finally:
        if fh is not None:
            fh.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="live console tail of an --obs-dir event stream"
    )
    ap.add_argument("target", help="an --obs-dir directory or a "
                    "*.events.jsonl stream file")
    ap.add_argument("--once", action="store_true",
                    help="replay the existing stream and exit (no follow)")
    ap.add_argument("--interval", type=float, default=0.5,
                    help="poll interval in seconds while following")
    ap.add_argument("--max-seconds", type=float, default=None,
                    help="stop following after this long (smoke tests)")
    ap.add_argument("--run", type=str, default=None, metavar="RUN_ID",
                    help="tail one tenant of an experiment-server obs "
                         "root: narrows target to <target>/<run_id>/ "
                         "(the run's private subtree)")
    ap.add_argument("--slow-factor", type=float, default=4.0,
                    help="flag a round whose traced span exceeds this "
                         "multiple of the running median (--trace on "
                         "streams only)")
    args = ap.parse_args(argv)
    if args.run is not None:
        if not os.path.isdir(args.target):
            print(f"--run needs a server obs-root directory, got "
                  f"{args.target}", file=sys.stderr)
            return 1
        args.target = os.path.join(args.target, args.run)
    renderer = Renderer(slow_factor=args.slow_factor)
    if args.once:
        stream = discover_stream(args.target)
        if stream is None:
            print(f"no *.events.jsonl under {args.target}", file=sys.stderr)
            return 1
        replay(stream, renderer)
        return 0
    follow(args.target, renderer, interval=args.interval,
           max_seconds=args.max_seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
