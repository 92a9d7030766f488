"""Event sinks: where structured telemetry goes.

The port's copy of ``byzantine_aircomp_tpu/obs/sinks.py``.

Every runner emits the same schema-versioned JSON events (``obs.events``); a sink is
the one-way pipe those events leave through.  Four concrete sinks cover
the deployment matrix:

* :class:`JsonlSink` — one JSON object per line, appended to a file.
  Default mode appends + flushes EVERY line, so a run killed by a
  timeout (or piped through a dying consumer) keeps its tail up to the
  last completed event; ``atomic=True`` instead buffers and writes the
  whole file through :func:`utils.io.atomic_write` at close — for
  summary artifacts where a torn half-file is worse than no file.
* :class:`StdoutSink` — the same JSON lines on stdout, flushed per line
  (machine-readable pipe surface; human logs go to stderr / the log tee).
* :class:`MemorySink` — in-process list, for tests and programmatic
  callers.
* :class:`MultiSink` — fan-out to several sinks (e.g. stdout + file).

Sinks never mutate the events they are handed and never raise into the
training loop for a full disk mid-run — emit failures after a successful
open surface once as a warning on stderr and the sink disables itself.

Every concrete sink stamps a per-sink monotonic ``seq`` envelope key on a
COPY of each event before writing it (``ts`` is wall-clock and therefore
non-monotonic under resume/append — ``seq`` is the ordering key analysis
tools sort by).  :class:`JsonlSink` in append mode continues the counter
from the existing line count, so a resumed run's stream stays totally
ordered end to end.
"""

from __future__ import annotations

import json
import sys
from typing import Any, Dict, List, Optional, TextIO

from ..utils import io as io_lib


def _dumps(event: Dict[str, Any]) -> str:
    # compact separators: event streams are read by machines; allow
    # non-finite floats (benchmarks report NaN deltas deliberately)
    return json.dumps(event, separators=(",", ":"), default=str)


def rotated_segments(path: str) -> List[str]:
    """Rotated siblings of a live stream ``path``, oldest first.

    :class:`JsonlSink` size rotation renames the live file to
    ``<path>.0001``, ``<path>.0002``, ... — an extension that can never
    match the ``*.events.jsonl`` glob the analysis tools use to discover
    RUNS, so a rotated run still presents exactly one live path and the
    loaders pull the segments in via this helper."""
    import glob
    import os

    return sorted(
        p for p in glob.glob(path + ".[0-9][0-9][0-9][0-9]")
        if os.path.isfile(p)
    )


class EventSink:
    """Interface: ``emit`` one event dict; ``close`` flushes/releases."""

    def _stamp(self, event: Dict[str, Any]) -> Dict[str, Any]:
        """Return a COPY of ``event`` carrying this sink's next monotonic
        ``seq`` (the original dict is never mutated — the same event may be
        fanned out to several sinks, each with its own counter)."""
        seq = getattr(self, "_seq", 0)
        self._seq = seq + 1
        return {**event, "seq": seq}

    def emit(self, event: Dict[str, Any]) -> None:
        raise NotImplementedError

    def flush(self) -> None:  # pragma: no cover - trivial default
        pass

    def close(self) -> None:  # pragma: no cover - trivial default
        pass

    # context-manager sugar so scripts can ``with sink:``
    def __enter__(self) -> "EventSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class NullSink(EventSink):
    """Drops everything — the obs-disabled path costs one method call."""

    def emit(self, event: Dict[str, Any]) -> None:
        pass


class MemorySink(EventSink):
    """Collects events in ``self.events`` (tests, programmatic callers)."""

    def __init__(self) -> None:
        self.events: List[Dict[str, Any]] = []

    def emit(self, event: Dict[str, Any]) -> None:
        self.events.append(self._stamp(event))

    def by_kind(self, kind: str) -> List[Dict[str, Any]]:
        return [e for e in self.events if e.get("kind") == kind]


class StdoutSink(EventSink):
    """One JSON line per event on stdout, flushed immediately."""

    def __init__(self, stream: Optional[TextIO] = None) -> None:
        self._stream = stream

    def emit(self, event: Dict[str, Any]) -> None:
        stream = self._stream or sys.stdout
        stream.write(_dumps(self._stamp(event)) + "\n")
        stream.flush()


class JsonlSink(EventSink):
    """Append-safe (default) or atomic-at-close JSONL file sink.

    Append mode writes each event as ONE ``write()`` call of a complete
    line and flushes, so a kill between events never leaves a torn line
    and concurrent appenders (multi-process sweeps sharing a file) never
    interleave partial records.  ``fresh`` records whether the file was
    empty/absent at construction — writers that lead with a header line
    (benchmarks/trajectory.py) key on it instead of re-implementing the
    ``tell() == 0`` dance.

    ``rotate_mb`` > 0 caps the live file: once a write carries it past
    the threshold it is renamed to the next ``<path>.NNNN`` segment and
    a fresh live file opens.  The in-memory ``seq`` counter keeps
    running across rotations (and a resumed sink counts lines across
    ALL segments), so the multi-segment stream keeps one monotonic
    ``seq`` envelope and the seq-ordered loaders read it unchanged.
    Always-on service runs stay bounded per file instead of growing one
    unbounded JSONL.
    """

    def __init__(
        self, path: str, atomic: bool = False, rotate_mb: float = 0.0
    ) -> None:
        import os

        self.path = path
        self._atomic = atomic
        self._failed = False
        self._rotate_bytes = int(rotate_mb * 2**20)
        segments = rotated_segments(path) if not atomic else []
        self.fresh = (
            not os.path.exists(path) or os.path.getsize(path) == 0
        ) and not segments
        if atomic:
            self._rows: List[str] = []
            self._fh: Optional[TextIO] = None
        else:
            self._fh = io_lib.open_append(path)
            if not self.fresh:
                # resume/append: continue ``seq`` from the existing line
                # count — across rotated segments — so the stream stays
                # totally ordered across restarts
                try:
                    n = 0
                    for p in segments + [path]:
                        if os.path.exists(p):
                            with open(p, "r") as fh:
                                n += sum(1 for _ in fh)
                    self._seq = n
                except OSError:
                    pass

    def emit(self, event: Dict[str, Any]) -> None:
        if self._failed:
            return
        line = _dumps(self._stamp(event))
        try:
            if self._atomic:
                self._rows.append(line)
            else:
                assert self._fh is not None
                self._fh.write(line + "\n")
                self._fh.flush()
                if (
                    self._rotate_bytes
                    and self._fh.tell() >= self._rotate_bytes
                ):
                    self._rotate()
        except OSError as e:  # disk full mid-run: degrade, don't kill training
            self._failed = True
            print(
                f"[obs] WARNING: event sink {self.path} failed ({e}); "
                "further events dropped",
                file=sys.stderr,
            )

    def _rotate(self) -> None:
        """Rename the live file to the next numbered segment and reopen."""
        import os

        assert self._fh is not None
        self._fh.close()
        existing = rotated_segments(self.path)
        nxt = 1
        if existing:
            nxt = int(existing[-1].rsplit(".", 1)[1]) + 1
        os.replace(self.path, f"{self.path}.{nxt:04d}")
        self._fh = io_lib.open_append(self.path)

    def flush(self) -> None:
        if self._fh is not None and not self._failed:
            self._fh.flush()

    def close(self) -> None:
        if self._atomic:
            if self._rows and not self._failed:
                rows = self._rows
                io_lib.atomic_write(
                    self.path,
                    lambda f: f.write("".join(r + "\n" for r in rows)),
                    mode="w",
                )
            self._rows = []
        elif self._fh is not None:
            self._fh.close()
            self._fh = None


class MultiSink(EventSink):
    """Fan one event stream out to several sinks."""

    def __init__(self, sinks: List[EventSink]) -> None:
        self.sinks = list(sinks)

    def emit(self, event: Dict[str, Any]) -> None:
        for s in self.sinks:
            s.emit(event)

    def flush(self) -> None:
        for s in self.sinks:
            s.flush()

    def close(self) -> None:
        for s in self.sinks:
            s.close()
