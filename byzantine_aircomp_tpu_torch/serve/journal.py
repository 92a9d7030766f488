"""Durable run journal: the experiment server's write-ahead log.

The port's copy of ``byzantine_aircomp_tpu/serve/journal.py``, whole: the
same ops, fields and replay folds, so a journal written by either server
replays the same way in the other.

The control plane's registry (``serve/runs.RunManager``) is in-memory —
before this module a server crash lost every run: queued configs,
progress, even the knowledge that a run had completed.  The journal makes
the lifecycle durable: one JSONL line per transition, appended through
``utils/io.open_append`` (line-buffered, one ``write()`` per line — a
kill can tear at most the final line, and :func:`replay` skips a torn
tail with a warning instead of raising).

Ops and their extra fields::

    submitted   config (non-default FedConfig fields, PRE-namespace),
                signature, title, solo, idempotency_key?
    running     —           (the scheduler picked the run up)
    checkpoint  round       (a durable per-round checkpoint landed)
    requeued    retries, reason   (watchdog bounded-backoff retry)
    refill      lane, round, group_round, signature   (a drained lane's
                slot reseated from the admission queue mid-group —
                WRITTEN BEFORE the device splice, so a SIGKILL
                mid-refill replays the same tenant into the same lane)
    completed   round, lowerings, final_val_acc?, final_val_loss?
    failed      round, reason
    cancelled   round

The journal records *transitions*; the resumable *state* (params, opt
carries, metric paths) lives in the per-run checkpoints
(``fed/checkpoint.py`` — atomic npz with the paths JSON riding the same
write).  A restarted server folds the journal into per-run states
(:func:`replay`): terminal runs are re-adopted as facts, in-flight runs
are re-queued and resume from their last checkpoint.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, Optional

from ..utils import io as io_lib

#: journal file name under the server's obs root
JOURNAL_NAME = "journal.jsonl"

#: ops that mean the run reached a terminal status
TERMINAL_OPS = ("completed", "failed", "cancelled")


def journal_path(obs_root: str) -> str:
    return os.path.join(obs_root, JOURNAL_NAME)


class RunJournal:
    """Append-only lifecycle log, one JSON object per line.

    Thread-safe (the scheduler, watchdog, and HTTP handler threads all
    append); the file handle opens lazily on first append so constructing
    a journal for a root that never sees a run creates nothing.
    """

    def __init__(self, path: str) -> None:
        self.path = path
        self._lock = threading.Lock()
        self._fh = None

    def append(self, op: str, run_id: str, **fields: Any) -> None:
        rec = {"op": op, "run_id": run_id, "ts": time.time(), **fields}
        line = json.dumps(rec)
        with self._lock:
            if self._fh is None:
                self._fh = io_lib.open_append(self.path)
            self._fh.write(line + "\n")

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def replay(
    path: str, warn: Optional[Callable[[str], None]] = None
) -> Dict[str, Dict[str, Any]]:
    """Fold a journal into per-run states, in first-submission order.

    Returns ``run_id -> state`` where state carries ``status`` (the last
    op's terminal name, or ``queued`` for any in-flight run), ``config``
    (the submitted mapping — None if the submitted line itself was the
    torn tail, in which case the run is unrecoverable and reported
    through ``warn``), ``round`` (the last durably checkpointed round),
    ``retries``, and the terminal facts (``lowerings``, ``error``,
    ``final_val_acc``/``final_val_loss``) when present.  Torn or garbage
    lines are skipped via ``warn`` — a crash mid-append must cost one
    line, never the journal.
    """
    states: Dict[str, Dict[str, Any]] = {}
    for rec in io_lib.iter_jsonl(path, warn=warn):
        op = rec.get("op")
        run_id = rec.get("run_id")
        if not op or not isinstance(run_id, str):
            continue
        st = states.setdefault(
            run_id,
            {
                "run_id": run_id,
                "status": "queued",
                "config": None,
                "round": 0,
                "retries": 0,
            },
        )
        if op == "submitted":
            st["config"] = rec.get("config")
            st["signature"] = rec.get("signature")
            st["title"] = rec.get("title")
            st["solo"] = bool(rec.get("solo"))
            if rec.get("idempotency_key"):
                st["idempotency_key"] = rec["idempotency_key"]
        elif op == "running":
            st["status"] = "queued"  # in-flight: requeue on replay
        elif op == "checkpoint":
            st["round"] = max(st["round"], int(rec.get("round", 0)))
        elif op == "requeued":
            st["status"] = "queued"
            st["retries"] = int(rec.get("retries", st["retries"]))
        elif op == "refill":
            # mid-group reseat: in-flight (requeue on replay), remember
            # the lane so recovery seats the same tenant in the same
            # slot; the resume round stays checkpoint-owned
            st["status"] = "queued"
            if rec.get("lane") is not None:
                st["lane"] = int(rec["lane"])
        elif op in TERMINAL_OPS:
            st["status"] = op
            if rec.get("round") is not None:
                st["round"] = int(rec["round"])
            if rec.get("lowerings") is not None:
                st["lowerings"] = int(rec["lowerings"])
            if rec.get("reason"):
                st["error"] = rec["reason"]
            for k in ("final_val_acc", "final_val_loss"):
                if rec.get(k) is not None:
                    st[k] = rec[k]
    for run_id, st in list(states.items()):
        if st["config"] is None:
            if warn is not None:
                warn(
                    f"run {run_id}: journal has no intact 'submitted' "
                    "line (torn tail?); dropping — resubmit it"
                )
            del states[run_id]
    return states


#: root-journal file name under the aggregation root's obs dir
ROOT_JOURNAL_NAME = "root_journal.jsonl"

#: root-journal ops (run_id is ``edge-<id>``): ``partial`` carries the
#: per-round accepted-nonce high-water mark (written at round close, not
#: per exchange — a round is ~100 exchanges and the HWM is all restart
#: recovery needs), ``replay_rejected`` / ``forged_rejected`` record the
#: zero-trust rejections with the offending nonce (a replay rejection
#: also raises the HWM floor, so a captured submission stays dead across
#: restarts without quarantining the edge it names), ``strike`` an
#: authenticated protocol violation counting toward ``strike_limit``,
#: ``edge_quarantined`` the containment decision, and ``round_done`` the
#: fleet-level close.


def replay_edges(
    path: str, warn: Optional[Callable[[str], None]] = None
) -> Dict[int, Dict[str, Any]]:
    """Fold a ROOT journal into per-edge security state.

    Returns ``edge -> {"nonce": hwm, "quarantined": reason | None}``.  A
    restarted root restores the nonce high-water marks BEFORE serving, so
    a replay of a submission captured before the crash is still rejected
    — the idempotency machinery the run journal uses for run adoption,
    reused for replay protection.  Quarantines are permanent across
    restarts: a contained edge stays contained until the operator rotates
    its key and clears the journal.
    """
    states: Dict[int, Dict[str, Any]] = {}
    for rec in io_lib.iter_jsonl(path, warn=warn):
        run_id = rec.get("run_id")
        if not isinstance(run_id, str) or not run_id.startswith("edge-"):
            continue
        try:
            edge = int(run_id[5:])
        except ValueError:
            continue
        st = states.setdefault(edge, {"nonce": 0, "quarantined": None})
        nonce = rec.get("nonce")
        if isinstance(nonce, int):
            st["nonce"] = max(st["nonce"], nonce)
        if rec.get("op") == "edge_quarantined":
            st["quarantined"] = rec.get("reason", "unknown")
    return states
