"""Run registry + scheduler: the control plane behind the experiment server.

The port of ``byzantine_aircomp_tpu/serve/runs.py``.  A
:class:`RunManager` owns the lifecycle of every submitted run:

* ``submit`` assigns a ``run_id``, rebases the config's output paths onto
  the run's private subtree (``harness.run_namespace`` — the tenancy
  boundary), journals the submission (``serve/journal.py`` — the durable
  write-ahead log a restarted server replays), opens the run's own event
  stream, and queues it under its :func:`~.batch.static_signature`.
* The scheduler (a background thread started by :meth:`start`, or a
  direct :meth:`drain` call from tests) groups queued runs by
  ``static_signature`` and executes each group through ONE shared
  runner (:func:`~.elastic.runner_for`): 64 tenant submissions are one
  group, one ``batch_round_fn`` build, over one dataset on the device.
  Streamed and population-shard tenants batch too (the elastic runner
  pins the cohort-scan gating knobs instead of refusing them); only
  multi-round dispatch (``rounds_per_dispatch > 1``, whose dispatches
  cannot join the per-round group loop, and whose CUDA graph would bake
  a swappable knob) and service-mode warm rollback run SOLO through the
  harness.
* Lane groups are ELASTIC: when a lane drains mid-group (completes its
  own horizon, cancels, or quarantines) the slot is refilled between
  rounds from the admission queue (same signature), the incoming
  tenant resuming from its own checkpoint.  Each refill decision is a
  journal record written BEFORE the device splice, so a SIGKILL
  mid-refill replays the same tenant into the same lane; per-lane
  round indices let every lane run its own horizon, and the group
  retires only when no lane is live.
* Between rounds (the BatchRunner's ``before_round`` hook) queued knob
  swaps and cancellations land; after each round (``after_round``) every
  live lane writes a durable checkpoint — params + opt carries + the
  metric paths recorded so far, one atomic npz — so a killed server
  resumes every in-flight run from its last round boundary with final
  records bit-identical to an uninterrupted run.
* A poisoned lane (non-finite params/variance/loss, exception in eval)
  is quarantined by the BatchRunner health guards: the run fails with
  exactly one ``run_failed`` event naming the reason while its cotenants
  continue in the same group.
* A watchdog thread (``wedge_secs > 0``) detects runs that stop making
  progress, cancels and requeues them with bounded retries and
  exponential backoff (``run_retries`` / ``run_backoff``), and reports
  the service degraded (the server's ``/healthz`` flips to 503) while
  any run is wedged.

Every tenant-visible state change is an audit event in the run's own
stream — ``run_submitted`` / ``knob_swap`` / ``run_cancelled`` /
``run_failed`` / ``run_requeued`` / ``journal_replay`` (schema v6) —
and, when the manager was given a shared registry, every run's metrics
land under its own ``run_id`` label via
:class:`~..obs.metrics.LabeledRegistry`, so one ``/metrics`` scrape shows
all tenants side by side.

Threads: every device call runs on the scheduler thread (``drain``
asserts it while the scheduler runs, and each runner asserts that the
thread that built it drives it).  The HTTP handlers, the watchdog and the
``/metrics`` scrape read host copies only: the runs' infos, their paths
lists and the registry.  The server's device (``device``, ``cuda``
unless the caller asks for the CPU) is every tenant's: it sets the
``use_gpu`` field of every submitted config.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

from .. import obs as obs_lib
from ..fed import checkpoint, harness
from ..fed.config import FedConfig, config_from_mapping, config_to_mapping
from ..utils import io as io_lib
from . import elastic as elastic_lib
from . import journal as journal_lib
from .batch import applicable_knobs, static_signature

#: terminal statuses — no further transitions, obs stream closed
_DONE = ("completed", "cancelled", "failed")


class QueueFull(RuntimeError):
    """Submission rejected by the queue cap (HTTP maps this to 429)."""


def _warn(msg: str) -> None:
    print(f"[serve] {msg}", file=sys.stderr)


class Run:
    """One tenant run: config + lifecycle + its private output subtree.

    Not self-locking — the manager's lock guards every mutation (the
    scheduler, watchdog, and HTTP handler threads all touch runs).
    """

    def __init__(self, run_id: str, cfg: FedConfig, signature: str) -> None:
        self.run_id = run_id
        self.cfg = cfg
        self.signature = signature
        self.title = harness.ckpt_title(cfg)
        self.status = "queued"
        self.round = 0  # last round boundary reached while running
        self.lane: Optional[int] = None
        self.lane_hint: Optional[int] = None  # journal-replayed seat
        self.error: Optional[str] = None
        self.lowerings: Optional[int] = None
        self.swaps: List[tuple] = []  # pending (knob, value), applied between rounds
        self.applied_swaps: List[dict] = []
        self.cancel_requested = False
        self.paths: Optional[Dict[str, list]] = None
        self.obs: obs_lib.Observability = obs_lib.NULL
        # crash-safety / supervision state
        self.solo = False  # streamed/mesh config: single-lane harness path
        self.resume_round = 0  # checkpointed round a (re)start resumes from
        self.retries = 0  # watchdog requeues consumed
        self.wedged = False  # watchdog flagged: no progress in wedge_secs
        self.attempt = 0  # execution epoch: stale group closures no-op
        self.last_progress = time.time()
        self.idempotency_key: Optional[str] = None
        self.final: Optional[Dict[str, Any]] = None  # journal-adopted val stats
        self.record_path: Optional[str] = None
        # distributed tracing (--trace on tenants only): the tenant's
        # trace id (adopted from the submit's traceparent header when
        # present, minted otherwise), the pre-minted "run_request" root
        # span every per-run span hangs off, and the client's span id
        # (recorded on the root as remote_parent_span_id — kept out of
        # parent_span_id so local orphan detection stays meaningful)
        self.submitted_at = time.time()
        self.trace_id: Optional[str] = None
        self.root_span_id: Optional[str] = None
        self.remote_parent: Optional[str] = None

    def info(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "run_id": self.run_id,
            "title": self.title,
            "signature": self.signature,
            "status": self.status,
            "round": self.round,
            "rounds": self.cfg.rounds,
            "lane": self.lane,
            "obs_dir": self.cfg.obs_dir,
            "checkpoint_dir": self.cfg.checkpoint_dir,
            "knobs": {
                k: getattr(self.cfg, k)
                for k in ("seed",) + tuple(applicable_knobs(self.cfg))
            },
            "swaps": list(self.applied_swaps),
        }
        if self.solo:
            d["solo"] = True
        if self.resume_round:
            d["resume_round"] = self.resume_round
        if self.retries:
            d["retries"] = self.retries
        if self.wedged:
            d["wedged"] = True
        if self.lowerings is not None:
            d["lowerings"] = self.lowerings
        if self.trace_id is not None:
            d["trace_id"] = self.trace_id
        if self.error is not None:
            d["error"] = self.error
        if self.record_path is not None:
            d["record"] = self.record_path
        if self.paths and self.paths.get("valLossPath"):
            d["val_loss"] = self.paths["valLossPath"][-1]
            d["val_acc"] = self.paths["valAccPath"][-1]
        elif self.final is not None:
            if self.final.get("val_loss") is not None:
                d["val_loss"] = self.final["val_loss"]
            if self.final.get("val_acc") is not None:
                d["val_acc"] = self.final["val_acc"]
        return d


class RunManager:
    """Thread-safe run registry + signature-grouped batch scheduler."""

    def __init__(
        self,
        obs_root: str,
        registry=None,
        dataset=None,
        backend: str = "vmap",
        batch_window: float = 0.25,
        queue_cap: int = 0,
        run_retries: int = 1,
        run_backoff: float = 2.0,
        wedge_secs: float = 0.0,
        device: str = "cuda",
    ) -> None:
        from ..device import resolve_device

        # a server without a GPU and without device="cpu" fails here; it
        # never serves tenants on the CPU quietly
        self.device = resolve_device(device).type
        self.obs_root = obs_root
        self.registry = registry
        self._dataset = dataset
        self._backend = backend
        self._batch_window = batch_window
        self.queue_cap = queue_cap
        self.run_retries = run_retries
        self.run_backoff = run_backoff
        self.wedge_secs = wedge_secs
        self.journal = journal_lib.RunJournal(journal_lib.journal_path(obs_root))
        self._lock = threading.RLock()
        self._runs: Dict[str, Run] = {}
        self._order: List[str] = []
        self._pending: List[str] = []
        self._idem: Dict[str, str] = {}
        self._requeue_at: Dict[str, float] = {}
        self._seq = 0
        self._wake = threading.Event()
        self._stop = False
        self._held = False
        self._thread: Optional[threading.Thread] = None
        self._watchdog: Optional[threading.Thread] = None
        self._dataset_cache: Dict[str, Any] = {}
        # scheduler-scope telemetry: lane_group / lane_refill events and
        # the admission-queue gauge are group/service facts, not tenant
        # ones, so they land UNLABELED on the shared registry
        self._sched = (
            obs_lib.Observability(obs_lib.MetricsSink(registry))
            if registry is not None
            else obs_lib.NULL
        )

    # ---------------------------------------------------------- registry

    @staticmethod
    def _is_solo(cfg: FedConfig) -> bool:
        """Only genuinely unbatchable semantics fall outside the batch
        contract now: multi-round dispatch tiers (the group loop is
        per-round; an R-round scan cannot join it) and service-mode warm
        rollback (it restores per-run host state outside the shared
        batch carry).  Streamed cohorts and population meshes batch
        through the elastic runner (``serve/elastic.py``), which pins
        their trace-gating knobs instead of refusing them."""
        if cfg.rounds_per_dispatch > 1:
            return True
        return cfg.service == "on" and cfg.rollback != "off"

    def _queue_depth(self) -> int:
        """Runs awaiting admission to a lane (caller holds the lock)."""
        return sum(1 for r in self._runs.values() if r.status == "queued")

    def _gauge_queue(self) -> None:
        """Refresh the admission-queue-depth gauge (caller holds the
        lock; the registry itself is thread-safe)."""
        if self.registry is not None:
            self.registry.set(
                "aircomp_admission_queue_depth",
                float(self._queue_depth()),
                help_text="runs queued for admission to a lane group",
            )

    def _open_obs(self, run_id: str, cfg: FedConfig, title: str):
        sink: obs_lib.EventSink = obs_lib.JsonlSink(
            obs_lib.events_path(cfg.obs_dir, title)
        )
        if self.registry is not None:
            labeled = obs_lib.LabeledRegistry(self.registry, run_id=run_id)
            msink = obs_lib.MetricsSink(labeled)
            # the watchdog's wedge threshold doubles as the per-run
            # health bar (0 keeps per-sink wedge detection disabled)
            msink.wedge_secs = self.wedge_secs
            sink = obs_lib.MultiSink([sink, msink])
        out = obs_lib.Observability(sink)
        out.traced = getattr(cfg, "trace", "off") == "on"
        return out

    # ----------------------------------------------------------- tracing

    @staticmethod
    def _init_trace(run: Run, traceparent=None) -> None:
        """Mint (or adopt, from a submit's traceparent header) the
        tenant's trace identity and hang it on the run's obs façade so
        every retrospective span (queue_wait, lane_install, per-lane
        rounds, the run_request root) shares one tree.  No-op for
        untraced tenants."""
        if not run.obs.traced:
            return
        if traceparent is not None:
            run.trace_id = traceparent[0]
            run.remote_parent = traceparent[1]
        else:
            run.trace_id = obs_lib.trace.new_trace_id()
        run.root_span_id = obs_lib.trace.new_span_id()
        run.obs.trace_root = (run.trace_id, run.root_span_id)

    @staticmethod
    def _trace_fields(run: Run) -> Dict[str, Any]:
        """Envelope correlation for a tenant's control-plane events:
        the run's trace id plus the root span as the enclosing span.
        Empty for untraced tenants, so their streams stay byte-identical
        to pre-trace builds."""
        if run.trace_id is None:
            return {}
        out: Dict[str, Any] = {"trace_id": run.trace_id}
        if run.root_span_id is not None:
            out["span_id"] = run.root_span_id
        return out

    def _reopen_obs(self, run: Run) -> None:
        """Reopen a handed-over stream (solo finalization) with the
        run's trace identity restored."""
        run.obs = self._open_obs(run.run_id, run.cfg, run.title)
        if run.trace_id is not None and run.obs.traced:
            run.obs.trace_root = (run.trace_id, run.root_span_id)

    def _close_run_obs(self, run: Run) -> None:
        """Every terminal transition funnels here: emit the tenant's
        ``run_request`` root span (traced runs only — submit to terminal
        wall-clock, the id every other per-run span parents to) and
        close the stream, so no trace leaves its root unclosed."""
        if (
            run.trace_id is not None
            and run.obs is not obs_lib.NULL
            and run.obs.traced
        ):
            extra: Dict[str, Any] = {}
            if run.remote_parent is not None:
                extra["remote_parent_span_id"] = run.remote_parent
            run.obs.span_event(
                "run_request",
                ms=(time.time() - run.submitted_at) * 1e3,
                run_id=run.run_id,
                span_id=run.root_span_id,
                status=run.status,
                **extra,
            )
        run.obs.close()
        # detach so a second terminal sweep (e.g. a group-level _fail
        # after a lane already finalized) can never re-emit the root
        run.obs = obs_lib.NULL

    def submit(
        self,
        cfg: FedConfig,
        idempotency_key: Optional[str] = None,
        traceparent: Optional[Tuple[str, str]] = None,
    ) -> str:
        """Register + queue one run; returns its server-assigned id.

        The submission is journaled FIRST (write-ahead: the pre-namespace
        config mapping, so a restarted server can rebuild the exact run
        under the same id) and the run's event stream opens here so
        ``run_submitted`` is the stream's first event — a crash between
        submit and execution still leaves both an audit trail and a
        recoverable queue entry.  Raises :class:`QueueFull` when a
        ``queue_cap`` is set and that many runs are already queued."""
        cfg = dataclasses.replace(cfg, use_gpu=self.device == "cuda")
        cfg_map = config_to_mapping(cfg)
        with self._lock:
            if idempotency_key is not None and idempotency_key in self._idem:
                return self._idem[idempotency_key]
            if self.queue_cap > 0:
                queued = sum(
                    1 for r in self._runs.values() if r.status == "queued"
                )
                if queued >= self.queue_cap:
                    raise QueueFull(
                        f"queue full: {queued} runs already queued "
                        f"(cap {self.queue_cap}); retry after the scheduler "
                        "drains"
                    )
            self._seq += 1
            run_id = f"run-{self._seq:04d}"
            cfg = harness.run_namespace(cfg, run_id, self.obs_root)
            run = Run(run_id, cfg, static_signature(cfg))
            run.solo = self._is_solo(cfg)
            run.idempotency_key = idempotency_key
            if idempotency_key is not None:
                self._idem[idempotency_key] = run_id
            self.journal.append(
                "submitted",
                run_id,
                config=cfg_map,
                signature=run.signature,
                title=run.title,
                solo=run.solo,
                idempotency_key=idempotency_key,
            )
            run.obs = self._open_obs(run_id, cfg, run.title)
            self._init_trace(run, traceparent)
            run.obs.emit(
                "run_submitted",
                run_id=run_id, title=run.title, signature=run.signature,
                **self._trace_fields(run),
            )
            self._runs[run_id] = run
            self._order.append(run_id)
            self._pending.append(run_id)
            self._gauge_queue()
        self._wake.set()
        return run_id

    def submit_idempotent(
        self,
        cfg: FedConfig,
        key: Optional[str] = None,
        traceparent: Optional[Tuple[str, str]] = None,
    ) -> Tuple[str, bool]:
        """Submit unless ``key`` was already used; returns ``(run_id,
        created)`` so the HTTP layer can answer 200 instead of 201 on a
        client retry."""
        with self._lock:
            if key is not None and key in self._idem:
                return self._idem[key], False
        return (
            self.submit(cfg, idempotency_key=key, traceparent=traceparent),
            True,
        )

    def _get(self, run_id: str) -> Run:
        run = self._runs.get(run_id)
        if run is None:
            raise KeyError(f"no such run {run_id!r}")
        return run

    def get(self, run_id: str) -> Dict[str, Any]:
        with self._lock:
            return self._get(run_id).info()

    def list_runs(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [self._runs[rid].info() for rid in self._order]

    def cancel(
        self, run_id: str, traceparent: Optional[Tuple[str, str]] = None
    ) -> Dict[str, Any]:
        """Cancel a run.  Queued runs finalize immediately; running batch
        lanes go dark at the next round boundary (idempotent on done
        runs).  A running SOLO lane cannot be interrupted mid-schedule —
        the cancel takes effect only if it is still queued."""
        with self._lock:
            run = self._get(run_id)
            if run.status in _DONE:
                return run.info()
            run.cancel_requested = True
            self._requeue_at.pop(run_id, None)
            if run.status == "queued":
                run.status = "cancelled"
                run.obs.emit(
                    "run_cancelled", run_id=run_id, round=0,
                    **self._remote_fields(run, traceparent),
                )
                self._close_run_obs(run)
                self.journal.append("cancelled", run_id, round=run.round)
                self._gauge_queue()
            return run.info()

    @classmethod
    def _remote_fields(
        cls, run: Run, traceparent: Optional[Tuple[str, str]]
    ) -> Dict[str, Any]:
        """Trace fields for a control-plane event triggered over HTTP:
        the run's own trace identity plus, when the client stamped the
        request with a traceparent, the client's span as
        ``remote_parent_span_id`` (correlation both ways without
        grafting a foreign span into the local tree)."""
        out = cls._trace_fields(run)
        if out and traceparent is not None:
            out["remote_parent_span_id"] = traceparent[1]
            if traceparent[0] != run.trace_id:
                out["remote_trace_id"] = traceparent[0]
        return out

    def swap(
        self, run_id: str, knob: str, value,
        traceparent: Optional[Tuple[str, str]] = None,
    ) -> Dict[str, Any]:
        """Hot-swap one batchable knob.  Queued runs take the new value
        into their initial config; running runs get the lane's knob
        written at the next round boundary (no rebuild).  Raises
        ``ValueError`` for non-batchable knobs or done runs."""
        with self._lock:
            run = self._get(run_id)
            if run.status in _DONE:
                raise ValueError(
                    f"run {run_id} is {run.status}; knobs can only be "
                    f"swapped on queued/running runs"
                )
            allowed = set(applicable_knobs(run.cfg)) - set(
                elastic_lib.pinned_knobs(run.cfg)
            )
            if knob not in allowed:
                raise ValueError(
                    f"knob {knob!r} is not hot-swappable for this run "
                    f"(batchable here: {sorted(allowed)}); structural "
                    f"and stream-pinned knobs need a new run"
                )
            value = float(value)
            if run.status == "queued":
                # the batch doesn't exist yet — the new value simply
                # becomes the lane's initial knob (the runner copies cfg)
                setattr(run.cfg, knob, value)
                run.applied_swaps.append(
                    {"round": 0, "knob": knob, "value": value}
                )
                run.obs.emit(
                    "knob_swap",
                    run_id=run_id, round=0, knob=knob, value=value,
                    **self._remote_fields(run, traceparent),
                )
            else:
                run.swaps.append((knob, value))
            return run.info()

    # ---------------------------------------------------------- recovery

    def recover(self, warn=None) -> List[str]:
        """Replay the durable journal: re-adopt terminal runs as facts,
        requeue in-flight runs to resume from their last checkpoint.
        Returns the requeued ids.  Call BEFORE :meth:`start` on a
        restarted server (ExperimentServer does)."""
        warn = warn or _warn
        states = journal_lib.replay(self.journal.path, warn=warn)
        requeued: List[str] = []
        with self._lock:
            for run_id, st in states.items():
                if run_id in self._runs:
                    continue
                try:
                    num = int(run_id.rsplit("-", 1)[1])
                except (IndexError, ValueError):
                    num = 0
                self._seq = max(self._seq, num)
                try:
                    cfg = config_from_mapping(dict(st["config"]),
                                              use_gpu=self.device == "cuda")
                except Exception as exc:
                    warn(
                        f"run {run_id}: journaled config no longer valid "
                        f"({exc}); dropping"
                    )
                    continue
                cfg = harness.run_namespace(cfg, run_id, self.obs_root)
                run = Run(run_id, cfg, static_signature(cfg))
                run.solo = self._is_solo(cfg)
                key = st.get("idempotency_key")
                if key:
                    run.idempotency_key = key
                    self._idem[key] = run_id
                status = st["status"]
                if status in _DONE:
                    run.status = status
                    run.round = (
                        cfg.rounds if status == "completed"
                        else int(st.get("round", 0))
                    )
                    run.lowerings = st.get("lowerings")
                    run.error = st.get("error")
                    if status == "completed":
                        # re-adopt the on-disk record so a restarted
                        # server still serves completed runs' artifacts
                        path = harness.cache_path(cfg, cfg.dataset)
                        if os.path.exists(path):
                            run.record_path = path
                    if (
                        st.get("final_val_acc") is not None
                        or st.get("final_val_loss") is not None
                    ):
                        run.final = {
                            "val_acc": st.get("final_val_acc"),
                            "val_loss": st.get("final_val_loss"),
                        }
                else:
                    run.retries = int(st.get("retries", 0))
                    run.resume_round = self._probe_resume(run, warn)
                    run.round = run.resume_round
                    run.status = "queued"
                    if st.get("lane") is not None:
                        # journaled refill seat: recovery must reseat
                        # this tenant into the same lane (seat_order)
                        run.lane_hint = int(st["lane"])
                    run.obs = self._open_obs(run_id, cfg, run.title)
                    # trace ids are not journaled — a re-adopted tenant
                    # starts a fresh trace for its new attempt
                    self._init_trace(run)
                    run.obs.emit(
                        "journal_replay",
                        run_id=run_id,
                        status="resumed" if run.resume_round else "restarted",
                        round=run.resume_round,
                        **self._trace_fields(run),
                    )
                    self._pending.append(run_id)
                    requeued.append(run_id)
                self._runs[run_id] = run
                self._order.append(run_id)
            self._gauge_queue()
        if requeued:
            self._wake.set()
        return requeued

    def _probe_resume(self, run: Run, warn=_warn) -> int:
        """The round this run can durably resume from — 0 when there is
        no usable checkpoint (absent, torn, or missing the paths meta a
        full-record batch resume needs; restarting from scratch replays
        the identical trajectory, it just costs recompute)."""
        try:
            restored = checkpoint.load(run.cfg.checkpoint_dir, run.title)
            if restored is None:
                return 0
            if not run.solo:
                meta = checkpoint.load_meta(run.cfg.checkpoint_dir, run.title)
                if meta is None:
                    return 0
            return int(restored[0])
        except Exception as exc:
            warn(
                f"run {run.run_id}: unreadable checkpoint "
                f"({type(exc).__name__}: {exc}); restarting from round 0"
            )
            return 0

    # --------------------------------------------------------- scheduler

    def start(self) -> "RunManager":
        """Start the background scheduler (the server's mode).  Waits
        ``batch_window`` seconds after a submission before draining so
        concurrent tenants coalesce into one batch.  With
        ``wedge_secs > 0`` a watchdog thread also starts, requeueing
        wedged runs with bounded retries."""
        with self._lock:
            if self._thread is None:
                self._stop = False
                self._thread = threading.Thread(
                    target=self._loop,
                    name="aircomp-run-scheduler",
                    daemon=True,
                )
                self._thread.start()
            if self.wedge_secs > 0 and self._watchdog is None:
                self._watchdog = threading.Thread(
                    target=self._watchdog_loop,
                    name="aircomp-run-watchdog",
                    daemon=True,
                )
                self._watchdog.start()
        return self

    def tap_scheduler(self, sink) -> None:
        """Fan the scheduler-scope events (``lane_group``, ``lane_refill``)
        out to ``sink`` as well, on the scheduler thread, each right after
        the registry has folded it: a reader that must see every group
        boundary once, in order (the soak's occupancy gate), gets them
        without polling the registry.  Needs the server's registry."""
        if self._sched is obs_lib.NULL:
            raise ValueError("tap_scheduler needs a RunManager with a registry")
        self._sched.sink = obs_lib.MultiSink([self._sched.sink, sink])

    def hold(self) -> None:
        """Keep the scheduler thread from draining until :meth:`release`.
        Submissions queue meanwhile, and the first drain after the release
        groups every one of them: a caller that submits a known set of
        tenants (the soak's arrival phase) gets a group whose make-up does
        not hang on how fast its requests land against the batch window."""
        self._held = True

    def release(self) -> None:
        """End a :meth:`hold`: the scheduler drains the queue after its batch
        window, as after a submission."""
        self._held = False
        self._wake.set()

    def close(self) -> None:
        self._stop = True
        self._wake.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=30.0)
            self._thread = None
        watchdog = self._watchdog
        if watchdog is not None:
            watchdog.join(timeout=5.0)
            self._watchdog = None
        with self._lock:
            for rid in self._order:
                run = self._runs[rid]
                if run.status not in _DONE:
                    run.obs.close()
        self._sched.close()
        self.journal.close()

    def _loop(self) -> None:
        while not self._stop:
            self._wake.wait(timeout=0.5)
            self._wake.clear()
            if self._stop:
                break
            if self._pending and not self._held:
                time.sleep(self._batch_window)
                try:
                    self.drain()
                except Exception:  # keep the scheduler alive; runs record
                    traceback.print_exc()  # their own failure status

    def drain(self) -> None:
        """Execute every currently-queued run: solo configs one at a
        time, batchable ones grouped by ``signature`` into one elastic
        runner per group (each lane resumes from its OWN checkpoint
        round, so mixed-progress tenants still share a group).
        Blocks until done.  Tests call this directly for deterministic
        grouping; the scheduler thread calls it after the batch
        window (and, while the scheduler runs, only it may: the device
        has one driving thread).  Runs left queued (submitted mid-drain) are picked up
        either by a group's between-round refill or by the next loop
        iteration."""
        if self._thread is not None and threading.current_thread() is not self._thread:
            raise RuntimeError(
                "drain() runs on the scheduler thread while the scheduler is "
                "started: the device has one driving thread")
        while True:
            with self._lock:
                pending = [
                    self._runs[rid]
                    for rid in self._pending
                    if self._runs[rid].status == "queued"
                ]
                self._pending = []
                solos: List[Run] = []
                groups: Dict[str, List[Run]] = {}
                for run in pending:
                    run.status = "running"
                    run.attempt += 1
                    run.last_progress = time.time()
                    self.journal.append("running", run.run_id)
                    if run.solo:
                        solos.append(run)
                    else:
                        groups.setdefault(run.signature, []).append(run)
                self._gauge_queue()
            if not groups and not solos:
                return
            for runs in groups.values():
                self._run_group(runs)
            for run in solos:
                self._run_solo(run)

    def _dataset_for(self, name: str):
        if self._dataset is not None:
            return self._dataset
        if name not in self._dataset_cache:
            from ..data import datasets as data_lib

            self._dataset_cache[name] = data_lib.load(name)
        return self._dataset_cache[name]

    def _fail(self, runs: List[Run], exc: BaseException) -> None:
        with self._lock:
            for run in runs:
                if run.status not in _DONE:
                    run.status = "failed"
                    run.error = f"{type(exc).__name__}: {exc}"
                    run.obs.emit(
                        "run_failed",
                        run_id=run.run_id, round=run.round, reason=run.error,
                        **self._trace_fields(run),
                    )
                    self.journal.append(
                        "failed", run.run_id,
                        round=run.round, reason=run.error,
                    )
                self._close_run_obs(run)

    def _load_lane_resume(
        self, run: Run
    ) -> Tuple[int, Optional[tuple], Optional[Dict[str, list]]]:
        """One lane's durable resume state: ``(round, restored, paths)``
        — or ``(0, None, None)`` when there is no usable checkpoint
        (absent, torn, round-mismatched, or missing the paths meta).
        Per-lane: an elastic group resumes each lane independently, so
        one torn checkpoint restarts ONE lane, never the group (a fresh
        replay is bit-identical: every stream is derived from (seed,
        round, iteration) —
        correctness never depends on the checkpoint, only wall-clock
        does)."""
        if run.resume_round <= 0:
            return 0, None, None
        try:
            restored = checkpoint.load(run.cfg.checkpoint_dir, run.title)
            meta = checkpoint.load_meta(run.cfg.checkpoint_dir, run.title)
        except Exception as exc:
            _warn(
                f"run {run.run_id}: checkpoint unreadable at seat time "
                f"({type(exc).__name__}: {exc}); lane restarts fresh"
            )
            return 0, None, None
        if (
            restored is None
            or int(restored[0]) != run.resume_round
            or meta is None
        ):
            return 0, None, None
        return run.resume_round, restored, json.loads(meta)

    def _run_group(self, runs: List[Run]) -> None:
        runs = elastic_lib.seat_order(runs)
        lane_resume = [self._load_lane_resume(run) for run in runs]
        start_rounds = [rr for rr, _, _ in lane_resume]
        restores = [restored for _, restored, _ in lane_resume]
        resume_paths = [paths for _, _, paths in lane_resume]
        try:
            dataset = self._dataset_for(runs[0].cfg.dataset)

            def restore_fn(lane: int, trainer) -> None:
                if restores[lane] is not None:
                    harness.restore_trainer(trainer, restores[lane], log_fn=_warn)

            batch = elastic_lib.runner_for(
                [r.cfg for r in runs],
                dataset=dataset,
                backend=self._backend,
                device=self.device,
                restore_fn=(
                    restore_fn
                    if any(r is not None for r in restores)
                    else None
                ),
            )
        except Exception as exc:
            self._fail(runs, exc)
            return
        # seated[lane] is the lane's CURRENT occupant (None = drained
        # slot awaiting refill); group_runs accumulates every run that
        # ever rode this batch, so a group-level exception fails the
        # refilled tenants too
        seated: List[Optional[Run]] = list(runs)
        group_runs: List[Run] = list(runs)
        attempts = {run.run_id: run.attempt for run in runs}
        with self._lock:
            for lane, run in enumerate(runs):
                run.lane = lane
                run.lane_hint = lane
                run.resume_round = start_rounds[lane]
                run.round = start_rounds[lane]
                # admission latency, submit -> lane seat (traced no-op
                # otherwise); feeds aircomp_queue_wait_seconds and the
                # queue_wait_p99 alert
                run.obs.span_event(
                    "queue_wait",
                    ms=(time.time() - run.submitted_at) * 1e3,
                    run_id=run.run_id, lane=lane,
                )

        def _live(run: Run) -> bool:
            """Still this group's run?  A watchdog requeue bumps the
            attempt — the stale group must stop touching it."""
            return (
                run.status == "running"
                and run.attempt == attempts[run.run_id]
            )

        def _release(lane: int) -> None:
            # free the slot AND the lane's forensic state (quarantine
            # freeze / failure reason), so a refilled tenant never
            # inherits the prior occupant's counters
            batch.release_lane(lane)
            seated[lane] = None

        def install(lane: int, run: Run, step: int) -> None:
            """Seat a picked tenant into a drained lane.  Called without
            the lock: the trainer build and the checkpoint read must not
            stall the HTTP thread's submits; the run is already
            ``running`` (:func:`refill_picks`), so a cancel meanwhile
            only marks it."""
            with self._lock:
                run.obs.span_event(
                    "queue_wait",
                    ms=(time.time() - run.submitted_at) * 1e3,
                    run_id=run.run_id, lane=lane,
                )
            t_install = time.perf_counter()
            rr, restored, rpaths = self._load_lane_resume(run)
            # WAL discipline: the refill record lands BEFORE the device
            # splice, so a SIGKILL between the two replays this tenant
            # back into this exact lane (recover() turns the journaled
            # lane into a seat_order hint)
            self.journal.append(
                "refill", run.run_id,
                lane=lane, round=rr, group_round=step,
                signature=run.signature,
            )
            try:
                batch.install_lane(
                    lane, run.cfg, own_round=rr,
                    restored=restored, paths=rpaths,
                )
            except Exception as exc:
                with self._lock:
                    run.status = "failed"
                    run.error = f"{type(exc).__name__}: {exc}"
                    run.obs.emit(
                        "run_failed",
                        run_id=run.run_id, round=rr, reason=run.error,
                        **self._trace_fields(run),
                    )
                    self._close_run_obs(run)
                    self.journal.append(
                        "failed", run.run_id, round=rr, reason=run.error,
                    )
                return
            with self._lock:
                batch.obs_list[lane] = run.obs
                run.resume_round = rr
                run.round = rr
                seated[lane] = run
                group_runs.append(run)
                run.obs.span_event(
                    "lane_install",
                    ms=(time.perf_counter() - t_install) * 1e3,
                    run_id=run.run_id, lane=lane, round=rr,
                )
                run.obs.emit(
                    "lane_refill",
                    run_id=run.run_id, lane=lane, round=rr, group_round=step,
                    **self._trace_fields(run),
                )
                self._sched.emit(
                    "lane_refill",
                    run_id=run.run_id, lane=lane, round=rr, group_round=step,
                )

        def refill_picks() -> List[Tuple[int, Run]]:
            """Between rounds, pick queued tenants for the drained lanes
            (lock held): same-signature tenants only, the journal-hinted
            ones reclaiming their exact lane first, the rest zipping into
            the remaining slots in submission order.  A pick leaves the
            queue as ``running`` now; :func:`install` seats it."""
            free = [ln for ln in range(batch.n) if seated[ln] is None]
            if not free:
                return []
            sig = runs[0].signature
            picks: List[Run] = []
            keep: List[str] = []
            for rid in self._pending:
                cand = self._runs[rid]
                if (
                    len(picks) < len(free)
                    and cand.status == "queued"
                    and not cand.solo
                    and cand.signature == sig
                    and not cand.cancel_requested
                ):
                    picks.append(cand)
                else:
                    keep.append(rid)
            if not picks:
                return []
            self._pending = keep
            free_set = set(free)
            hinted: List[Tuple[int, Run]] = []
            rest: List[Run] = []
            for cand in picks:
                h = cand.lane_hint
                if h is not None and h in free_set:
                    hinted.append((h, cand))
                    free_set.discard(h)
                else:
                    rest.append(cand)
            open_lanes = iter(sorted(free_set))
            seats = hinted + [(next(open_lanes), c) for c in rest]
            for lane, run in seats:
                run.status = "running"
                run.attempt += 1
                attempts[run.run_id] = run.attempt
                run.lane = lane
                run.lane_hint = lane
                run.wedged = False
                run.last_progress = time.time()
            self._gauge_queue()
            return seats

        def emit_lane_group(step: int) -> None:
            # occupancy is the acceptance gauge: live lanes / group
            # width, sampled every round boundary after refill
            live = sum(1 for ln in range(batch.n) if seated[ln] is not None)
            self._sched.emit(
                "lane_group",
                round=step, lanes=batch.n, live=live,
                occupancy=live / batch.n,
                queue_depth=self._queue_depth(),
            )

        def before_round(step: int) -> None:
            with self._lock:
                for lane in range(batch.n):
                    run = seated[lane]
                    if run is None:
                        continue
                    if not _live(run):
                        # terminal elsewhere (quarantined, watchdog-
                        # failed) or re-adopted: free the slot
                        _release(lane)
                        continue
                    if run.wedged:
                        # the watchdog owns this run now (requeue or
                        # terminal failure) — this group just stops
                        # driving the lane, without terminalizing
                        _release(lane)
                        continue
                    rnd = batch.lane_rounds[lane]
                    if run.cancel_requested:
                        _release(lane)
                        run.status = "cancelled"
                        run.obs.emit(
                            "run_cancelled", run_id=run.run_id, round=rnd,
                            **self._trace_fields(run),
                        )
                        self._close_run_obs(run)
                        self.journal.append(
                            "cancelled", run.run_id, round=rnd
                        )
                        run.swaps = []
                        continue
                    for knob, value in run.swaps:
                        batch.set_knob(lane, knob, value)
                        setattr(run.cfg, knob, value)
                        run.applied_swaps.append(
                            {"round": rnd, "knob": knob, "value": value}
                        )
                        run.obs.emit(
                            "knob_swap",
                            run_id=run.run_id, round=rnd,
                            knob=knob, value=value,
                            **self._trace_fields(run),
                        )
                    run.swaps = []
                    run.round = rnd
                    run.last_progress = time.time()
                seats = refill_picks()
            for lane, run in seats:
                install(lane, run, step)
            with self._lock:
                emit_lane_group(step)

        def on_quarantine(lane: int, rnd: int, reason: str) -> None:
            with self._lock:
                run = seated[lane]
                if run is None or not _live(run):
                    return
                run.status = "failed"
                run.error = f"quarantined: {reason}"
                run.round = rnd
                run.obs.emit(
                    "run_failed",
                    run_id=run.run_id, round=rnd, reason=run.error,
                    **self._trace_fields(run),
                )
                self._close_run_obs(run)
                self.journal.append(
                    "failed", run.run_id, round=rnd, reason=run.error
                )

        def after_round(step: int) -> None:
            # durable per-round progress: params + opt carries + the
            # metric paths so far, one atomic npz per live lane — the
            # unit a restarted server resumes from.  lane_rounds has
            # already advanced past the round just run, so it IS the
            # boundary a restart resumes from.  The writes run without
            # the lock (the HTTP thread reads the runs meanwhile).
            with self._lock:
                due = [
                    (lane, seated[lane]) for lane in range(batch.n)
                    if seated[lane] is not None
                    and _live(seated[lane])
                    and batch.active[lane]
                ]
            for lane, run in due:
                rnd = batch.lane_rounds[lane]
                flat, extras = batch.lane_state(lane)
                try:
                    checkpoint.save(
                        run.cfg.checkpoint_dir,
                        run.title,
                        rnd,
                        flat,
                        extras,
                        meta=json.dumps(batch.paths_list[lane]),
                    )
                except Exception as exc:
                    _warn(
                        f"run {run.run_id}: checkpoint write failed "
                        f"({type(exc).__name__}: {exc}); continuing"
                    )
                    continue
                with self._lock:
                    self.journal.append(
                        "checkpoint", run.run_id, round=rnd
                    )
                    run.round = rnd
                    run.last_progress = time.time()

        def on_lane_done(lane: int) -> None:
            # a lane reached its OWN horizon: finalize the tenant now
            # (record, journal, stream close) so the slot refills at
            # the next round boundary while cotenants keep going
            with self._lock:
                run = seated[lane]
                if run is None or not _live(run) or run.wedged:
                    return
                paths = batch.paths_list[lane]
                run.paths = paths
                run.lowerings = batch.retrace.count("batch_round_fn")
                run.status = "completed"
                run.wedged = False
                run.round = run.cfg.rounds
                record = harness.build_record(
                    run.cfg,
                    paths,
                    dataset_name=dataset.name,
                    dataset_size=len(dataset.x_train),
                    max_feature=int(dataset.x_train[0].size),
                )
                try:
                    run.record_path = io_lib.atomic_pickle(
                        harness.cache_path(run.cfg, dataset.name), record
                    )
                except Exception as exc:
                    _warn(
                        f"run {run.run_id}: record write failed "
                        f"({type(exc).__name__}: {exc})"
                    )
                self.journal.append(
                    "completed",
                    run.run_id,
                    round=run.round,
                    lowerings=run.lowerings,
                    final_val_acc=paths["valAccPath"][-1],
                    final_val_loss=paths["valLossPath"][-1],
                )
                self._close_run_obs(run)
                seated[lane] = None

        try:
            batch.train(
                obs_list=[r.obs for r in runs],
                start_rounds=start_rounds,
                before_round=before_round,
                after_round=after_round,
                resume_paths=resume_paths,
                on_quarantine=on_quarantine,
                on_lane_done=on_lane_done,
            )
        except Exception as exc:
            self._fail(group_runs, exc)
            return
        lowerings = batch.retrace.count("batch_round_fn")
        with self._lock:
            for run in group_runs:
                # lanes finalized early (mid-group retirement) recorded
                # their lowering count as of that round; backfill the
                # group-final count so every tenant reports the shared
                # program's true total
                if run.status == "completed" and run.lowerings is None:
                    run.lowerings = lowerings

    def _run_solo(self, run: Run) -> None:
        """One solo tenant (multi-round dispatch, warm rollback) through
        the ordinary harness path.  The harness reopens the run's event
        stream (seq continues from the file), checkpoints every round (each
        dispatch under R > 1) with the metric paths riding the npz, and on
        an ``inherit`` resume merges the prefix so the record covers the
        whole schedule."""
        run_id = run.run_id
        with self._lock:
            run.lane = 0
            run.last_progress = time.time()
            run.obs.span_event(
                "queue_wait",
                ms=(time.time() - run.submitted_at) * 1e3,
                run_id=run_id, lane=0,
            )
        # hand the stream over: the harness's own sink appends after ours
        run.obs.close()
        run.obs = obs_lib.NULL
        solo_cfg = dataclasses.replace(run.cfg, inherit=True)

        def on_ckpt(rnd: int, _trainer=None) -> None:
            self.journal.append("checkpoint", run_id, round=rnd)
            with self._lock:
                run.round = rnd
                run.last_progress = time.time()

        def _exec():
            return harness.run_with_trainer(
                solo_cfg,
                device=self.device,
                record_in_file=True,
                dataset=self._dataset_for(solo_cfg.dataset),
                on_round=on_ckpt,
            )[1]

        try:
            if run.trace_id is not None:
                # the harness's own "run" span (and everything under it)
                # adopts the tenant's trace and parents to the pre-minted
                # run_request root — one tree across the handover
                with obs_lib.trace.activate(run.trace_id, run.root_span_id):
                    record = _exec()
            else:
                record = _exec()
        except Exception as exc:
            err = f"{type(exc).__name__}: {exc}"
            with self._lock:
                run.status = "failed"
                run.error = err
                self._reopen_obs(run)
                run.obs.emit(
                    "run_failed", run_id=run_id, round=run.round, reason=err,
                    **self._trace_fields(run),
                )
                self._close_run_obs(run)
            self.journal.append(
                "failed", run_id, round=run.round, reason=err
            )
            return
        lowerings = self._solo_lowerings(run.cfg, run.title)
        with self._lock:
            run.paths = {
                k: v
                for k, v in record.items()
                if isinstance(v, list)
            }
            run.lowerings = lowerings
            run.status = "completed"
            run.round = run.cfg.rounds
            run.record_path = harness.cache_path(run.cfg, record["name"])
            if run.trace_id is not None:
                # reopen the handed-back stream just long enough to seal
                # the trace: the run_request root appends after the
                # harness's own events, closing the tree
                self._reopen_obs(run)
                self._close_run_obs(run)
            else:
                run.obs = obs_lib.NULL
        self.journal.append(
            "completed",
            run_id,
            round=run.cfg.rounds,
            lowerings=lowerings,
            final_val_acc=record["valAccPath"][-1],
            final_val_loss=record["valLossPath"][-1],
        )

    def _solo_lowerings(self, cfg: FedConfig, title: str) -> Optional[int]:
        """The solo run's build count, read back from the run's own retrace
        event (the harness emits it at run end): its eager set-up
        (``round_fn``), or its CUDA-graph capture (``multi_round_fn``) for
        a graphed multi-round run."""
        path = obs_lib.events_path(cfg.obs_dir, title)
        count: Optional[int] = None
        for e in io_lib.iter_jsonl(path):
            if e.get("kind") == "retrace":
                counts = e.get("counts") or {}
                if counts.get("round_fn") or counts.get("multi_round_fn"):
                    count = int(counts.get("round_fn") or counts["multi_round_fn"])
        return count

    # ---------------------------------------------------------- watchdog

    def degraded(self) -> Optional[str]:
        """A human-readable reason when the service is degraded (wedged
        or backoff-pending runs), else None — the server's /healthz
        flips to 503 on it."""
        with self._lock:
            wedged = [
                rid
                for rid in self._order
                if self._runs[rid].wedged
                and self._runs[rid].status not in _DONE
            ]
            if wedged:
                return f"wedged runs: {', '.join(wedged)}"
            if self._requeue_at:
                return (
                    "requeue pending: "
                    + ", ".join(sorted(self._requeue_at))
                )
        return None

    def _watchdog_loop(self) -> None:
        interval = max(min(self.wedge_secs / 4.0, 0.5), 0.05)
        while not self._stop:
            time.sleep(interval)
            try:
                self._watchdog_sweep(time.time())
            except Exception:
                traceback.print_exc()

    def _watchdog_sweep(self, now: float) -> None:
        """One supervision pass (explicit ``now`` so tests drive it
        deterministically): flag running runs with no progress in
        ``wedge_secs`` as wedged, cancel their lane, and either schedule
        a bounded-backoff requeue (``run_backoff * 2**(retries-1)``
        seconds) or — retries exhausted — fail them for good.  Solo
        lanes are flagged (degrading /healthz) but never requeued while
        their executing thread may still be alive: a second execution
        over the same namespace would race the first.  Reads host state
        only (the runs' progress stamps)."""
        wake = False
        with self._lock:
            for rid in self._order:
                run = self._runs[rid]
                if (
                    run.status != "running"
                    or run.wedged
                    or self.wedge_secs <= 0
                ):
                    continue
                age = now - run.last_progress
                if age <= self.wedge_secs:
                    continue
                run.wedged = True
                run.cancel_requested = True  # lane goes dark if it wakes
                reason = f"wedged: no progress in {age:.1f}s"
                if run.solo:
                    _warn(
                        f"run {rid} {reason} (solo lane — flagged, not "
                        "requeued; /healthz reports degraded)"
                    )
                    continue
                if run.retries < self.run_retries:
                    run.retries += 1
                    delay = self.run_backoff * (2 ** (run.retries - 1))
                    self._requeue_at[rid] = now + delay
                    run.obs.emit(
                        "run_requeued",
                        run_id=rid, round=run.round,
                        retries=run.retries, reason=reason,
                    )
                    self.journal.append(
                        "requeued", rid, retries=run.retries, reason=reason
                    )
                    _warn(
                        f"run {rid} {reason}; requeue "
                        f"{run.retries}/{self.run_retries} in {delay:.1f}s"
                    )
                else:
                    run.status = "failed"
                    run.error = f"{reason}; retries exhausted"
                    run.obs.emit(
                        "run_failed",
                        run_id=rid, round=run.round, reason=run.error,
                    )
                    run.obs.close()
                    self.journal.append(
                        "failed", rid, round=run.round, reason=run.error
                    )
            for rid, due in sorted(self._requeue_at.items()):
                if now < due:
                    continue
                del self._requeue_at[rid]
                run = self._runs[rid]
                if run.status in _DONE:
                    continue
                run.status = "queued"
                run.wedged = False
                run.cancel_requested = False
                run.last_progress = now
                run.resume_round = self._probe_resume(run)
                run.round = run.resume_round
                self._pending.append(rid)
                self._gauge_queue()
                wake = True
        if wake:
            self._wake.set()
