"""Experiment-axis batching: N same-shape configs as lanes of one group.

The port of ``byzantine_aircomp_tpu/serve/batch.py``.  The batch contract
is JAX's, field for field: :func:`validate_batch` requires every config
field that selects program structure to match across the batch, lets the
output-only fields and the per-lane horizon (``rounds``) differ, and makes
the knobs in :data:`BATCHABLE_KNOBS` per-lane data; :func:`static_signature`
is the grouping key.  The verdicts, the error texts and the grouping equal
JAX's on the same configs.

The lanes' design differs from JAX's, which maps the unmodified round over
stacked carries under one ``jit``.  The port compiles nothing per round, so
here:

* **The lanes share one set-up**: one dataset on the device (lane 0's
  trainer uploads the train rows, labels, client offsets and eval arrays;
  every other lane's is built with ``data_from`` and reads them) and one
  load of the kernels (the Weiszfeld workspaces and select plans are
  module-global per (device, shape)).  Each lane is its own trainer state
  (params, server optimizer, client momentum, fault, defense, onset and
  service state) and its own seed.  A ``batch_round_fn`` build
  (``obs/retrace.py``) is counted wherever a lane's trainer uploads the
  dataset itself, so a group counts one, and a swap or refill that set the
  group up again would show as a second.
* **The backends ``vmap`` and ``map`` both run each lane's round in turn**,
  through the solo trainer's own iteration code, on one stream.  A lane's
  record is then bitwise its solo run on the same device, by construction:
  the contract chaos (``kill9``), refill and the tuner's resume rely on.
  Lanes are not stacked into one [N, K, d] program: ``torch.func.vmap``
  cannot pass through the ctypes kernel launches, and a batched product
  rounds otherwise than the solo one.  The two names are JAX's, taken for
  its clients; they will choose between stacked lanes and lanes in turn
  once a lane axis exists (ROADMAP queue B).
* **Knobs are per-lane data, never a rebuild.**  The trainer reads
  ``cfg.gamma``, ``cfg.weight_decay``, ``cfg.attack_param``,
  ``cfg.noise_var`` and the service knobs as Python floats at call time,
  and the detector and policy constants from its defense spec, so
  :meth:`BatchRunner.set_knob` writes the lane's own copy and its next
  round reads it (JAX's ``_bound``).
* **Per-lane round cursors.**  A trainer derives every stream from (seed,
  round, iteration, stream), so a lane refilled at round r draws what its
  solo run draws at round r.
* **Quarantine** reads each lane's variance and params' finiteness on the
  host once per round, as JAX's ``train`` does, and freezes a poisoned
  lane's state finite in place; inactive lanes run nothing, so the
  cotenants' records are those of a batch without it.
* **One device thread.**  The module-global kernel workspaces are safe
  only when one thread drives the device; a runner records the thread
  that built it and raises if another one touches its lanes.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from .. import obs as obs_lib
from ..defense import events as defense_events
from ..fed.config import FedConfig

#: knobs the trainer reads off its cfg at call time
_CFG_KNOBS = (
    "gamma", "weight_decay", "attack_param", "noise_var",
    "churn_arrival", "churn_departure", "straggler_prob",
)
#: cfg knob -> DetectorParams field
_DETECTOR_KNOBS = {
    "defense_alpha": "alpha",
    "defense_drift": "drift",
    "defense_z": "z_thresh",
    "defense_cusum": "cusum_thresh",
    "defense_warmup": "warmup",
}
#: cfg knob -> PolicyParams field
_POLICY_KNOBS = {
    "defense_up": "up_n",
    "defense_down": "down_m",
    "defense_min_flagged": "min_flagged",
    "defense_leak": "budget_leak",
    "defense_floor": "floor_thresh",
}
_INT_KNOBS = frozenset(
    {"defense_warmup", "defense_up", "defense_down", "defense_min_flagged"}
)

#: batchable knobs the streamed round gates its structure on: a streamed
#: batch must PIN these (equal across the batch, not hot-swappable);
#: ``serve/elastic.py`` enforces it and :func:`static_signature` folds them
#: into a streamed config's digest
PINNED_STREAM_KNOBS = ("straggler_prob",)

#: every knob that can ride the experiment axis as per-lane data; ``seed``
#: is batchable structurally (each lane has its own trainer)
BATCHABLE_KNOBS = (
    ("seed",)
    + _CFG_KNOBS
    + tuple(_DETECTOR_KNOBS)
    + tuple(_POLICY_KNOBS)
)

#: fields that relocate or duplicate outputs without touching the rounds —
#: free to differ across the batch (JAX's list; forensics is not here: its
#: top-M is part of the round)
_OUTPUT_ONLY = (
    "checkpoint_dir", "cache_dir", "profile_dir", "profile_rounds",
    "inherit", "mark", "obs_dir", "obs_stdout", "log_file", "quiet",
    "hbm_warn_factor", "metrics", "metrics_port", "alerts",
    "obs_rotate_mb",
    "async_writer", "dispatch_prefetch",
    "trace",
)

#: host-driver horizons: each lane retires at its own ``rounds``
_PER_LANE_HORIZON = ("rounds",)

#: the server's fields (its device): equal for every tenant, and outside
#: the digest, so a signature is the JAX package's for the same config
_SERVER_FIELDS = ("use_gpu",)

#: the backends a runner takes (JAX's names); both run the lanes in turn,
#: on one stream, until stacked lanes exist (ROADMAP queue B)
BACKENDS = ("vmap", "map")


def applicable_knobs(cfg: FedConfig) -> List[str]:
    """The knobs live for this config family (JAX ``batch.py:130``): a knob
    whose feature is off has no read site, so it is neither per-lane data
    nor hot-swappable."""
    knobs = ["gamma", "weight_decay"]
    if cfg.attack is not None and cfg.attack_param is not None:
        knobs.append("attack_param")
    if cfg.noise_var is not None:
        knobs.append("noise_var")
    if cfg.service == "on":
        knobs += ["churn_arrival", "churn_departure", "straggler_prob"]
    if cfg.defense != "off":
        knobs += list(_DETECTOR_KNOBS) + list(_POLICY_KNOBS)
    return knobs


def _validate_structure(cfgs: Sequence[FedConfig]) -> List[str]:
    """The shared structural contract (everything in :func:`validate_batch`
    but the streamed-cohort carve-out).  Raises ``ValueError`` naming the
    first violation; returns the applicable knob names."""
    if not cfgs:
        raise ValueError("validate_batch: empty batch")
    for cfg in cfgs:
        cfg.validate()
    t = cfgs[0]
    skip = (set(BATCHABLE_KNOBS) | set(_OUTPUT_ONLY) | set(_PER_LANE_HORIZON)
            | set(_SERVER_FIELDS))
    for f in dataclasses.fields(FedConfig):
        if f.name in skip:
            continue
        vals = [getattr(c, f.name) for c in cfgs]
        if any(v != vals[0] for v in vals[1:]):
            raise ValueError(
                f"batch contract: field {f.name!r} must match across the "
                f"batch (it selects traced-program structure), got "
                f"{sorted(set(map(repr, vals)))}"
            )
    for knob in ("attack_param", "noise_var"):
        classes = {getattr(c, knob) is None for c in cfgs}
        if len(classes) > 1:
            raise ValueError(
                f"batch contract: {knob} presence must match across the "
                f"batch (None gates a traced branch); mix of set/None"
            )
    if t.service == "on" and t.rollback != "off":
        raise ValueError(
            "batch contract: service batches require rollback='off' "
            "(warm rollback restores per-run host state outside the "
            "shared batch carry)"
        )
    if t.partition == "dirichlet":
        seeds = {c.seed for c in cfgs}
        if len(seeds) > 1:
            raise ValueError(
                "batch contract: a dirichlet partition derives the data "
                "permutation from the seed; batched lanes share one data "
                "layout, so seeds must match (use contiguous for seed "
                "batches)"
            )
    return applicable_knobs(t)


def validate_batch(cfgs: Sequence[FedConfig]) -> List[str]:
    """The contract of the base runner (JAX ``batch.py:203``): the
    structural contract, and no streamed cohorts (``serve/elastic.py``
    admits them with their gating knobs pinned).  Returns the applicable
    knob names."""
    knobs = _validate_structure(cfgs)
    if cfgs[0].cohort_size != 0:
        raise ValueError(
            "batch contract: cohort streaming (cohort_size > 0) is not "
            "batchable — the cohort scan selects structure from knob "
            "values; run streamed configs solo"
        )
    return knobs


def static_signature(cfg: FedConfig) -> str:
    """Stable digest of everything :func:`validate_batch` requires to
    match: two configs with equal signatures share one runner (the run
    manager's grouping key; JAX ``batch.py:232``, the same digest)."""
    skip = (set(BATCHABLE_KNOBS) | set(_OUTPUT_ONLY) | set(_PER_LANE_HORIZON)
            | set(_SERVER_FIELDS))
    parts = []
    for f in sorted(dataclasses.fields(FedConfig), key=lambda f: f.name):
        if f.name in skip:
            continue
        parts.append(f"{f.name}={getattr(cfg, f.name)!r}")
    parts.append(f"attack_param_set={cfg.attack_param is not None}")
    parts.append(f"noise_var_set={cfg.noise_var is not None}")
    if cfg.partition == "dirichlet":
        parts.append(f"seed={cfg.seed}")
    if cfg.cohort_size > 0:
        for knob in PINNED_STREAM_KNOBS:
            parts.append(f"{knob}={getattr(cfg, knob)!r}")
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:12]


def knob_value(name: str, value):
    """A knob's value as the trainer reads it: int for the integer
    constants, float otherwise."""
    return int(value) if name in _INT_KNOBS else float(value)


def write_knob(trainer, name: str, value) -> None:
    """Install one knob into a lane's trainer: its cfg for the knobs read
    off the cfg, its defense spec for the detector and policy constants."""
    value = knob_value(name, value)
    setattr(trainer.cfg, name, value)
    spec = trainer.defense
    if spec is not None and name in _DETECTOR_KNOBS:
        trainer.defense = dataclasses.replace(
            spec, detector=dataclasses.replace(spec.detector, **{_DETECTOR_KNOBS[name]: value}))
    elif spec is not None and name in _POLICY_KNOBS:
        trainer.defense = dataclasses.replace(
            spec, policy=dataclasses.replace(spec.policy, **{_POLICY_KNOBS[name]: value}))


def _freeze_finite(x):
    """Replace a state tree's non-finite floats by finite ones, in place."""
    if isinstance(x, torch.Tensor):
        if x.is_floating_point():
            torch.nan_to_num_(x, nan=0.0, posinf=0.0, neginf=0.0)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _freeze_finite(v)


class BatchRunner:
    """N same-shape experiments as lanes of one group (see the module
    docstring): one trainer per lane over one shared dataset on the
    device, every lane's round run in turn through the trainer's own
    code, knobs per lane, one ``batch_round_fn`` build per group."""

    def __init__(
        self,
        cfgs: Sequence[FedConfig],
        dataset=None,
        retrace: Optional[obs_lib.RetraceDetector] = None,
        backend: str = "vmap",
        restore_fn: Optional[Callable[[int, Any], None]] = None,
        device: Optional[str] = None,
    ) -> None:
        from ..data import datasets as data_lib

        self.knob_names = self._validate(cfgs)
        self._check_backend(backend)
        self.backend = backend
        # the runner's own copies: a knob swap writes a lane's copy, never
        # the caller's config
        self.cfgs = [copy.copy(c) for c in cfgs]
        self.n = len(self.cfgs)
        self.device = device or ("cuda" if self.cfgs[0].use_gpu else "cpu")
        self.dataset = dataset or data_lib.load(self.cfgs[0].dataset)
        self.retrace = retrace or obs_lib.RetraceDetector()
        # the thread that drives the device: the kernels' module-global
        # workspaces are safe for one thread only
        self._device_thread = threading.get_ident()
        self.trainers: list = []
        for c in self.cfgs:
            self.trainers.append(self._make_trainer(c))
        if restore_fn is not None:
            # the resume hook: each lane's checkpoint, installed before the
            # first round (the server's crash-recovery path)
            for lane, t in enumerate(self.trainers):
                restore_fn(lane, t)
        self.template = self.trainers[0]
        #: whether the group has run a round (its first pays for the
        #: kernels' load, as a solo run's first round does)
        self._ran = False
        self.active = [True] * self.n
        #: per-lane round cursor: lane i's NEXT round of its own trajectory
        self.lane_rounds = [0] * self.n
        #: lanes reseated through install_lane over this runner's life
        self.refills = 0
        #: lane -> quarantine reason
        self.failed: Dict[int, str] = {}
        self.obs_list: List[Optional[obs_lib.Observability]] = [None] * self.n
        self.paths_list: Optional[List[Dict[str, list]]] = None

    # ------------------------------------------------------------ set-up

    def _validate(self, cfgs: Sequence[FedConfig]) -> List[str]:
        """The admission contract; the elastic runner widens it."""
        return validate_batch(cfgs)

    def _check_backend(self, backend: str) -> None:
        if backend not in BACKENDS:
            raise ValueError(f"backend must be 'vmap' or 'map', got {backend!r}")

    def _make_trainer(self, cfg: FedConfig):
        """One lane's trainer, reading the group's dataset on the device
        (lane 0's trainer uploads it).  A trainer that uploaded its own
        is the group's set-up: it counts one ``batch_round_fn`` build."""
        from ..fed.train import Trainer

        t = Trainer(cfg, dataset=self.dataset, device=self.device, graphs=False,
                    data_from=self.trainers[0] if self.trainers else None)
        if t.staged_data:
            self.retrace.build("batch_round_fn")
        return t

    def _check_thread(self) -> None:
        if threading.get_ident() != self._device_thread:
            raise RuntimeError(
                "a batch runner's lanes are driven by the thread that built it: "
                "the kernels' workspaces are module-global and safe for one "
                "device thread only")

    # -------------------------------------------------------- execution

    def run_round(self, round_idx):
        """One group round: every active lane runs the next round of its
        own trajectory, in turn.  ``round_idx`` is a scalar (every lane at
        the same round) or a length-N sequence of per-lane rounds.
        Returns the per-lane honest dispersion (device scalars, None for
        a lane that did not run), without a host sync."""
        self._check_thread()
        rounds = ([int(round_idx)] * self.n if not isinstance(round_idx, (list, tuple))
                  else [int(r) for r in round_idx])
        self._ran = True
        out: List[Optional[torch.Tensor]] = [None] * self.n
        for i, t in enumerate(self.trainers):
            if self.active[i]:
                out[i] = t.run_round(rounds[i])
        return out

    def lane_params(self, lane: int) -> torch.Tensor:
        return self.trainers[lane].flat_params

    def lane_state(self, lane: int):
        """One lane's resumable state, ``(flat_params, extra_leaves)`` in
        ``harness.extra_state`` order, ready for ``checkpoint.save``: a
        lane's checkpoint restores through the solo path."""
        from ..fed import harness

        self._check_thread()
        t = self.trainers[lane]
        return t.flat_params, harness.extra_state(t)

    def _quarantine(self, lane: int, round_idx: int, reason: str, on_quarantine, log) -> None:
        """Evict a poisoned lane: stop recording it, freeze its state
        finite in place, and notify the control plane.  The cotenants are
        untouched: each lane is its own trainer."""
        self._check_thread()
        self.active[lane] = False
        self.failed[lane] = reason
        _freeze_finite(self.trainers[lane]._state())
        log(f"[lane {lane}] QUARANTINED at round {round_idx}: {reason}")
        if on_quarantine is not None:
            try:
                on_quarantine(lane, round_idx, reason)
            except Exception:  # a control-plane bug must not kill cotenants
                import traceback

                traceback.print_exc()

    def evaluate(self, lane: int, split: str = "val"):
        """One lane's (loss, accuracy) through its trainer's eval (the
        eval arrays are shared: the lanes share one dataset)."""
        self._check_thread()
        return self.trainers[lane].evaluate(split)

    # -------------------------------------------------------- hot swap

    def set_knob(self, lane: int, name: str, value) -> None:
        """Hot-swap one lane's knob: the lane's next round reads it, with
        no rebuild.  Raises ``KeyError`` for a knob that is not per-lane
        data in this batch's config family."""
        if name not in self.knob_names:
            raise KeyError(
                f"knob {name!r} is not traced data for this batch "
                f"(batchable here: {sorted(self.knob_names)}); structural "
                f"knobs cannot be hot-swapped without a retrace"
            )
        if not 0 <= lane < self.n:
            raise IndexError(f"lane {lane} out of range [0, {self.n})")
        write_knob(self.trainers[lane], name, value)

    def cancel(self, lane: int) -> None:
        """Stop running, recording and evaluating a lane."""
        self.release_lane(lane)

    # -------------------------------------------------- elastic lanes

    def release_lane(self, lane: int) -> None:
        """Free a lane for refill: deactivate it and clear its quarantine
        state, so a tenant reseated there never inherits the prior
        occupant's."""
        self.active[lane] = False
        self.failed.pop(lane, None)

    def install_lane(
        self,
        lane: int,
        cfg: FedConfig,
        own_round: int = 0,
        restored=None,
        paths: Optional[Dict[str, list]] = None,
    ) -> None:
        """Reseat a freed lane with a new tenant: build its trainer over the
        group's shared data (restoring a checkpoint where given, so a
        refilled resume is bitwise the uninterrupted run) and start its
        round cursor at ``own_round``.  It reads the group's dataset, so it
        counts no build."""
        from ..fed import harness

        self._check_thread()
        self._validate([self.cfgs[0], cfg])
        cfg = copy.copy(cfg)
        t = self._make_trainer(cfg)
        if restored is not None:
            harness.restore_trainer(t, restored, log_fn=lambda s: None)
        self.cfgs[lane] = cfg
        self.trainers[lane] = t
        self.active[lane] = True
        self.failed.pop(lane, None)
        self.lane_rounds[lane] = int(own_round)
        self.refills += 1
        self._init_rung(t)
        if self.paths_list is not None:
            # after the trainer is in place: a fresh lane's index-0 eval
            # reads the new params
            self.paths_list[lane] = dict(paths) if paths is not None else self._init_paths(lane)

    # -------------------------------------------------------- driver

    def _init_paths(self, lane: int) -> Dict[str, list]:
        """A fresh lane's paths, with its initial eval (the solo
        ``Trainer.train``'s)."""
        from ..fed.train import FAULT_PATHS, SERVICE_PATHS

        cfg = self.cfgs[lane]
        t = self.trainers[lane]
        tr_loss, tr_acc = self.evaluate(lane, "train") if cfg.eval_train else (0.0, 0.0)
        va_loss, va_acc = self.evaluate(lane, "val")
        paths: Dict[str, list] = {
            "trainLossPath": [tr_loss],
            "trainAccPath": [tr_acc],
            "valLossPath": [va_loss],
            "valAccPath": [va_acc],
            "variencePath": [],  # sic — reference spelling
            "roundsPerSec": [],
        }
        if t.fault is not None:
            for key in FAULT_PATHS:
                paths[key] = []
        if t.defense is not None:
            for key in defense_events.PATH_KEYS.values():
                paths[key] = []
        if t.service_state is not None:
            for key in SERVICE_PATHS:
                paths[key] = []
        return paths

    def train(
        self,
        log_fn: Optional[Callable[[str], None]] = None,
        obs_list: Optional[Sequence[Optional[obs_lib.Observability]]] = None,
        start_round: int = 0,
        before_round: Optional[Callable[[int], None]] = None,
        after_round: Optional[Callable[[int], None]] = None,
        resume_paths: Optional[Sequence[Optional[Dict[str, list]]]] = None,
        on_quarantine: Optional[Callable[[int, int, str], None]] = None,
        start_rounds: Optional[Sequence[int]] = None,
        on_lane_done: Optional[Callable[[int], None]] = None,
    ) -> List[Dict[str, list]]:
        """Drive every lane to its own ``cfg.rounds``; returns per-lane
        paths equal to ``Trainer.train``'s (the same keys and floats: the
        bitwise surface, ``roundsPerSec`` aside).  ``obs_list`` gives one
        Observability per lane; ``before_round(step)`` runs at each group
        step (the control plane's swaps, cancels and refills),
        ``after_round(step)`` after the step's lanes are recorded (its
        checkpoints).  A lane at its horizon retires (``on_lane_done(i)``);
        the loop ends when no lane is active.

        Resume: ``start_rounds[i]`` (or ``start_round``) with
        ``resume_paths[i]`` holding lane i's checkpointed paths continues a
        crashed group, bitwise.  Quarantine: a lane whose variance or
        params go non-finite, whose val loss is non-finite or whose
        recording raises is evicted (``self.failed[lane]``,
        ``on_quarantine(lane, round, reason)``) while the others go on."""
        self._check_thread()
        log = log_fn or (lambda s: None)
        self.obs_list = list(obs_list) if obs_list else [None] * self.n
        self.paths_list = [
            dict(resume_paths[i]) if resume_paths is not None and resume_paths[i] is not None
            else self._init_paths(i)
            for i in range(self.n)
        ]
        self.lane_rounds = [int(r) for r in (
            start_rounds if start_rounds is not None else [start_round] * self.n)]
        for t in self.trainers:
            self._init_rung(t)
        # a lane resumed at its horizon has nothing left to run
        self._retire_done_lanes(on_lane_done)
        step = min(self.lane_rounds)
        while True:
            if before_round is not None:
                before_round(step)
            # a lane refilled at its horizon retires without running
            self._retire_done_lanes(on_lane_done)
            if not any(self.active):
                break
            rounds = list(self.lane_rounds)
            running = [i for i in range(self.n) if self.active[i]]
            compiled = not self._ran
            self.template._sync()
            t0 = time.perf_counter()
            variances = self.run_round(rounds)
            self.template._sync()
            dt = time.perf_counter() - t0
            for i in running:
                self._after_lane_round(i, rounds[i], variances[i], dt, compiled,
                                       on_quarantine, log)
            for i in running:
                self.lane_rounds[i] = rounds[i] + 1
            # retire before after_round, so the control plane's checkpoint
            # pass never writes one past a finished tenant's horizon
            self._retire_done_lanes(on_lane_done)
            if after_round is not None:
                after_round(step)
            step += 1
        return self.paths_list

    def _after_lane_round(self, i, r, variance, dt, compiled, on_quarantine, log) -> None:
        """Lane ``i``'s health checks and record for its round ``r``."""
        t = self.trainers[i]
        var_f = float(variance)
        if var_f != var_f or var_f in (float("inf"), float("-inf")):
            self._quarantine(i, r, "non-finite round variance", on_quarantine, log)
            return
        if not bool(torch.isfinite(t.flat_params).all()):
            self._quarantine(i, r, "non-finite parameters", on_quarantine, log)
            return
        # a lane's slice of the group round, emitted before the round event
        # so the tail renderer can attach the duration to its line
        lane_obs = self.obs_list[i] or obs_lib.NULL
        lane_obs.span_event("round", ms=dt * 1e3, round=r, lane=i, compiled=compiled)
        try:
            self._record_lane(i, r, var_f, dt, compiled, log)
        except Exception as exc:  # one lane's eval must not kill N-1
            self._quarantine(i, r, f"recording error: {type(exc).__name__}: {exc}",
                             on_quarantine, log)
            return
        va = self.paths_list[i]["valLossPath"][-1]
        if va != va or va in (float("inf"), float("-inf")):
            self._quarantine(i, r, "non-finite validation loss", on_quarantine, log)

    @staticmethod
    def _init_rung(t) -> None:
        """The rung the lane's first ``defense`` event transitions from (as
        ``Trainer.train`` reads it)."""
        t._prev_rung = int(t.defense_state[1][0]) if t.defense is not None else None

    def _retire_done_lanes(self, on_lane_done) -> None:
        """Deactivate every lane at or past its own horizon, notifying the
        control plane (a hook exception must not kill cotenants)."""
        for i in range(self.n):
            if self.active[i] and self.lane_rounds[i] >= self.cfgs[i].rounds:
                self.active[i] = False
                if on_lane_done is not None:
                    try:
                        on_lane_done(i)
                    except Exception:
                        import traceback

                        traceback.print_exc()

    def _record_lane(self, i, r, var_f, dt, compiled, log) -> None:
        """Lane ``i``'s round ``r`` into its paths and events, through the
        trainer's own ``_append_round`` (the solo record's code)."""
        cfg = self.cfgs[i]
        t = self.trainers[i]
        obs = self.obs_list[i] or obs_lib.NULL
        tr_loss, tr_acc = self.evaluate(i, "train") if cfg.eval_train else (0.0, 0.0)
        va_loss, va_acc = self.evaluate(i, "val")
        forensic = (None if t.last_forensic_metrics is None
                    else t.last_forensic_metrics.tolist())
        t._append_round(
            self.paths_list[i], (tr_loss, tr_acc, va_loss, va_acc), var_f, 1.0 / dt,
            None if t.fault is None else t.last_fault_metrics.tolist(),
            None if t.service_state is None else t.last_service_metrics.tolist(),
            None if t.defense is None else t.last_defense_metrics,
            obs=obs, round_idx=r, forensic_row=forensic, round_secs=dt, compiled=compiled)
        log(f"[lane {i}][{r + 1}/{cfg.rounds}] val: loss={va_loss:.4f} acc={va_acc:.4f}")
