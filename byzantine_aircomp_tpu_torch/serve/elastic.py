"""Elastic lane scheduling: streamed and population-shard tenants in shared
lanes, and lane refill.

The port of ``byzantine_aircomp_tpu/serve/elastic.py``:

**Streamed tenants batch.**  The streamed round gates its structure on one
batchable knob (``straggler_prob``).  :func:`validate_stream_batch` admits
``cohort_size > 0`` tenants by PINNING the gating knobs: equal across the
batch (``static_signature`` folds them into a streamed config's digest, so
unequal tenants never group), left out of the per-lane knobs and of
hot-swap.

**Population-shard tenants** (``pop_shards > 1``) batch in the same
runner.  JAX moves them to its ``shard_vmap`` backend, which shards the
lane axis over the device mesh.  The server here is one process, where the
solo harness runs such a config on the trainer's sequential population-
shard engine (``ops/shardctx.py``); every lane's trainer is that one, and
its rounds run in turn like every other lane's, so a lane is bitwise its
solo population-shard run.

**Elastic refill.**  :func:`seat_order` reseats recovered tenants into their
journal-hinted lanes (a refilled tenant lands back in the same lane after a
crash), and the run manager's between-round refill path splices a queued
tenant into a drained slot with ``install_lane``: one build per group for
its whole life, refills included.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from .. import obs as obs_lib
from ..fed.config import FedConfig
from . import batch as batch_lib
from .batch import PINNED_STREAM_KNOBS, BatchRunner


def pinned_knobs(cfg: FedConfig) -> tuple:
    """The batchable knobs this config family must pin: the streamed
    round's gating knobs for ``cohort_size > 0`` tenants, none otherwise."""
    return PINNED_STREAM_KNOBS if cfg.cohort_size > 0 else ()


def validate_stream_batch(cfgs: Sequence[FedConfig]) -> List[str]:
    """The widened contract: :func:`.batch.validate_batch` without the
    streamed-cohort carve-out, plus pinned-knob equality.  Returns the
    applicable knob names less the pinned ones."""
    knobs = batch_lib._validate_structure(cfgs)
    t = cfgs[0]
    for knob in pinned_knobs(t):
        vals = sorted({float(getattr(c, knob)) for c in cfgs})
        if len(vals) > 1:
            raise ValueError(
                f"stream batch contract: knob {knob!r} gates the cohort "
                f"scan's traced structure and must be PINNED (equal) "
                f"across a streamed batch, got {vals}"
            )
    return [k for k in knobs if k not in pinned_knobs(t)]


class ElasticBatchRunner(BatchRunner):
    """A runner that admits streamed and population-shard tenants."""

    def _validate(self, cfgs: Sequence[FedConfig]) -> List[str]:
        return validate_stream_batch(cfgs)


def runner_for(
    cfgs: Sequence[FedConfig],
    dataset=None,
    retrace: Optional[obs_lib.RetraceDetector] = None,
    backend: str = "vmap",
    restore_fn=None,
    device: Optional[str] = None,
) -> BatchRunner:
    """The runner for a signature group: streamed and population-shard
    tenants get the elastic runner, resident ones the base runner."""
    cls = ElasticBatchRunner if cfgs[0].cohort_size > 0 or cfgs[0].pop_shards > 1 else BatchRunner
    return cls(cfgs, dataset=dataset, retrace=retrace, backend=backend,
               restore_fn=restore_fn, device=device)


def seat_order(runs: Sequence) -> List:
    """A group's runs by lane: a run whose journal-replayed ``lane_hint``
    points at an unclaimed in-range slot is seated there, the rest fill the
    remaining slots in submission order."""
    n = len(runs)
    seats: List[Optional[object]] = [None] * n
    rest = []
    for run in runs:
        hint = getattr(run, "lane_hint", None)
        if hint is not None and 0 <= hint < n and seats[hint] is None:
            seats[hint] = run
        else:
            rest.append(run)
    it = iter(rest)
    return [seat if seat is not None else next(it) for seat in seats]
