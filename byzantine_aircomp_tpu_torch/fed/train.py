"""The federated training engine of the main path.

Port of the rounds of ``byzantine_aircomp_tpu/fed/train.py``: the resident
``_iteration`` (:605), with or without service rounds, and the
cohort-streamed ``_iteration_streamed`` (:1103), whose chunk passes run through a
population-shard context (:mod:`..ops.shardctx`; the process-group engine
is ``parallel.popmesh``), and the multi-round dispatch driver
``_train_multi`` (:2337), whose rounds on the card replay one CUDA graph of
a round (:mod:`.graphs`).  The client step's rows, the straggler replay and
the stack's assembly, the message attack, the OMA link's terms, the
rule's call and the honest variance are hooks (:meth:`Trainer._client_stage`,
:meth:`Trainer._dropout_stage`, :meth:`Trainer._whole_stack`,
:meth:`Trainer._attack_stage`, :meth:`Trainer._held_terms`,
:meth:`Trainer._aggregate`, :meth:`Trainer._variance`) that the sharded
layout (``parallel.sharded``) runs on a rank's block of the stack.  One resident
global iteration is

    flat_params [d] [--participants: m of K drawn-->]
      --per-client local SGD steps (FedAvg, FedProx, client momentum)-->
      weight stack [m, d] [--fault: dropout replay-->] --message attack-->
      [--fault: corruption, CSI error, deep-fade erasure-->]
      --OMA channel (not for gm, signmv)--> [--defense: score, detector,
      policy-->] [--bucket means-->] --aggregate (or the defense's rung)-->
      [--server optimizer-->] [d]

With a fault set the rule runs in its degraded mode, and a finite guard
keeps the previous params wherever the aggregate is not finite.

Service rounds (``--service on``, JAX ``fed/train.py:297-318``, :559-603,
:690-705, :822-909): a population of stable client ids with Markov churn;
every iteration draws ``honest_size`` honest and ``byz_size`` Byzantine ids
from the available ones (each reads its own data shard), the channel links
are keyed by id (:func:`..ops.channel.oma_by_id`), a deadline erases the
absent and late rows to NaN, the rules run degraded (trimmed_mean with the
rollback-widened trim fraction), and the defense's detector is keyed by
population id.  ``train`` adds warm rollback: a diverged round restores the
last good round's state and goes on under salted draws.

Cohort-streamed rounds (``--cohort-size > 0``) never hold the [K, d] stack:
``rebuild(c)`` remakes chunk c (local steps, message attack, fault
transmission, channel, deadline), one observation pass collects the sums,
moments, fault counts and detector updates, and the rule's streamed
realization (:func:`..ops.aggregators.stream_aggregate`) rebuilds the chunks
once per pass it needs.

with per-client gradients taken with respect to the flat parameter vector
through ``torch.func`` (``functional_call`` + ``vmap(grad)``), so the
[K, d] stack is produced with no per-parameter Python plumbing.  The u8
train set stays on the device and is normalized after the gather.

Random draws: every iteration of every round has four streams, as the JAX
package splits its iteration key into (batch, channel, aggregation,
message), a fifth for the fault channel when a fault is set, and one each
for the participants' draw and the buckets' permutation when those are on;
here each is a ``torch.Generator`` seeded from ``(seed, round, iteration,
stream)``, with a fixed stream number per feature, so a run without a
feature draws what it drew before the feature was ported.  Service rounds
add stream 7, split into the churn, the draw and the deadline generators
and the per-id link's key; a streamed round seeds each chunk's channel,
message and fault generators from ``(seed, round, iteration,
channel.cohort_stream(stream), chunk)``.  After a warm rollback the epoch
extends every seed; at epoch 0 nothing is added, so a run that never rolls
back draws exactly what it drew before rollback was ported.
``iteration`` also takes the draws as inputs (``draws``), so the tests can
feed it the JAX package's numbers.  ``run_round`` keeps one generator per
(iteration slot, stream) and seeds it afresh for every round, so no
generator carries state from one round to the next: a run resumed at round
R draws exactly what the uninterrupted run drew from round R on, and a
CUDA graph of the round replays with those generators re-seeded.

A delayed attack (``name@R``) counts global iterations in ``attack_iter``,
a device int32 scalar, and one device bool, ``attack_iter >= R *
display_interval``, gates every Byzantine behavior (the data swap, the
gradient scale and the message attack), as the JAX trainer's carried
counter does (``fed/train.py:100-108``, ``:639-645``, ``:800-803``): the
counter is never read on the host inside a round.
"""

from __future__ import annotations

import functools
import math
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call, grad, vmap

from .. import defense as defense_lib
from .. import obs as obs_lib
from ..data import datasets as data_lib
from ..device import resolve_device
from ..ops import aggregators as agg_lib
from ..ops import attacks as attack_lib
from ..ops import channel as channel_lib
from ..ops import faults as fault_lib
from ..ops import flatten as flatten_lib
from ..ops import kernels
from ..ops import shardctx as shardctx_lib
from ..obs import forensics as forensics_lib
from ..obs.span import span
from ..registry import MODELS
from . import graphs as graphs_lib
from . import server_opt as server_opt_lib
from .config import FedConfig


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample softmax cross entropy with integer labels."""
    return F.cross_entropy(logits, labels, reduction="none")


def honest_variance(w_stack: torch.Tensor, honest_size: int) -> torch.Tensor:
    """Mean over honest clients of ||w_i - mean_honest||^2
    (reference ``getVarience``, ``:127-129``)."""
    w_h = w_stack[:honest_size]
    centered = w_h - torch.mean(w_h, dim=0, keepdim=True)
    return torch.mean(torch.sum(centered**2, dim=1))


class IterationGenerators(NamedTuple):
    """One iteration's random streams, in the JAX package's split order;
    ``fault`` (stream 4), ``participation`` (5) and ``bucket`` (6) exist only
    when their feature is on, so a run without them draws what it drew
    before they were ported.  Under service rounds stream 7 gives the
    ``churn``, ``draw`` and ``deadline`` generators and the per-id link's
    ``link_key`` (an int); a cohort-streamed round's ``cohort(stream, c)``
    seeds chunk c's generator of an iteration stream afresh on each call."""

    batch: torch.Generator
    channel: torch.Generator
    aggregation: torch.Generator
    message: torch.Generator
    fault: Optional[torch.Generator] = None
    participation: Optional[torch.Generator] = None
    bucket: Optional[torch.Generator] = None
    churn: Optional[torch.Generator] = None
    draw: Optional[torch.Generator] = None
    deadline: Optional[torch.Generator] = None
    link_key: Optional[int] = None
    cohort: Optional[Callable[[int, int], torch.Generator]] = None


#: the stream number of each optional generator
_OPTIONAL_STREAMS = (("fault", 4), ("participation", 5), ("bucket", 6))
#: service rounds' stream, and its sub-streams
_SERVICE_STREAM = 7
_SERVICE_SUBSTREAMS = ("churn", "draw", "deadline", "link_key")
#: the iteration streams a streamed round draws per chunk
CHANNEL_STREAM, MESSAGE_STREAM, FAULT_STREAM = 1, 3, 4

# the span around the clients' local steps (all E of them)
CLIENT_STEP_RANGE = "client_step"


# the record's paths of the fault counts (dropped, erased and corrupt rows,
# then the effective K: the finite rows aggregated), in the order of the
# JAX package's fault_metrics; the first three are summed over a round, the
# effective K is the round's minimum
FAULT_PATHS = ("faultDroppedPath", "faultErasedPath", "faultCorruptPath", "effectiveKPath")

# the record's paths of the service metrics (available ids, absent and late
# rows, the effective K), the JAX package's serviceAvailPath etc.: the
# availability is the round's last, the events are summed, the effective K
# is the round's minimum
SERVICE_PATHS = ("serviceAvailPath", "serviceAbsentPath", "serviceLatePath", "effectiveKPath")

# the warm rollback's guard: the val losses of the last rounds it keeps
ROLLBACK_WINDOW = 8


def masked_honest_variance(w_h: torch.Tensor) -> torch.Tensor:
    """The honest dispersion over the finite honest rows (JAX
    ``_masked_honest_variance``, :593): ``sum ||w||^2 / n - ||mean||^2``,
    the service round's variant of :func:`honest_variance` (a missed row is
    NaN and would otherwise NaN the metric and trip the rollback guard)."""
    fin = agg_lib._finite_rows(w_h)
    n = torch.clamp(torch.sum(fin).to(torch.float32), min=1.0)
    w0 = torch.where(fin[:, None], w_h.to(torch.float32), 0.0)
    mean = torch.sum(w0, dim=0) / n
    return torch.sum(w0 * w0) / n - torch.sum(mean * mean)


def detector_update_by_id(det, score, finite, ids, params):
    """The population-keyed detector of service rounds (JAX
    ``fed/train.py:879-909``): gather the drawn ids' rows, update them with
    their own first-observation marker ``dev == 0`` (the first observation
    of an id can come at any step), scatter them back; ids not drawn keep
    their baselines.  Returns ``((ema, dev, cusum), flags)``; the caller
    advances the step."""
    step, ema, dev, cus = det
    ema_g, dev_g, cus_g = ema[ids], dev[ids], cus[ids]
    (_, ema_r, dev_r, cus_r), flags = defense_lib.detector_update(
        (step, ema_g, dev_g, cus_g), score, finite, params, first=dev_g == 0.0,
    )
    return (ema.index_put((ids,), ema_r), dev.index_put((ids,), dev_r),
            cus.index_put((ids,), cus_r)), flags


class DispatchOutputs(NamedTuple):
    """A dispatch's per-round outputs, stacked on the device with a leading
    dim of the rounds run: the honest variance [n] and the round rows of
    :data:`FAULT_PATHS` [n, 4], of the defense [n, 6], of
    :data:`SERVICE_PATHS` [n, 4] and the forensic top-M [n, M, NUM_COLS]
    (:mod:`..obs.forensics`), each None when its feature is off."""

    variances: torch.Tensor
    fault: Optional[torch.Tensor]
    defense: Optional[torch.Tensor]
    service: Optional[torch.Tensor]
    forensic: Optional[torch.Tensor] = None


class _HostRows:
    """Host copies of a dispatch's outputs, started with no wait: on the
    card into pinned buffers behind one event, so that ``get()`` waits for
    this dispatch's work alone, not for a dispatch queued after it."""

    def __init__(self, outs: DispatchOutputs):
        self._event = None
        self._host = []
        for t in outs:
            if t is not None and t.device.type == "cuda":
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                t = h
                if self._event is None:
                    self._event = torch.cuda.Event()
            self._host.append(t)
        if self._event is not None:
            self._event.record()

    def get(self) -> List[Optional[list]]:
        if self._event is not None:
            self._event.synchronize()
        return [None if h is None else h.tolist() for h in self._host]


def _clone_state(x):
    """A deep copy of a state tree of tensors, tuples and Nones."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        cloned = [_clone_state(v) for v in x]
        return type(x)(*cloned) if hasattr(x, "_fields") else tuple(cloned)
    return x


def bucket_means(w_stack: torch.Tensor, perm: torch.Tensor, s: int) -> torch.Tensor:
    """[m/s, d] bucket means: bucket i holds the rows ``perm[i*s:(i+1)*s]``
    (JAX ``fed/train.py:950-972``, where row ``perm[j]`` goes to bucket
    ``j // s``).  The s gathered [m/s, d] slices are added in a fixed order,
    with no float atomics, so reruns give the same bits; a non-finite row
    poisons its own bucket only."""
    cols = perm.reshape(-1, s)
    total = torch.index_select(w_stack, 0, cols[:, 0])
    for j in range(1, s):
        total = total + torch.index_select(w_stack, 0, cols[:, j])
    return total / s


#: the trainer's device tensors that hold the dataset, lent by ``data_from``
DATA_TENSORS = ("x_train", "y_train", "offsets", "sizes", "_norm_scale", "_norm_bias")


def _under_impl(method):
    """Run a trainer method with every kernel wrapper taking the trainer's
    resolved ``agg_impl`` (:func:`..ops.kernels.implementation`)."""

    @functools.wraps(method)
    def wrapped(self, *args, **kw):
        with kernels.implementation(self._agg_impl):
            return method(self, *args, **kw)

    return wrapped


class Trainer:
    """Drives the main path on one device (``"cuda"`` unless the caller
    passes ``device="cpu"``).  ``params`` (flat [d], JAX layout) replaces
    the seeded initialization, e.g. with weights carried over from the JAX
    package (:mod:`..interop`).  Under ``rounds_per_dispatch > 1`` a
    configuration that :func:`.graphs.dispatch_graph` admits replays one
    CUDA graph per round; ``graphs=False`` runs its dispatches eagerly
    instead, the referee the graphed rounds are held against.
    ``data_from`` (a trainer on the same device and data layout) lends its
    device-resident train rows, labels, partition and eval arrays, so the
    lanes of one batch group hold one dataset on the device
    (``serve/batch.py``); ``staged_data`` says whether this trainer
    uploaded its own."""

    def __init__(
        self,
        cfg: FedConfig,
        dataset: Optional[data_lib.Dataset] = None,
        device: str = "cuda",
        params: Optional[torch.Tensor] = None,
        graphs: bool = True,
        data_from: Optional["Trainer"] = None,
    ):
        self.cfg = cfg.validate()
        self.device = resolve_device(device)
        # (graphed, reason), printed in the run's banner under R > 1; the
        # graph of a round is captured at the first dispatch
        self.dispatch_graph = (
            graphs_lib.dispatch_graph(cfg, self.device) if graphs
            else (False, "graphs=False: the eager dispatch, the graphed round's referee"))
        self.round_graph: Optional[graphs_lib.RoundGraph] = None
        # run_round's generators, one per (iteration slot, stream, *sub),
        # seeded afresh for every round
        self._slot_generators: Dict[tuple, torch.Generator] = {}
        self.dataset = dataset or data_lib.load(cfg.dataset)
        self.attack = attack_lib.resolve(cfg.attack)
        self.agg_fn = agg_lib.resolve(cfg.agg)
        self.fault = fault_lib.resolve(cfg.fault, cfg.fault_overrides())
        # the online defense (None when off: no defense code runs)
        self.defense = defense_lib.from_config(cfg)
        # the kernels' implementation (JAX fed/train.py:215-217): "auto" is
        # the CUDA kernels on the card and their plain versions on the CPU,
        # which has no kernel to run under "pallas"
        self._agg_impl = cfg.agg_impl
        if self._agg_impl == "auto":
            self._agg_impl = "pallas" if self.device.type == "cuda" else "xla"
        if self._agg_impl == "pallas" and self.device.type != "cuda":
            raise ValueError(
                "agg_impl 'pallas' runs the hand-written CUDA kernels, and the CPU has "
                "none: use agg_impl 'xla' or 'auto' on the CPU")
        # the dtype of the stack the rule reads (JAX fed/train.py:980)
        self._stack_dtype = torch.bfloat16 if cfg.stack_dtype == "bf16" else torch.float32
        # the fused epilogue (JAX fed/train.py:229-239, :834-837): "auto"
        # folds only where the kernels run, "on" under the plain versions too
        self._fused_epilogue = cfg.fused_epilogue == "on" or (
            cfg.fused_epilogue == "auto" and self._agg_impl == "pallas")
        # whether the channel folds into the rule's read (select_columns'
        # epilogue) instead of being applied to the stack first: only where
        # nothing else reads the received stack before the rule, and on an
        # f32 stack (a bf16 one carries the received values, rounded)
        self.channel_fused = (
            self._fused_epilogue
            and cfg.noise_var is not None and agg_lib.needs_oma_prepass(cfg.agg)
            and agg_lib.supports_fused_epilogue(cfg.agg) and self.fault is None
            and cfg.bucket_size == 1 and cfg.service == "off" and cfg.cohort_size == 0
            and self._stack_dtype == torch.float32
            and not (self.defense is not None and self.defense.mode == "adaptive"))
        self.num_classes = self.dataset.num_classes

        # init params (reference modelFactory + setup_seed(2021), :98-104)
        # (the factories take the knobs they use: fc_width the CNN's,
        # width and remat ResNet-18's, as in JAX fed/train.py:111-118)
        init_gen = torch.Generator().manual_seed(cfg.seed)
        self.model = MODELS.get(cfg.model)(
            input_shape=self.dataset.input_shape,
            num_classes=self.num_classes,
            generator=init_gen,
            fc_width=cfg.fc_width,
            width=cfg.resnet_width,
            remat=cfg.remat,
        ).to(self.device)
        self.spec = flatten_lib.make_flat_spec(self.model)
        self.dim = self.spec.total
        if params is None:
            params = flatten_lib.flatten(dict(self.model.named_parameters()), self.spec)
        self.flat_params = params.detach().to(self.device, torch.float32).clone()

        # device-resident u8 train rows [N, features]; ((u8/255) - mean)/std
        # folded into one multiply-add after the gather, with the same f32
        # constants as the JAX package.  Spatial models (CNN, ResNet-18)
        # get each batch back in the image shape after the gather, as the
        # JAX trainer does (fed/train.py:730); the MLP takes the rows.
        ds = self.dataset
        self._sample_shape = (
            tuple(ds.input_shape) if getattr(type(self.model), "SPATIAL_INPUT", True)
            else (-1,)
        )
        #: whether this trainer uploaded the dataset itself (its set-up's
        #: costly part), rather than reading ``data_from``'s copy
        self.staged_data = data_from is None
        if data_from is None:
            self._stage_data(cfg, ds)
        else:
            for name in DATA_TENSORS:
                setattr(self, name, getattr(data_from, name))

        # static per-client Byzantine mask: LAST byz_size clients (:291)
        mask = np.zeros(cfg.node_size, bool)
        if cfg.byz_size:
            mask[-cfg.byz_size:] = True
        self.byz_mask = torch.from_numpy(mask).to(self.device)

        # partial participation: m_h honest and m_b Byzantine clients drawn
        # every iteration (the Byzantine rows last); only the counts are
        # static, so the [m, d] stack keeps one shape
        self._part_h, self._part_b = cfg.participant_counts()
        if cfg.participation < 1.0:
            pmask = np.zeros(self._part_h + self._part_b, bool)
            if self._part_b:
                pmask[-self._part_b:] = True
            self._part_mask = torch.from_numpy(pmask).to(self.device)
        else:
            self._part_mask = self.byz_mask

        # delayed onset ("name@R"): the threshold in global iterations, and
        # the device counter of iterations run (None without an onset)
        self._attack_onset = None
        self.attack_iter: Optional[torch.Tensor] = None
        if self.attack is not None and self.attack.onset_round is not None:
            self._attack_onset = self.attack.onset_round * cfg.display_interval
            self.attack_iter = torch.zeros((), dtype=torch.int32, device=self.device)

        self._per_client_grad = vmap(grad(self._loss), in_dims=(None, 0, 0))
        # local steps past the first: every client carries its own params
        self._per_client_grad_own = vmap(grad(self._loss), in_dims=(0, 0, 0))
        self._eval_cache: Dict[str, tuple] = {} if data_from is None else data_from._eval_cache

        # the fault channel's carried state (stale buffer, Gilbert-Elliott
        # states), and the [4] counts of FAULT_PATHS: of the last iteration,
        # and reduced over the last round (device tensors)
        self.fault_state = (
            fault_lib.init_state(self.fault, cfg.node_size, self.flat_params)
            if self.fault is not None else None
        )
        self.iteration_fault_metrics: Optional[torch.Tensor] = None
        self.last_fault_metrics: Optional[torch.Tensor] = None

        # the server optimizer's state (fed/server_opt.py; None for "none"),
        # the [K, d] client momentum (None when off), and the defense's
        # (detector, policy) state (None when off), all carried across
        # rounds and checkpointed; the defense's [5] observations of the
        # last iteration and [6] round vector of the last round
        self.server_opt_state = server_opt_lib.init(cfg.server_opt, self.flat_params)
        self.client_m = (
            torch.zeros((cfg.node_size, self.dim), dtype=torch.float32, device=self.device)
            if cfg.client_momentum else None
        )
        # under service rounds the detector's rows are keyed by population id
        # (scores survive non-participation), so it holds `population` rows
        self.defense_state = defense_lib.init_state(
            self.defense, cfg.population if cfg.service == "on" else cfg.node_size,
            self.device)
        self.iteration_defense_metrics: Optional[torch.Tensor] = None
        self.last_defense_metrics: Optional[torch.Tensor] = None
        # client-level forensics (obs/forensics.py), output only: the
        # [forensics_top, NUM_COLS] top-M of the last iteration and of the
        # last round (device tensors, None when off), and under "full" the
        # host-side flight recorder
        self._forensics_on = cfg.forensics != "off"
        self.iteration_forensic: Optional[torch.Tensor] = None
        self.last_forensic_metrics: Optional[torch.Tensor] = None
        self.flight_recorder = (
            forensics_lib.FlightRecorder(cfg.flight_window,
                                         cfg.obs_dir or cfg.checkpoint_dir or ".")
            if cfg.forensics == "full" else None)
        # the profiler of the run that drove this trainer (set by the
        # harness; its last_profile is the trace's torch.profiler object)
        self.profiler = obs_lib.NULL_PROFILER

        # service rounds (JAX fed/train.py:297-318): the stable id -> data
        # shard map (the population oversubscribes the node_size shards
        # round-robin within each stratum, so honest ids never read
        # Byzantine shards) and the carried (availability [population] bool,
        # trim widening f32) state; the [4] metrics of SERVICE_PATHS of the
        # last iteration and the last round.  None when off
        self.service_state = None
        self.iteration_service_metrics: Optional[torch.Tensor] = None
        self.last_service_metrics: Optional[torch.Tensor] = None
        if cfg.service == "on":
            self._pop_h, self._pop_b = cfg.population_counts()
            pop_shard = np.empty(cfg.population, np.int64)
            pop_shard[: self._pop_h] = np.arange(self._pop_h) % cfg.honest_size
            if cfg.byz_size:
                pop_shard[self._pop_h:] = cfg.honest_size + np.arange(self._pop_b) % cfg.byz_size
            self._pop_shard = torch.from_numpy(pop_shard).to(self.device)
            self.service_state = (
                torch.ones(cfg.population, dtype=torch.bool, device=self.device),
                torch.ones((), dtype=torch.float32, device=self.device),
            )
        # warm rollback (train()): the epoch extends every later round's
        # seeds once a restore happened (0: never, the unsalted streams)
        self._rollback_epoch = 0
        self._rollbacks_done = 0
        # the streamed round's population-shard context (ops/shardctx.py):
        # LOCAL at pop_shards 1, the sequential engine above, the process
        # group's engine in parallel/popmesh.py
        self._pop_ctx = self._make_pop_ctx()

    def _stage_data(self, cfg: FedConfig, ds) -> None:
        """Upload the dataset to the device, in the client partition's order."""
        # the client partition (JAX fed/train.py:138-178): the reference's
        # contiguous equal slices, or the label-Dirichlet split, whose
        # shards are made contiguous by permuting the train rows and labels
        # once on the host; then the Zipf re-cut of that index stream
        y_host = np.asarray(ds.y_train)
        perm = None
        if cfg.partition == "dirichlet":
            perm, sharding = data_lib.dirichlet_shards(
                y_host, cfg.node_size, cfg.dirichlet_alpha, seed=cfg.seed
            )
            y_host = y_host[perm]
        else:
            sharding = data_lib.contiguous_shards(len(y_host), cfg.node_size)
        skew = data_lib.parse_size_skew(cfg.size_skew)
        if skew is not None:
            sharding = data_lib.zipf_shards(len(y_host), cfg.node_size, skew)
        if ds.x_train_raw is not None:
            raw = ds.x_train_raw if perm is None else ds.x_train_raw[perm]
            raw = raw.reshape(len(raw), -1)
            self.x_train = torch.from_numpy(np.ascontiguousarray(raw)).to(self.device)
            mean, std = ds.stats
            m = np.broadcast_to(np.asarray(mean, np.float32), ds.input_shape).reshape(-1)
            s = np.broadcast_to(np.asarray(std, np.float32), ds.input_shape).reshape(-1)
            self._norm_scale = torch.from_numpy(1.0 / (255.0 * s)).to(self.device)
            self._norm_bias = torch.from_numpy(-m / s).to(self.device)
        else:
            x = np.asarray(ds.x_train, np.float32)
            if perm is not None:
                x = x[perm]
            x = x.reshape(len(x), -1)
            self.x_train = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
            self._norm_scale = self._norm_bias = None
        self.y_train = torch.from_numpy(y_host.astype(np.int64)).to(self.device)
        self.offsets = torch.from_numpy(sharding.offsets).to(self.device)
        self.sizes = torch.from_numpy(sharding.sizes).to(self.device)

    def _make_pop_ctx(self):
        """LOCAL (pop_shards 1) or the sequential reference engine (JAX
        ``fed/train.py:437-446``)."""
        return shardctx_lib.make_ctx(self.cfg.pop_shards)

    # ------------------------------------------------------------------
    # one iteration

    def _loss(self, flat_params, x, y):
        params = flatten_lib.unflatten(flat_params, self.spec)
        logits = functional_call(self.model, params, (x,))
        return torch.mean(cross_entropy(logits, y))

    def _attacked_batch(self, x, y, is_byz):
        """The data-level attack on the Byzantine clients' batches."""
        attack = self.attack
        if attack is None or attack.data_fn is None:
            return x, y
        x_att, y_att = attack.apply_data(x, y, self.num_classes)
        x = torch.where(is_byz.reshape((-1,) + (1,) * (x.dim() - 1)), x_att, x)
        y = torch.where(is_byz.reshape((-1,) + (1,) * (y.dim() - 1)), y_att, y)
        return x, y

    def _grad_scale(self, g, is_byz):
        """The gradient-scale attack on the Byzantine clients' gradients."""
        attack = self.attack
        if attack is None or attack.grad_scale == 1.0:
            return g
        one = torch.ones((), dtype=g.dtype, device=g.device)
        return g * torch.where(is_byz, attack.grad_scale * one, one)[:, None]

    def client_stack(self, flat_params, x, y, is_byz) -> torch.Tensor:
        """[m, d] weights after each client's ``local_steps`` local SGD
        steps ``w <- w - gamma*(g + wd*w)`` (``:302-303``; JAX
        ``_per_client_weights``, ``fed/train.py:467-486``), each on its own
        batch: ``x`` is [m, B, ...] at one local step and [m, E, B, ...]
        above.  The data-level attack applies to the Byzantine clients'
        batches, a gradient-scale attack to their gradient at every step,
        then FedProx's ``mu*(w - w_round_start)``, then weight decay.  One
        local step without FedProx is the reference's FedSGD."""
        cfg = self.cfg
        x, y = self._attacked_batch(x, y, is_byz)
        if cfg.local_steps == 1:
            x, y = x[:, None], y[:, None]
        # the first step starts every client from the round's params [d];
        # from the second on each client carries its own row of [m, d]
        w = flat_params
        for e in range(cfg.local_steps):
            grad_fn = self._per_client_grad if e == 0 else self._per_client_grad_own
            g = self._grad_scale(grad_fn(w, x[:, e], y[:, e]), is_byz)
            if cfg.fedprox_mu:
                g = g + cfg.fedprox_mu * (w - flat_params)
            w = w - cfg.gamma * (g + cfg.weight_decay * w)
        return w

    def client_stack_momentum(self, flat_params, x, y, is_byz, m_prev):
        """Client momentum (JAX ``_per_client_momentum_step``,
        ``fed/train.py:488-502``; local_steps == 1): ``m <- beta*m +
        (1-beta)*(g*scale + wd*w)``, each client sends ``w - gamma*m``.
        Returns ``(weights [m, d], new momentum rows [m, d])``."""
        cfg = self.cfg
        x, y = self._attacked_batch(x, y, is_byz)
        g = self._grad_scale(self._per_client_grad(flat_params, x, y), is_byz)
        g = g + cfg.weight_decay * flat_params
        beta = cfg.client_momentum
        m_new = beta * m_prev + (1.0 - beta) * g
        return flat_params - cfg.gamma * m_new, m_new

    def draw_participants(self, generator) -> torch.Tensor:
        """[m] drawn client indices: ``m_h`` of the honest clients, then
        ``m_b`` of the Byzantine ones (JAX ``fed/train.py:658-672``)."""
        cfg = self.cfg
        part = torch.randperm(cfg.honest_size, generator=generator,
                              device=self.device)[: self._part_h]
        if self._part_b:
            byz = torch.randperm(cfg.byz_size, generator=generator,
                                 device=self.device)[: self._part_b]
            part = torch.cat([part, cfg.honest_size + byz])
        return part

    def _seed(self, round_idx: int, it: int, stream: int, *sub: int) -> int:
        """The 63-bit seed of ``(seed, round, iteration, stream, *sub)``,
        with the rollback epoch appended when it is above 0 (so epoch 0
        keeps the seeds of runs that predate rollback, bit for bit)."""
        entropy = [self.cfg.seed, round_idx, it, stream, *sub]
        if self._rollback_epoch:
            entropy.append(self._rollback_epoch)
        hi, lo = np.random.SeedSequence(entropy).generate_state(2)
        return ((int(hi) << 32) | int(lo)) & (2**63 - 1)

    def _generator(self, round_idx: int, it: int, stream: int, *sub: int,
                   persistent: bool = False) -> torch.Generator:
        """The generator of ``(seed, round, iteration, stream, *sub)``: a
        new one, or with ``persistent`` the one kept for the iteration slot
        ``it`` and the stream, seeded afresh (the same draws either way)."""
        if not persistent:
            g = torch.Generator(device=self.device)
        else:
            g = self._slot_generators.get((it, stream) + sub)
            if g is None:
                g = self._slot_generators[(it, stream) + sub] = torch.Generator(
                    device=self.device)
        g.manual_seed(self._seed(round_idx, it, stream, *sub))
        return g

    def reseed_slot_generators(self, round_idx: int):
        """Seed every kept generator for ``round_idx``, as ``run_round``
        would: what a CUDA-graph replay of a round draws from."""
        for (it, stream, *sub), g in self._slot_generators.items():
            g.manual_seed(self._seed(round_idx, it, stream, *sub))

    def iteration_generators(self, round_idx: int, it: int,
                             persistent: bool = False) -> IterationGenerators:
        """Iteration ``it`` of round ``round_idx``'s generators: new ones,
        or with ``persistent`` the ones kept for the slot (``run_round``;
        a chunk's cohort generators are new on every call either way)."""
        cfg = self.cfg
        on = {"fault": self.fault is not None, "participation": cfg.participation < 1.0,
              "bucket": cfg.bucket_size > 1}
        extra = {name: self._generator(round_idx, it, s, persistent=persistent)
                 for name, s in _OPTIONAL_STREAMS if on[name]}
        if cfg.service == "on":
            for sub, name in enumerate(_SERVICE_SUBSTREAMS):
                extra[name] = (self._seed(round_idx, it, _SERVICE_STREAM, sub)
                               if name == "link_key"
                               else self._generator(round_idx, it, _SERVICE_STREAM, sub,
                                                    persistent=persistent))
        if cfg.cohort_size > 0:
            extra["cohort"] = lambda stream, c: self._generator(
                round_idx, it, channel_lib.cohort_stream(stream), c)
        return IterationGenerators(
            *(self._generator(round_idx, it, s, persistent=persistent) for s in range(4)),
            **extra,
        )

    # ------------------------------------------------------------------
    # service rounds

    def service_draw(self, avail: torch.Tensor, generator=None, u=None):
        """The stratified draw over stable population ids (JAX
        ``_service_draw``, :559): ``honest_size`` ids of [0, pop_h) and
        ``byz_size`` of [pop_h, population), each stratum ranked by the
        priority ``U(0,1) + 2*offline`` under a stable sort, so every
        available id outranks every offline one.  A stratum with too few
        available ids is topped up with offline ones, whose rows then miss
        the deadline.  ``u`` = (honest [pop_h], Byzantine [pop_b]) f32
        uniforms may be passed in, else drawn from ``generator``.

        Returns ``(pop_ids [K] int64, arrived [K] bool)``, honest rows
        first."""
        cfg, dev = self.cfg, avail.device
        pop_h = self._pop_h
        if u is None:
            u = (torch.rand(pop_h, generator=generator, device=dev),
                 torch.rand(self._pop_b, generator=generator, device=dev))
        prio_h = u[0] + torch.where(avail[:pop_h], 0.0, 2.0)
        ids = torch.argsort(prio_h, stable=True)[: cfg.honest_size]
        if cfg.byz_size:
            prio_b = u[1] + torch.where(avail[pop_h:], 0.0, 2.0)
            ids = torch.cat([ids, pop_h + torch.argsort(prio_b, stable=True)[: cfg.byz_size]])
        return ids, avail[ids]

    def churn(self, avail: torch.Tensor, generator=None, masks=None) -> torch.Tensor:
        """One step of the Markov churn (JAX ``fed/train.py:695-705``): an
        online id leaves with ``churn_departure``, an offline one comes back
        with ``churn_arrival``.  ``masks`` = (arrive, depart) [population]
        bool may be passed in, else drawn (uniforms < p) from
        ``generator``, arrivals first."""
        cfg = self.cfg
        if masks is None:
            n, dev = avail.shape[0], avail.device
            masks = (torch.rand(n, generator=generator, device=dev) < cfg.churn_arrival,
                     torch.rand(n, generator=generator, device=dev) < cfg.churn_departure)
        arrive, depart = masks
        return torch.where(avail, ~depart, arrive)

    def _service_stage(self, gens, draws):
        """The iteration's draw and churn: ``(pop_ids, arrived, n_avail)``,
        with ``service_state`` advanced.  The draw sees the availability
        from before the churn, so the reported count is what the server
        drew from."""
        avail, widen = self.service_state
        n_avail = torch.sum(avail).to(torch.float32)
        pop_ids, arrived = self.service_draw(avail, gens.draw, u=draws.get("service_u"))
        self.service_state = (self.churn(avail, gens.churn, draws.get("churn")), widen)
        return pop_ids, arrived, n_avail

    def _trim_ratio(self) -> torch.Tensor:
        """The service round's trim fraction ``min(0.1 * widen, 0.45)``, a
        device f32 scalar (no host read)."""
        widen = self.service_state[1]
        return torch.clamp(torch.tensor(0.1, dtype=torch.float32) * widen, max=0.45)

    def _defense_view(self, flat_params, rows=None):
        """The detector state published after the previous iteration, as a
        defense-aware attack reads it: the rows ``rows`` (population ids
        under service, a chunk's slice) or all of them."""
        spec = self.defense
        (step, ema, dev, cusum), pol = self.defense_state
        if rows is not None:
            ema, dev, cusum = ema[rows], dev[rows], cusum[rows]
        return attack_lib.DefenseView(
            step=step, ema=ema, dev=dev, cusum=cusum, rung=pol[0],
            detector=spec.detector, policy=spec.policy, guess=flat_params,
        )

    # ------------------------------------------------------------------
    # one resident iteration (its helpers serve the streamed one too)

    def _batches(self, idx):
        """The normalized inputs [m, E, B, ...] (or [m, B, ...] at one local
        step) and labels of the train rows ``idx`` [m, E*B]."""
        cfg = self.cfg
        x = self.x_train[idx]  # [m, E*B, features] on-device gather
        if self._norm_scale is not None:
            x = x.to(torch.float32) * self._norm_scale + self._norm_bias
        y = self.y_train[idx]
        steps = cfg.local_steps
        if steps > 1:
            batch = (idx.shape[0], steps, cfg.batch_size)
            return x.reshape(batch + self._sample_shape), y.reshape(batch)
        return x.reshape(x.shape[:2] + self._sample_shape), y

    def _client_stage(self, flat_params, idx, is_byz, part):
        """The clients' rows of the stack from the batch indices ``idx``
        [m, E*B]: their local steps, with client momentum read and written
        back (the participants' rows under ``part``).  A layout that splits
        the rows (``parallel.sharded``) computes its own."""
        x, y = self._batches(idx)
        if self.client_m is None:
            return self.client_stack(flat_params, x, y, is_byz)
        m_prev = self.client_m if part is None else self.client_m[part]
        w_stack, m_rows = self.client_stack_momentum(flat_params, x, y, is_byz, m_prev)
        # the drawn rows written back (distinct indices: no accumulation)
        self.client_m = m_rows if part is None else self.client_m.index_put((part,), m_rows)
        return w_stack

    def _dropout_stage(self, w_rows, gens, fault_draws):
        """The fault's straggler replay on the rows of :meth:`_client_stage`,
        against the stale buffer, which becomes what they delivered:
        ``(rows, n_dropped)``."""
        stale, ge_bad = self.fault_state
        w_rows, stale, n_dropped = fault_lib.apply_dropout(
            self.fault, w_rows, stale, generator=gens.fault,
            dropped=fault_draws.get("dropped"))
        self.fault_state = fault_lib.FaultState(stale, ge_bad)
        return w_rows, n_dropped

    def _whole_stack(self, w_rows):
        """The [m, d] stack the later stages read, from the rows this
        trainer computed (all of them here)."""
        return w_rows

    def _attack_stage(self, w_stack, gens, draws, view):
        """The message attack on the stack (its last ``m_b`` rows are the
        Byzantine ones)."""
        return self.attack.apply_message(
            w_stack, self._part_b, gens.message, param=self.cfg.attack_param,
            noise=draws.get("message"), defense=view,
        )

    def _held_terms(self, terms):
        """The OMA link's terms of the rows of :meth:`_whole_stack` (all)."""
        return terms

    def _aggregate(self, w_agg, agg_kw):
        """The rule on the stack: the [d] f32 aggregate."""
        return self.agg_fn(w_agg, **agg_kw).to(torch.float32)

    def _variance(self, w_stack, m_h, terms, service):
        """The honest dispersion of the received stack (its first ``m_h``
        rows); ``terms`` when the channel folds into the rule's read."""
        w_h = w_stack[:m_h]
        if terms is not None:
            # the received honest rows, bitwise those channel.oma makes
            w_h = w_h + channel_lib.oma_residual(
                channel_lib.OmaTerms(*(t[:m_h] for t in terms))
            )
        # under service the missed rows are NaN: the dispersion of what the
        # round received
        return masked_honest_variance(w_h) if service else honest_variance(w_h, m_h)

    def checkpoint_carries(self):
        """``(client momentum [K, d], fault state)`` whole, as a checkpoint
        holds them."""
        return self.client_m, self.fault_state

    def restore_carries(self, client_m, fault_state):
        """Install whole carries read from a checkpoint."""
        self.client_m, self.fault_state = client_m, fault_state

    def _agg_kw(self, flat_params, honest_size, degraded, gens, draws, terms=None):
        cfg = self.cfg
        kw = dict(
            guess=flat_params,
            honest_size=honest_size,
            noise_var=cfg.noise_var,
            channel=terms,
            maxiter=cfg.agg_maxiter,
            tol=cfg.agg_tol,
            p_max=cfg.gm_p_max,
            m=cfg.krum_m,
            clip_tau=cfg.clip_tau,
            clip_iters=cfg.clip_iters,
            sign_eta=cfg.sign_eta,
            sign_bits=cfg.sign_bits,
            dnc_iters=cfg.dnc_iters,
            dnc_sub_dim=cfg.dnc_sub_dim,
            dnc_c=cfg.dnc_c,
            degraded=degraded,
            generator=gens.aggregation,
            fades=draws.get("fades"),
            noise=draws.get("noise"),
            vote_noise=draws.get("vote_noise"),
            dnc_draws=draws.get("dnc"),
        )
        if cfg.service == "on":
            # the rollback-widened fraction: only the degraded trimmed_mean
            # reads it, every other rule swallows it
            kw["trim_ratio"] = self._trim_ratio()
        return kw

    def _server_step(self, flat_params, aggregated):
        if self.server_opt_state is None:
            return aggregated
        # FedOpt: the aggregate defines the pseudo-gradient
        cfg = self.cfg
        new_flat, self.server_opt_state = server_opt_lib.step(
            cfg.server_opt, flat_params, aggregated, self.server_opt_state,
            cfg.server_lr, cfg.server_momentum,
        )
        return new_flat

    @_under_impl
    def iteration(
        self,
        flat_params: torch.Tensor,
        generators: Optional[IterationGenerators] = None,
        draws: Optional[dict] = None,
        want_variance: bool = False,
    ):
        """One global iteration: [participants or the service draw] -> local
        steps -> [dropout] -> attack -> [corruption, CSI error, erasure] ->
        channel -> [deadline] -> [defense] -> [buckets] -> agg -> [server
        optimizer].  With ``cohort_size > 0`` the streamed iteration runs
        instead (:meth:`iteration_streamed`).

        Returns ``(new flat params, honest variance or None)``.  ``draws``
        may supply any of: ``"u"`` [m, E*B] batch uniforms, ``"oma"`` the
        OMA link's terms (:class:`..ops.channel.OmaTerms`), ``"fades"``
        (h_r, h_i) [T, K] and ``"noise"`` [T, d+1] for gm's Weiszfeld
        steps, ``"vote_noise"`` [d] for signmv's receiver, ``"dnc"`` dnc's
        ``[(cols, v0)]`` per filtering round, ``"message"`` the gaussian
        attack's [B, d] normals, ``"fault"`` a dict of the
        fault channel's draws (``"dropped"`` for
        :func:`..ops.faults.apply_dropout`, the keys of
        :func:`..ops.faults.apply_transmission`), ``"part"`` the [m] drawn
        clients (:meth:`draw_participants`), ``"bucket"`` the [m]
        permutation of :func:`bucket_means`, and under service
        ``"service_u"`` the draw's uniforms (:meth:`service_draw`),
        ``"churn"`` its masks (:meth:`churn`) and ``"late"`` the [K]
        straggler mask (:func:`..ops.faults.apply_deadline`); the rest
        comes from ``generators``.

        With a fault set, the carried ``fault_state`` advances, the rule
        runs degraded, every non-finite coordinate of the aggregate keeps
        its previous value, and ``iteration_fault_metrics`` holds this
        iteration's [4] counts (in the order of :data:`FAULT_PATHS`).  The
        carried ``client_m``, ``defense_state`` and ``server_opt_state``
        advance too, and with a defense ``iteration_defense_metrics`` holds
        this iteration's [5] observations (rung, flagged, suspicious, max
        score, max CUSUM).  Under service the ``service_state`` advances, the
        rule runs degraded behind the same finite guard, and
        ``iteration_service_metrics`` holds the [4] of :data:`SERVICE_PATHS`.

        With ``--var`` set, median and trimmed_mean take the OMA terms as
        ``channel=`` and fold the corruption into their one read of the
        stack, except under a fault or service (their degraded modes take
        the received stack, as the JAX package's degraded rounds do), with
        buckets (the means are of received rows) and under the adaptive
        defense (every rung reads the same received stack, JAX
        ``fed/train.py:236-241``); the other rules (except gm and signmv,
        which own their channel) get the corrupted stack.  Under service the
        link is keyed by population id (:func:`..ops.channel.oma_by_id`).
        Either way the honest variance and the defense's scores are taken
        on the post-channel stack, as the reference takes the variance
        (``:351-352``, ``:360-361``).  Under ``--defense adaptive`` the rung
        is read on the host once per iteration to call its aggregator
        (:func:`..defense.policy.aggregate_rung`), the one host sync the
        defense adds."""
        if self.cfg.cohort_size > 0:
            return self.iteration_streamed(flat_params, generators, draws, want_variance)
        cfg = self.cfg
        draws = draws or {}
        gens = generators or IterationGenerators(None, None, None, None)
        fault = self.fault
        fault_draws = draws.get("fault") or {}
        spec = self.defense
        service = cfg.service == "on"
        m_h, m_b = self._part_h, self._part_b

        part, offsets, sizes = None, self.offsets, self.sizes
        if cfg.participation < 1.0:
            part = draws.get("part")
            if part is None:
                part = self.draw_participants(gens.participation)
            offsets, sizes = self.offsets[part], self.sizes[part]
        pop_ids = None
        if service:
            pop_ids, arrived, n_avail = self._service_stage(gens, draws)
            # a drawn id reads its own shard wherever the draw placed it
            shard = self._pop_shard[pop_ids]
            offsets, sizes = self.offsets[shard], self.sizes[shard]
        # the [m, E*B] indices in one draw: at E = 1 the stream of the
        # single-step trainer
        with span("batch"):
            idx = data_lib.sample_client_batch_indices(
                offsets, sizes, cfg.local_steps * cfg.batch_size,
                generator=gens.batch, u=draws.get("u"),
            )
        # one device bool gates every Byzantine behavior until the onset
        is_byz, attack_on = self._part_mask, None
        if self._attack_onset is not None:
            attack_on = self.attack_iter >= self._attack_onset
            is_byz = is_byz & attack_on
        with span(CLIENT_STEP_RANGE):
            w_stack = self._client_stage(flat_params, idx, is_byz, part)
        if fault is not None:
            # before the attack: the buffer keeps what the clients sent
            w_stack, n_dropped = self._dropout_stage(w_stack, gens, fault_draws)
            ge_bad = self.fault_state.ge_bad
        w_stack = self._whole_stack(w_stack)
        if self.attack is not None:
            with span("attack"):
                # a defense-aware attack reads the detector state published
                # after the previous iteration (under service, the drawn ids')
                view = (self._defense_view(flat_params, pop_ids)
                        if self.attack.defense_aware else None)
                w_att = self._attack_stage(w_stack, gens, draws, view)
                w_stack = w_att if attack_on is None else torch.where(attack_on, w_att,
                                                                      w_stack)
        if fault is not None:
            # after it: corruption and the channel's faults hit every row
            w_stack, ge_bad, n_erased, n_corrupt = fault_lib.apply_transmission(
                fault, w_stack, ge_bad, generator=gens.fault, draws=fault_draws,
            )
            self.fault_state = fault_lib.FaultState(self.fault_state.stale, ge_bad)
        adaptive = spec is not None and spec.mode == "adaptive"
        terms = None
        if cfg.noise_var is not None and agg_lib.needs_oma_prepass(cfg.agg):
            with span("channel"):
                terms = draws.get("oma")
                if service:
                    # each row's link is that of its stable id
                    w_stack = channel_lib.oma_by_id(w_stack, pop_ids, cfg.noise_var,
                                                    key=gens.link_key, terms=terms)
                    terms = None
                else:
                    if terms is None:
                        terms = channel_lib.oma_terms(
                            m_h + m_b, self.dim, cfg.noise_var, generator=gens.channel,
                            device=w_stack.device,
                        )
                    terms = self._held_terms(terms)
                    if not self.channel_fused:
                        w_stack = channel_lib.oma(w_stack, cfg.noise_var, terms=terms)
                        terms = None
        if service:
            # the round closes now: absent and late rows are erased to NaN
            w_stack, n_absent, n_late = fault_lib.apply_deadline(
                w_stack, arrived, cfg.straggler_prob, generator=gens.deadline,
                late=draws.get("late"),
            )

        rung = None
        if spec is not None:
            # the scores read the received stack: under monitor with the
            # channel folded into the rule's read, its received rows (bitwise
            # those of channel.oma) are made for the scores alone
            seen = w_stack if terms is None else channel_lib.oma(
                w_stack, cfg.noise_var, terms=terms)
            det, pol = self.defense_state
            score, finite, parts = defense_lib.client_score_components(seen, flat_params)
            if self._forensics_on:
                # the forensic rows' identities and the baselines the
                # detector thresholded (from before the update)
                f_ids, ema_pre, dev_pre = (
                    (pop_ids, det[1][pop_ids], det[2][pop_ids]) if service
                    else (torch.arange(w_stack.shape[0], device=w_stack.device), det[1],
                          det[2]))
            if service:
                rows, flags = detector_update_by_id(det, score, finite, pop_ids, spec.detector)
                det = (det[0] + 1,) + rows
            else:
                det, flags = defense_lib.detector_update(det, score, finite, spec.detector)
            n_flagged = torch.sum(flags)
            pol, suspicious = defense_lib.policy_update(pol, n_flagged, spec.policy)
            rung = pol[0]
            if self._forensics_on:
                cus_post = det[3][pop_ids] if service else det[3]
                self.iteration_forensic = forensics_lib.with_rung(forensics_lib.top_m(
                    forensics_lib.candidate_rows(f_ids, score, parts, ema_pre, dev_pre,
                                                 cus_post, flags, spec.detector),
                    cfg.forensics_top), rung)
            self.defense_state = (det, pol)
            self.iteration_defense_metrics = torch.stack([
                rung.to(torch.float32), n_flagged.to(torch.float32),
                suspicious.to(torch.float32), torch.max(score), torch.max(det[3]),
            ])
            del seen

        agg_honest, w_agg = m_h, w_stack
        if cfg.bucket_size > 1:
            # the worst case: every Byzantine row in a bucket of its own
            m, s = m_h + m_b, cfg.bucket_size
            perm = draws.get("bucket")
            if perm is None:
                perm = torch.randperm(m, generator=gens.bucket, device=self.device)
            w_agg = bucket_means(w_stack, perm, s)
            agg_honest = m // s - m_b

        degraded = fault is not None or service
        agg_kw = self._agg_kw(flat_params, agg_honest, degraded, gens, draws, terms)
        # --stack-dtype bf16: the rule reads a bf16 copy of the stack; its
        # arithmetic stays f32 and the aggregate comes back f32
        w_agg = w_agg.to(self._stack_dtype)
        with span("aggregate"):
            if adaptive:
                # rung 0 is cfg.agg, so a quiet run aggregates as --defense off
                aggregated = defense_lib.aggregate_rung(rung, spec.ladder, w_agg, **agg_kw)
            else:
                # reference semantics (:354-358)
                aggregated = self._aggregate(w_agg, agg_kw)
        if degraded:
            # the receiver's finite guard: a coordinate that no finite row
            # reached keeps its previous value
            aggregated = torch.where(torch.isfinite(aggregated), aggregated, flat_params)
            eff_k = torch.sum(agg_lib._finite_rows(w_stack)).to(torch.float32)
        if fault is not None:
            self.iteration_fault_metrics = torch.stack([n_dropped, n_erased, n_corrupt, eff_k])
        if service:
            self.iteration_service_metrics = torch.stack([n_avail, n_absent, n_late, eff_k])
        with span("server_step"):
            new_flat = self._server_step(flat_params, aggregated)
        variance = None
        if want_variance:
            with span("variance"):
                variance = self._variance(w_stack, m_h, terms, service)
        if self.attack_iter is not None:
            self.attack_iter = self.attack_iter + 1
        return new_flat, variance

    # ------------------------------------------------------------------
    # one cohort-streamed iteration

    def make_rebuild(self, flat_params, gens, idx_all, attack_on=None, pop_ids=None,
                     missed=None, ge_bad=None, defense_state=None, draws=None):
        """``rebuild_full(c) -> (chunk [cohort, d], GE slice, n_erased,
        n_corrupt)``: client chunk c of a streamed iteration end to end
        (JAX ``rebuild_full``, :1334): local steps on its rows of
        ``idx_all``, the row-local message attack on a Byzantine chunk, the
        fault transmission (``row_offset`` = the chunk's first row), the
        channel (the per-id link under service, else the chunk's own
        stream) and the deadline erasure last.  It is pure in c: each call
        seeds the chunk's generators afresh (``gens.cohort``), and a
        defense-aware attack reads ``defense_state``, the detector snapshot
        from the start of the iteration, so that every pass sees the same
        chunk.  ``draws`` may hold ``"message"`` [cohort, d], the gaussian
        attack's normals (the tests share them)."""
        cfg = self.cfg
        draws = draws or {}
        cohort = cfg.cohort_size
        n_h_chunks = self._part_h // cohort
        fault, attack = self.fault, self.attack
        dev = flat_params.device

        def chunk_gen(stream, c):
            return None if gens.cohort is None else gens.cohort(stream, c)

        def rebuild_full(c: int):
            off = c * cohort
            rows = slice(off, off + cohort)
            mask_c = self._part_mask[rows]
            if attack_on is not None:
                mask_c = mask_c & attack_on
            x, y = self._batches(idx_all[rows])
            with span(CLIENT_STEP_RANGE):
                chunk = self.client_stack(flat_params, x, y, mask_c)
            # chunks are purely honest or purely Byzantine: only the last
            # ones are attacked, all of their rows
            if attack is not None and attack.message_fn is not None and c >= n_h_chunks:
                view = None
                if attack.defense_aware:
                    (step, ema, dv, cus), pol = defense_state
                    ids = rows if pop_ids is None else pop_ids[rows]
                    view = attack_lib.DefenseView(
                        step=step, ema=ema[ids], dev=dv[ids], cusum=cus[ids], rung=pol[0],
                        detector=self.defense.detector, policy=self.defense.policy,
                        guess=flat_params)
                w_att = attack.apply_message(chunk, cohort, chunk_gen(MESSAGE_STREAM, c),
                                             param=cfg.attack_param,
                                             noise=draws.get("message"), defense=view)
                chunk = w_att if attack_on is None else torch.where(attack_on, w_att, chunk)
            ge_c = None
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            n_erased = n_corrupt = zero
            if fault is not None:
                chunk, ge_c, n_erased, n_corrupt = fault_lib.apply_transmission(
                    fault, chunk, None if ge_bad is None else ge_bad[rows],
                    generator=chunk_gen(FAULT_STREAM, c), row_offset=off,
                )
            if cfg.noise_var is not None and agg_lib.needs_oma_prepass(cfg.agg):
                if pop_ids is not None:
                    # under the iteration's key: a client's link is that of
                    # its id in any chunk, bitwise the resident stack's
                    chunk = channel_lib.oma_by_id(chunk, pop_ids[rows], cfg.noise_var,
                                                  key=gens.link_key)
                else:
                    chunk = channel_lib.oma(chunk, cfg.noise_var,
                                            generator=chunk_gen(CHANNEL_STREAM, c))
            if missed is not None:
                chunk = torch.where(missed[rows][:, None], math.nan, chunk)
            return chunk, ge_c, n_erased, n_corrupt

        return rebuild_full

    @_under_impl
    def iteration_streamed(
        self,
        flat_params: torch.Tensor,
        generators: Optional[IterationGenerators] = None,
        draws: Optional[dict] = None,
        want_variance: bool = False,
    ):
        """One cohort-streamed global iteration (JAX
        ``_iteration_streamed``, :1103, with the one-device context): the
        [K, d] stack is never held.  The participants' draw, the service
        draw, churn and deadline mask, and one [K, E*B] batch-index draw
        (the resident stream, so with the channel and faults off every chunk
        is bitwise the resident stack's rows) are made up front; then one
        observation pass over the chunks collects the sums, the finite
        count, the honest moments (over the finite rows under service), the
        fault counts and Gilbert-Elliott states, and the detector's
        per-chunk updates (scores per cohort, a documented approximation);
        then the policy, and the rule's streamed realization (or the rung's)
        rebuilds the chunks once per pass it needs.  Dropout is absent: the
        stale-replay buffer is refused under streaming.  Same returns and
        carried state as :meth:`iteration`; ``draws`` takes ``"u"``,
        ``"part"``, ``"service_u"``, ``"churn"``, ``"late"`` and
        ``"message"``."""
        cfg = self.cfg
        draws = draws or {}
        gens = generators or IterationGenerators(None, None, None, None)
        fault, spec = self.fault, self.defense
        service = cfg.service == "on"
        m_h, m_b = self._part_h, self._part_b
        cohort = cfg.cohort_size
        n_h_chunks, n_chunks = m_h // cohort, (m_h + m_b) // cohort
        d, dev = self.dim, flat_params.device

        attack_on = None
        if self._attack_onset is not None:
            attack_on = self.attack_iter >= self._attack_onset
        offsets, sizes = self.offsets, self.sizes
        if cfg.participation < 1.0:
            # subsample, then stream the participants' index space
            part = draws.get("part")
            if part is None:
                part = self.draw_participants(gens.participation)
            offsets, sizes = self.offsets[part], self.sizes[part]
        pop_ids = missed = None
        if service:
            pop_ids, arrived, n_avail = self._service_stage(gens, draws)
            shard = self._pop_shard[pop_ids]
            offsets, sizes = self.offsets[shard], self.sizes[shard]
            missed, n_absent, n_late = fault_lib.deadline_misses(
                arrived, cfg.straggler_prob, generator=gens.deadline, late=draws.get("late"))
        idx_all = data_lib.sample_client_batch_indices(
            offsets, sizes, cfg.local_steps * cfg.batch_size,
            generator=gens.batch, u=draws.get("u"),
        )
        ge_bad = self.fault_state.ge_bad if fault is not None else None
        defense_in = self.defense_state
        rebuild_full = self.make_rebuild(flat_params, gens, idx_all, attack_on, pop_ids,
                                         missed, ge_bad, defense_in, draws)

        # the observation pass, one carry through the population-shard
        # context (JAX fed/train.py:1440-1580): float sums fold in shard
        # order, integer sums and extrema merge exactly, the detector rows
        # stack for the disjoint-row merge below; () marks a slot that is off
        ctx = self._pop_ctx
        sharded = ctx.n_shards > 1
        want_topm = spec is not None and self._forensics_on
        zeros = torch.zeros(d, dtype=torch.float32, device=dev)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        det_rows0 = ()
        if spec is not None:
            # copies: rebuild's defense-aware view reads the snapshot
            det0, pol = defense_in
            det_rows0 = tuple(t.clone() for t in det0[1:])
            if sharded:
                # the rows each shard updated (the draw is without
                # replacement, so the shards' rows never overlap)
                det_rows0 += (torch.zeros(det0[1].shape, dtype=torch.bool, device=dev),)
        obs_init = (
            zeros, zeros, torch.zeros((), dtype=torch.int32, device=dev), zeros, zero,
            zero if service else (),
            () if ge_bad is None else ge_bad.clone(),
            zero, zero, det_rows0,
            torch.zeros((), dtype=torch.int64, device=dev) if spec is not None else (),
            zero if spec is not None else (),
            forensics_lib.stream_init(cfg.forensics_top, device=dev) if want_topm else (),
        )
        obs_spec = (
            "sum", "sum", "sum", "sum", "sum", "sum" if service else (),
            "stack" if ge_bad is not None else (), "sum", "sum",
            ("stack",) * len(det_rows0) if spec is not None else (),
            "sum" if spec is not None else (), "max" if spec is not None else (),
            "stack" if want_topm else (),
        )

        def obs_body(carry, c):
            (s_all, s_fin, n_fin, s_h, ssq_h, n_h_fin, ge_new, n_er, n_co, det_rows,
             n_flag, max_sc, topm) = carry
            chunk, ge_c, er, co = rebuild_full(c)
            fin = agg_lib._finite_rows(chunk)
            c32 = chunk.to(torch.float32)
            c_fin = torch.where(fin[:, None], c32, 0.0)
            s_all = s_all + torch.sum(c32, dim=0)
            s_fin = s_fin + torch.sum(c_fin, dim=0)
            n_fin = n_fin + torch.sum(fin).to(torch.int32)
            if c < n_h_chunks:
                # under service the missed honest rows are NaN: the moments
                # of what the round received
                rows_h = c_fin if service else c32
                s_h = s_h + torch.sum(rows_h, dim=0)
                ssq_h = ssq_h + torch.sum(rows_h * rows_h)
                if service:
                    n_h_fin = n_h_fin + torch.sum(fin).to(torch.float32)
            if fault is not None:
                n_er, n_co = n_er + er, n_co + co
                if ge_c is not None:
                    ge_new[c * cohort:(c + 1) * cohort] = ge_c
            if spec is not None:
                # per-client rows updated chunk by chunk under the step of the
                # iteration's start (advanced once after the pass)
                ema, dv, cus = det_rows[:3]
                score, score_fin, parts = defense_lib.client_score_components(
                    chunk, flat_params)
                rows = slice(c * cohort, (c + 1) * cohort)
                ids_c = pop_ids[rows] if service else None
                if want_topm:
                    # the chunk's rows' baselines from before their update
                    ema_pre, dev_pre = ((ema[ids_c], dv[ids_c]) if service
                                        else (ema[rows].clone(), dv[rows].clone()))
                if service:
                    (ema, dv, cus), flags = detector_update_by_id(
                        (det0[0], ema, dv, cus), score, score_fin, ids_c, spec.detector)
                    det_rows = (ema, dv, cus) + (
                        (det_rows[3].index_put((ids_c,), torch.ones_like(ids_c, dtype=torch.bool)),)
                        if sharded else ())
                else:
                    (_, ema[rows], dv[rows], cus[rows]), flags = defense_lib.detector_update(
                        (det0[0], ema[rows], dv[rows], cus[rows]), score, score_fin,
                        spec.detector)
                if want_topm:
                    # the chunk's candidates against the running top-M
                    # (population ids under service, participant rows else)
                    ids_f = ids_c if service else torch.arange(
                        c * cohort, (c + 1) * cohort, device=dev)
                    cus_post = cus[ids_c] if service else cus[rows]
                    topm = forensics_lib.merge_top_m(
                        topm, forensics_lib.candidate_rows(
                            ids_f, score, parts, ema_pre, dev_pre, cus_post, flags,
                            spec.detector), cfg.forensics_top)
                n_flag = n_flag + torch.sum(flags)
                max_sc = torch.maximum(max_sc, torch.max(score))
            return (s_all, s_fin, n_fin, s_h, ssq_h, n_h_fin, ge_new, n_er, n_co, det_rows,
                    n_flag, max_sc, topm)

        (s_all, s_fin, n_fin, s_h, ssq_h, n_h_fin, ge_new, n_er, n_co, det_rows, n_flag,
         max_sc, topm) = ctx.scan_idx_merge(n_chunks, obs_body, obs_init, obs_spec)

        rung = None
        if spec is not None:
            if sharded:
                # the disjoint-row merge of the stacked [S, rows] partials:
                # a shard's touched rows take its values, the rest keep the
                # round-start ones
                ema_s, dev_s, cus_s, touched_s = det_rows
                ema, dv, cus = det0[1], det0[2], det0[3]
                for p in range(ctx.n_shards):
                    t_p = touched_s[p]
                    ema = torch.where(t_p, ema_s[p], ema)
                    dv = torch.where(t_p, dev_s[p], dv)
                    cus = torch.where(t_p, cus_s[p], cus)
            else:
                ema, dv, cus = det_rows
            det = (det0[0] + 1, ema, dv, cus)
            pol, suspicious = defense_lib.policy_update(pol, n_flag, spec.policy)
            rung = pol[0]
            self.defense_state = (det, pol)
            if want_topm:
                # the rung at flag time, stamped once the policy has updated
                self.iteration_forensic = forensics_lib.with_rung(topm, rung)
            self.iteration_defense_metrics = torch.stack([
                rung.to(torch.float32), n_flag.to(torch.float32),
                suspicious.to(torch.float32), max_sc, torch.max(det[3]),
            ])
        if fault is not None:
            self.fault_state = fault_lib.FaultState(None, ge_new if ge_bad is not None else None)

        def rebuild(c):
            return rebuild_full(c)[0]

        degraded = fault is not None or service
        kw = dict(k=m_h + m_b, d=d, n_chunks=n_chunks, device=dev, degraded=degraded,
                  sum_all=s_all, sum_finite=s_fin, n_finite=n_fin, guess=flat_params,
                  maxiter=cfg.agg_maxiter, tol=cfg.agg_tol, quantile=cfg.cohort_quantile,
                  sketch_bins=cfg.cohort_sketch_bins, ctx=ctx)
        if service:
            kw["trim_ratio"] = self._trim_ratio()
        if spec is not None and spec.mode == "adaptive":
            aggregated = defense_lib.stream_aggregate_rung(rung, spec.ladder, rebuild, **kw)
        else:
            aggregated = agg_lib.stream_aggregate(cfg.agg, rebuild, **kw).to(torch.float32)
        if degraded:
            # the receiver's finite guard, as in the resident round
            aggregated = torch.where(torch.isfinite(aggregated), aggregated, flat_params)
        eff_k = n_fin.to(torch.float32)
        if fault is not None:
            # dropout is absent under streaming: its count is 0
            self.iteration_fault_metrics = torch.stack([zero, n_er, n_co, eff_k])
        if service:
            self.iteration_service_metrics = torch.stack([n_avail, n_absent, n_late, eff_k])
        new_flat = self._server_step(flat_params, aggregated)
        variance = None
        if want_variance:
            # (1/H) sum ||w_i||^2 - ||mean_h||^2 from the pass's moments
            n_h = (torch.clamp(n_h_fin, min=1.0) if service
                   else torch.tensor(float(m_h), dtype=torch.float32))
            mean_h = s_h / n_h
            variance = ssq_h / n_h - torch.sum(mean_h * mean_h)
        if self.attack_iter is not None:
            self.attack_iter = self.attack_iter + 1
        return new_flat, variance

    def run_round(self, round_idx: int) -> torch.Tensor:
        """``display_interval`` iterations; returns the honest dispersion of
        the last iteration's stack (reference ``:360-361``) as a device
        scalar, without a host sync.  With a fault set,
        ``last_fault_metrics`` becomes the round's counts: dropped, erased
        and corrupt rows summed over its iterations, the effective K at its
        minimum (device tensors too).  With a defense,
        ``last_defense_metrics`` becomes the round's [6] vector
        (:func:`..defense.events.reduce_round`).  Under service,
        ``last_service_metrics`` becomes the round's [4]: the last
        iteration's available count, the absent and late rows summed, the
        effective K at its minimum (JAX ``fed/train.py:1773-1782``).  With
        forensics on, ``last_forensic_metrics`` becomes the round's
        [forensics_top, NUM_COLS] top-M of its iterations' matrices.  The
        round is the span ``dispatch``."""
        with span("dispatch"):
            return self._round(round_idx)

    def _round(self, round_idx: int) -> torch.Tensor:
        """:meth:`run_round`'s round, in no span of its own."""
        interval = self.cfg.display_interval
        variance = None
        counts, observed, served, forensic = [], [], [], []
        rung_in = self.defense_state[1][0] if self.defense is not None else None
        for it in range(interval):
            self.flat_params, variance = self.iteration(
                self.flat_params,
                self.iteration_generators(round_idx, it, persistent=True),
                want_variance=it == interval - 1,
            )
            if self.fault is not None:
                counts.append(self.iteration_fault_metrics)
            if self.defense is not None:
                observed.append(self.iteration_defense_metrics)
            if self.service_state is not None:
                served.append(self.iteration_service_metrics)
            if self._forensics_on:
                forensic.append(self.iteration_forensic)
        if counts:
            per_it = torch.stack(counts)
            self.last_fault_metrics = torch.cat(
                [torch.sum(per_it[:, :3], dim=0), torch.amin(per_it[:, 3:], dim=0)]
            )
        if observed:
            self.last_defense_metrics = defense_lib.events.reduce_round(rung_in, observed)
        if served:
            per_it = torch.stack(served)
            self.last_service_metrics = torch.cat([
                per_it[-1, :1], torch.sum(per_it[:, 1:3], dim=0),
                torch.amin(per_it[:, 3:], dim=0)])
        if forensic:
            # a client's peak iteration wins; host-side emission dedupes
            self.last_forensic_metrics = forensics_lib.merge_interval(
                torch.stack(forensic), self.cfg.forensics_top)
        return variance

    def run_rounds_stacked(self, start_round: int, num_rounds: int) -> DispatchOutputs:
        """Rounds ``start_round .. start_round + num_rounds - 1`` as one
        dispatch (JAX ``run_rounds_stacked``, :1945): on the card, where
        :func:`.graphs.dispatch_graph` admits the configuration, one replay
        of the round's CUDA graph per round (captured at the first
        dispatch); else the rounds run eagerly.  Returns the stacked
        per-round outputs (:class:`DispatchOutputs`) as device tensors,
        with no host read; ``last_*_metrics`` become the last round's
        rows, as after :meth:`run_round`.  The dispatch is the span
        ``dispatch``."""
        with span("dispatch"):
            if self.dispatch_graph[0]:
                if self.round_graph is None:
                    self.round_graph = graphs_lib.RoundGraph(self)
                outs = self.round_graph.run(start_round, num_rounds)
            else:
                rows = []
                for i in range(num_rounds):
                    variance = self._round(start_round + i)
                    rows.append((variance, self.last_fault_metrics,
                                 self.last_defense_metrics, self.last_service_metrics,
                                 self.last_forensic_metrics))
                outs = DispatchOutputs(*(
                    None if col[0] is None else torch.stack(col) for col in zip(*rows)))
            if outs.forensic is not None:
                self.last_forensic_metrics = outs.forensic[-1]
            if outs.fault is not None:
                self.last_fault_metrics = outs.fault[-1]
            if outs.defense is not None:
                self.last_defense_metrics = outs.defense[-1]
            if outs.service is not None:
                self.last_service_metrics = outs.service[-1]
        return outs

    def run_rounds(self, start_round: int, num_rounds: int) -> torch.Tensor:
        """:meth:`run_rounds_stacked`'s per-round honest variance [n], a
        device tensor (JAX ``run_rounds``, :1979)."""
        return self.run_rounds_stacked(start_round, num_rounds).variances

    # ------------------------------------------------------------------
    # eval and the host-side training loop

    def _eval_arrays(self, split: str):
        if split not in self._eval_cache:
            ds = self.dataset
            x, y = (ds.x_val, ds.y_val) if split == "val" else (ds.x_train, ds.y_train)
            x = np.ascontiguousarray(x, np.float32).reshape((len(x),) + self._sample_shape)
            self._eval_cache[split] = (
                torch.from_numpy(x).to(self.device),
                torch.from_numpy(np.asarray(y, np.int64)).to(self.device),
            )
        return self._eval_cache[split]

    @torch.no_grad()
    def evaluate(self, split: str = "val"):
        """Full-dataset (loss, accuracy) (reference ``calculateAccuracy``,
        ``:106-125``), in chunks of ``eval_batch``."""
        x, y = self._eval_arrays(split)
        params = flatten_lib.unflatten(self.flat_params, self.spec)
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        for lo in range(0, len(y), self.cfg.eval_batch):
            xc, yc = x[lo : lo + self.cfg.eval_batch], y[lo : lo + self.cfg.eval_batch]
            logits = functional_call(self.model, params, (xc,))
            loss += torch.sum(cross_entropy(logits, yc))
            correct += torch.sum(torch.argmax(logits, dim=1) == yc)
        n = len(y)
        return float(loss) / n, int(correct) / n

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _state(self):
        return (self.flat_params, self.server_opt_state, self.client_m, self.fault_state,
                self.defense_state, self.attack_iter, self.service_state)

    def _set_state(self, state):
        (self.flat_params, self.server_opt_state, self.client_m, self.fault_state,
         self.defense_state, self.attack_iter, self.service_state) = state

    def _divergence(self, tr_loss, va_loss, variance, recent_val) -> Optional[str]:
        """The warm rollback's guard (JAX ``fed/train.py:2102-2125``): the
        reason a round diverged, or None."""
        cfg = self.cfg
        if not (math.isfinite(tr_loss) and math.isfinite(va_loss) and math.isfinite(variance)):
            return "non_finite"
        if (self.defense is not None and cfg.rollback_cusum > 0.0
                and float(self.last_defense_metrics[4]) >= cfg.rollback_cusum):
            return "cusum_spike"
        if len(recent_val) >= 3:
            med = sorted(recent_val)[len(recent_val) // 2]
            if va_loss > cfg.rollback_loss_factor * max(med, 1e-3):
                return "loss_spike"
        return None

    def train(
        self,
        log_fn: Optional[Callable[[str], None]] = None,
        checkpoint_fn: Optional[Callable[[int, "Trainer", Dict[str, List[float]]], None]] = None,
        start_round: int = 0,
        obs: Optional["obs_lib.Observability"] = None,
        profiler: Optional["obs_lib.Profiler"] = None,
    ) -> Dict[str, List[float]]:
        """Full training run; returns the reference-schema metric paths
        (``trainLossPath`` etc., pickled record keys at ``:481-489``).
        ``start_round > 0`` resumes a checkpointed run (the caller restores
        the state first, ``harness.restore_trainer``): the paths start with
        the eval of the restored params.  ``checkpoint_fn(r, trainer, paths)``
        runs after every round, with ``r`` the number of rounds done and
        ``paths`` those recorded so far.

        ``obs`` (default: the null sink) receives the JAX trainer's events
        (``fed/train.py:2026-2330``): a ``round`` span per round (its
        ``compiled`` true where the round paid for the eager set-up), an
        ``eval`` span per eval and a ``checkpoint`` span per checkpoint,
        and per round ``participation`` (service), ``defense``,
        ``client_flag`` (forensics) and ``round``, all from the host floats
        that go into the paths (:meth:`_append_round`), and ``rollback``.
        The spans add no device sync: the round already ends on one.
        ``profiler`` (default: the null profiler) wraps each round in its
        ``round`` range and names eval and checkpoint, and owns a
        ``--profile-rounds`` window through its round hooks.

        Under service rounds with ``rollback`` on (JAX ``fed/train.py:
        2084-2194``, :2310-2328), a guard runs before a round's paths are
        appended: a non-finite train or val loss or variance, a CUSUM peak
        at ``rollback_cusum`` (with a defense), or a val loss above
        ``rollback_loss_factor`` times the median of the last
        ``ROLLBACK_WINDOW`` ones.  A tripped round appends nothing: the
        state of the last good round comes back (a copy taken before that
        round's ``checkpoint_fn``, which cannot reach it), the trim
        widening is multiplied by ``rollback_widen``, the rollback count
        (at most ``rollback_max``) becomes the epoch that salts every later
        round's seeds, and the round runs again."""
        cfg = self.cfg
        log = log_fn or (lambda s: None)
        obs = obs or obs_lib.NULL
        profiler = profiler or obs_lib.NULL_PROFILER

        def eval_pair():
            tr = self.evaluate("train") if cfg.eval_train else (0.0, 0.0)
            return tr, self.evaluate("val")

        with (obs.span("eval", ranged=False, stage="initial", round=start_round),
              profiler.phase("eval")):
            (tr_loss, tr_acc), (va_loss, va_acc) = eval_pair()
        paths = {
            "trainLossPath": [tr_loss],
            "trainAccPath": [tr_acc],
            "valLossPath": [va_loss],
            "valAccPath": [va_acc],
            "variencePath": [],  # sic — reference spelling
            "roundsPerSec": [],
        }
        if self.fault is not None:
            for key in FAULT_PATHS:
                paths[key] = []
        if self.defense is not None:
            for key in defense_lib.events.PATH_KEYS.values():
                paths[key] = []
        if self.service_state is not None:
            for key in SERVICE_PATHS:
                paths[key] = []
        # the previous round's rung, for the defense event's transition
        # (read once, only when the stream is on)
        self._prev_rung = (int(self.defense_state[1][0])
                           if self.defense is not None and obs.enabled else None)
        log(
            f"[{start_round}/{cfg.rounds}](interval: {cfg.display_interval}) "
            f"train: loss={tr_loss:.4f} acc={tr_acc:.4f} "
            f"val: loss={va_loss:.4f} acc={va_acc:.4f}"
        )
        if cfg.rounds_per_dispatch > 1:
            # the R = 1 loop below stays as it was, bit for bit
            return self._train_multi(paths, (tr_loss, tr_acc, va_loss, va_acc), eval_pair,
                                     log, checkpoint_fn, start_round, obs, profiler)
        var_str = f" var={cfg.noise_var:.2e}" if cfg.noise_var is not None else ""
        rollback_armed = cfg.service == "on" and cfg.rollback == "on"
        snapshot = None
        recent_val: List[float] = []
        r = start_round
        while r < cfg.rounds:
            profiler.round_start(r)
            with obs.span("round", ranged=False, round=r) as sp, profiler.step(r):
                self._sync()
                t0 = time.perf_counter()
                variance = self.run_round(r)
                self._sync()
                dt = time.perf_counter() - t0
                # the first round pays for the eager set-up (obs/retrace.py)
                compiled = sp["compiled"] = r == start_round
            with (obs.span("eval", ranged=False, stage="round", round=r + 1),
                  profiler.phase("eval")):
                (tr_loss, tr_acc), (va_loss, va_acc) = eval_pair()
            var_f = float(variance)
            if rollback_armed and self._roll_back(
                    self._divergence(tr_loss, va_loss, var_f, recent_val), snapshot,
                    f"round {r + 1}", log, obs, r, va_loss):
                profiler.round_end(r)
                continue
            # the round's fault, service, defense and forensic rows, read
            # with the eval: one host read each
            forensic = (None if self.last_forensic_metrics is None
                        else self.last_forensic_metrics.tolist())
            fault_str = self._append_round(
                paths, (tr_loss, tr_acc, va_loss, va_acc), var_f, 1.0 / dt,
                None if self.fault is None else self.last_fault_metrics.tolist(),
                None if self.service_state is None else self.last_service_metrics.tolist(),
                None if self.defense is None else self.last_defense_metrics,
                obs=obs, round_idx=r, forensic_row=forensic,
                round_secs=dt, compiled=compiled)
            self._flight_record(r, forensic, dict(val_loss=va_loss, val_acc=va_acc,
                                                  variance=var_f))
            log(
                f"[{r + 1}/{cfg.rounds}](interval: {cfg.display_interval}) "
                f"train: loss={tr_loss:.4f} acc={tr_acc:.4f} "
                f"val: loss={va_loss:.4f} acc={va_acc:.4f}{var_str}{fault_str}"
            )
            if rollback_armed:
                recent_val = (recent_val + [va_loss])[-ROLLBACK_WINDOW:]
                # a copy, taken before checkpoint_fn: a hook that poisons
                # the params in place cannot reach the restore point
                snapshot = (_clone_state(self._state()), r + 1)
            if checkpoint_fn is not None:
                with (obs.span("checkpoint", ranged=False, round=r + 1),
                      profiler.phase("checkpoint")):
                    checkpoint_fn(r + 1, self, paths)
            profiler.round_end(r)
            r += 1
        return paths

    def _flight_record(self, r, forensic_row, summary):
        """Round ``r`` into the flight recorder (``--forensics full``): the
        detector and policy state, the round's defense vector and forensic
        top-M (host copies, read after the round's barrier)."""
        if self.flight_recorder is None:
            return
        det, pol = self.defense_state
        self.flight_recorder.record(r, detector_state=det, policy_state=pol,
                                    defense_metrics=self.last_defense_metrics,
                                    forensic_rows=forensic_row, summary=summary)

    def _append_round(self, paths, evals, variance, rate, fault_row, service_row,
                      defense_row, *, obs=None, round_idx=None, forensic_row=None,
                      **round_fields) -> str:
        """One round's entries into ``paths``: the evals ``(train loss,
        train acc, val loss, val acc)``, the variance, the rate, and the
        fault, service and defense rows of a run that has them (None
        otherwise).  With ``obs`` on, the same floats go out as round
        ``round_idx``'s events: ``participation``, ``defense``, the
        ``client_flag`` events of ``forensic_row`` (the round's top-M, host
        rows) and ``round`` (with ``round_fields``: ``round_secs``,
        ``compiled``).  Returns the round's log suffix for the rows."""
        cfg = self.cfg
        obs = obs or obs_lib.NULL
        tr_loss, tr_acc, va_loss, va_acc = evals
        paths["trainLossPath"].append(tr_loss)
        paths["trainAccPath"].append(tr_acc)
        paths["valLossPath"].append(va_loss)
        paths["valAccPath"].append(va_acc)
        paths["variencePath"].append(variance)
        paths["roundsPerSec"].append(rate)
        suffix = ""
        fault_metrics = service_metrics = None
        if fault_row is not None:
            dropped, erased, corrupt, eff_k = fault_row
            for key, v in zip(FAULT_PATHS, fault_row):
                paths[key].append(v)
            fault_metrics = dict(dropped=dropped, erased=erased, corrupt=corrupt,
                                 effective_k=eff_k)
            suffix = (f" effK={eff_k:.0f} drop={dropped:.0f} "
                      f"erase={erased:.0f} corrupt={corrupt:.0f}")
        if service_row is not None:
            avail_m, absent_m, late_m, eff_k = service_row
            for key, v in zip(SERVICE_PATHS, service_row):
                paths[key].append(v)
            service_metrics = dict(available=avail_m, absent=absent_m, late=late_m,
                                   effective_k=eff_k)
            obs.emit("participation", round=round_idx, **service_metrics)
            suffix += f" avail={avail_m:.0f} effK={eff_k:.0f} late={late_m:.0f}"
        if defense_row is not None:
            events = defense_lib.events
            dm = events.round_metrics(defense_row)
            for key, path_key in events.PATH_KEYS.items():
                paths[path_key].append(dm[key])
            agg_name = events.active_agg(self.defense.mode, self.defense.ladder,
                                         int(dm["rung"]), cfg.agg)
            if obs.enabled:
                events.emit_round(obs, round_idx, mode=self.defense.mode, agg=agg_name,
                                  metrics=dm, prev_rung=self._prev_rung)
                self._prev_rung = int(dm["rung"])
            suffix += f" rung={int(dm['rung'])}({agg_name}) flag={dm['flagged']:.0f}"
        if obs.enabled:
            if forensic_row is not None:
                forensics_lib.emit_round_flags(obs, round_idx, forensic_row,
                                               mode=cfg.forensics)
            obs.round(round_idx, train_loss=tr_loss, train_acc=tr_acc, val_loss=va_loss,
                      val_acc=va_acc, variance=variance, rounds_per_sec=rate,
                      fault_metrics=fault_metrics, service_metrics=service_metrics,
                      memory=obs_lib.device_memory(self.device), **round_fields)
        return suffix

    def _roll_back(self, reason, snapshot, what: str, log, obs=None, round_idx=None,
                   va_loss=None) -> bool:
        """The rollback guard's trip: where ``reason`` names a divergence,
        a ``snapshot = (state, round)`` exists and rollbacks are left,
        restore the snapshot, widen the trim by ``rollback_widen`` and
        salt every later round's seeds with the new rollback count (the
        epoch).  Returns whether it rolled back; ``what`` names the
        diverged round or dispatch in the log line.  A trip emits a
        ``rollback`` event for ``round_idx`` on ``obs`` and, under
        ``--forensics full``, records the diverged state and dumps the
        flight recorder (JAX ``fed/train.py:2128-2190``)."""
        cfg = self.cfg
        if reason is None or snapshot is None or self._rollbacks_done >= cfg.rollback_max:
            return False
        obs = obs or obs_lib.NULL
        if self.flight_recorder is not None:
            # the diverged round's detector state, before the restore
            self._flight_record(round_idx, self.last_forensic_metrics,
                                dict(val_loss=va_loss, diverged=True, reason=reason))
        state, snap_round = snapshot
        self._set_state(_clone_state(state))
        avail, widen = self.service_state
        self.service_state = (
            avail, widen * torch.tensor(cfg.rollback_widen, dtype=torch.float32))
        self._rollbacks_done += 1
        self._rollback_epoch = self._rollbacks_done
        if obs.enabled:
            obs.emit("rollback", round=round_idx, restored_round=snap_round, reason=reason,
                     epoch=self._rollback_epoch, widen=float(widen) * cfg.rollback_widen)
        if self.flight_recorder is not None:
            self.flight_recorder.dump(round_idx, reason, obs=obs)
        log(
            f"[rollback {self._rollbacks_done}/{cfg.rollback_max}] {what} diverged "
            f"({reason}); restored round {snap_round}, trim widened x{cfg.rollback_widen:.2f}"
        )
        return True

    def _train_multi(self, paths, evals, eval_pair, log, checkpoint_fn, start_round,
                     obs=None, profiler=None):
        """The R > 1 driver (JAX ``_train_multi``, :2337-2690): dispatches of
        ``rounds_per_dispatch`` rounds (:meth:`run_rounds_stacked`), the
        record folded at each dispatch's end.

        * Eval runs at dispatch boundaries (every one, or every
          ``eval_interval`` rounds, and at the run's end); a dispatch's
          record entries repeat the last eval, since the params between
          its rounds never reach the host.
        * The per-round variance and fault, defense, service and forensic
          rows are kept exactly (stacked on the device, read once per
          dispatch); each round's events are emitted at fold time from
          those host rows.
        * Every round of a dispatch reports its rate ``n / dt``.
        * ``checkpoint_fn`` runs at boundaries, so a resume lands on one;
          a resumed run may open with an alignment dispatch and close with
          a tail dispatch (fewer rounds, the same graph).
        * Under ``--dispatch-mode degraded`` with service rollback armed,
          the guard judges a dispatch's last round at its boundary, and a
          trip restores the previous boundary's state and runs the whole
          dispatch again under salted draws.
        * With ``--dispatch-prefetch on`` a boundary with nothing to do on
          the host (no eval due, no guard armed, no checkpoint_fn, no
          flight recorder) folds its record after the next dispatch has
          been queued; the ``dispatch`` span then times the queueing only,
          with no sync.
        * The flight recorder (``--forensics full``) keeps one entry per
          dispatch, its last round's."""
        cfg = self.cfg
        obs = obs or obs_lib.NULL
        profiler = profiler or obs_lib.NULL_PROFILER
        tr_loss, tr_acc, va_loss, va_acc = evals
        R = cfg.rounds_per_dispatch
        eval_every = cfg.eval_interval or R
        prefetch = cfg.dispatch_prefetch == "on"
        rollback_armed = cfg.service == "on" and cfg.rollback == "on"
        snapshot = None
        recent_val: List[float] = []

        var_str = f" var={cfg.noise_var:.2e}" if cfg.noise_var is not None else ""

        def fold(r0, n, t0, dt, compiled, rows):
            """The dispatch's host rows into the paths, the events and one
            log line; ``dt`` None for a deferred fold, measured now."""
            var_l, fault_l, defense_l, service_l, forensic_l = rows
            if dt is None:
                dt = time.perf_counter() - t0
            suffix = ""
            for i in range(n):
                suffix = self._append_round(
                    paths, (tr_loss, tr_acc, va_loss, va_acc), var_l[i], n / dt,
                    None if fault_l is None else fault_l[i],
                    None if service_l is None else service_l[i],
                    None if defense_l is None else defense_l[i],
                    obs=obs, round_idx=r0 + i,
                    forensic_row=None if forensic_l is None else forensic_l[i],
                    round_secs=dt / n, compiled=compiled)
            if forensic_l is not None:
                self._flight_record(r0 + n - 1, forensic_l[-1],
                                    dict(val_loss=va_loss, val_acc=va_acc,
                                         variance=var_l[-1]))
            log(
                f"[{r0 + n}/{cfg.rounds}](interval: {cfg.display_interval}, dispatch: {n}) "
                f"train: loss={tr_loss:.4f} acc={tr_acc:.4f} "
                f"val: loss={va_loss:.4f} acc={va_acc:.4f}{var_str}{suffix}"
            )

        r = start_round
        pending = None  # a deferred fold: (r0, n, t0, compiled, host rows)
        while r < cfg.rounds:
            # an alignment dispatch on an unaligned resume, a tail at an
            # unaligned end; every other dispatch is R rounds
            rem = r % R
            n = min(R - rem if rem else R, cfg.rounds - r)
            end = r + n
            profiler.round_start(r)
            t0 = time.perf_counter()
            with obs.span("dispatch", ranged=False, round=r, rounds=n) as sp:
                # the first dispatch pays for the eager set-up or the
                # capture (obs/retrace.py)
                compiled = sp["compiled"] = r == start_round
                if self.dispatch_graph[0] and self.round_graph is None:
                    # the capture runs outside the profiler's trace, which
                    # would otherwise record into what is captured
                    self.round_graph = graphs_lib.RoundGraph(self)
                    with profiler.suspended():
                        self.round_graph.capture(r)
                with profiler.step(r):
                    host = _HostRows(self.run_rounds_stacked(r, n))
            if pending is not None:
                # the previous dispatch's fold, while the card runs this one
                p_r0, p_n, p_t0, p_compiled, p_host = pending
                fold(p_r0, p_n, p_t0, None, p_compiled, p_host.get())
                pending = None
            do_eval = end % eval_every == 0 or end >= cfg.rounds or rollback_armed
            sync = (not prefetch or do_eval or rollback_armed or checkpoint_fn is not None
                    or self.flight_recorder is not None or end >= cfg.rounds)
            if not sync:
                pending = (r, n, t0, compiled, host)
                profiler.round_end(r)
                r = end
                continue
            self._sync()
            dt = time.perf_counter() - t0
            rows = host.get()
            if do_eval:
                with (obs.span("eval", ranged=False, stage="round", round=end),
                      profiler.phase("eval")):
                    (tr_loss, tr_acc), (va_loss, va_acc) = eval_pair()
            # judged on the dispatch's last round; a trip re-runs the whole
            # dispatch from the previous boundary's state
            if rollback_armed and self._roll_back(
                    self._divergence(tr_loss, va_loss, rows[0][-1], recent_val), snapshot,
                    f"dispatch ending round {end}", log, obs, end - 1, va_loss):
                profiler.round_end(r)
                continue
            fold(r, n, t0, dt, compiled, rows)
            if rollback_armed:
                recent_val = (recent_val + [va_loss])[-ROLLBACK_WINDOW:]
                # a copy, taken before checkpoint_fn (as in the R = 1 loop)
                snapshot = (_clone_state(self._state()), end)
            if checkpoint_fn is not None:
                with (obs.span("checkpoint", ranged=False, round=end),
                      profiler.phase("checkpoint")):
                    checkpoint_fn(end, self, paths)
            profiler.round_end(r)
            r = end
        return paths
