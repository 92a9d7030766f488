"""Experiment harness: title, banner, per-round log, pickled record.

Port of the main-path surface of ``byzantine_aircomp_tpu/fed/harness.py``
(reference ``run``, ``MNIST_Air_weight.py:427-492``): the same title scheme
``{Model}_{opt}_{attack|baseline}_{agg}[_{var}][_{mark}]`` (``:446-455``),
the cache-path convention ``{name}_K{K}_B{B}_`` (``:546-550``) and the same
record keys, including the ``variencePath`` spelling (``:481-489``), so the
reference's analysis reads the port's records unchanged.

Checkpoint and resume follow the JAX harness (``fed/harness.py:407-501``,
``:670-742``): with ``checkpoint_dir`` set, the params and the extra state
(:func:`extra_state`) are written after every round (every dispatch under
``--rounds-per-dispatch``) under :func:`ckpt_title`, and ``inherit``
resumes from them.  With ``--async-writer`` on (``auto``: iff R > 1) the
checkpoint writes and the record pickle ride a writer thread
(:mod:`..obs.writer`), drained before the run returns.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .. import obs as obs_lib
from ..utils import io as io_lib
from . import checkpoint
from .config import FedConfig
from ..defense import events as defense_events
from .train import FAULT_PATHS, SERVICE_PATHS, Trainer
from ..parallel import multihost


# the log's routing, set per run by configure_log: the --log-file tee and
# the --quiet gate (module globals, since every caller of `log` shares them)
_LOG_FILE = None
_QUIET = False


def configure_log(log_file: str = "", quiet: bool = False):
    """Route :func:`log` and the banner (JAX ``fed/harness.py:39-66``): tee
    to ``log_file`` (appended, flushed per line) and/or silence stdout.
    Returns a zero-argument restore callable, so sequential runs in one
    process never inherit a previous run's routing."""
    global _LOG_FILE, _QUIET
    prev = (_LOG_FILE, _QUIET)
    _LOG_FILE = io_lib.open_append(log_file) if log_file else None
    _QUIET = quiet

    def restore():
        global _LOG_FILE, _QUIET
        if _LOG_FILE is not None:
            _LOG_FILE.close()
        _LOG_FILE, _QUIET = prev

    return restore


def _emit_line(line: str):
    """One log line to the configured outputs, flushed."""
    if not _QUIET:
        print(line)
        sys.stdout.flush()
    if _LOG_FILE is not None:
        _LOG_FILE.write(line + "\n")
        _LOG_FILE.flush()


def log(*k, **kw):
    """Timestamped logging (reference ``log``, ``:40-44``), routed by
    :func:`configure_log`."""
    stamp = time.strftime("[%m-%d %H:%M:%S] ", time.localtime())
    _emit_line(stamp + kw.get("sep", " ").join(str(x) for x in k))


_CFG_DEFAULTS = {f.name: f.default for f in dataclasses.fields(FedConfig)}


def _non_default(cfg: FedConfig, name: str) -> bool:
    return getattr(cfg, name) != _CFG_DEFAULTS[name]


def run_title(cfg: FedConfig) -> str:
    """The JAX harness's title (``fed/harness.py:85``) for the knobs the
    port has: each suffix appears only off its default, so a reference-
    equivalent run keeps the reference's title."""
    attack_name = cfg.attack if cfg.attack is not None else "baseline"
    title = f"{cfg.model}_{cfg.opt}_{attack_name}_{cfg.agg}"
    if cfg.noise_var is not None:
        title += f"_{cfg.noise_var}"
    if _non_default(cfg, "local_steps"):
        title += f"_E{cfg.local_steps}"
    if cfg.fedprox_mu:
        title += f"_prox{cfg.fedprox_mu}"
    if cfg.server_opt == "momentum":
        title += f"_momentum{cfg.server_lr}m{cfg.server_momentum}"
    elif cfg.server_opt != "none":
        title += f"_{cfg.server_opt}{cfg.server_lr}"
    if cfg.client_momentum:
        title += f"_cm{cfg.client_momentum}"
    if cfg.attack_param is not None:
        title += f"_ap{cfg.attack_param}"
    if cfg.krum_m is not None:
        title += f"_m{cfg.krum_m}"
    if _non_default(cfg, "clip_tau"):
        title += f"_tau{cfg.clip_tau}"
    elif cfg.agg == "cclip":
        # the JAX package spells the adaptive radius out, so that its runs
        # never alias its older fixed-radius ones
        title += "_tauadaptive"
    if _non_default(cfg, "clip_iters"):
        title += f"_ci{cfg.clip_iters}"
    if cfg.sign_eta is not None:
        title += f"_eta{cfg.sign_eta}"
    for knob, tag in (("sign_bits", "sb"), ("dnc_iters", "di"), ("dnc_sub_dim", "ds"),
                      ("dnc_c", "dc")):
        if _non_default(cfg, knob):
            title += f"_{tag}{getattr(cfg, knob)}"
    if cfg.partition == "dirichlet":
        title += f"_dir{cfg.dirichlet_alpha}"
    if cfg.size_skew != "none":
        title += f"_skew{cfg.size_skew.replace(':', '')}"
    if cfg.participation < 1.0:
        title += f"_part{cfg.participation}"
    if cfg.bucket_size > 1:
        title += f"_bkt{cfg.bucket_size}"
    if cfg.cohort_size > 0:
        # the streamed round adds in another order and draws each chunk's
        # terms apart: its runs never alias resident ones
        title += f"_cohort{cfg.cohort_size}"
        for knob in FedConfig._COHORT_KNOBS:
            if _non_default(cfg, knob):
                title += f"_{knob.replace('cohort_', '')}{getattr(cfg, knob)}"
    if cfg.service == "on":
        # (JAX fed/harness.py:145-160) then the service knobs
        title += f"_pop{cfg.population}_sub{cfg.node_size}"
        for knob in FedConfig._SERVICE_KNOBS:
            if knob != "population" and _non_default(cfg, knob):
                title += f"_{knob.replace('_', '')}{getattr(cfg, knob)}"
    if cfg.pop_shards > 1:
        # (JAX fed/harness.py:161-165): the shard fold adds the float
        # partial sums in another order, so the lineage forks
        title += f"_ps{cfg.pop_shards}"
    if cfg.rounds_per_dispatch > 1:
        # (JAX fed/harness.py:166-175): boundary eval and checkpoints, so
        # its runs never alias the per-round loop's
        title += f"_rd{cfg.rounds_per_dispatch}"
        if _non_default(cfg, "eval_interval"):
            title += f"_ev{cfg.eval_interval}"
        if _non_default(cfg, "dispatch_mode"):
            title += f"_{cfg.dispatch_mode}"
    if _non_default(cfg, "prng_impl"):
        title += f"_prng{cfg.prng_impl}"
    if _non_default(cfg, "stack_dtype"):
        # (JAX fed/harness.py:176-181): prefixed, so that it never reads
        # as a --mark bf16 of a default-dtype run
        title += f"_stack{cfg.stack_dtype}"
    if cfg.fault is not None:
        title += f"_fault{cfg.fault}"
        for knob, val in sorted(cfg.fault_overrides().items()):
            title += f"_{knob.replace('_', '')}{val}"
    if cfg.defense != "off":
        # the mode and its non-default knobs (JAX fed/harness.py:189-195);
        # an off run keeps the title it had before the defense was ported
        title += f"_def{cfg.defense}"
        for knob in FedConfig._DEFENSE_KNOBS:
            if _non_default(cfg, knob):
                val = str(getattr(cfg, knob)).replace(",", "-")
                title += f"_{knob.replace('_', '')}{val}"
    if cfg.mark:
        title += f"_{cfg.mark}"
    return title


# fields that never change the trajectory, and so never split a checkpoint's
# identity: the JAX harness's unconditional skip list (``fed/harness.py:219``)
# as far as the port has the fields.  ``rounds`` is the horizon that
# ``inherit`` exists to extend; the writer thread and the dispatch prefetch
# change when bytes reach the disk and the host folds, not the records; the
# observability knobs, live telemetry among them, add outputs only (JAX
# :224-237)
_HASH_SKIP = ("checkpoint_dir", "cache_dir", "inherit", "rounds", "async_writer",
              "dispatch_prefetch") + FedConfig._OBS_FIELDS

# fields skipped while at their default, so that a config that leaves them
# there hashes as it did before the field was ported: the sign channel's
# width, the size skew, the training options, the implementation knobs and
# the execution layout
_HASH_SKIP_AT_DEFAULT = (
    "sign_bits", "size_skew", "local_steps", "fedprox_mu", "server_opt", "server_lr",
    "server_momentum", "client_momentum", "participation", "bucket_size",
    "agg_impl", "fused_epilogue", "stack_dtype", "prng_impl", "sharded", "model_parallel",
)


def config_hash(cfg: FedConfig) -> str:
    """Short stable digest of every result-affecting config field: sha256
    over the sorted ``(name, repr(value))`` pairs of every field but the
    skip list, the JAX harness's scheme (``fed/harness.py:205-300``).
    ``run_title`` leaves out the seed, the sizes, the data set and more, so
    two cells that share a title could otherwise resume each other's state.
    As in the JAX package, ``sign_bits`` is skipped at its default 32,
    ``size_skew`` at its default "none", the defense's fields while it is
    off, the cohort fields at ``cohort_size`` 0, the service fields
    while it is off (``fed/harness.py:248-264``), the dispatch fields at
    ``rounds_per_dispatch`` 1 and the writer and prefetch knobs always
    (:280-286, :242); the training options are skipped
    at their defaults too (:data:`_HASH_SKIP_AT_DEFAULT`), so a default run
    keeps the hash it had before they were ported.  The
    digest is NOT the JAX package's for the same run: the two FedConfigs
    hold different field sets, so their pairs differ."""
    skip = _HASH_SKIP + tuple(k for k in _HASH_SKIP_AT_DEFAULT if not _non_default(cfg, k))
    if cfg.defense == "off":
        skip += ("defense",) + FedConfig._DEFENSE_KNOBS
    # (JAX fed/harness.py:254-264): a config without cohorts or service
    # hashes as it did before those fields were ported
    if cfg.cohort_size == 0:
        skip += ("cohort_size",) + FedConfig._COHORT_KNOBS
    if cfg.service == "off":
        skip += ("service",) + FedConfig._SERVICE_KNOBS
    if cfg.rounds_per_dispatch == 1:
        # (JAX fed/harness.py:280-286): an R = 1 config hashes as it did
        # before the dispatch fields were ported
        skip += ("rounds_per_dispatch",) + FedConfig._DISPATCH_KNOBS
    if cfg.pop_shards == 1:
        # (JAX fed/harness.py:265-270): the single chunk loop hashes as it
        # did before population shards were ported
        skip += ("pop_shards",)
    items = sorted(
        (f.name, repr(getattr(cfg, f.name)))
        for f in dataclasses.fields(cfg)
        if f.name not in skip
    )
    return hashlib.sha256(repr(items).encode()).hexdigest()[:8]


def ckpt_title(cfg: FedConfig) -> str:
    """Checkpoint key: the run title plus the config hash, so two configs
    share saved state only when every result-affecting field matches.
    Pickled records keep the bare :func:`run_title`."""
    return f"{run_title(cfg)}_c{config_hash(cfg)}"


def run_namespace(cfg: FedConfig, run_id: str, root: str) -> FedConfig:
    """Rebase every output path onto the run's private subtree
    ``<root>/<run_id>/``, the experiment server's tenancy boundary (JAX
    ``fed/harness.py:303-322``).  Every rewritten field is one the config
    hash skips, so the namespaced config keeps the submitted one's
    identity."""
    ns = os.path.join(root, run_id)
    os.makedirs(ns, exist_ok=True)
    return dataclasses.replace(
        cfg,
        obs_dir=ns,
        checkpoint_dir=os.path.join(ns, "ckpt"),
        cache_dir=os.path.join(ns, "cache"),
        profile_dir=os.path.join(ns, "profile"),
        log_file="",
    )


def cache_path(cfg: FedConfig, dataset_name: str) -> str:
    cache_dir = cfg.cache_dir or f"./{dataset_name.upper()}_Air_weight_torch/"
    os.makedirs(cache_dir, exist_ok=True)
    prefix = f"{dataset_name}_K{cfg.node_size}_B{cfg.byz_size}_"
    return os.path.join(cache_dir, prefix + run_title(cfg))


def banner(cfg: FedConfig, trainer: Trainer, path: str):
    n_params = trainer.dim
    if n_params >= 2**20:
        p_str = f"{n_params / 2**20:.2f}M"
    elif n_params >= 2**10:
        p_str = f"{n_params / 2**10:.2f}K"
    else:
        p_str = str(n_params)
    attack_name = cfg.attack if cfg.attack is not None else "baseline"
    ds = trainer.dataset
    dev = trainer.device
    dev_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    impl_desc = "CUDA kernels" if trainer._agg_impl == "pallas" else "plain torch versions"
    lines = [
        f"[submit task ] {path}",
        "[running info]",
        f"[network info]   name={cfg.model} parameters number={p_str}",
        f"[optimization]   name={cfg.opt} aggregation={cfg.agg} attack={attack_name}",
        f"[dataset info] name={ds.name} source={ds.source} "
        f"trainSize={len(ds.x_train)} validationSize={len(ds.x_val)}",
        f"[optimizer   ] gamma={cfg.gamma} weight_decay={cfg.weight_decay} "
        f"batchSize={cfg.batch_size}",
        f"[node number ]   honestSize={cfg.honest_size}, byzantineSize={cfg.byz_size}",
        f"[running time]   rounds={cfg.rounds}, displayInterval={cfg.display_interval}",
        f"[torch set   ]  device={dev} ({dev_name}) torch={torch.__version__} "
        f"SEED={cfg.seed}, fixSeed={cfg.fix_seed}",
        f"[kernels     ]   aggImpl={trainer._agg_impl} ({impl_desc}) "
        f"channelFold={'on' if trainer.channel_fused else 'off'} "
        f"stackDtype={cfg.stack_dtype} prng={cfg.prng_impl}",
        f"[data reader ]   {ds.reader}",
    ]
    layout = getattr(trainer, "layout_desc", None)
    if layout is not None:
        lines.append(f"[layout      ]   {layout}")
    if cfg.rounds_per_dispatch > 1:
        graphed, reason = trainer.dispatch_graph
        lines.append(
            f"[dispatch    ]   roundsPerDispatch={cfg.rounds_per_dispatch} "
            f"evalInterval={cfg.eval_interval} mode={cfg.dispatch_mode} "
            f"prefetch={cfg.dispatch_prefetch} asyncWriter={cfg.async_writer} "
            f"cudaGraph={'yes' if graphed else 'no'} ({reason})"
        )
    lines.append("-------------------------------------------")
    for line in lines:
        _emit_line(line)


def build_record(
    cfg: FedConfig,
    paths: Dict[str, list],
    *,
    dataset_name: str,
    dataset_size: int,
    max_feature: int,
) -> Dict:
    """The reference-format pickled record from a finished run's paths."""
    record = {
        # dataset config block (reference dataSetConfig, :536-541)
        "name": dataset_name,
        "dataSet": dataset_name,
        "dataSetSize": dataset_size,
        "maxFeature": max_feature,
        # config block with callables already as names (reference :474-479)
        "honestSize": cfg.honest_size,
        "byzantineSize": cfg.byz_size,
        "rounds": cfg.rounds,
        "displayInterval": cfg.display_interval,
        "weight_decay": cfg.weight_decay,
        "fixSeed": cfg.fix_seed,
        "SEED": cfg.seed,
        "batchSize": cfg.batch_size,
        "gamma": cfg.gamma,
        "aggregate": cfg.agg,
        "attack": cfg.attack,
        "noise_var": cfg.noise_var,
        "model": cfg.model,
        # metric paths (reference :481-489)
        "trainLossPath": paths["trainLossPath"],
        "trainAccPath": paths["trainAccPath"],
        "valLossPath": paths["valLossPath"],
        "valAccPath": paths["valAccPath"],
        "variencePath": paths["variencePath"],
        # framework extras
        "roundsPerSec": paths["roundsPerSec"],
    }
    if cfg.fault is not None:
        record["fault"] = cfg.fault
        record["faultOverrides"] = cfg.fault_overrides()
        for key in FAULT_PATHS:
            record[key] = paths[key]
    if cfg.defense != "off":
        record["defense"] = cfg.defense
        record["defenseLadder"] = list(cfg.defense_ladder_names())
        for key in defense_events.PATH_KEYS.values():
            record[key] = paths[key]
    if cfg.service == "on":
        record["service"] = cfg.service
        record["population"] = cfg.population
        for key in SERVICE_PATHS:
            record[key] = paths[key]
    return record


def extra_state(t: Trainer) -> list:
    """Everything beyond the flat params that a resume needs, as a flat
    list of leaves in the JAX harness's order (``fed/harness.py:407``):
    ``(server_opt, client_m, fault_state, defense, attack_iter, service,
    epoch)``: the server optimizer's state in optax's leaf order
    (``[trace]`` or ``[count, mu, nu]``), the [K, d] client momentum, the
    fault state (its stale buffer and Gilbert-Elliott states, each only
    where the fault uses it), the detector's (step, ema, dev, cusum) and the
    policy's (rung, up, down, budget), the onset counter, the service state
    (availability [population] bool, trim widening f32) and the rollback
    epoch (int32), each only when its feature is on.  The order is the
    checkpoint contract: the JAX package reads a port checkpoint of the
    same config leaf for leaf, and the reverse."""
    leaves = []
    client_m, fault_state = t.checkpoint_carries()
    if t.server_opt_state is not None:
        leaves += list(t.server_opt_state)
    if client_m is not None:
        leaves.append(client_m)
    if fault_state is not None:
        leaves += [x for x in fault_state if x is not None]
    if t.defense_state is not None:
        det, pol = t.defense_state
        leaves += list(det) + list(pol)
    if t.attack_iter is not None:
        leaves.append(t.attack_iter)
    if t.service_state is not None:
        leaves += list(t.service_state)
        leaves.append(torch.tensor(t._rollback_epoch, dtype=torch.int32))
    return leaves


def restore_trainer(trainer: Trainer, restored, log_fn=None) -> int:
    """Install a :func:`checkpoint.load` result into a freshly built
    trainer; returns the round to resume from.  On a leaf-count mismatch
    it warns and keeps the extra state fresh: the params alone still
    resume the trajectory (JAX ``fed/harness.py:431-480``)."""
    from ..ops import faults as fault_lib

    log_fn = log_fn or log
    start_round, flat, extra_leaves = restored
    dev = trainer.device
    trainer.flat_params = torch.from_numpy(np.array(flat, np.float32)).to(dev)
    own = extra_state(trainer)
    if len(extra_leaves) == len(own) and extra_leaves:
        leaves = iter(
            torch.from_numpy(np.array(leaf)).to(dev).to(o.dtype).reshape(o.shape)
            for leaf, o in zip(extra_leaves, own)
        )
        if trainer.server_opt_state is not None:
            trainer.server_opt_state = tuple(next(leaves) for _ in trainer.server_opt_state)
        client_m, fault_state = trainer.checkpoint_carries()
        if client_m is not None:
            client_m = next(leaves)
        if fault_state is not None:
            fault_state = fault_lib.FaultState(
                *(None if x is None else next(leaves) for x in fault_state))
        trainer.restore_carries(client_m, fault_state)
        if trainer.defense_state is not None:
            det, pol = trainer.defense_state
            trainer.defense_state = (tuple(next(leaves) for _ in det),
                                     tuple(next(leaves) for _ in pol))
        if trainer.attack_iter is not None:
            trainer.attack_iter = next(leaves)
        if trainer.service_state is not None:
            trainer.service_state = (next(leaves), next(leaves))
            # the epoch is the count of rollbacks so far: one saved scalar
            # restores both the seeds' salt and the budget
            trainer._rollback_epoch = trainer._rollbacks_done = int(next(leaves))
    elif len(extra_leaves) != len(own):
        log_fn(
            f"WARNING: checkpoint extra state ({len(extra_leaves)} leaves) does "
            f"not match this config ({len(own)}); starting the server-opt, "
            "client-momentum, fault, defense, attack-onset and service state fresh"
        )
    return start_round


#: paths whose index 0 is the pre-training eval: a resumed run re-evaluates
#: the checkpointed params as its index 0, a bitwise duplicate of the
#: prefix's last entry, so the merge drops it
_EVAL_PATH_KEYS = ("trainLossPath", "trainAccPath", "valLossPath", "valAccPath")


def merge_paths(prefix: Dict[str, list], current: Dict[str, list]) -> Dict[str, list]:
    """Join a checkpointed paths prefix to a resumed run's paths, so the
    merged record reads as one uninterrupted run (floats round-trip
    bitwise through the checkpoint's JSON; only ``roundsPerSec``, a host
    clock reading, differs) (JAX ``fed/harness.py:489-501``)."""
    merged: Dict[str, list] = {}
    for key, cur in current.items():
        pre = prefix.get(key) or []
        if pre and key in _EVAL_PATH_KEYS:
            merged[key] = list(pre) + list(cur[1:])
        else:
            merged[key] = list(pre) + list(cur)
    return merged


def run(cfg: FedConfig, device: str = "cuda", record_in_file: bool = True) -> Dict:
    """Build a trainer on ``device``, run the full schedule, pickle the
    record (reference ``run``, ``:427-492``).  With no attack the
    Byzantine count is zeroed (``:430-431``)."""
    return run_with_trainer(cfg, device, record_in_file)[1]


def run_with_trainer(
    cfg: FedConfig, device: str = "cuda", record_in_file: bool = True, dataset=None,
    on_round: Optional[Callable[[int, Trainer], None]] = None,
) -> Tuple[Trainer, Dict]:
    """:func:`run`, also returning the finished trainer (its final
    ``flat_params``) for callers that check the trained state.  ``dataset``
    replaces the one ``cfg.dataset`` names at its default size.
    ``on_round(r, trainer)`` runs after each round's checkpoint (each
    dispatch's under ``--rounds-per-dispatch``), with ``r`` the rounds done
    (the JAX harness's ``on_checkpoint``, here also without a checkpoint
    directory; a smoke run injects a divergence through it).

    With ``cfg.checkpoint_dir`` set, every round ends in a checkpoint under
    :func:`ckpt_title` that also holds the whole run's paths so far as its
    ``meta`` (the JAX harness's ``persist_paths``, always on here, so that a
    resumed run pickles the whole run's record, through any number of
    resumes); with ``cfg.inherit`` the run resumes from that checkpoint,
    and the saved paths prefix is joined to the resumed run's
    (:func:`merge_paths`).  A torn or unreadable checkpoint restarts from
    round 0, with one log line.

    With ``--obs-dir`` / ``--obs-stdout`` set, the JAX package's schema-v10
    event stream is written beside the pickled record (JAX
    ``fed/harness.py:569-1010``): ``run_start`` (with the aggregation's
    ``hbm`` traffic block), the ``setup`` span, the trainer's round events,
    ``profile`` (``--profile-dir``), ``retrace``, the flight recorder's
    run-end ``forensic_dump`` (``--forensics full``) and ``run_end`` with
    the ``memory`` block (the card's peak against :func:`modeled_peak`).
    ``--trace on`` wraps the run in a ``run`` span.  ``--log-file`` tees
    and ``--quiet`` silences the log for the run's duration.
    ``--metrics``/``--metrics-port``/``--alerts`` fold the same events into
    a metrics registry, serve it (``obs.exporter``, closed with the sinks)
    and evaluate the alert rules after each round's events; the run ends
    with the alert summary and a ``metrics_snapshot`` event
    (:func:`_telemetry_epilogue`).

    With the writer thread on (:func:`..obs.resolve_async`) each
    checkpoint is copied to the host here and written by the writer as one
    task, the event appends ride it too, the record pickle rides it last,
    and the writer is drained before the sinks close and closed before this
    returns, on success or failure (JAX ``fed/harness.py:599-645``,
    :994-999)."""
    if cfg.attack is None:
        cfg.byz_size = 0
    cfg.validate()
    restore_log = configure_log(cfg.log_file, cfg.quiet)
    writer = obs_lib.WriterThread() if obs_lib.resolve_async(cfg) else None
    obs = obs_lib.from_config(cfg, ckpt_title(cfg), writer=writer)
    try:
        if cfg.metrics_port > 0:
            # up before the trainer is built, so /metrics answers during the
            # set-up and the capture; obs.close() below shuts it down on run
            # end and crash alike.  A failed bind raises here
            obs.exporter = obs_lib.MetricsExporter(
                obs.registry, port=cfg.metrics_port,
                health_fn=obs.metrics_sink.health).start()
            log(f"Serving /metrics and /healthz on port {obs.exporter.port}")
        if obs.traced:
            # the trace root: every span of the run nests under this one
            with obs.span("run", title=ckpt_title(cfg)):
                return _run_inner(cfg, device, record_in_file, dataset, on_round, writer,
                                  obs)
        return _run_inner(cfg, device, record_in_file, dataset, on_round, writer, obs)
    finally:
        # every enqueued append, checkpoint and pickle lands before the
        # sinks close, on a crash too
        if writer is not None:
            writer.drain()
        obs.close()
        if writer is not None:
            writer.close()
        restore_log()


def _data_bytes(cfg: FedConfig, trainer: Trainer) -> int:
    """What the trainer keeps on the card for the whole run: the train rows
    and labels, the shards' offsets and sizes, and the eval caches the
    initial eval allocates (the val split, and the train split when
    ``eval_train``: f32 rows and int64 labels)."""
    held = sum(t.numel() * t.element_size()
               for t in (trainer.x_train, trainer.y_train, trainer.offsets, trainer.sizes))
    ds = trainer.dataset
    feats = int(np.prod(ds.input_shape))
    splits = [len(ds.x_val)] + ([len(ds.x_train)] if cfg.eval_train else [])
    return held + sum(n * (4 * feats + 8) for n in splits)


def modeled_peak(cfg: FedConfig, trainer: Trainer) -> Tuple[int, Dict[str, int]]:
    """The port's memory model of ``cfg``'s run on the card
    (:func:`..obs.hbm.cuda_peak_bytes`) and its terms: the data, the
    stacks (K rows resident, ``cohort_size`` streamed), the channel terms
    of a rule that takes them, and the client step's working set from the
    model's layer shapes (:func:`..obs.hbm.per_sample_bytes`)."""
    from ..obs import hbm as hbm_lib
    from ..ops import aggregators as agg_lib

    streamed = cfg.cohort_size > 0
    part_h, part_b = cfg.participant_counts()
    rows = cfg.cohort_size if streamed else part_h + part_b
    ds = trainer.dataset
    spatial = getattr(type(trainer.model), "SPATIAL_INPUT", True)
    shape = tuple(ds.input_shape) if spatial else (int(np.prod(ds.input_shape)),)
    input_bytes, act_bytes = hbm_lib.per_sample_bytes(trainer.model, shape, cfg.remat)
    data_attack = trainer.attack is not None and trainer.attack.data_fn is not None
    client = hbm_lib.client_step_bytes(
        rows * cfg.local_steps * cfg.batch_size, input_bytes, act_bytes,
        input_copies=2 if data_attack else 1)
    channel = 2 if cfg.noise_var is not None and agg_lib.needs_oma_prepass(cfg.agg) else 0
    state_pc = 0
    if streamed:
        # the O(K) per-client state that survives streaming (JAX
        # fed/harness.py:884-903)
        if cfg.defense != "off":
            state_pc += 3 * 4
        if cfg.fault is not None:
            state_pc += 1
        if cfg.service == "on":
            per = cfg.population // cfg.node_size
            state_pc += per + ((per - 1) * 3 * 4 if cfg.defense != "off" else 0)
    data = _data_bytes(cfg, trainer)
    modeled = hbm_lib.cuda_peak_bytes(
        rows, trainer.dim, client_bytes=client, data_bytes=data, channel_copies=channel,
        param_copies=6 if streamed else 4, state_bytes=state_pc * cfg.node_size)
    # population shards (JAX obs/hbm.py streamed_peak_bytes): the merge
    # holds the S partial carries (the [d] float sums, the per-client rows)
    # at once, on each rank of the process group as in one process
    merge = (cfg.pop_shards - 1) * (6 * trainer.dim * 4 + state_pc * cfg.node_size)
    terms = dict(rows=rows, data_bytes=data, stack_bytes=rows * trainer.dim * 4,
                 channel_copies=channel, client_step_bytes=client,
                 input_bytes_per_sample=input_bytes, activation_bytes_per_sample=act_bytes,
                 pop_shard_merge_bytes=merge)
    return modeled + merge, terms


def _memory_block(cfg: FedConfig, trainer: Trainer, baseline: Optional[int]) -> Dict:
    """The ``run_end`` memory block: the device's watermarks, the port's
    model (:func:`modeled_peak`) beside the JAX package's, and whether the
    run's own peak (``max_memory_allocated`` since the run started, less
    what was allocated before it) exceeds ``hbm_warn_factor`` x the model.
    Only a ``device:`` source is judged: a host RSS holds the interpreter."""
    from ..obs import hbm as hbm_lib
    from ..obs import profile as profile_lib

    memory = dict(profile_lib.device_memory(trainer.device))
    modeled, terms = modeled_peak(cfg, trainer)
    memory["hbm_model"] = ("resident" if cfg.cohort_size == 0 else
                           "streamed_per_host" if cfg.pop_shards > 1 else "streamed")
    memory["modeled_peak_bytes"] = modeled
    memory["model_terms"] = terms
    memory["jax_modeled_peak_bytes"] = (
        hbm_lib.streamed_peak_bytes(cfg.node_size, trainer.dim, cfg.cohort_size,
                                    data_bytes=terms["data_bytes"],
                                    pop_shards=cfg.pop_shards)
        if cfg.cohort_size > 0 else
        hbm_lib.modeled_peak_bytes(cfg.node_size, trainer.dim, data_bytes=terms["data_bytes"]))
    memory["warn_factor"] = cfg.hbm_warn_factor
    on_device = str(memory["source"]).startswith("device")
    if on_device and baseline is not None:
        memory["baseline_bytes"] = baseline
        memory["run_peak_bytes"] = memory["peak_bytes_in_use"] - baseline
        memory["measured_over_modeled"] = memory["run_peak_bytes"] / modeled
    exceeds = on_device and memory.get("run_peak_bytes", 0) > cfg.hbm_warn_factor * modeled
    memory["exceeds_model"] = bool(exceeds)
    if exceeds:
        log(f"WARNING: measured device peak {memory['run_peak_bytes']} bytes exceeds "
            f"{cfg.hbm_warn_factor:g}x the modeled peak {modeled} bytes (obs/hbm "
            f"{memory['hbm_model']} model) — an allocation the model does not account "
            "for is resident")
    return memory


def _retrace(trainer: Trainer, rounds_run: int):
    """The programs ``trainer`` built in its run (obs/retrace.py): its
    CUDA-graph captures (``RoundGraph.captures``), and the eager round's
    one-time set-up where it ran a round eagerly."""
    from ..obs import RetraceDetector

    retrace = RetraceDetector()
    rg = trainer.round_graph
    for _ in range(rg.captures if rg is not None else 0):
        retrace.build("multi_round_fn")
    if rounds_run and not trainer.dispatch_graph[0]:
        retrace.build("round_fn")
    return retrace


def _telemetry_epilogue(cfg: FedConfig, obs) -> None:
    """The run's end under ``--metrics``/``--alerts`` (JAX
    ``fed/harness.py:960-983``): one last rule evaluation (the retrace and
    memory gauges exist only after the run_end fold), the alert summary on
    the log, and the registry's snapshot as a ``metrics_snapshot`` event."""
    last_round = max(cfg.rounds - 1, 0)
    alert_summary = None
    if obs.alert_engine is not None:
        alert_summary = obs.alert_engine.finalize(last_round, obs.sink)
        fired = {name: info["fired"] for name, info in alert_summary["rules"].items()
                 if info["fired"]}
        if fired:
            log(f"ALERTS: {alert_summary['total_fired']} fired "
                f"(worst severity {alert_summary['worst']}): {fired}")
        else:
            log("ALERTS: none fired")
    if obs.registry is not None:
        obs.emit("metrics_snapshot", round=last_round, metrics=obs.registry.snapshot(),
                 alerts=alert_summary)


# the rules whose collective form ``--sharding auto`` does not pick: each
# Weiszfeld step of it is host-launched ops and an all_reduce, which on one
# H100 rank ran an iteration 3.1x (gm2 K=1000) to 10x (gm --var K=50) slower
# than the one-device loop (PERF.md, run z14b), and no run over several
# cards shows the split paying; ``--sharding on`` still picks it
AUTO_UNSHARDED_RULES = ("gm", "gm2")


def make_trainer(cfg: FedConfig, dataset=None, device: str = "cuda") -> Trainer:
    """Pick the execution layout as the JAX harness's ``_make_trainer``
    (``fed/harness.py:372-405``) does, keyed on the process group's world
    size where JAX reads its device count: population shards over the
    group's ranks (``pop_shards`` > 1 and a group of exactly that size; the
    sequential engine with fewer ranks or ``sharded=False``; a larger group
    is refused, where JAX runs on its first ``pop_shards`` devices); else
    the clients sharded over the (clients, model) grid of ranks when that
    buys parallelism (``sharded=None`` is auto: several ranks, K divisible
    by the clients axis, and a rule not in :data:`AUTO_UNSHARDED_RULES`) or
    when forced; else the one-device trainer."""
    from ..parallel import PopShardedFedTrainer, ShardedFedTrainer
    from ..parallel import mesh as mesh_lib

    n_dev = multihost.process_count()
    if cfg.pop_shards > 1:
        if cfg.sharded is not False and n_dev > cfg.pop_shards:
            raise ValueError(
                f"pop_shards={cfg.pop_shards} runs one shard per rank, but the process "
                f"group has {n_dev} ranks: start {cfg.pop_shards} processes, or use the "
                "sequential engine with --sharding off")
        if cfg.sharded is not False and n_dev == cfg.pop_shards:
            log(f"Population-sharded execution over {cfg.pop_shards} ranks")
            return PopShardedFedTrainer(cfg, dataset=dataset, device=device)
        log(f"Population shards x{cfg.pop_shards} (sequential engine)")
        return Trainer(cfg, dataset=dataset, device=device)
    n_model = cfg.model_parallel or 1
    n_clients_axis = n_dev // n_model if n_dev % n_model == 0 else 0
    auto = n_dev > 1 and bool(n_clients_axis) and cfg.node_size % n_clients_axis == 0
    if auto and cfg.sharded is None and cfg.agg in AUTO_UNSHARDED_RULES:
        log(f"One-device execution on every rank: --sharding auto keeps {cfg.agg} "
            "unsharded (its per-step all_reduce costs more than the step; "
            "--sharding on splits it)")
        auto = False
    if auto if cfg.sharded is None else cfg.sharded:
        mesh = mesh_lib.make_mesh(model_parallel=cfg.model_parallel)
        log(f"Sharded execution over mesh {mesh.describe()}")
        return ShardedFedTrainer(cfg, dataset=dataset, device=device, mesh=mesh)
    return Trainer(cfg, dataset=dataset, device=device)


def _run_inner(cfg, device, record_in_file, dataset, on_round, writer, obs):
    from ..device import resolve_device
    from ..obs import hbm as hbm_lib
    from ..obs import profile as profile_lib

    baseline = None
    dev = resolve_device(device)
    if obs.enabled and dev.type == "cuda":
        # the run's own peak: the watermark restarts here, and what is
        # allocated already is the caller's
        torch.cuda.reset_peak_memory_stats(dev)
        baseline = torch.cuda.memory_allocated(dev)
    with obs.span("setup", stage="trainer_init"):
        trainer = make_trainer(cfg, dataset=dataset, device=device)
    # in a process group every rank runs the whole schedule; rank 0 alone
    # writes the record and the npz checkpoints
    primary = multihost.process_index() == 0
    record_in_file = record_in_file and primary
    path = cache_path(cfg, trainer.dataset.name)
    banner(cfg, trainer, path)

    start_round = 0
    checkpoint_fn = None
    resume_prefix: Optional[Dict[str, list]] = None
    title = ckpt_title(cfg)
    if cfg.checkpoint_dir:
        def checkpoint_fn(r, t, so_far):
            if resume_prefix:
                so_far = merge_paths(resume_prefix, so_far)
            # every rank gathers the carries a layout keeps by rows
            leaves = extra_state(t)
            if primary:
                checkpoint.save(cfg.checkpoint_dir, title, r, t.flat_params,
                                leaves, meta=json.dumps(so_far), writer=writer)
            if on_round is not None:
                on_round(r, t)

        if cfg.inherit:
            try:
                restored = checkpoint.load(cfg.checkpoint_dir, title)
                meta = checkpoint.load_meta(cfg.checkpoint_dir, title)
            except Exception as exc:  # a torn or corrupt npz
                log(f"Unreadable checkpoint ({type(exc).__name__}: {exc}); "
                    "restarting from round 0")
                restored = meta = None
            if restored is not None:
                if meta is not None:
                    # read before the resumed run's checkpoints overwrite it
                    resume_prefix = json.loads(meta)
                start_round = restore_trainer(trainer, restored)
                log(f"Resumed from checkpoint at round {start_round}")
    elif on_round is not None:
        def checkpoint_fn(r, t, so_far):
            on_round(r, t)

    if obs.enabled:
        extra = {}
        if cfg.service == "on":
            extra = dict(service=cfg.service, population=cfg.population,
                         churn_arrival=cfg.churn_arrival,
                         churn_departure=cfg.churn_departure,
                         straggler_prob=cfg.straggler_prob, rollback=cfg.rollback)
        if cfg.forensics != "off":
            extra.update(forensics=cfg.forensics, forensics_top=cfg.forensics_top)
        obs.emit(
            "run_start",
            title=run_title(cfg),
            ckpt_title=title,
            backend=trainer.device.type,
            rounds=cfg.rounds,
            start_round=start_round,
            k=cfg.node_size,
            byz=cfg.byz_size,
            byz_ids=(None if cfg.service == "on"
                     else [int(i) for i in torch.nonzero(trainer.byz_mask).flatten().tolist()]),
            dim=trainer.dim,
            agg=cfg.agg,
            attack=cfg.attack,
            fault=cfg.fault,
            defense=cfg.defense,
            seed=cfg.seed,
            **extra,
            # the resolved impl: "pallas" the CUDA kernels, "xla" their
            # plain torch versions
            hbm=hbm_lib.aggregator_hbm_model(
                cfg.agg, cfg.node_size, trainer.dim, impl=trainer._agg_impl,
                fused=trainer.channel_fused, channel=cfg.noise_var is not None,
                trim=cfg.byz_size),
        )
    log("Optimization begin")
    t0 = time.perf_counter()
    profiler = profile_lib.from_config(cfg, trainer.device)
    if profiler.enabled:
        window = f" (rounds {cfg.profile_rounds})" if cfg.profile_rounds else ""
        log(f"Profiling to {cfg.profile_dir}{window}")
    profiler.start()  # whole-run mode; window mode opens at round A
    # the finished trainer carries its run's profiler (``last_profile``)
    trainer.profiler = profiler
    try:
        paths = trainer.train(log_fn=log, checkpoint_fn=checkpoint_fn,
                              start_round=start_round, obs=obs, profiler=profiler)
    finally:
        profiler.close()
    elapsed = time.perf_counter() - t0
    if resume_prefix:
        paths = merge_paths(resume_prefix, paths)
    if profiler.captured:
        obs.emit("profile", dir=cfg.profile_dir, rounds=cfg.profile_rounds or "all",
                 traces=profiler.trace_paths)
    # a resume at the end runs no round: no rate to report
    rounds_run = max(cfg.rounds - start_round, 0)
    rps = None
    if rounds_run and elapsed > 1e-6:
        rps = rounds_run / elapsed
        log(f"Optimization done in {elapsed:.1f}s ({rps:.2f} rounds/sec)")
    else:
        log(f"Optimization done in {elapsed:.1f}s (no rounds run)")
    if obs.enabled:
        retrace = _retrace(trainer, rounds_run)
        steady_ok = retrace.check("multi_round_fn", max_lowerings=1, warn_fn=log)
        obs.emit("retrace", counts=retrace.snapshot(), steady_state_ok=steady_ok)
    if trainer.flight_recorder is not None:
        trainer.flight_recorder.dump(max(cfg.rounds - 1, 0), "run_end", obs=obs)
    if obs.enabled:
        obs.emit(
            "run_end",
            elapsed_secs=round(elapsed, 3),
            rounds_run=rounds_run,
            rounds_per_sec=None if rps is None else round(rps, 4),
            final_val_acc=paths["valAccPath"][-1],
            final_val_loss=paths["valLossPath"][-1],
            memory=_memory_block(cfg, trainer, baseline),
        )
    _telemetry_epilogue(cfg, obs)
    record = build_record(
        cfg,
        paths,
        dataset_name=trainer.dataset.name,
        dataset_size=len(trainer.dataset.x_train),
        max_feature=int(trainer.dataset.x_train[0].size),
    )
    if record_in_file:
        if writer is not None:
            # after every pending checkpoint; drained so that the file is
            # there when this returns
            writer.submit_traced(lambda: io_lib.atomic_pickle(path, record), "record_pickle",
                                 sink=obs.sink)
            writer.drain()
        else:
            io_lib.atomic_pickle(path, record)
    return trainer, record
