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


def log(*k, **kw):
    """Timestamped logging (reference ``log``, ``:40-44``)."""
    stamp = time.strftime("[%m-%d %H:%M:%S] ", time.localtime())
    print(stamp + kw.get("sep", " ").join(str(x) for x in k))
    sys.stdout.flush()


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
    if cfg.rounds_per_dispatch > 1:
        # (JAX fed/harness.py:166-175): boundary eval and checkpoints, so
        # its runs never alias the per-round loop's
        title += f"_rd{cfg.rounds_per_dispatch}"
        if _non_default(cfg, "eval_interval"):
            title += f"_ev{cfg.eval_interval}"
        if _non_default(cfg, "dispatch_mode"):
            title += f"_{cfg.dispatch_mode}"
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
# change when bytes reach the disk and the host folds, not the records
_HASH_SKIP = ("checkpoint_dir", "cache_dir", "inherit", "rounds", "async_writer",
              "dispatch_prefetch")

# fields skipped while at their default, so that a config that leaves them
# there hashes as it did before the field was ported: the sign channel's
# width, the size skew, and the training options
_HASH_SKIP_AT_DEFAULT = (
    "sign_bits", "size_skew", "local_steps", "fedprox_mu", "server_opt", "server_lr",
    "server_momentum", "client_momentum", "participation", "bucket_size",
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
    ]
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
        print(line)
    sys.stdout.flush()


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
    if t.server_opt_state is not None:
        leaves += list(t.server_opt_state)
    if t.client_m is not None:
        leaves.append(t.client_m)
    if t.fault_state is not None:
        leaves += [x for x in t.fault_state if x is not None]
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
        if trainer.client_m is not None:
            trainer.client_m = next(leaves)
        if trainer.fault_state is not None:
            trainer.fault_state = fault_lib.FaultState(
                *(None if x is None else next(leaves) for x in trainer.fault_state)
            )
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

    With the writer thread on (:func:`..obs.resolve_async`) each
    checkpoint is copied to the host here and written by the writer as one
    task, the record pickle rides it last, and the writer is drained and
    closed before this returns, on success or failure (JAX
    ``fed/harness.py:599-645``, :994-999)."""
    if cfg.attack is None:
        cfg.byz_size = 0
    cfg.validate()
    writer = obs_lib.WriterThread() if obs_lib.resolve_async(cfg) else None
    try:
        return _run_inner(cfg, device, record_in_file, dataset, on_round, writer)
    finally:
        if writer is not None:
            writer.close()


def _run_inner(cfg, device, record_in_file, dataset, on_round, writer):
    trainer = Trainer(cfg, dataset=dataset, device=device)
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
            checkpoint.save(cfg.checkpoint_dir, title, r, t.flat_params,
                            extra_state(t), meta=json.dumps(so_far), writer=writer)
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

    log("Optimization begin")
    t0 = time.perf_counter()
    paths = trainer.train(log_fn=log, checkpoint_fn=checkpoint_fn, start_round=start_round)
    elapsed = time.perf_counter() - t0
    if resume_prefix:
        paths = merge_paths(resume_prefix, paths)
    # a resume at the end runs no round: no rate to report
    rounds_run = max(cfg.rounds - start_round, 0)
    if rounds_run and elapsed > 1e-6:
        log(f"Optimization done in {elapsed:.1f}s ({rounds_run / elapsed:.2f} rounds/sec)")
    else:
        log(f"Optimization done in {elapsed:.1f}s (no rounds run)")
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
            writer.submit(lambda: io_lib.atomic_pickle(path, record))
            writer.drain()
        else:
            io_lib.atomic_pickle(path, record)
    return trainer, record
