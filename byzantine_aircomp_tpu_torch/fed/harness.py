"""Experiment harness: title, banner, per-round log, pickled record.

Port of the main-path surface of ``byzantine_aircomp_tpu/fed/harness.py``
(reference ``run``, ``MNIST_Air_weight.py:427-492``): the same title scheme
``{Model}_{opt}_{attack|baseline}_{agg}[_{var}][_{mark}]`` (``:446-455``),
the cache-path convention ``{name}_K{K}_B{B}_`` (``:546-550``) and the same
record keys, including the ``variencePath`` spelling (``:481-489``), so the
reference's analysis reads the port's records unchanged.
"""

from __future__ import annotations

import os
import pickle
import sys
import tempfile
import time
from typing import Dict, Tuple

import torch

from .config import FedConfig
from .train import Trainer


def log(*k, **kw):
    """Timestamped logging (reference ``log``, ``:40-44``)."""
    stamp = time.strftime("[%m-%d %H:%M:%S] ", time.localtime())
    print(stamp + kw.get("sep", " ").join(str(x) for x in k))
    sys.stdout.flush()


def run_title(cfg: FedConfig) -> str:
    attack_name = cfg.attack if cfg.attack is not None else "baseline"
    title = f"{cfg.model}_{cfg.opt}_{attack_name}_{cfg.agg}"
    if cfg.noise_var is not None:
        title += f"_{cfg.noise_var}"
    # the JAX package's suffixes for the sign channel, only off the default
    if cfg.sign_eta is not None:
        title += f"_eta{cfg.sign_eta}"
    if cfg.sign_bits != 32:
        title += f"_sb{cfg.sign_bits}"
    if cfg.mark:
        title += f"_{cfg.mark}"
    return title


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
        "-------------------------------------------",
    ]
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
    return {
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


def atomic_pickle(path: str, obj) -> str:
    """Pickle ``obj`` to a temporary file beside ``path``, then rename it
    over ``path``: a killed run never leaves a torn record."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp_record_")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(obj, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise
    return path


def run(cfg: FedConfig, device: str = "cuda", record_in_file: bool = True) -> Dict:
    """Build a trainer on ``device``, run the full schedule, pickle the
    record (reference ``run``, ``:427-492``).  With no attack the
    Byzantine count is zeroed (``:430-431``)."""
    return run_with_trainer(cfg, device, record_in_file)[1]


def run_with_trainer(
    cfg: FedConfig, device: str = "cuda", record_in_file: bool = True
) -> Tuple[Trainer, Dict]:
    """:func:`run`, also returning the finished trainer (its final
    ``flat_params``) for callers that check the trained state."""
    if cfg.attack is None:
        cfg.byz_size = 0
    cfg.validate()
    trainer = Trainer(cfg, device=device)
    path = cache_path(cfg, trainer.dataset.name)
    banner(cfg, trainer, path)
    log("Optimization begin")
    t0 = time.perf_counter()
    paths = trainer.train(log_fn=log)
    elapsed = time.perf_counter() - t0
    log(f"Optimization done in {elapsed:.1f}s ({cfg.rounds / elapsed:.2f} rounds/sec)")
    record = build_record(
        cfg,
        paths,
        dataset_name=trainer.dataset.name,
        dataset_size=len(trainer.dataset.x_train),
        max_feature=int(trainer.dataset.x_train[0].size),
    )
    if record_in_file:
        atomic_pickle(path, record)
    return trainer, record
