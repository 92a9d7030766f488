"""The system under test: the port's trainer, built and driven through the
calls that ``Trainer.train``'s drivers make.  It imports the port only
inside its functions, as an input kind's ``port_dataset`` and the readers
of the port's counters do."""

from __future__ import annotations

import os
import tempfile
import time
from typing import Dict, List

import torch

from gpubench import inputs

PORT = "byzantine_aircomp_tpu_torch"
#: the program's profiler range around the clients' local steps
CLIENT_STEP_RANGE = "client_step"
#: the benchmark's range around each dispatch's host read
HOST_READ_RANGE = "gpubench.host_read"
# rounds a trainer is configured for: more than any window runs
ROUNDS = 10**6


def import_port():
    """The port's modules that the trainer needs, imported."""
    from byzantine_aircomp_tpu_torch.fed import harness  # noqa: F401


def make_trainer(config, cell, data, p0, seed: int, device):
    """The port's trainer for the cell, on the benchmark's data set, with
    its weights set to ``p0``."""
    from byzantine_aircomp_tpu_torch.fed import harness
    from byzantine_aircomp_tpu_torch.fed.config import FedConfig

    dataset = inputs.of(config).port_dataset(config, data)
    r = cell["rounds_per_dispatch"]
    cfg = FedConfig(
        honest_size=cell["honest_size"], byz_size=cell["byz_size"], rounds=r * ROUNDS,
        display_interval=config["display_interval"], gamma=config["gamma"],
        weight_decay=config["weight_decay"], batch_size=config["batch_size"], agg=cell["agg"],
        attack=cell["attack"], noise_var=cell["noise_var"], agg_maxiter=config["agg_maxiter"],
        agg_tol=config["agg_tol"], gm_p_max=config["gm_p_max"], seed=seed,
        model=config["model"], fc_width=config.get("fc_width", 1024), rounds_per_dispatch=r,
        cache_dir=os.path.join(tempfile.gettempdir(), "gpubench"), **config.get("fed", {}))
    trainer = harness.make_trainer(cfg, dataset=dataset, device=str(device))
    if trainer.flat_params.numel() != p0.numel():
        raise ValueError(f"the port's {config['model']} has {trainer.flat_params.numel()} "
                         f"weights, the configuration {p0.numel()}")
    trainer.flat_params.copy_(p0)
    return trainer


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Dispatcher:
    """One dispatch of the trainer per call, as its drivers make it: at
    R = 1 ``run_round`` and the host read of its variance (the R = 1 loop
    of ``Trainer.train``), at R > 1 ``run_rounds_stacked`` and the host
    read of its stacked outputs (``Trainer._train_multi``).  Each call
    returns ``(host seconds of the call, seconds to the outputs on the
    host, each round's honest variance)``."""

    def __init__(self, trainer, rounds_per_dispatch: int):
        self.trainer = trainer
        self.rounds = rounds_per_dispatch
        self.device = trainer.flat_params.device
        self.next_round = 0

    def __call__(self):
        t, r = self.trainer, self.next_round
        t0 = time.perf_counter()
        if self.rounds == 1:
            out = t.run_round(r)
            t1 = time.perf_counter()
            with torch.profiler.record_function(HOST_READ_RANGE):
                _sync(self.device)
                variances: List[float] = [float(out)]
        else:
            outs = t.run_rounds_stacked(r, self.rounds)
            t1 = time.perf_counter()
            with torch.profiler.record_function(HOST_READ_RANGE):
                _sync(self.device)
                variances = [None if o is None else o.tolist() for o in outs][0]
        t2 = time.perf_counter()
        self.next_round += self.rounds
        return t1 - t0, t2 - t0, variances

    def params(self) -> torch.Tensor:
        return self.trainer.flat_params


def launches() -> Dict[str, int]:
    """The port's kernel launches so far, by wrapper (a graph replay adds
    its capture's)."""
    from byzantine_aircomp_tpu_torch.ops import kernels

    return dict(kernels.LAUNCHES)
