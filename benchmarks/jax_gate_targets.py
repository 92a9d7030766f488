"""JAX accuracies for the port's accuracy gate, one config and seed a run.

    JAX_PLATFORMS=cpu python benchmarks/jax_gate_targets.py \
        --gate gm2_classflip_b5 --seed 2021 --out targets_cf5_2021.json

Runs the JAX package's ``FedTrainer`` on one gate config of
``byzantine_aircomp_tpu_torch.tools.reproduce.GATES`` (the same FedConfig
fields, the same synthetic set) at one seed, and writes the tail-averaged
final val accuracy, the val accuracy path and the run's wall seconds as
JSON.  The seed-means of seeds 2021 and 2022 are the targets of the two
ideal-channel MLP configs; the AirComp ``gm`` and the CNN targets come
from ``docs/aircomp_parity_r04.json`` and ``docs/cnn_parity_r04.json``
(the CNN takes about 5 minutes a seed on the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import platform
import time

from byzantine_aircomp_tpu.data import datasets as jax_data
from byzantine_aircomp_tpu.fed.config import FedConfig
from byzantine_aircomp_tpu.fed.train import FedTrainer
from byzantine_aircomp_tpu_torch.tools import reproduce


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--gate", required=True, choices=[g.name for g in reproduce.GATES])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    gate = next(g for g in reproduce.GATES if g.name == args.gate)
    data = dict(gate.data)
    ds = jax_data.load(data.pop("dataset"), **data)
    cfg = reproduce.gate_config(gate, args.seed)
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
          if f.name in FedConfig.__dataclass_fields__}
    t0 = time.perf_counter()
    paths = FedTrainer(FedConfig(**kw), dataset=ds).train()
    secs = time.perf_counter() - t0
    res = {
        "gate": gate.name,
        "seed": args.seed,
        "acc": reproduce.tail_accuracy(paths),
        "valAccPath": paths["valAccPath"],
        "seconds": secs,
        "host": f"{platform.processor() or platform.machine()} cpu",
    }
    with open(args.out, "w") as f:
        json.dump(res, f)
    print(json.dumps({k: v for k, v in res.items() if k != "valAccPath"}))


if __name__ == "__main__":
    main()
