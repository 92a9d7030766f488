"""JAX seed-means for the port's accuracy gate (the two ideal-channel configs).

    JAX_PLATFORMS=cpu python benchmarks/jax_gate_targets.py \
        --gate gm2_classflip_b5 --seed 2021 --out targets_cf5_2021.json

Runs the JAX package's ``FedTrainer`` on one gate config of
``byzantine_aircomp_tpu_torch.tools.reproduce.GATES`` (the same FedConfig
fields, the same mnist_hard 20000/10000 set) at one seed, and writes the
tail-averaged final val accuracy and the run's wall seconds as JSON.  The
seed-means of seeds 2021 and 2022 are the targets ``reproduce.GATES``
holds the port to; the AirComp ``gm`` target comes from
``docs/aircomp_parity_r04.json`` instead.
"""

from __future__ import annotations

import argparse
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
    ds = jax_data.load(
        reproduce.GATE_DATA["dataset"],
        synthetic_train=reproduce.GATE_DATA["synthetic_train"],
        synthetic_val=reproduce.GATE_DATA["synthetic_val"],
    )
    kw = dict(reproduce.GATE_COMMON, dataset=reproduce.GATE_DATA["dataset"],
              seed=args.seed, **gate.fields)
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
