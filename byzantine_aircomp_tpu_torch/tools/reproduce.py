"""The paper's experiment grid, and the port's accuracy gate on the card.

    python -m byzantine_aircomp_tpu_torch.tools.reproduce --gate

runs the three full-schedule gates of the JAX package's
``tests/test_parity.py`` (``test_full_schedule_parity_north_star``,
``..._weightflip_b10``, ``..._aircomp``) through the port on the GPU, each
at four seeds, and holds every config's seed-mean final accuracy against
the JAX package's own seed-mean (:data:`GATES`, each target with its
source).  Each run is mnist_hard 20000/10000, K=50, 100 rounds x 10
iterations, batch 50, ``agg_maxiter=1000``, ``agg_tol=1e-5``, no train-set
eval, and its final accuracy is the mean of its last 5 val evals.  The bar:
every seed above the JAX gate's own floor, and the 4-seed mean within
:data:`MEAN_BAR` of the JAX seed-mean (also reported: whether it is within
:data:`MEAN_BAR_TIGHT`).  The two packages' random streams (threefry,
Philox) are unpaired, so the per-seed accuracies differ by seed luck alone;
the JAX package's own two ``gm`` seeds are 0.021 apart.  The result goes to
``chiprun_out/reproduce_gate.json`` (``--out``); the exit code is 0 only
when every config passes.

``--rounds``, ``--interval``, ``--agg-maxiter``, ``--seeds`` and the data
sizes cut the gate down for a smoke run (``--device cpu`` on a machine
without a GPU); a cut run cannot pass the bar.  Without ``--gate`` the
tool runs :func:`paper_configs`, the 8 runs behind the paper's figure,
through the harness (records pickled under ``--cache-dir``); the plotting
stays with the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..fed.config import FedConfig

# every gate run's data set, schedule and aggregator options
# (tests/test_parity.py::_run_full_schedule and its three callers)
GATE_DATA = dict(dataset="mnist_hard", synthetic_train=20000, synthetic_val=10000)
GATE_COMMON = dict(
    rounds=100,
    display_interval=10,
    batch_size=50,
    eval_train=False,
    agg_maxiter=1000,
    agg_tol=1e-5,
)
GATE_SEEDS = (2021, 2022, 2023, 2024)
TAIL = 5  # final accuracy = mean of the last TAIL val evals
MEAN_BAR = 0.01
MEAN_BAR_TIGHT = 0.005


@dataclass(frozen=True)
class Gate:
    """One gated config: its FedConfig fields beyond :data:`GATE_COMMON`,
    the JAX gate's per-seed floor, and the JAX seed-mean it is held to."""

    name: str
    fields: Dict
    floor: float
    jax_mean: float
    jax_source: str


GATES = (
    Gate(
        "gm2_classflip_b5",
        dict(honest_size=45, byz_size=5, attack="classflip", agg="gm2"),
        0.88,
        0.90424,
        "JAX FedTrainer on the CPU, seeds 2021/2022: 0.90534/0.90314 "
        "(benchmarks/jax_gate_targets.py)",
    ),
    Gate(
        "gm2_weightflip_b10",
        dict(honest_size=40, byz_size=10, attack="weightflip", agg="gm2"),
        0.9,
        0.92330,
        "JAX FedTrainer on the CPU, seeds 2021/2022: 0.92330/0.92330 "
        "(benchmarks/jax_gate_targets.py)",
    ),
    Gate(
        "gm_var_classflip_b10",
        dict(honest_size=40, byz_size=10, attack="classflip", agg="gm", noise_var=1e-2),
        0.8,
        0.84990,
        "docs/aircomp_parity_r04.json seed_mean.jax (seeds 2021/2022: "
        "0.86062/0.83918)",
    ),
)


def gate_config(gate: Gate, seed: int, **overrides) -> FedConfig:
    """The FedConfig of one gate run (the JAX package's field names, so
    ``benchmarks/jax_gate_targets.py`` builds the JAX side from the same
    dict)."""
    kw = dict(GATE_COMMON, dataset=GATE_DATA["dataset"], seed=seed, **gate.fields)
    kw.update(overrides)
    return FedConfig(**kw)


def tail_accuracy(paths: Dict[str, list], tail: int = TAIL) -> float:
    return float(np.mean(paths["valAccPath"][-tail:]))


def judge(gate: Gate, per_seed: Dict[int, float]) -> Dict:
    """The bar for one config: every seed above the floor, the seed-mean
    within :data:`MEAN_BAR` of the JAX seed-mean."""
    mean = float(np.mean(list(per_seed.values())))
    delta = mean - gate.jax_mean
    floors_ok = all(a > gate.floor for a in per_seed.values())
    return {
        "per_seed": {str(s): a for s, a in per_seed.items()},
        "mean": mean,
        "jax_mean": gate.jax_mean,
        "jax_source": gate.jax_source,
        "delta": delta,
        "floor": gate.floor,
        "floors_ok": floors_ok,
        "within_0.01": abs(delta) <= MEAN_BAR,
        "within_0.005": abs(delta) <= MEAN_BAR_TIGHT,
        "pass": floors_ok and abs(delta) <= MEAN_BAR,
    }


def run_gate(
    device: str = "cuda",
    seeds: Sequence[int] = GATE_SEEDS,
    overrides: Optional[Dict] = None,
    synthetic_train: int = GATE_DATA["synthetic_train"],
    synthetic_val: int = GATE_DATA["synthetic_val"],
    gates: Sequence[Gate] = GATES,
    log_fn=print,
) -> Dict:
    """Every gate config at every seed through :class:`..fed.train.Trainer`
    (``overrides``: FedConfig fields that cut the schedule); returns the
    JSON-ready result (per config: per-seed accuracies, seconds, mean,
    delta and verdict)."""
    from ..data import datasets as data_lib
    from ..fed.train import Trainer

    ds = data_lib.load(
        GATE_DATA["dataset"], synthetic_train=synthetic_train, synthetic_val=synthetic_val
    )
    overrides = overrides or {}
    out = {"configs": {}, "seeds": list(seeds), "overrides": overrides,
           "synthetic_train": synthetic_train, "synthetic_val": synthetic_val}
    for gate in gates:
        per_seed, secs = {}, {}
        for seed in seeds:
            cfg = gate_config(gate, seed, **overrides)
            t0 = time.perf_counter()
            paths = Trainer(cfg, dataset=ds, device=device).train()
            secs[str(seed)] = time.perf_counter() - t0
            per_seed[seed] = tail_accuracy(paths)
            log_fn(f"[gate] {gate.name} seed={seed} acc={per_seed[seed]:.5f} "
                   f"({secs[str(seed)]:.1f} s)")
        res = judge(gate, per_seed)
        res["seconds"] = secs
        out["configs"][gate.name] = res
        log_fn(f"[gate] {gate.name} mean={res['mean']:.5f} jax={gate.jax_mean:.5f} "
               f"delta={res['delta']:+.5f} pass={res['pass']}")
    out["pass"] = not overrides and all(r["pass"] for r in out["configs"].values())
    return out


def paper_configs(rounds: int = 100, cache_dir: str = "./repro", **overrides) -> List[FedConfig]:
    """The 8 (channel x attack x B) configurations behind the paper's
    figure (JAX ``analysis/reproduce.py``; reference ``draw.ipynb`` cell
    0): K=50 MNIST MLP, gamma=1e-2, ideal ``gm2`` against AirComp ``gm
    --var 1e-2``, classflip and weightflip, B in {5, 10}."""
    cfgs = []
    for attack in ("classflip", "weightflip"):
        for byz in (5, 10):
            for agg, var in (("gm2", None), ("gm", 1e-2)):
                kw = dict(
                    dataset="mnist",
                    model="MLP",
                    honest_size=50 - byz,
                    byz_size=byz,
                    attack=attack,
                    agg=agg,
                    noise_var=var,
                    rounds=rounds,
                    cache_dir=cache_dir,
                )
                kw.update(overrides)
                cfgs.append(FedConfig(**kw))
    return cfgs


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser("byzantine_aircomp_tpu_torch.tools.reproduce")
    ap.add_argument("--gate", action="store_true",
                    help="run the three accuracy gates instead of the paper grid")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--rounds", type=int, default=None,
                    help="cut every run's schedule (default: 100)")
    ap.add_argument("--interval", type=int, default=None,
                    help="cut every round's iterations (default: 10)")
    ap.add_argument("--agg-maxiter", type=int, default=None,
                    help="cut the Weiszfeld steps per aggregation (default: 1000)")
    ap.add_argument("--seeds", type=str, default=",".join(map(str, GATE_SEEDS)))
    ap.add_argument("--synthetic-train", type=int, default=GATE_DATA["synthetic_train"])
    ap.add_argument("--synthetic-val", type=int, default=GATE_DATA["synthetic_val"])
    ap.add_argument("--out", default="chiprun_out/reproduce_gate.json")
    ap.add_argument("--cache-dir", default="./repro")
    ap.add_argument("--dataset", default="mnist")
    args = ap.parse_args(argv)

    if not args.gate:
        from ..fed import harness

        for i, cfg in enumerate(paper_configs(args.rounds or 100, args.cache_dir,
                                              dataset=args.dataset)):
            harness.log(f"[reproduce] run {i + 1}/8: agg={cfg.agg} attack={cfg.attack} "
                        f"B={cfg.byz_size} var={cfg.noise_var}")
            harness.run(cfg, device=args.device)
        return 0

    from ..device import resolve_device

    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    cuts = {"rounds": args.rounds, "display_interval": args.interval,
            "agg_maxiter": args.agg_maxiter}
    res = run_gate(
        device=args.device,
        seeds=[int(s) for s in args.seeds.split(",")],
        overrides={k: v for k, v in cuts.items() if v is not None},
        synthetic_train=args.synthetic_train,
        synthetic_val=args.synthetic_val,
    )
    res["seconds_total"] = time.perf_counter() - t0
    if dev.type == "cuda":
        import subprocess

        import torch

        res["device"] = torch.cuda.get_device_name(0)
        res["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True,
        ).stdout.strip()
    else:
        res["device"] = "cpu"
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items() if k != "configs"}
                     | {"pass_by_config": {n: r["pass"] for n, r in res["configs"].items()}}))
    return 0 if res["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
