"""The paper's experiment grid, and the port's accuracy gate on the card.

    python -m byzantine_aircomp_tpu_torch.tools.reproduce --gate

runs four gates of the JAX package's ``tests/test_parity.py`` through the
port on the GPU (:data:`GATES`, each target with its source).  Three are
its full-schedule MLP gates
(``test_full_schedule_parity_north_star``, ``..._weightflip_b10``,
``..._aircomp``): mnist_hard 20000/10000, K=50, 100 rounds x 10
iterations, batch 50, ``agg_maxiter=1000``, ``agg_tol=1e-5``.  The fourth
is its CNN trajectory (``test_mid_schedule_parity_cnn``,
``docs/cnn_parity_r04.json``): mnist_hard 6000/3000, the CNN at fc_width
32, K=6 (B=1) classflip gm2, 45 rounds x 10, batch 16, ``agg_maxiter=100``.
No run evaluates the train set, and a run's final accuracy is the mean of
its last 5 val evals.  The MLP bar, at seeds 2021-2024: every seed above
the JAX gate's own floor, and the 4-seed mean within :data:`MEAN_BAR` of
the JAX seed-mean (also reported: whether it is within
:data:`MEAN_BAR_TIGHT`).  The two packages' random streams (threefry,
Philox) are unpaired, so the per-seed accuracies differ by seed luck
alone; the JAX package's own two ``gm`` seeds are 0.021 apart.

The CNN's runs take off at different rounds from seed to seed: a late
take-off ends a run below the bar in either package (the JAX package on
the CPU: 1 seed of 20; the port on the card: 5 of 60), so a bar on each
of 4 seeds fails about a fifth of honest runs.  Its bar is a distribution
over seeds 2021-2040 held against the JAX package's own 20 runs of the
same config (:data:`JAX_CNN_SEEDS`, from ``benchmarks/jax_gate_targets.py``):
the median of the port's 20 accuracies within :data:`MEAN_BAR` of the JAX
median, and at most :data:`CNN_MAX_LOW` of the 20 below 0.889 (at the JAX
package's rate of 1 in 20, 5 or more late seeds has a chance under 0.3%).
The result goes to
``chiprun_out/reproduce_gate.json`` (``--out``); the exit code is 0 only
when every config passes.

``--rounds``, ``--interval``, ``--agg-maxiter``, ``--seeds`` and the data
sizes (each gate's own by default) cut the gate down for a smoke run
(``--device cpu`` on a machine without a GPU); a cut run cannot pass the
bar.  Without ``--gate`` the
tool runs :func:`paper_configs`, the 8 runs behind the paper's figure,
through the harness (records pickled under ``--cache-dir``), and draws the
figure (JAX ``analysis/reproduce.py``) into ``--out`` (default
``paper.png``) from exactly the 8 records those runs return, never from a
glob of the cache directory; the figure can be drawn again later from the
pickles with ``python -m byzantine_aircomp_tpu_torch.analysis plots``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..fed.config import FedConfig

#: the JAX package's 20 runs of the CNN gate config (seeds 2021-2040)
JAX_CNN_SEEDS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "jax_cnn_gate_seeds.json")

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
CNN_SEEDS = tuple(range(2021, 2041))
TAIL = 5  # final accuracy = mean of the last TAIL val evals
MEAN_BAR = 0.01
MEAN_BAR_TIGHT = 0.005
# the CNN's distributional bar: at most this many of its 20 seeds below its
# floor
CNN_MAX_LOW = 4


@dataclass(frozen=True)
class Gate:
    """One gated config: its FedConfig fields beyond (or over)
    :data:`GATE_COMMON`, the JAX gate's per-seed floor, the JAX seed-mean
    it is held to, its data (:data:`GATE_DATA` unless stated), its seeds,
    and, for a distributional bar, the file of the JAX package's per-seed
    accuracies at the same seeds."""

    name: str
    fields: Dict
    floor: float
    jax_mean: float
    jax_source: str
    data: Dict = field(default_factory=lambda: dict(GATE_DATA))
    seeds: tuple = GATE_SEEDS
    jax_per_seed_file: Optional[str] = None

    def jax_per_seed(self) -> Dict[str, float]:
        with open(self.jax_per_seed_file) as f:
            return json.load(f)["per_seed"]


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
    Gate(
        "cnn_gm2_classflip_b1",
        dict(model="CNN", fc_width=32, honest_size=5, byz_size=1, attack="classflip",
             agg="gm2", rounds=45, batch_size=16, agg_maxiter=100),
        0.91900 - 0.03,
        0.91487,
        "JAX FedTrainer on the CPU, seeds 2021-2040, median 0.91853, 1 of 20 below "
        "0.889 (tools/jax_cnn_gate_seeds.json, benchmarks/jax_gate_targets.py)",
        data=dict(dataset="mnist_hard", synthetic_train=6000, synthetic_val=3000),
        seeds=CNN_SEEDS,
        jax_per_seed_file=JAX_CNN_SEEDS,
    ),
)


def gate_config(gate: Gate, seed: int, **overrides) -> FedConfig:
    """The FedConfig of one gate run (the JAX package's field names, so
    ``benchmarks/jax_gate_targets.py`` builds the JAX side from the same
    dict)."""
    kw = dict(GATE_COMMON, dataset=gate.data["dataset"], seed=seed)
    kw.update(gate.fields)
    kw.update(overrides)
    return FedConfig(**kw)


def tail_accuracy(paths: Dict[str, list], tail: int = TAIL) -> float:
    return float(np.mean(paths["valAccPath"][-tail:]))


def judge(gate: Gate, per_seed: Dict[int, float]) -> Dict:
    """The bar for one config: every seed above the floor and the seed-mean
    within :data:`MEAN_BAR` of the JAX seed-mean; or, for a gate with the
    JAX package's per-seed file, :func:`judge_distribution`."""
    if gate.jax_per_seed_file is not None:
        return judge_distribution(gate, per_seed)
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


def judge_distribution(gate: Gate, per_seed: Dict[int, float]) -> Dict:
    """The CNN's bar over its 20 seeds: the median accuracy within
    :data:`MEAN_BAR` of the JAX package's median over the same seeds, and
    at most :data:`CNN_MAX_LOW` seeds below the floor.  Only the gate's own
    seeds can pass."""
    jax = gate.jax_per_seed()
    accs = list(per_seed.values())
    median, jax_median = float(np.median(accs)), float(np.median(list(jax.values())))
    low = sorted(int(s) for s, a in per_seed.items() if not a > gate.floor)
    mean = float(np.mean(accs))
    all_seeds = sorted(int(s) for s in per_seed) == list(gate.seeds)
    return {
        "per_seed": {str(s): a for s, a in per_seed.items()},
        "jax_per_seed": jax,
        "median": median,
        "jax_median": jax_median,
        "median_delta": median - jax_median,
        "seeds_below_floor": low,
        "jax_seeds_below_floor": sorted(int(s) for s, a in jax.items() if not a > gate.floor),
        "max_below_floor": CNN_MAX_LOW,
        "mean": mean,
        "jax_mean": gate.jax_mean,
        "jax_source": gate.jax_source,
        "delta": mean - gate.jax_mean,
        "floor": gate.floor,
        "all_seeds": all_seeds,
        "pass": (all_seeds and abs(median - jax_median) <= MEAN_BAR
                 and len(low) <= CNN_MAX_LOW),
    }


def run_gate(
    device: str = "cuda",
    seeds: Optional[Sequence[int]] = None,
    overrides: Optional[Dict] = None,
    synthetic_train: Optional[int] = None,
    synthetic_val: Optional[int] = None,
    gates: Sequence[Gate] = GATES,
    log_fn=print,
) -> Dict:
    """Every gate config at each of its seeds (or ``seeds``, for every
    gate) through :class:`..fed.train.Trainer` (``overrides``: FedConfig
    fields that cut the schedule; the data sizes, when given, replace every
    gate's own); returns the JSON-ready result (per config: its data,
    per-seed accuracies, val accuracy paths and seconds, and the verdict)."""
    from ..data import datasets as data_lib
    from ..fed.train import Trainer

    overrides = overrides or {}
    out = {"configs": {}, "seeds": None if seeds is None else list(seeds),
           "overrides": overrides}
    loaded = {}
    for gate in gates:
        data = dict(gate.data)
        if synthetic_train is not None:
            data["synthetic_train"] = synthetic_train
        if synthetic_val is not None:
            data["synthetic_val"] = synthetic_val
        key = tuple(sorted(data.items()))
        if key not in loaded:
            kw = dict(data)
            loaded[key] = data_lib.load(kw.pop("dataset"), **kw)
        ds = loaded[key]
        per_seed, secs, acc_paths = {}, {}, {}
        for seed in (gate.seeds if seeds is None else seeds):
            cfg = gate_config(gate, seed, **overrides)
            t0 = time.perf_counter()
            paths = Trainer(cfg, dataset=ds, device=device).train()
            secs[str(seed)] = time.perf_counter() - t0
            acc_paths[str(seed)] = paths["valAccPath"]
            per_seed[seed] = tail_accuracy(paths)
            log_fn(f"[gate] {gate.name} seed={seed} acc={per_seed[seed]:.5f} "
                   f"({secs[str(seed)]:.1f} s)")
        res = judge(gate, per_seed)
        res["seconds"] = secs
        res["valAccPath"] = acc_paths
        res["data"] = data
        out["configs"][gate.name] = res
        log_fn(f"[gate] {gate.name} mean={res['mean']:.5f} jax={gate.jax_mean:.5f} "
               f"delta={res['delta']:+.5f}"
               + (f" median={res['median']:.5f} jax_median={res['jax_median']:.5f} "
                  f"below {gate.floor:.3f}: {res['seeds_below_floor']}" if "median" in res
                  else "") + f" pass={res['pass']}")
    # a cut schedule, other seeds or a subset of the configs is no pass
    out["pass"] = (not overrides and seeds is None
                   and set(out["configs"]) == {g.name for g in GATES}
                   and all(r["pass"] for r in out["configs"].values()))
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
                    help="run the four accuracy gates instead of the paper grid")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--rounds", type=int, default=None,
                    help="cut every run's schedule (default: 100)")
    ap.add_argument("--interval", type=int, default=None,
                    help="cut every round's iterations (default: 10)")
    ap.add_argument("--agg-maxiter", type=int, default=None,
                    help="cut the Weiszfeld steps per aggregation (default: 1000)")
    ap.add_argument("--seeds", type=str, default=None,
                    help="comma-separated seeds for every config (default: each "
                         "gate's own; other seeds never pass)")
    ap.add_argument("--config", action="append", choices=[g.name for g in GATES],
                    help="run only this gate config (repeatable; default: all)")
    ap.add_argument("--synthetic-train", type=int, default=None,
                    help="replace every gate's train-set size")
    ap.add_argument("--synthetic-val", type=int, default=None,
                    help="replace every gate's val-set size")
    ap.add_argument("--out", default="chiprun_out/reproduce_gate.json")
    ap.add_argument("--cache-dir", default="./repro")
    ap.add_argument("--dataset", default="mnist")
    args = ap.parse_args(argv)

    if not args.gate:
        from ..analysis.plots import paper_figure
        from ..fed import harness

        # without --gate, --out names the figure (paper.png unless given)
        out = "paper.png" if args.out == ap.get_default("out") else args.out
        cuts = {k: v for k, v in (("display_interval", args.interval),
                                  ("agg_maxiter", args.agg_maxiter)) if v is not None}
        records = {}
        for i, cfg in enumerate(paper_configs(args.rounds or 100, args.cache_dir,
                                              dataset=args.dataset, **cuts)):
            harness.log(f"[reproduce] run {i + 1}/8: agg={cfg.agg} attack={cfg.attack} "
                        f"B={cfg.byz_size} var={cfg.noise_var}")
            # run_title has no Byzantine count, so B=5 and B=10 share one:
            # the key carries it (JAX analysis/reproduce.py:76-81)
            records[f"{harness.run_title(cfg)}_B{cfg.byz_size}"] = harness.run(
                cfg, device=args.device)
        if len(records) != 8:
            raise RuntimeError(f"record keys collided: {sorted(records)}")
        paper_figure(records, out)
        print(f"wrote {out} ({len(records)} records)")
        return 0

    from ..device import resolve_device

    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    cuts = {"rounds": args.rounds, "display_interval": args.interval,
            "agg_maxiter": args.agg_maxiter}
    res = run_gate(
        device=args.device,
        seeds=None if args.seeds is None else [int(s) for s in args.seeds.split(",")],
        overrides={k: v for k, v in cuts.items() if v is not None},
        synthetic_train=args.synthetic_train,
        synthetic_val=args.synthetic_val,
        gates=[g for g in GATES if args.config is None or g.name in args.config],
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
