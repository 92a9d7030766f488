"""Defense-vs-attack sweep: run the full (aggregator x attack) matrix and
tabulate final accuracy.

The port's copy of ``byzantine_aircomp_tpu/analysis/sweep.py``.  The
reference's evaluation workflow is one run per CLI invocation plus a
hand-assembled notebook figure (``draw.ipynb``); a whole robustness matrix
is cheap, so the sweep is first-class tooling:

    python -m byzantine_aircomp_tpu_torch.sweep --aggs gm2,krum,signmv \
        --attacks classflip,alie,minmax --K 50 --B 10 --rounds 5

Each cell trains from scratch (same seed, same dataset object, loaded
once) on the card (``--device cpu`` for the CPU) and reports final val
accuracy/loss and rounds/sec.  Output: one JSON line per cell on stdout
plus a markdown table on stderr, and optionally a pickle of the full grid
(``--out``) for downstream plotting.  Each cell is one solo trainer, or
with ``--batched`` its ``--seeds`` replicas as the lanes of one
:class:`..serve.batch.BatchRunner` (one set-up for the seed axis; each
lane bitwise its solo cell).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional, Tuple

from .. import obs as obs_lib
from ..cli import add_knob_flags
from ..fed.config import FedConfig
from ..fed.train import Trainer
from ..registry import AGGREGATORS, ATTACKS
from ..utils import io as io_lib

def _cell_kw(
    agg: str, attack: Optional[str], cfg_kw: dict
) -> Tuple[dict, Dict[str, object]]:
    """Per-cell knob sanitization, so one global knob set can cover a mixed
    matrix: attack_param only reaches attacks that take one, and krum_m
    is clamped when the byz-zeroed 'none' cell shrinks node_size below
    it.  Every adjustment is recorded in ``effective`` so the emitted
    rows / pickled grid can't misrepresent which knobs a cell actually
    ran."""
    kw = dict(cfg_kw)
    kw["agg"] = agg
    kw["attack"] = attack
    effective: Dict[str, object] = {}
    if attack is None and kw.get("byz_size"):
        kw["byz_size"] = 0  # reference semantics (run(), :430-431)
        effective["byz_size"] = 0
    if kw.get("attack_param") is not None:
        spec = ATTACKS.get(attack) if attack is not None else None
        if spec is None or spec.param_name is None:
            kw["attack_param"] = None
            effective["attack_param"] = None  # dropped: attack takes no knob
    if kw.get("krum_m") is not None:
        clamped = min(kw["krum_m"], kw["honest_size"] + kw["byz_size"])
        if clamped != kw["krum_m"]:
            effective["krum_m"] = clamped
        kw["krum_m"] = clamped
    return kw, effective


def run_cell(
    agg: str, attack: Optional[str], cfg_kw: dict, dataset
) -> Dict[str, float]:
    """Train one (aggregator, attack) cell; returns its final metrics.

    ``rounds_per_sec`` excludes set-up and eval: round 0 is the warm-up
    (it loads the kernels and allocates their workspaces) and the timer,
    closed by a ``torch.cuda.synchronize()`` on the card, stops before
    ``evaluate``; with ``rounds=1`` there is nothing past the warm-up to
    time, so the field is omitted."""
    kw, effective = _cell_kw(agg, attack, cfg_kw)
    cfg = FedConfig(**kw)
    trainer = Trainer(cfg, dataset=dataset, device="cuda" if cfg.use_gpu else "cpu")
    # round 0 both warms up and advances the trajectory; rounds 1..R-1 run
    # inside the timed window
    trainer.run_round(0)
    trainer._sync()
    metrics: Dict[str, float] = {}
    if cfg.rounds > 1:
        t0 = time.perf_counter()
        for r in range(1, cfg.rounds):
            trainer.run_round(r)
        trainer._sync()
        dt = time.perf_counter() - t0
        metrics["rounds_per_sec"] = round((cfg.rounds - 1) / dt, 3)
    loss, acc = trainer.evaluate("val")
    metrics.update(val_acc=round(acc, 4), val_loss=round(loss, 4))
    if effective:
        metrics["effective"] = effective
    return metrics


def run_cell_batched(
    agg: str, attack: Optional[str], cfg_kw: dict, dataset, seeds: int
) -> List[Dict[str, float]]:
    """Every seed replica of one cell as lanes of ONE
    :class:`..serve.batch.BatchRunner` (JAX ``run_cell_batched``): one
    set-up for the seed axis instead of one trainer each.  Each lane's
    trajectory is bitwise its solo cell's; ``rounds_per_sec`` is the
    group's rate (every lane's round of a group step, the same value on
    every replica), past the warm-up round."""
    from ..serve.batch import BatchRunner

    kw, effective = _cell_kw(agg, attack, cfg_kw)
    base_seed = kw.get("seed", 2021)
    cfgs = [FedConfig(**dict(kw, seed=base_seed + s)) for s in range(seeds)]
    batch = BatchRunner(cfgs, dataset=dataset)
    batch.run_round(0)  # the warm-up: the group's one set-up
    batch.template._sync()
    rps = None
    if cfgs[0].rounds > 1:
        t0 = time.perf_counter()
        for r in range(1, cfgs[0].rounds):
            batch.run_round(r)
        batch.template._sync()
        rps = round((cfgs[0].rounds - 1) / (time.perf_counter() - t0), 3)
    runs = []
    for lane in range(seeds):
        loss, acc = batch.evaluate(lane, "val")
        metrics: Dict[str, float] = {}
        if rps is not None:
            metrics["rounds_per_sec"] = rps
        metrics.update(val_acc=round(acc, 4), val_loss=round(loss, 4))
        if effective:
            metrics["effective"] = effective
        runs.append(metrics)
    return runs


def run_sweep(
    aggs: List[str],
    attacks: List[Optional[str]],
    cfg_kw: dict,
    dataset=None,
    log=lambda s: print(s, file=sys.stderr, flush=True),
    on_cell=None,
    seeds: int = 1,
    batched: bool = False,
) -> Dict[Tuple[str, Optional[str]], Dict[str, float]]:
    """The full matrix; dataset is loaded once and shared across cells.
    ``on_cell(agg, attack, metrics)`` fires as each cell completes, so
    callers can stream results and a late-cell crash loses nothing.
    ``seeds > 1`` repeats each cell at consecutive seeds and reports the
    mean, plus ``val_acc_std`` across seeds.  ``batched=True`` runs the seed
    axis of each cell as the lanes of one batch runner
    (:func:`run_cell_batched`); the eager per-seed loop stays the default."""
    from ..data import datasets as data_lib

    if seeds < 1:
        raise ValueError(f"seeds must be >= 1, got {seeds}")
    for a in aggs:
        AGGREGATORS.get(a)  # fail fast on typos, before any training
    for t in attacks:
        if t is not None:
            ATTACKS.get(t)
    if dataset is None:
        dataset = data_lib.load(cfg_kw.get("dataset", "mnist"))
    base_seed = cfg_kw.get("seed", 2021)
    grid: Dict[Tuple[str, Optional[str]], Dict[str, float]] = {}
    for attack in attacks:
        for agg in aggs:
            if batched:
                runs = run_cell_batched(agg, attack, dict(cfg_kw, seed=base_seed), dataset,
                                        seeds)
            else:
                runs = [run_cell(agg, attack, dict(cfg_kw, seed=base_seed + s), dataset)
                        for s in range(seeds)]
            cell = {
                k: round(sum(r[k] for r in runs) / len(runs), 4)
                for k in runs[0]
                if isinstance(runs[0][k], (int, float))
            }
            if "effective" in runs[0]:  # same sanitization at every seed
                cell["effective"] = runs[0]["effective"]
            if seeds > 1:
                accs = [r["val_acc"] for r in runs]
                mu = sum(accs) / len(accs)
                cell["val_acc_std"] = round(
                    (sum((a - mu) ** 2 for a in accs) / len(accs)) ** 0.5, 4
                )
            grid[(agg, attack)] = cell
            log(f"[sweep] agg={agg} attack={attack}: {cell}")
            if on_cell is not None:
                on_cell(agg, attack, cell)
    return grid


def markdown_table(
    grid: Dict[Tuple[str, Optional[str]], Dict[str, float]],
    metric: str = "val_acc",
) -> str:
    aggs = sorted({a for a, _ in grid})
    attacks = sorted({t for _, t in grid}, key=lambda t: (t is not None, t))
    head = "| attack \\ agg | " + " | ".join(aggs) + " |"
    sep = "|" + "---|" * (len(aggs) + 1)
    rows = []
    for t in attacks:
        cells = [f"{grid[(a, t)][metric]:.4f}" for a in aggs]
        rows.append(f"| {t or 'none'} | " + " | ".join(cells) + " |")
    return "\n".join([head, sep] + rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--aggs", default="gm2,krum,trimmed_mean,mean")
    ap.add_argument("--attacks", default="none,classflip,weightflip")
    ap.add_argument("--dataset", default="mnist")
    ap.add_argument("--K", type=int, default=20)
    ap.add_argument("--B", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--interval", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=50)
    ap.add_argument("--gamma", type=float, default=1e-2)
    ap.add_argument("--var", type=float, default=None)
    ap.add_argument("--seed", type=int, default=2021)
    ap.add_argument("--seeds", type=int, default=1,
                    help="repeat each cell at N consecutive seeds; reports "
                         "the mean (+ val_acc_std)")
    ap.add_argument("--batched", action="store_true",
                    help="run each cell's --seeds replicas as lanes of one "
                         "batch runner (one set-up; each lane bitwise its solo cell)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default) or cpu")
    add_knob_flags(ap)  # shared with the main CLI (incl. help text)
    ap.add_argument("--out", default=None, help="pickle the grid here")
    ap.add_argument("--obs-dir", default=None,
                    help="also append sweep_cell events (JSONL) here")
    args = ap.parse_args(argv)

    aggs = [a for a in args.aggs.split(",") if a]
    attacks: List[Optional[str]] = [
        None if t in ("none", "") else t for t in args.attacks.split(",")
    ]
    cfg_kw = dict(
        dataset=args.dataset,
        honest_size=args.K - args.B,
        byz_size=args.B,
        rounds=args.rounds,
        display_interval=args.interval,
        batch_size=args.batch_size,
        gamma=args.gamma,
        noise_var=args.var,
        seed=args.seed,
        eval_train=False,
        partition=args.partition,
        dirichlet_alpha=args.dirichlet_alpha,
        size_skew=args.size_skew,
        participation=args.participation,
        bucket_size=args.bucket_size,
        client_momentum=args.client_momentum,
        attack_param=args.attack_param,
        krum_m=args.krum_m,
        clip_tau=args.clip_tau,
        clip_iters=args.clip_iters,
        sign_eta=args.sign_eta,
        sign_bits=args.sign_bits,
        dnc_iters=args.dnc_iters,
        dnc_sub_dim=args.dnc_sub_dim,
        dnc_c=args.dnc_c,
        fault=args.fault,
        dropout_prob=args.dropout_prob,
        fade_floor=args.fade_floor,
        csi_std=args.csi_std,
        corrupt_prob=args.corrupt_prob,
        corrupt_mode=args.corrupt_mode,
        corrupt_size=args.corrupt_size,
        defense=args.defense,
        defense_ladder=args.defense_ladder,
        defense_warmup=args.defense_warmup,
        defense_alpha=args.defense_alpha,
        defense_drift=args.defense_drift,
        defense_cusum=args.defense_cusum,
        defense_z=args.defense_z,
        defense_up=args.defense_up,
        defense_down=args.defense_down,
        defense_min_flagged=args.defense_min_flagged,
        defense_floor=args.defense_floor,
        defense_leak=args.defense_leak,
        cohort_size=args.cohort_size,
        cohort_quantile=args.cohort_quantile,
        cohort_sketch_bins=args.cohort_sketch_bins,
        service=args.service,
        population=args.population,
        churn_arrival=args.churn_arrival,
        churn_departure=args.churn_departure,
        straggler_prob=args.straggler_prob,
        rollback=args.rollback,
        rollback_loss_factor=args.rollback_loss_factor,
        rollback_cusum=args.rollback_cusum,
        rollback_widen=args.rollback_widen,
        rollback_max=args.rollback_max,
        rounds_per_dispatch=args.rounds_per_dispatch,
        eval_interval=args.eval_interval,
        dispatch_mode=args.dispatch_mode,
        dispatch_prefetch=args.dispatch_prefetch,
        async_writer=args.async_writer,
        use_gpu=args.device == "cuda",
    )
    # stdout keeps one JSON object per completed cell (the shape scripts
    # already parse — schema stamps v/kind/ts are additive); --obs-dir tees
    # the same events into an append-safe JSONL stream
    sinks = [obs_lib.StdoutSink()]
    if args.obs_dir:
        sinks.append(obs_lib.JsonlSink(obs_lib.events_path(args.obs_dir, "sweep")))
    sink = obs_lib.MultiSink(sinks) if len(sinks) > 1 else sinks[0]
    try:
        grid = run_sweep(
            aggs,
            attacks,
            cfg_kw,
            seeds=args.seeds,
            batched=args.batched,
            on_cell=lambda agg, attack, cell: sink.emit(
                obs_lib.make_event(
                    "sweep_cell", agg=agg, attack=attack or "none", **cell
                )
            ),
        )
    finally:
        sink.close()
    print(markdown_table(grid), file=sys.stderr, flush=True)
    if args.out:
        io_lib.atomic_pickle(
            args.out, {f"{a}|{t or 'none'}": c for (a, t), c in grid.items()}
        )
        print(f"[sweep] grid pickled to {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
