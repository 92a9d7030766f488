"""Fault-tolerance matrix: run (aggregator x fault x attack) cells and
tabulate accuracy and survival (JAX ``analysis/fault_matrix.py``).

The sweep (:mod:`.sweep`) answers which aggregator survives which
adversary; this tool answers which aggregator survives which
non-adversarial failure (``ops/faults.py``), alone and composed with an
attack.  Each cell trains from scratch on the port's :class:`Trainer` and
reports the final val accuracy, whether the global params stayed finite
every round (the receiver's finite guard working), and the least
per-round effective client count:

    python -m byzantine_aircomp_tpu_torch.analysis.fault_matrix \\
        --aggs gm2,krum,trimmed_mean --faults none,dropout,chaos \\
        --attacks none,classflip --K 20 --B 4 --rounds 5

Output: one JSON line per cell on stdout (kind ``fault_cell``), a markdown
table per attack on stderr, and optionally an atomic pickle of the grid
(``--out``).  Cells run on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import obs as obs_lib
from ..fed.config import FedConfig
from ..fed.train import Trainer
from ..registry import AGGREGATORS, ATTACKS, FAULTS
from ..utils import io as io_lib

Cell = Tuple[str, Optional[str], Optional[str]]  # (agg, fault, attack)


def run_cell(agg: str, fault: Optional[str], attack: Optional[str], cfg_kw: dict, dataset,
             device: str = "cuda") -> Dict[str, float]:
    """Train one (aggregator, fault, attack) cell.  Beyond the accuracy it
    records ``finite_all_rounds`` and, with a fault, ``min_effective_k``
    and the summed dropped/erased/corrupt counts."""
    kw = dict(cfg_kw)
    kw["agg"] = agg
    kw["attack"] = attack
    kw["fault"] = fault
    if attack is None and kw.get("byz_size"):
        kw["byz_size"] = 0  # reference semantics (run(), :430-431)
    cfg = FedConfig(**kw)
    trainer = Trainer(cfg, dataset=dataset, device=device)
    finite_all = True
    min_eff_k = float(cfg.node_size)
    dropped = erased = corrupt = 0.0
    for r in range(cfg.rounds):
        trainer.run_round(r)
        finite_all = finite_all and bool(np.isfinite(trainer.flat_params.cpu().numpy()).all())
        if fault is not None:
            d, e, c, eff_k = (float(v) for v in trainer.last_fault_metrics.tolist())
            dropped, erased, corrupt = dropped + d, erased + e, corrupt + c
            min_eff_k = min(min_eff_k, eff_k)
    loss, acc = trainer.evaluate("val")
    metrics: Dict[str, float] = {
        "val_acc": round(acc, 4),
        "val_loss": round(loss, 4),
        "finite_all_rounds": finite_all,
    }
    if fault is not None:
        metrics.update(min_effective_k=min_eff_k, dropped=dropped, erased=erased,
                       corrupt=corrupt)
    return metrics


def run_matrix(
    aggs: List[str],
    faults: List[Optional[str]],
    attacks: List[Optional[str]],
    cfg_kw: dict,
    dataset=None,
    log=lambda s: print(s, file=sys.stderr, flush=True),
    on_cell=None,
    device: str = "cuda",
) -> Dict[Cell, Dict[str, float]]:
    """The full cube; the data set is loaded once and shared by the cells."""
    from ..data import datasets as data_lib

    for a in aggs:
        AGGREGATORS.get(a)  # fail fast on typos, before any training
    for f in faults:
        if f is not None:
            FAULTS.get(f)
    for t in attacks:
        if t is not None:
            ATTACKS.get(t)
    if dataset is None:
        dataset = data_lib.load(cfg_kw.get("dataset", "mnist"))
    grid: Dict[Cell, Dict[str, float]] = {}
    for attack in attacks:
        for fault in faults:
            for agg in aggs:
                cell = run_cell(agg, fault, attack, cfg_kw, dataset, device)
                grid[(agg, fault, attack)] = cell
                log(f"[fault_matrix] agg={agg} fault={fault} attack={attack}: {cell}")
                if on_cell is not None:
                    on_cell(agg, fault, attack, cell)
    return grid


def markdown_table(grid: Dict[Cell, Dict[str, float]], metric: str = "val_acc") -> str:
    """One ``fault x agg`` table per attack; a cell whose params went
    non-finite is marked ``!``, so a survival failure cannot hide behind a
    plausible number."""
    aggs = sorted({a for a, _, _ in grid})
    faults = sorted({f for _, f, _ in grid}, key=lambda f: (f is not None, f))
    attacks = sorted({t for _, _, t in grid}, key=lambda t: (t is not None, t))
    blocks = []
    for t in attacks:
        head = f"**attack: {t or 'none'}**\n\n| fault \\ agg | " + " | ".join(aggs) + " |"
        sep = "|" + "---|" * (len(aggs) + 1)
        rows = []
        for f in faults:
            cells = []
            for a in aggs:
                c = grid[(a, f, t)]
                mark = "" if c["finite_all_rounds"] else " !"
                cells.append(f"{c[metric]:.4f}{mark}")
            rows.append(f"| {f or 'none'} | " + " | ".join(cells) + " |")
        blocks.append("\n".join([head, sep] + rows))
    return "\n\n".join(blocks)


def _none_list(spec: str) -> List[Optional[str]]:
    return [None if x in ("none", "") else x for x in spec.split(",")]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--aggs", default="gm2,krum,trimmed_mean,mean")
    ap.add_argument("--faults", default="none,dropout,deep_fade,csi,corrupt,chaos")
    ap.add_argument("--attacks", default="none,classflip")
    ap.add_argument("--dataset", default="mnist")
    ap.add_argument("--K", type=int, default=20)
    ap.add_argument("--B", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--interval", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=50)
    ap.add_argument("--gamma", type=float, default=1e-2)
    ap.add_argument("--var", type=float, default=None)
    ap.add_argument("--seed", type=int, default=2021)
    ap.add_argument("--out", default=None, help="pickle the grid here")
    ap.add_argument("--obs-dir", default=None,
                    help="also append fault_cell events (JSONL) here")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    aggs = [a for a in args.aggs.split(",") if a]
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
        use_gpu=args.device == "cuda",
    )
    # stdout keeps one JSON object per finished cell; --obs-dir tees the
    # same events into an append-safe JSONL
    sinks = [obs_lib.StdoutSink()]
    if args.obs_dir:
        sinks.append(obs_lib.JsonlSink(obs_lib.events_path(args.obs_dir, "fault_matrix")))
    sink = obs_lib.MultiSink(sinks) if len(sinks) > 1 else sinks[0]
    try:
        grid = run_matrix(
            aggs, _none_list(args.faults), _none_list(args.attacks), cfg_kw,
            device=args.device,
            on_cell=lambda agg, fault, attack, cell: sink.emit(obs_lib.make_event(
                "fault_cell", agg=agg, fault=fault or "none", attack=attack or "none",
                **cell)),
        )
    finally:
        sink.close()
    print(markdown_table(grid), file=sys.stderr, flush=True)
    if args.out:
        io_lib.atomic_pickle(
            args.out, {f"{a}|{f or 'none'}|{t or 'none'}": c for (a, f, t), c in grid.items()})
        print(f"[fault_matrix] grid pickled to {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
