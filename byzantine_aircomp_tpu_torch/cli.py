"""Command line of the port: the reference flags plus ``--device``.

    python -m byzantine_aircomp_tpu_torch --var 1e-2 --attack classflip --K 50 --B 10

runs the paper's experiment (``MNIST_Air_weight.py``, default aggregator
``gm``) on the GPU; ``--device cpu`` runs it on the CPU.  ``--agg`` also
takes ``gm2``, ``mean``, ``median``, ``trimmed_mean``, ``krum`` and
``signmv`` (with ``--sign-bits 1 --sign-eta E`` for the packed one-bit
vote).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from .fed.config import FedConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("byzantine_aircomp_tpu_torch")
    p.add_argument("--agg", type=str, default="gm", help="aggregator name")
    p.add_argument("--attack", type=str, default=None, help="attack name")
    p.add_argument("--var", type=float, default=None, help="channel noise variance")
    p.add_argument("--K", type=int, default=None, help="number of total devices")
    p.add_argument("--B", type=int, default=None, help="number of Byzantine devices")
    p.add_argument("--rounds", type=int, default=100)
    p.add_argument("--interval", type=int, default=10, help="displayInterval")
    p.add_argument("--batch-size", type=int, default=50)
    p.add_argument("--gamma", type=float, default=1e-2)
    p.add_argument("--seed", type=int, default=2021)
    p.add_argument("--dataset", type=str, default="mnist")
    p.add_argument("--model", type=str, default="MLP")
    p.add_argument("--sign-eta", type=float, default=None,
                   help="signmv step size (default: median |delta|)")
    p.add_argument("--sign-bits", type=int, choices=[1, 8, 16, 32], default=32,
                   help="signmv ballot width: 32 = full precision, 1 = packed "
                        "words + popcount (needs --sign-eta)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def config_from_args(args: argparse.Namespace) -> FedConfig:
    cfg = FedConfig(
        agg=args.agg,
        attack=args.attack,
        noise_var=args.var,
        rounds=args.rounds,
        display_interval=args.interval,
        batch_size=args.batch_size,
        gamma=args.gamma,
        seed=args.seed,
        dataset=args.dataset,
        model=args.model,
        sign_eta=args.sign_eta,
        sign_bits=args.sign_bits,
    )
    # reference --K/--B override: honestSize = K - B (:531-533); with K
    # alone the total node count becomes K, keeping the Byzantine count
    if args.K is not None and args.B is not None:
        cfg.honest_size = args.K - args.B
        cfg.byz_size = args.B
    elif args.K is not None:
        cfg.honest_size = args.K - cfg.byz_size
    elif args.B is not None:
        cfg.honest_size = cfg.node_size - args.B
        cfg.byz_size = args.B
    return cfg


def main(argv: Optional[Sequence[str]] = None):
    from .fed import harness

    args = build_parser().parse_args(argv)
    return harness.run(config_from_args(args), device=args.device)
