"""Command line of the port: the reference flags plus ``--device``.

    python -m byzantine_aircomp_tpu_torch --var 1e-2 --attack classflip --K 50 --B 10

runs the paper's experiment (``MNIST_Air_weight.py``, default aggregator
``gm``) on the GPU; ``--device cpu`` runs it on the CPU.  ``--agg`` also
takes ``gm2``, ``mean``, ``median``, ``trimmed_mean``, ``krum``,
``multi_krum``, ``bulyan`` (K > 4B), ``cclip``, ``dnc``, ``signmv`` and
``bev`` (with ``--sign-bits 1 --sign-eta E`` for the packed one-bit vote,
``--sign-bits 8|16`` for the quantized deltas).  ``--fault`` (``dropout``,
``deep_fade``, ``csi``, ``corrupt``, ``chaos``) injects non-adversarial
failures, and the rule runs in its degraded mode.
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
    p.add_argument("--krum-m", type=int, default=None,
                   help="multi-Krum selection count (default: honest size)")
    p.add_argument("--clip-tau", type=float, default=None,
                   help="centered-clipping radius (agg=cclip); default: the "
                        "per-step median client delta norm")
    p.add_argument("--clip-iters", type=int, default=3,
                   help="centered-clipping iterations (agg=cclip)")
    p.add_argument("--sign-eta", type=float, default=None,
                   help="signmv/bev step size (default: median |delta|)")
    p.add_argument("--sign-bits", type=int, choices=[1, 8, 16, 32], default=32,
                   help="signmv/bev ballot width: 32 = full precision, 8/16 = "
                        "quantize-dequantize emulation, 1 = packed words + "
                        "popcount (needs --sign-eta)")
    p.add_argument("--dnc-iters", type=int, default=3,
                   help="dnc filtering rounds (agg=dnc)")
    p.add_argument("--dnc-sub-dim", type=int, default=10000,
                   help="dnc coordinate-subsample size (agg=dnc)")
    p.add_argument("--dnc-c", type=float, default=1.0,
                   help="dnc removal multiplier: ceil(c*B) removed per round")
    p.add_argument("--fault", type=str, default=None,
                   help="fault scenario (dropout, deep_fade, csi, corrupt, "
                        "chaos); default: the ideal deployment")
    p.add_argument("--dropout-prob", type=float, default=None,
                   help="per-round client dropout probability (stale-update "
                        "replay); overrides the --fault scenario")
    p.add_argument("--fade-floor", type=float, default=None,
                   help="deep-fade outage threshold on |h|^2 (rows below are "
                        "erased); overrides the --fault scenario")
    p.add_argument("--csi-std", type=float, default=None,
                   help="CSI estimation error log-magnitude std; overrides the "
                        "--fault scenario")
    p.add_argument("--corrupt-prob", type=float, default=None,
                   help="per-round payload-corruption probability of the "
                        "faulty clients; overrides the --fault scenario")
    p.add_argument("--corrupt-mode", choices=["nan", "inf", "saturate"], default=None,
                   help="corrupted payload value class; overrides the --fault "
                        "scenario")
    p.add_argument("--corrupt-size", type=int, default=None,
                   help="number of corruption-eligible (honest) clients; "
                        "overrides the --fault scenario")
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
        krum_m=args.krum_m,
        clip_tau=args.clip_tau,
        clip_iters=args.clip_iters,
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
