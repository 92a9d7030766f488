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

The reference's own flags are all here: ``--opt`` (only ``SGD``),
``--agg``, ``--attack`` (also ``name@R``, an onset at round R), ``--var``,
``--inherit``, ``--mark``, ``--use-gpu``, ``--K``, ``--B``.  ``--inherit``
works: with ``--checkpoint-dir D`` every round is checkpointed under D, and
``--inherit`` resumes from there.  ``--use-gpu false`` asks for the CPU, as
``--device cpu`` does; the two must not disagree.  A run never goes to the
CPU for want of a card.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from .fed.config import FedConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("byzantine_aircomp_tpu_torch")
    # the reference surface (MNIST_Air_weight.py:16-28)
    p.add_argument("--opt", type=str, default="SGD", choices=["SGD"], help="optimizer")
    p.add_argument("--agg", type=str, default="gm", help="aggregator name")
    p.add_argument("--attack", type=str, default=None,
                   help="attack name; name@R attacks from round R on")
    p.add_argument("--var", type=float, default=None, help="channel noise variance")
    p.add_argument("--inherit", action="store_true",
                   help="resume from the checkpoint under --checkpoint-dir")
    p.add_argument("--mark", type=str, default="", help="mark on title")
    p.add_argument("--use-gpu", type=str, default=None,
                   help="true (default): run on CUDA; false: run on the CPU, "
                        "like --device cpu")
    p.add_argument("--K", type=int, default=None, help="number of total devices")
    p.add_argument("--B", type=int, default=None, help="number of Byzantine devices")
    p.add_argument("--rounds", type=int, default=100)
    p.add_argument("--interval", type=int, default=10, help="displayInterval")
    p.add_argument("--batch-size", type=int, default=50)
    p.add_argument("--gamma", type=float, default=1e-2)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--attack-param", type=float, default=None,
                   help="scalar attack magnitude (alie z / ipm eps / gaussian "
                        "sigma / minmax+minsum fixed gamma)")
    p.add_argument("--seed", type=int, default=2021)
    p.add_argument("--cache-dir", type=str, default="",
                   help="where the pickled record goes (default "
                        "./{DATASET}_Air_weight_torch/)")
    eval_group = p.add_mutually_exclusive_group()
    eval_group.add_argument("--eval-train", dest="eval_train", action="store_true",
                            default=True, help="evaluate the train set every round "
                            "(the default)")
    eval_group.add_argument("--no-eval-train", dest="eval_train", action="store_false",
                            help="skip the train-set eval (its paths hold zeros)")
    p.add_argument("--checkpoint-dir", type=str, default="",
                   help="checkpoint every round here (and --inherit from here)")
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
    p.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="cuda (default) or cpu")
    return p


_TRUE, _FALSE = ("true", "1", "yes", "on"), ("false", "0", "no", "off")


def resolve_device_flags(device: Optional[str], use_gpu: Optional[str]) -> str:
    """``--device`` and ``--use-gpu`` -> "cuda" or "cpu".  Either flag may
    ask for the CPU; CUDA is the default; a conflict raises."""
    gpu = None
    if use_gpu is not None:
        if use_gpu.lower() not in _TRUE + _FALSE:
            raise ValueError(f"--use-gpu must be true or false, got {use_gpu!r}")
        gpu = use_gpu.lower() in _TRUE
    if gpu is not None and device is not None and gpu != (device == "cuda"):
        raise ValueError(
            f"--use-gpu {use_gpu} conflicts with --device {device}; give one"
        )
    if device is not None:
        return device
    return "cpu" if gpu is False else "cuda"


def config_from_args(args: argparse.Namespace) -> FedConfig:
    device = resolve_device_flags(args.device, args.use_gpu)
    cfg = FedConfig(
        opt=args.opt,
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
        inherit=args.inherit,
        mark=args.mark,
        use_gpu=device == "cuda",
        weight_decay=args.weight_decay,
        attack_param=args.attack_param,
        cache_dir=args.cache_dir,
        eval_train=args.eval_train,
        checkpoint_dir=args.checkpoint_dir,
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
    cfg = config_from_args(args)
    return harness.run(cfg, device="cuda" if cfg.use_gpu else "cpu")
