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

``--model CNN`` trains the reference's CNN and ``--model ResNet18
--dataset cifar10 [--resnet-width W] [--remat]`` ResNet-18;
``--partition dirichlet --dirichlet-alpha A`` splits the data label-skewed
and ``--size-skew zipf:S`` skews the shard sizes.

The training options: ``--local-steps E`` (FedAvg), ``--fedprox-mu``,
``--server-opt momentum|adam`` with ``--server-lr`` and
``--server-momentum`` (FedAvgM, FedAdam), ``--client-momentum``,
``--participation`` and ``--bucket-size``; the online defense:
``--defense monitor|adaptive`` with its ``--defense-*`` knobs, which also
enables the defense-aware attacks ``mimic``, ``under_radar`` and
``duty_cycle``.

Service rounds: ``--service on --population P`` (a multiple of K) with
``--churn-arrival``, ``--churn-departure``, ``--straggler-prob`` and the
warm rollback's ``--rollback``, ``--rollback-loss-factor``,
``--rollback-cusum``, ``--rollback-widen`` and ``--rollback-max``.
Cohort-streamed rounds: ``--cohort-size C`` (C divides the honest and the
Byzantine counts; mean, median, trimmed_mean or gm2) with
``--cohort-quantile exact|sketch`` and ``--cohort-sketch-bins``; the two
compose.

Multi-round dispatch: ``--rounds-per-dispatch R`` (R divides ``--rounds``)
runs R rounds per dispatch, on the card each round one replay of a CUDA
graph of the round where the configuration allows it (the run's banner says
whether it does, and why not); ``--eval-interval`` (a multiple of R; 0 =
every dispatch), ``--dispatch-mode exact|degraded``, ``--dispatch-prefetch
off|on`` and ``--async-writer auto|on|off`` tune it.

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
    p.add_argument("--local-steps", type=int, default=1,
                   help="local SGD steps per client per iteration (1 = reference FedSGD)")
    p.add_argument("--fedprox-mu", type=float, default=0.0,
                   help="FedProx proximal coefficient (anchors client drift when "
                        "--local-steps > 1; 0 = plain FedAvg/FedSGD)")
    p.add_argument("--server-opt", choices=["none", "momentum", "adam"], default="none",
                   help="server optimizer over the pseudo-gradient (FedAvgM / FedAdam)")
    p.add_argument("--server-lr", type=float, default=1.0)
    p.add_argument("--server-momentum", type=float, default=0.9)
    p.add_argument("--participation", type=float, default=1.0,
                   help="fraction of clients active per iteration (stratified "
                        "honest/Byzantine draw; 1.0 = all, the reference's behavior)")
    p.add_argument("--client-momentum", type=float, default=0.0,
                   help="client-side momentum beta (needs --local-steps 1); 0 = off")
    p.add_argument("--bucket-size", type=int, default=1,
                   help="server-side bucketing: aggregate the means of random "
                        "s-client buckets; 1 = off")
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
    p.add_argument("--resnet-width", type=int, default=64,
                   help="ResNet-18 stem width (64 = standard; a multiple of 8)")
    p.add_argument("--remat", action="store_true",
                   help="recompute residual-block activations in the backward "
                        "pass (less activation memory for more FLOPs)")
    p.add_argument("--partition", choices=["contiguous", "dirichlet"],
                   default="contiguous",
                   help="client data split (dirichlet = label-skewed non-IID, "
                        "Hsu et al. 2019)")
    p.add_argument("--dirichlet-alpha", type=float, default=0.3,
                   help="Dirichlet concentration for --partition dirichlet "
                        "(smaller = more label skew)")
    p.add_argument("--size-skew", type=str, default="none",
                   help="per-client quantity skew: 'zipf:<s>' re-cuts the "
                        "(possibly Dirichlet-permuted) sample stream into "
                        "Zipf(s)-proportioned shards (zipf:0 = the equal cut)")
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
    # the online defense; its knob flags require --defense monitor|adaptive
    p.add_argument("--defense", choices=["off", "monitor", "adaptive"], default="off",
                   help="anomaly detection: monitor = score and report only, "
                        "adaptive = escalate the aggregator through "
                        "--defense-ladder (off runs no defense code)")
    p.add_argument("--defense-ladder", type=str, default="mean,trimmed_mean,multi_krum",
                   help="comma-separated aggregator escalation ladder; under "
                        "adaptive the first rung must equal --agg")
    p.add_argument("--defense-warmup", type=int, default=5,
                   help="iterations of baseline building before any flag")
    p.add_argument("--defense-alpha", type=float, default=0.1,
                   help="EMA rate of the per-client score baseline")
    p.add_argument("--defense-drift", type=float, default=0.5,
                   help="CUSUM drift allowance (in robust z-units)")
    p.add_argument("--defense-cusum", type=float, default=8.0,
                   help="CUSUM change-point alarm threshold")
    p.add_argument("--defense-z", type=float, default=4.0,
                   help="instantaneous robust z-score alarm threshold")
    p.add_argument("--defense-up", type=int, default=3,
                   help="consecutive suspicious iterations per escalation")
    p.add_argument("--defense-down", type=int, default=20,
                   help="consecutive clean iterations per de-escalation")
    p.add_argument("--defense-min-flagged", type=int, default=1,
                   help="flagged clients that make an iteration suspicious")
    p.add_argument("--defense-floor", type=float, default=1.5,
                   help="escalation-budget threshold above which the rung floor "
                        "pins at 1 (0 disables the floor)")
    p.add_argument("--defense-leak", type=float, default=0.005,
                   help="per-iteration decay rate of the escalation budget")
    p.add_argument("--cohort-size", type=int, default=0,
                   help="stream the round over client chunks of this size instead "
                        "of the resident [K, d] stack (peak memory O(cohort*d)); "
                        "must divide the honest and Byzantine sizes; 0 = resident")
    p.add_argument("--cohort-quantile", choices=["exact", "sketch"], default="exact",
                   help="streamed median/trimmed_mean: exact key bisection (32 "
                        "counting passes) or a mergeable histogram sketch")
    p.add_argument("--cohort-sketch-bins", type=int, default=512,
                   help="histogram resolution of the quantile sketch")
    # service rounds; the knob flags require --service on
    p.add_argument("--service", choices=["off", "on"], default="off",
                   help="service rounds: draw each iteration's K participants from "
                        "a --population with churn and a deadline, with warm "
                        "rollback")
    p.add_argument("--population", type=int, default=0,
                   help="registered client population, a positive multiple of K")
    p.add_argument("--churn-arrival", type=float, default=0.02,
                   help="per-iteration probability an offline client comes back")
    p.add_argument("--churn-departure", type=float, default=0.01,
                   help="per-iteration probability an online client leaves")
    p.add_argument("--straggler-prob", type=float, default=0.0,
                   help="per-iteration probability a drawn client misses the "
                        "deadline (its row is erased)")
    p.add_argument("--rollback", choices=["off", "on"], default="on",
                   help="warm rollback: on divergence restore the last good round "
                        "and go on with a widened trim under salted draws")
    p.add_argument("--rollback-loss-factor", type=float, default=3.0,
                   help="trip when the val loss exceeds this multiple of the "
                        "recent median")
    p.add_argument("--rollback-cusum", type=float, default=0.0,
                   help="trip when the defense CUSUM peak reaches this (0 = off; "
                        "requires --defense)")
    p.add_argument("--rollback-widen", type=float, default=1.5,
                   help="trim-fraction multiplier of each rollback")
    p.add_argument("--rollback-max", type=int, default=3,
                   help="rollbacks per run")
    # multi-round dispatch; the granularity knobs require
    # --rounds-per-dispatch > 1
    p.add_argument("--rounds-per-dispatch", type=int, default=1,
                   help="run R rounds per dispatch (on the card one CUDA-graph replay "
                        "per round); the record folds at dispatch ends, eval and "
                        "checkpoints move to R-round boundaries; 1 = the per-round "
                        "loop (R must divide --rounds)")
    p.add_argument("--eval-interval", type=int, default=0,
                   help="rounds between boundary evals under R>1 (0 = every dispatch "
                        "boundary; a multiple of R; skipped rounds repeat the last "
                        "eval in the record)")
    p.add_argument("--dispatch-mode", choices=["exact", "degraded"], default="exact",
                   help="R>1 granularity: 'degraded' accepts the warm-rollback guard "
                        "at dispatch boundaries (needed for R>1 with --service on "
                        "--rollback on); 'exact' refuses what would coarsen")
    p.add_argument("--dispatch-prefetch", choices=["off", "on"], default="off",
                   help="launch dispatch i+1 before folding dispatch i's records "
                        "(timing only; records bitwise equal)")
    p.add_argument("--async-writer", choices=["auto", "on", "off"], default="auto",
                   help="a writer thread for checkpoint writes and the record pickle "
                        "(auto = on iff --rounds-per-dispatch > 1); output-only")
    p.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="cuda (default) or cpu")
    return p


_TRUE, _FALSE = ("true", "1", "yes", "on"), ("false", "0", "no", "off")

# the --defense flags, as suffixes of their FedConfig fields
_DEFENSE_SUFFIXES = ("", "_ladder", "_warmup", "_alpha", "_drift", "_cusum", "_z", "_up",
                     "_down", "_min_flagged", "_floor", "_leak")

# the cohort, service and dispatch flags: their FedConfig fields, as named
_FLAG_FIELDS = ("cohort_size", "cohort_quantile", "cohort_sketch_bins") + (
    ("service",) + FedConfig._SERVICE_KNOBS) + (
    "rounds_per_dispatch", "eval_interval", "dispatch_mode", "dispatch_prefetch",
    "async_writer")


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
        resnet_width=args.resnet_width,
        remat=args.remat,
        partition=args.partition,
        dirichlet_alpha=args.dirichlet_alpha,
        size_skew=args.size_skew,
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
        local_steps=args.local_steps,
        fedprox_mu=args.fedprox_mu,
        server_opt=args.server_opt,
        server_lr=args.server_lr,
        server_momentum=args.server_momentum,
        client_momentum=args.client_momentum,
        participation=args.participation,
        bucket_size=args.bucket_size,
        **{f"defense{name}": getattr(args, f"defense{name}") for name in _DEFENSE_SUFFIXES},
        **{name: getattr(args, name) for name in _FLAG_FIELDS},
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
