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

Multiple cards, one process each: ``--multihost --coordinator host:port
--num-processes N --process-id i`` starts the ``torch.distributed`` process
group (NCCL; gloo with ``--device cpu``), and the run then shards its
clients over the N ranks (``--sharding auto|on|off``, ``--model-parallel
M`` ranks along d) or, with ``--pop-shards N`` on a streamed service round,
its cohort chunks; rank 0 writes the record.

Multi-round dispatch: ``--rounds-per-dispatch R`` (R divides ``--rounds``)
runs R rounds per dispatch, on the card each round one replay of a CUDA
graph of the round where the configuration allows it (the run's banner says
whether it does, and why not); ``--eval-interval`` (a multiple of R; 0 =
every dispatch), ``--dispatch-mode exact|degraded``, ``--dispatch-prefetch
off|on`` and ``--async-writer auto|on|off`` tune it.

Observability (output-only): ``--obs-dir D`` writes the run's event
stream (the JAX package's schema v10) to ``D/{title}_c{hash}.events.jsonl``
(``--obs-stdout`` prints it too, ``--obs-rotate-mb`` rotates it, ``--trace
on`` gives spans ids); ``--forensics top|full`` (with ``--forensics-top``
and ``--flight-window``; needs ``--defense``) adds ``client_flag`` events
and, under ``full``, ``flight_*.json`` beside the stream; ``--profile-dir
P [--profile-rounds A:B]`` writes a ``torch.profiler`` trace to
``P/trace.json``; ``--hbm-warn-factor`` sets when the memory check warns;
``--log-file`` tees the log and ``--quiet`` silences it.  Live telemetry:
``--metrics on`` folds the events into a metrics registry,
``--metrics-port N`` serves it as ``/metrics`` and ``/healthz`` for the
run's duration, and ``--alerts default|rules.json`` evaluates SLO rules
each round (both imply ``--metrics on``); the run ends with the alert
summary on the log and a ``metrics_snapshot`` event.

The implementation knobs: ``--agg-impl auto|pallas|xla`` (``pallas`` the
hand-written CUDA kernels, ``xla`` their plain torch versions on any
device, ``auto`` the kernels on the card and the plain versions on the
CPU; ``pallas`` with ``--device cpu`` is refused), ``--fused-epilogue
auto|on|off`` (fold the channel into the selection's read),
``--stack-dtype f32|bf16`` (the dtype of the stack the rule reads) and
``--prng-impl threefry`` (JAX's ``rbg`` and ``unsafe_rbg`` are refused).
``--backend ref`` runs the NumPy referee (``backends/ref_trainer.py``)
instead of the torch trainer, on no device.  ``--preset NAME`` starts from
a named configuration (``presets.py``); a flag present on the command line
overrides the preset, even at its default value.

The reference's own flags are all here: ``--opt`` (only ``SGD``),
``--agg``, ``--attack`` (also ``name@R``, an onset at round R), ``--var``,
``--inherit``, ``--mark``, ``--use-gpu``, ``--K``, ``--B``.  ``--inherit``
works: with ``--checkpoint-dir D`` every round is checkpointed under D, and
``--inherit`` resumes from there.  ``--use-gpu false`` asks for the CPU, as
``--device cpu`` does; the two must not disagree.  A run never goes to the
CPU for want of a card.

Subcommands: ``serve`` boots the multi-tenant experiment server
(``serve/``; ``--host``, ``--port``, ``--obs-root``, ``--backend``,
``--batch-window``, ``--queue-cap``, ``--run-retries``, ``--run-backoff``,
``--wedge-secs``, ``--auth-token``, ``--device``), ``tune`` the defense
tuner (``tune/tuner.py``), ``root`` and ``edge`` the two-tier
aggregation's root and edges (``serve/root.py``, ``serve/edge.py``; each on
the card unless ``--device cpu``).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from .fed.config import FedConfig


def add_knob_flags(p) -> None:
    """The attack and defense magnitudes, the data split, the training
    options, the fault channel, the defense, cohort streaming, service
    rounds and their population shards, and multi-round dispatch: shared by
    the run CLI and the sweep (JAX ``cli.py:31``)."""
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
    p.add_argument("--participation", type=float, default=1.0,
                   help="fraction of clients active per iteration (stratified "
                        "honest/Byzantine draw; 1.0 = all, the reference's behavior)")
    p.add_argument("--client-momentum", type=float, default=0.0,
                   help="client-side momentum beta (needs --local-steps 1); 0 = off")
    p.add_argument("--bucket-size", type=int, default=1,
                   help="server-side bucketing: aggregate the means of random "
                        "s-client buckets; 1 = off")
    p.add_argument("--cohort-size", type=int, default=0,
                   help="stream the round over client chunks of this size instead "
                        "of the resident [K, d] stack (peak memory O(cohort*d)); "
                        "must divide the honest and Byzantine sizes; 0 = resident")
    p.add_argument("--cohort-quantile", choices=["exact", "sketch"], default="exact",
                   help="streamed median/trimmed_mean: exact key bisection (32 "
                        "counting passes) or a mergeable histogram sketch")
    p.add_argument("--cohort-sketch-bins", type=int, default=512,
                   help="histogram resolution of the quantile sketch")
    p.add_argument("--attack-param", type=float, default=None,
                   help="scalar attack magnitude (alie z / ipm eps / gaussian "
                        "sigma / minmax+minsum fixed gamma)")
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
    p.add_argument("--pop-shards", type=int, default=1,
                   help="split the streamed service round's cohort chunks over this "
                        "many owners: one rank each in a process group of that size "
                        "(parallel/popmesh.py), a sequential engine otherwise; 1 = the "
                        "single chunk loop (> 1 requires --service on with "
                        "--cohort-size)")
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


# argparse dest -> FedConfig field, for every flag that sets a field: the
# full config without a preset, and with one the overrides of the flags
# present on the command line (JAX ``cli.py:ARG_TO_FIELD``).  ``--K``,
# ``--B``, ``--device`` and ``--use-gpu`` are resolved apart
ARG_TO_FIELD = {
    "opt": "opt", "agg": "agg", "attack": "attack", "var": "noise_var",
    "inherit": "inherit", "mark": "mark", "rounds": "rounds",
    "interval": "display_interval", "batch_size": "batch_size", "gamma": "gamma",
    "weight_decay": "weight_decay", "local_steps": "local_steps",
    "fedprox_mu": "fedprox_mu", "server_opt": "server_opt", "server_lr": "server_lr",
    "server_momentum": "server_momentum", "seed": "seed", "cache_dir": "cache_dir",
    "eval_train": "eval_train", "checkpoint_dir": "checkpoint_dir",
    "dataset": "dataset", "model": "model", "resnet_width": "resnet_width",
    "remat": "remat", "agg_impl": "agg_impl", "fused_epilogue": "fused_epilogue",
    "prng_impl": "prng_impl", "stack_dtype": "stack_dtype", "sharding": "sharded",
    "model_parallel": "model_parallel",
}
# --sharding's words -> the sharded field (JAX cli.py:26)
_SHARDING = {"auto": None, "on": True, "off": False}
_CONVERT = {"sharding": _SHARDING.get}


def _field_value(args: argparse.Namespace, dest: str):
    value = getattr(args, dest)
    return _CONVERT[dest](value) if dest in _CONVERT else value
_KNOB_FIELDS = (
    "partition", "dirichlet_alpha", "size_skew", "participation", "client_momentum",
    "bucket_size", "cohort_size", "cohort_quantile", "cohort_sketch_bins", "attack_param",
    "krum_m", "clip_tau", "clip_iters", "sign_eta", "sign_bits", "dnc_iters",
    "dnc_sub_dim", "dnc_c", "fault", "dropout_prob", "fade_floor", "csi_std",
    "corrupt_prob", "corrupt_mode", "corrupt_size", "defense",
    *FedConfig._DEFENSE_KNOBS, "service", *FedConfig._SERVICE_KNOBS, "pop_shards",
    "rounds_per_dispatch", "eval_interval", "dispatch_mode", "dispatch_prefetch",
    "async_writer", *FedConfig._OBS_FIELDS,
)
ARG_TO_FIELD.update({name: name for name in _KNOB_FIELDS})


def build_parser() -> argparse.ArgumentParser:
    from . import presets

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
    # the framework surface
    p.add_argument("--backend", choices=["torch", "ref"], default="torch",
                   help="torch: the port's trainer; ref: the NumPy referee "
                        "(backends/ref_trainer.py), on no device")
    p.add_argument("--agg-impl", choices=["auto", "xla", "pallas"], default="auto",
                   help="the rules' kernels: pallas = the hand-written CUDA kernels, "
                        "xla = their plain torch versions (any device), auto = "
                        "pallas on the card, xla on the CPU")
    p.add_argument("--fused-epilogue", choices=["auto", "on", "off"], default="auto",
                   help="fold the OMA channel into median's/trimmed_mean's read of "
                        "the stack (auto = under --agg-impl pallas where nothing "
                        "else reads the received stack)")
    add_knob_flags(p)
    p.add_argument("--prng-impl", choices=["threefry", "rbg", "unsafe_rbg"],
                   default="threefry",
                   help="the random streams: threefry names the port's own (torch "
                        "Philox); rbg and unsafe_rbg, a TPU hardware RNG path, are "
                        "refused")
    p.add_argument("--stack-dtype", choices=["f32", "bf16"], default="f32",
                   help="[K, d] client-stack dtype fed to the aggregator (bf16 halves "
                        "the bytes each Weiszfeld step reads; f32 arithmetic)")
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
    p.add_argument("--seed", type=int, default=2021)
    p.add_argument("--cache-dir", type=str, default="",
                   help="where the pickled record goes (default "
                        "./{DATASET}_Air_weight_torch/)")
    eval_group = p.add_mutually_exclusive_group()
    eval_group.add_argument("--eval-train", dest="eval_train", action="store_true",
                            default=True, help="evaluate the train set every round "
                            "(the default; re-enables it over a preset)")
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
    # observability (obs/), all output-only: never in the title or the
    # config hash, the records bitwise the same with them on or off
    p.add_argument("--profile-dir", type=str, default="",
                   help="write a torch.profiler trace of the run here (Chrome/Perfetto "
                        "JSON; rounds carry a 'round' range, eval/checkpoint named ranges)")
    p.add_argument("--profile-rounds", type=str, default="", metavar="A:B",
                   help="restrict the trace to the half-open round window [A, B) "
                        "(requires --profile-dir)")
    p.add_argument("--hbm-warn-factor", type=float, default=2.0,
                   help="warn when the card's measured memory peak exceeds the memory "
                        "model by this factor (output-only)")
    p.add_argument("--obs-dir", type=str, default="",
                   help="write the schema-versioned per-round event stream (JSONL) here")
    p.add_argument("--obs-stdout", action="store_true",
                   help="also emit structured events as JSON lines on stdout")
    p.add_argument("--log-file", type=str, default="",
                   help="tee harness log lines to this file (append, flushed per line)")
    p.add_argument("--obs-rotate-mb", type=float, default=0.0,
                   help="rotate the --obs-dir event stream once the live file passes this "
                        "many MiB (segments keep one seq envelope; 0 = off)")
    p.add_argument("--trace", choices=["off", "on"], default="off",
                   help="spans mint trace/span ids and nest (output-only)")
    p.add_argument("--metrics", choices=["off", "on"], default="off",
                   help="fold the event stream into an in-process metrics registry "
                        "(counters/gauges/histograms; implied by --metrics-port/--alerts)")
    p.add_argument("--metrics-port", type=int, default=0,
                   help="serve Prometheus /metrics + /healthz on this port for the "
                        "duration of the run (0 = no exporter)")
    p.add_argument("--alerts", type=str, default="off",
                   help="SLO alert rules evaluated each round: 'default' for the "
                        "built-in pack or a path to a JSON rule list; alert events "
                        "join the stream")
    p.add_argument("--quiet", action="store_true",
                   help="suppress harness log lines on stdout (file tee still written)")
    p.add_argument("--forensics", choices=["off", "top", "full"], default="off",
                   help="per-client flag provenance: 'top' emits client_flag events for "
                        "flagged clients in the round's top-M, 'full' emits the whole "
                        "top-M and arms the flight recorder (requires --defense)")
    p.add_argument("--forensics-top", type=int, default=8,
                   help="M: suspicious clients extracted per round (<= K)")
    p.add_argument("--flight-window", type=int, default=8,
                   help="W: rounds of detector state kept in the flight-recorder ring")
    p.add_argument("--preset", choices=presets.names(), default=None,
                   help="named configuration (presets.py); flags present on the "
                        "command line override the preset")
    p.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="cuda (default) or cpu")
    # the execution layout (parallel/): the clients over the process group's
    # ranks, and the multi-process start-up, one process per card.  Any of
    # the last four brings the process group up (NCCL on the card, gloo with
    # --device cpu) before the trainer is built
    p.add_argument("--sharding", choices=["auto", "on", "off"], default="auto",
                   help="shard the clients over the process group's ranks (auto: when "
                        "there are several and K divides evenly)")
    p.add_argument("--model-parallel", type=int, default=None,
                   help="ranks along the model (d) axis of the grid")
    p.add_argument("--multihost", action="store_true",
                   help="start the torch.distributed process group (from the "
                        "launcher's MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK when the "
                        "explicit flags are left out)")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of rank 0's TCPStore")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
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


def _explicit_dests(argv: Sequence[str]) -> set:
    """The dests of the options present in ``argv``: a re-parse with every
    default suppressed leaves an absent flag's attribute unset (JAX
    ``cli.py:577``)."""
    p = build_parser()
    for action in p._actions:
        action.default = argparse.SUPPRESS
    ns, _ = p.parse_known_args(list(argv))
    return set(vars(ns))


def config_from_args(args: argparse.Namespace,
                     argv: Optional[Sequence[str]] = None) -> FedConfig:
    """The run's config from parsed flags (JAX ``cli.py:588-630``).  With
    ``--preset`` the preset's fields stand unless a flag present in
    ``argv`` (the argv that gave ``args``) overrides them, even at its
    default value; ``--K``/``--B`` apply last, as the reference's
    override."""
    device = resolve_device_flags(args.device, args.use_gpu)
    if args.preset is not None:
        from . import presets

        if argv is None:
            raise ValueError(
                "config_from_args(args, argv) needs the argv that gave args when "
                "--preset is used: which flags are explicit comes from it"
            )
        given = _explicit_dests(argv)
        overrides = {field: _field_value(args, dest) for dest, field in ARG_TO_FIELD.items()
                     if dest in given}
        cfg = presets.get(args.preset, use_gpu=device == "cuda", **overrides)
    else:
        cfg = FedConfig(use_gpu=device == "cuda",
                        **{field: _field_value(args, dest)
                           for dest, field in ARG_TO_FIELD.items()})
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


def serve_main(argv: Sequence[str]):
    """``python -m byzantine_aircomp_tpu_torch serve``: boot the multi-tenant
    experiment server (JAX ``cli.py:633-701``) on the card (``--device cpu``
    for the CPU) and block until interrupted."""
    import time

    p = argparse.ArgumentParser("byzantine_aircomp_tpu_torch serve")
    p.add_argument("--port", type=int, default=0,
                   help="HTTP port for the run API + /metrics + /healthz "
                        "(0 = OS-assigned ephemeral, printed at boot)")
    p.add_argument("--host", type=str, default="0.0.0.0")
    p.add_argument("--obs-root", type=str, default="./serve_runs",
                   help="root of the per-run output subtrees "
                        "(<obs-root>/<run_id>/ holds each tenant's events, "
                        "checkpoints, caches)")
    p.add_argument("--backend", choices=["vmap", "map"], default="vmap",
                   help="the lanes' backend; both run a group's lanes in turn, "
                        "on one stream (serve/batch.py)")
    p.add_argument("--batch-window", type=float, default=0.25,
                   help="seconds to wait after a submission before draining, "
                        "so concurrent tenants coalesce into one group")
    p.add_argument("--queue-cap", type=int, default=0,
                   help="max queued runs before POST /runs answers 429 "
                        "(0 = unbounded)")
    p.add_argument("--run-retries", type=int, default=1,
                   help="watchdog requeues per wedged run before it is "
                        "failed for good")
    p.add_argument("--run-backoff", type=float, default=2.0,
                   help="base seconds of the watchdog's exponential "
                        "requeue backoff (delay = backoff * 2^(retry-1))")
    p.add_argument("--wedge-secs", type=float, default=0.0,
                   help="seconds without a completed round before a "
                        "running run counts as wedged (0 = watchdog off); "
                        "/healthz reports 503 while any run is wedged")
    p.add_argument("--auth-token", type=str, default=None,
                   help="bearer token required on the mutating endpoints "
                        "(POST /runs, /cancel, /knobs return 401 without "
                        "'Authorization: Bearer <token>'); /metrics and "
                        "/healthz stay open for scrapes")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="the tenants' device: cuda (default; start-up fails "
                        "without a GPU) or cpu")
    args = p.parse_args(list(argv))
    from .serve.server import ExperimentServer

    server = ExperimentServer(
        args.obs_root,
        port=args.port,
        host=args.host,
        backend=args.backend,
        batch_window=args.batch_window,
        queue_cap=args.queue_cap,
        run_retries=args.run_retries,
        run_backoff=args.run_backoff,
        wedge_secs=args.wedge_secs,
        auth_token=args.auth_token,
        device=args.device,
    ).start()
    print(f"experiment server on {args.host}:{server.port} "
          f"(obs root: {args.obs_root}; device {args.device}; backend {args.backend}: "
          "a group's lanes run in turn on one stream)", flush=True)
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        server.close()


def main(argv: Optional[Sequence[str]] = None):
    import sys

    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "serve":
        return serve_main(argv[1:])
    if argv and argv[0] == "tune":
        from .tune.tuner import main as tune_main

        return tune_main(list(argv[1:]))
    if argv and argv[0] == "root":
        from .serve.root import main as root_main

        return root_main(list(argv[1:]))
    if argv and argv[0] == "edge":
        from .serve.edge import main as edge_main

        return edge_main(list(argv[1:]))
    args = build_parser().parse_args(argv)
    if (args.multihost or args.coordinator is not None or args.num_processes is not None
            or args.process_id is not None):
        # (JAX cli.py:718-731) before anything touches a device
        from .parallel import multihost

        multihost.initialize(coordinator=args.coordinator, num_processes=args.num_processes,
                             process_id=args.process_id,
                             device=resolve_device_flags(args.device, args.use_gpu))
        print(multihost.process_summary())
    cfg = config_from_args(args, argv)
    if args.backend == "ref":
        # the NumPy referee (JAX cli.py:733-736): no torch device
        from .backends.ref_trainer import run_ref

        return run_ref(cfg)
    from .fed import harness
    from .parallel import multihost

    try:
        return harness.run(cfg, device="cuda" if cfg.use_gpu else "cpu")
    finally:
        multihost.shutdown()
