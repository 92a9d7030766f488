"""Run configuration of the port.

The JAX package's ``byzantine_aircomp_tpu/fed/config.py`` field for field
(the main path, every aggregation rule's knobs, the fault channel's, the
models' widths, the client partition, the training options, the online
defense, cohort streaming, service rounds and their population shards,
multi-round dispatch, the implementation knobs, the observability fields
and the execution layout), with the same names and defaults, plus
``use_gpu``, the reference's ``--use-gpu``.  The defaults mirror the
reference's ``optConfig`` / CLI surface (``MNIST_Air_weight.py:16-28,
:516-544``): K=50 honest clients, 100 rounds x displayInterval 10, batch
50, gamma 1e-2, weight_decay 0, seed 2021, gm/gm2 maxiter 1000 tol 1e-5
(``:350``).  ``agg_impl`` picks the hand-written CUDA kernels
(``pallas``) or their plain torch versions (``xla``).
"""


from __future__ import annotations

import dataclasses
import typing
from dataclasses import dataclass, fields
from typing import Optional


@dataclass
class FedConfig:
    # topology
    honest_size: int = 50
    byz_size: int = 0

    # schedule (reference: rounds=100, displayInterval=10)
    rounds: int = 100
    display_interval: int = 10

    # optimizer (reference SGD: w <- w - gamma*(grad + wd*w))
    gamma: float = 1e-2
    weight_decay: float = 0.0
    batch_size: int = 50
    # local SGD steps per client per global iteration: 1 = the reference's
    # FedSGD (:296-303); >1 = FedAvg, each step on a fresh batch
    local_steps: int = 1
    # FedProx (Li et al., MLSys 2020): mu*(w - w_round_start) added to each
    # local step's gradient; 0 disables (with one local step it is 0 anyway)
    fedprox_mu: float = 0.0
    # server optimizer over the pseudo-gradient (flat - aggregated): "none"
    # takes the aggregate (reference :354-358), "momentum" FedAvgM, "adam"
    # FedAdam, with optax's formulas (fed/server_opt.py)
    server_opt: str = "none"
    server_lr: float = 1.0
    server_momentum: float = 0.9
    # client momentum (Karimireddy, He & Jaggi, ICML 2021): each client keeps
    # m <- beta*m + (1-beta)*g across iterations and sends w - gamma*m; a
    # [K, d] buffer carried on the trainer.  0 = off; needs local_steps == 1
    client_momentum: float = 0.0

    # dispatch
    agg: str = "gm"
    # a registered attack name, or "name@R": honest behavior until round R
    attack: Optional[str] = None
    noise_var: Optional[float] = None
    # non-adversarial fault injection (ops/faults.py): a registered fault
    # name ("dropout", "deep_fade", "csi", "corrupt", "chaos") or None, the
    # ideal deployment.  The knobs below override the named fault's values
    # when not None; setting one without `fault` is an error
    fault: Optional[str] = None
    dropout_prob: Optional[float] = None
    fade_floor: Optional[float] = None
    csi_std: Optional[float] = None
    corrupt_prob: Optional[float] = None
    corrupt_mode: Optional[str] = None
    corrupt_size: Optional[int] = None
    ge_p_gb: Optional[float] = None
    ge_p_bg: Optional[float] = None
    ge_bad_mult: Optional[float] = None

    # online defense (defense/): "off" runs no defense code; "monitor" scores
    # every client and tracks the rung that would run, the aggregation
    # untouched (the trajectory is bitwise that of "off"); "adaptive" lets
    # the rung pick the aggregator from the ladder.  The knobs below must
    # stay at their defaults when the defense is off
    defense: str = "off"
    # escalation ladder, cheapest rung first; in adaptive mode rung 0 must be
    # `agg`, and no rung may own its channel (gm, signmv)
    defense_ladder: str = "mean,trimmed_mean,multi_krum"
    # detector: iterations before flags arm, EMA rate, CUSUM allowance and
    # threshold (robust sigmas), instantaneous z threshold
    defense_warmup: int = 5
    defense_alpha: float = 0.1
    defense_drift: float = 0.5
    defense_cusum: float = 8.0
    defense_z: float = 4.0
    # hysteresis: escalate after `up` suspicious iterations in a row,
    # de-escalate after `down` clean ones; an iteration is suspicious when
    # at least `min_flagged` clients flag
    defense_up: int = 3
    defense_down: int = 20
    defense_min_flagged: int = 1
    # leaky escalation budget: +1 per escalation, x(1 - leak) per iteration;
    # at or above `floor` the rung cannot fall below 1.  floor 0 disables
    defense_floor: float = 1.5
    defense_leak: float = 0.005

    # aggregator options (reference options dict, :350)
    agg_maxiter: int = 1000
    agg_tol: float = 1e-5
    gm_p_max: float = 1.0
    # multi-Krum selection count (None = honest size)
    krum_m: Optional[int] = None
    # scalar magnitude of a parameterized message attack (alie z, ipm eps,
    # gaussian sigma, minmax/minsum fixed gamma); None = the attack's own
    # default (and the bisection, for minmax/minsum)
    attack_param: Optional[float] = None
    # centered-clipping radius (None = the per-step median of the client
    # delta norms) and its fixed step count
    clip_tau: Optional[float] = None
    clip_iters: int = 3
    # signmv/bev step; None = the coordinatewise median of |w_i - guess|
    sign_eta: Optional[float] = None
    # sign-channel payload width for signmv/bev: 32 = full-precision
    # ballots, 8/16 = quantize-dequantize emulation, 1 = bit-packed words +
    # popcount reduce (needs sign_eta)
    sign_bits: int = 32
    # dnc: filtering rounds, coordinate sample size, removal multiplier
    # (ceil(c*B) removed per round)
    dnc_iters: int = 3
    dnc_sub_dim: int = 10000
    dnc_c: float = 1.0
    # "auto" | "xla" | "pallas": the implementation of every kernel a rule
    # runs (the Weiszfeld steps, the selection, the vote count).  "pallas"
    # = the hand-written CUDA kernels (ops/kernels.py; refused on the CPU,
    # which has none), "xla" = their plain torch versions on any device,
    # "auto" = pallas on the card and xla on the CPU (JAX fed/train.py:215)
    agg_impl: str = "auto"
    # "auto" | "on" | "off": fold the OMA channel into median's and
    # trimmed_mean's one read of the stack (select_columns' epilogue)
    # instead of applying it to the stack first.  "auto" = fold where the
    # resolved impl is pallas, nothing else reads the received stack and
    # the stack is f32; "on" folds under xla too (the plain versions take
    # the channel); "off" never folds.  Either way the same bits
    fused_epilogue: str = "auto"
    # "f32" | "bf16": dtype of the [K, d] stack handed to the rule; bf16
    # halves the bytes each Weiszfeld step reads, the arithmetic stays f32
    # and the aggregate comes back f32
    stack_dtype: str = "f32"

    # determinism
    seed: int = 2021
    fix_seed: bool = True
    # the per-round random streams: "threefry" names the port's own torch
    # (Philox) streams; JAX's "rbg" / "unsafe_rbg" select a TPU hardware
    # RNG path with no counterpart on the card, and are refused
    prng_impl: str = "threefry"

    # model / data
    model: str = "MLP"
    dataset: str = "mnist"
    # the CNN's hidden width (1024 = the reference's MNIST CNN; 2048 its
    # EMNIST one)
    fc_width: int = 1024
    # ResNet-18's stem width (64 = the standard net; stage i is width*2^i)
    # and per-block activation recomputation in the backward pass
    resnet_width: int = 64
    remat: bool = False
    # client data partition: "contiguous" (the reference's equal slices,
    # :238-239) or "dirichlet" (label-skewed non-IID, Hsu et al. 2019,
    # derived from (seed, dirichlet_alpha); smaller alpha = more skew)
    partition: str = "contiguous"
    dirichlet_alpha: float = 0.3
    # quantity skew on top of the partition: "none" (equal cut) or
    # "zipf:<s>" (client i owns ~ i^-s of the samples; zipf:0 = equal cut)
    size_skew: str = "none"
    # partial participation: every iteration draws half-up(participation *
    # honest_size) honest and floor(participation * byz_size) Byzantine
    # clients (participant_counts); 1.0 = every client, the reference
    participation: float = 1.0
    # bucketing (Karimireddy, He & Jaggi, ICLR 2022): the rule aggregates the
    # means of random disjoint buckets of this many messages; 1 = off
    bucket_size: int = 1
    # cohort streaming: when > 0 the round never holds the [K, d] stack;
    # every aggregation pass rebuilds one cohort_size-client chunk at a
    # time (peak memory O(cohort*d)).  0 = the resident path.  Must divide
    # the participating honest and Byzantine counts, so that every chunk is
    # purely honest or purely Byzantine; needs a streamable rule (mean,
    # median, trimmed_mean, gm2), a row-local or data-level attack, and no
    # stale-replay fault
    cohort_size: int = 0
    # the streamed median/trimmed_mean: "exact" (32 counting passes of a
    # key bisection, the resident ranks) or "sketch" (a mergeable [bins, d]
    # key histogram, 2 passes, error within one bucket width)
    cohort_quantile: str = "exact"
    cohort_sketch_bins: int = 512
    # service rounds: a population of `population` stable client ids
    # (honest ids first, in proportion) with Markov churn; every iteration
    # draws honest_size + byz_size of them from the available ones, and a
    # deadline erases the absent and late rows to NaN (the rules run
    # degraded).  "off" draws and hashes exactly as before the fields
    service: str = "off"
    population: int = 0
    # per-iteration probabilities: an offline id comes back, an online one
    # leaves, an arrived participant misses the deadline
    churn_arrival: float = 0.02
    churn_departure: float = 0.01
    straggler_prob: float = 0.0
    # warm rollback: on a non-finite loss or variance, a val-loss spike past
    # rollback_loss_factor x the recent median, or (with a defense and
    # rollback_cusum > 0) a CUSUM peak past rollback_cusum, restore the last
    # good round, widen the trim fraction by rollback_widen and go on under
    # salted draws; at most rollback_max restores per run
    rollback: str = "on"
    rollback_loss_factor: float = 3.0
    rollback_cusum: float = 0.0
    rollback_widen: float = 1.5
    rollback_max: int = 3
    # population shards of a streamed service round (JAX fed/config.py:
    # 284-296): the round's cohort chunks split over S owners, each scanning
    # its own chunk range, the partial carries merged by the fixed algebra
    # of ops/shardctx.py (one rank each when a process group of S ranks is
    # up, the sequential engine otherwise).  1 (default) is the single
    # chunk loop bit for bit and is skipped from the config hash; > 1 needs
    # --service on with a streamed cohort and forks the title (_psS) and
    # hash, since the float partial sums add in another order
    pop_shards: int = 1

    # multi-round dispatch (fed/train.py Trainer._train_multi): R rounds per
    # dispatch, on the card one CUDA-graph replay per round (fed/graphs.py)
    # with no host read between them.  1 (default) drives the per-round
    # loop bit for bit and is skipped from the config hash; > 1 folds the
    # stacked per-round outputs into the record at each dispatch's end,
    # moves eval, checkpoints and the rollback guard to R-round boundaries
    # and forks the title (_rdN) and hash.  R must divide `rounds`; a
    # resumed run may open with an alignment dispatch and close with a tail
    rounds_per_dispatch: int = 1
    # rounds between boundary evals under R > 1: 0 evaluates at every
    # boundary; a multiple of R evaluates at those boundaries only, and the
    # skipped rounds' record entries repeat the last eval
    eval_interval: int = 0
    # "exact" refuses combinations that R > 1 would coarsen (service rounds'
    # warm rollback guards every round); "degraded" accepts the guard at
    # dispatch boundaries
    dispatch_mode: str = "exact"
    # "on" launches dispatch i+1 before folding dispatch i's outputs, so the
    # host fold overlaps device work; the records are bitwise those of
    # "off" but for roundsPerSec, so the hash skips it
    dispatch_prefetch: str = "off"
    # the writer thread (obs/writer.py) for checkpoint writes and the record
    # pickle: "auto" = on iff rounds_per_dispatch > 1; output-only, so the
    # hash skips it
    async_writer: str = "auto"

    # eval
    eval_batch: int = 2000
    eval_train: bool = True

    # federated optimizer (reference --opt, only SGD exists)
    opt: str = "SGD"

    # execution layout (parallel/sharded.py): None = auto (shard the clients
    # over the process group's ranks when there are several and K divides
    # evenly), True/False = force; model_parallel splits the d axis
    sharded: Optional[bool] = None
    model_parallel: Optional[int] = None

    # checkpoint / resume (the reference's --inherit is dead; this one
    # works): the params and the extra state are written after every round
    # under checkpoint_dir, and inherit resumes from them
    checkpoint_dir: str = ""
    inherit: bool = False

    # the reference's --use-gpu: False asks for the CPU (the CLI's --device
    # cpu sets it too); True runs on CUDA, never on the CPU for want of a card
    use_gpu: bool = True

    # misc
    mark: str = ""
    cache_dir: str = ""

    # observability (obs/): all output-only, so config_hash skips every one
    # of them and run_title names none; with all at their defaults no obs
    # code runs and the records, params and random streams are bitwise
    # those of a run without the subsystem (JAX fed/config.py:390-455).
    # a torch.profiler trace (Chrome/Perfetto JSON) of the run lands here,
    # each round a "round" range, eval and checkpoint named ranges
    profile_dir: str = ""
    # capture window "A:B" (half-open, round indices); requires profile_dir
    profile_rounds: str = ""
    # the per-run event stream ({ckpt_title}.events.jsonl, appended on resume)
    obs_dir: str = ""
    # also emit the event stream as JSON lines on stdout
    obs_stdout: bool = False
    # tee every harness log line here, flushed per line
    log_file: str = ""
    # silence the harness's stdout logging (the log_file tee still writes)
    quiet: bool = False
    # warn when the card's measured memory peak exceeds the port's memory
    # model (obs/hbm.cuda_peak_bytes) by this factor
    hbm_warn_factor: float = 2.0
    # client-level forensics (obs/forensics.py): "off" runs no forensic
    # code; "top" computes the round's top-M flag provenance and emits
    # client_flag events for the flagged rows; "full" emits the whole top-M
    # and keeps the flight recorder (the last flight_window rounds of
    # detector state, dumped on every rollback and at run end).  Requires
    # --defense monitor|adaptive
    forensics: str = "off"
    # top-M suspicious clients extracted per round (<= node_size)
    forensics_top: int = 8
    # flight-recorder window W: rounds of detector state kept in the ring
    flight_window: int = 8
    # rotate the --obs-dir stream once the live file passes this many MiB
    # (0 = one unbounded file); segments keep one seq envelope
    obs_rotate_mb: float = 0.0
    # "on": spans mint trace/span ids and nest (obs/trace.py)
    trace: str = "off"
    # live telemetry (obs/metrics.py, obs/exporter.py, obs/alerts.py),
    # derived on the host from the event stream.  "on" folds the events
    # into an in-process metrics registry
    metrics: str = "off"
    # serve Prometheus /metrics + /healthz on this port (implies --metrics
    # on); 0 disables the exporter
    metrics_port: int = 0
    # SLO alert rules evaluated each round on the registry (implies
    # --metrics on): "off", "default" (the built-in pack) or a path to a
    # JSON rule list
    alerts: str = "off"

    _FAULT_KNOBS = (
        "dropout_prob", "fade_floor", "csi_std", "corrupt_prob",
        "corrupt_mode", "corrupt_size", "ge_p_gb", "ge_p_bg", "ge_bad_mult",
    )

    # defense knobs that must stay at their defaults with the defense off;
    # harness.config_hash skips them then, as it skips `defense`
    _DEFENSE_KNOBS = (
        "defense_ladder", "defense_warmup", "defense_alpha", "defense_drift",
        "defense_cusum", "defense_z", "defense_up", "defense_down",
        "defense_min_flagged", "defense_floor", "defense_leak",
    )

    # cohort knobs that need cohort_size > 0; harness.config_hash skips them
    # (and cohort_size) at 0
    _COHORT_KNOBS = ("cohort_quantile", "cohort_sketch_bins")

    # service knobs that need --service on; harness.config_hash skips them
    # (and service) while it is off
    _SERVICE_KNOBS = (
        "population", "churn_arrival", "churn_departure", "straggler_prob",
        "rollback", "rollback_loss_factor", "rollback_cusum",
        "rollback_widen", "rollback_max",
    )

    # dispatch knobs that need rounds_per_dispatch > 1 (dispatch_prefetch
    # too, checked on its own); harness.config_hash skips them (and
    # rounds_per_dispatch) at R = 1.  async_writer and dispatch_prefetch
    # are output-only and skipped always
    _DISPATCH_KNOBS = ("eval_interval", "dispatch_mode")

    # forensics knobs that need --forensics top|full
    _FORENSICS_KNOBS = ("forensics_top", "flight_window")

    # the observability fields: output-only, skipped by config_hash always
    _OBS_FIELDS = ("obs_dir", "obs_stdout", "obs_rotate_mb", "log_file", "quiet",
                   "profile_dir", "profile_rounds", "hbm_warn_factor", "forensics",
                   "forensics_top", "flight_window", "trace", "metrics", "metrics_port",
                   "alerts")

    @property
    def node_size(self) -> int:
        return self.honest_size + self.byz_size

    def participant_counts(self) -> tuple:
        """(honest, Byzantine) rows per iteration (JAX ``fed/config.py:337``).
        The honest count rounds half up and the Byzantine count is floored,
        so rounding never adds an attacker beyond participation * byz_size;
        the 1e-9 guards keep binary-float products that land just under an
        integer or a .5 tie (0.29 * 100 = 28.999999999999996) on the
        mathematical side."""
        if self.participation < 1.0:
            return (
                int(self.participation * self.honest_size + 0.5 + 1e-9),
                int(self.participation * self.byz_size + 1e-9),
            )
        return self.honest_size, self.byz_size

    def population_counts(self) -> tuple:
        """(honest, Byzantine) population block sizes under --service on
        (JAX ``fed/config.py:361``): ids [0, pop_h) are honest, [pop_h,
        population) Byzantine, in the proportion of the node counts."""
        per = self.population // self.node_size
        return per * self.honest_size, per * self.byz_size

    def defense_ladder_names(self) -> tuple:
        """The escalation ladder as a tuple of aggregator names."""
        return tuple(n for n in self.defense_ladder.split(",") if n)

    def fault_overrides(self) -> dict:
        """The non-None fault knobs, as overrides of the named fault."""
        return {k: getattr(self, k) for k in self._FAULT_KNOBS if getattr(self, k) is not None}

    def validate(self) -> "FedConfig":
        """Reject configurations the main path cannot run; returns self."""
        from ..ops import aggregators as agg_lib
        from ..ops import attacks as attack_lib
        from ..ops import faults as fault_lib
        from ..registry import DATASETS, MODELS

        # reference asserts (MNIST_Air_weight.py:229-230)
        if not (self.byz_size == 0 or self.attack is not None):
            raise ValueError("byz_size > 0 requires an attack")
        if self.honest_size <= 0:
            raise ValueError("honest_size must be positive")
        if self.byz_size < 0:
            raise ValueError(f"byz_size must be >= 0, got {self.byz_size}")
        for name in ("rounds", "display_interval", "batch_size",
                     "agg_maxiter", "eval_batch"):
            if getattr(self, name) < 1:
                raise ValueError(
                    f"{name} must be >= 1, got {getattr(self, name)}"
                )
        if self.agg_tol < 0:
            raise ValueError(f"agg_tol must be >= 0, got {self.agg_tol}")
        if self.gm_p_max <= 0:
            raise ValueError(f"gm_p_max must be > 0, got {self.gm_p_max}")
        if self.noise_var is not None and self.noise_var < 0:
            raise ValueError(f"noise_var must be >= 0, got {self.noise_var}")
        if self.sign_eta is not None and not self.sign_eta > 0:
            raise ValueError(f"sign_eta must be positive when set, got {self.sign_eta}")
        if self.sign_bits not in (1, 8, 16, 32):
            raise ValueError(
                f"sign_bits must be one of 1, 8, 16, 32 (payload width of the "
                f"sign channel), got {self.sign_bits}"
            )
        if self.sign_bits != 32 and self.agg not in ("signmv", "bev"):
            raise ValueError(
                f"sign_bits={self.sign_bits} narrows the SIGN channel; only "
                f"signmv and bev transmit it, agg={self.agg!r} sends "
                "full-precision weights (use --agg signmv or bev, or leave "
                "sign_bits at 32)"
            )
        if self.sign_bits == 1 and self.sign_eta is None:
            raise ValueError(
                "sign_bits=1 requires an explicit --sign-eta: the one-bit wire "
                "carries no delta magnitudes for the adaptive eta"
            )
        if self.inherit and not self.checkpoint_dir:
            raise ValueError(
                "inherit resumes from checkpoint_dir; set --checkpoint-dir too"
            )
        if self.partition not in ("contiguous", "dirichlet"):
            raise ValueError(
                f"partition must be 'contiguous' or 'dirichlet', got {self.partition!r}"
            )
        if not self.dirichlet_alpha > 0:
            raise ValueError(
                f"dirichlet_alpha must be positive, got {self.dirichlet_alpha}"
            )
        if self.size_skew != "none":
            if not self.size_skew.startswith("zipf:"):
                raise ValueError(
                    f"size_skew must be 'none' or 'zipf:<s>', got {self.size_skew!r}"
                )
            try:
                skew = float(self.size_skew.split(":", 1)[1])
            except ValueError:
                raise ValueError(
                    f"size_skew exponent must be a float, got {self.size_skew!r}"
                ) from None
            if skew < 0:
                raise ValueError(f"size_skew exponent must be >= 0, got {skew}")
        if self.opt != "SGD":
            raise ValueError(f"opt must be 'SGD' (the only optimizer), got {self.opt!r}")
        self._validate_impl()
        self._validate_training_options()
        # the rule sees the drawn clients, or their bucket means
        part_h, part_b = self.participant_counts()
        k = (part_h + part_b) // self.bucket_size
        if self.krum_m is not None and not 1 <= self.krum_m <= k:
            raise ValueError(
                f"krum_m must be in [1, {k}] (participating clients), got {self.krum_m}"
            )
        if not (self.clip_tau is None or self.clip_tau > 0) or self.clip_iters < 1:
            raise ValueError(
                f"clip_tau must be > 0 (or None = adaptive) and clip_iters >= 1, "
                f"got {self.clip_tau}, {self.clip_iters}"
            )
        if not (self.dnc_iters >= 1 and self.dnc_sub_dim >= 1 and self.dnc_c > 0):
            raise ValueError(
                f"dnc knobs must be positive, got iters={self.dnc_iters}, "
                f"sub_dim={self.dnc_sub_dim}, c={self.dnc_c}"
            )
        # the rules' own size bounds, up front rather than mid-run
        if self.agg == "bulyan":
            agg_lib.bulyan_sizes(k, part_b)
        if self.agg == "dnc":
            agg_lib.dnc_removals(k, k - part_b, self.dnc_iters, self.dnc_c)
        # a knob without a fault, an unknown fault or a knob out of range
        # raises here
        spec = fault_lib.resolve(self.fault, self.fault_overrides())
        if spec is not None and spec.corrupt_size > self.honest_size:
            raise ValueError(
                f"corrupt_size {spec.corrupt_size} exceeds the {self.honest_size} "
                "honest clients (corruption models crashed honest senders; "
                "Byzantine rows are the attack's)"
            )
        if spec is not None and self.participation != 1.0:
            raise ValueError(
                "fault injection requires full participation: the stale-replay "
                "buffer and Gilbert-Elliott state are [K]-indexed by the full "
                "client stack"
            )
        self._validate_defense()
        self._validate_obs()
        # unknown names fail here, not mid-run (KeyError lists known names)
        agg_lib.resolve(self.agg)
        # an unknown name, or a malformed "name@R", raises here
        attack = attack_lib.resolve(self.attack)
        self._validate_cohort(part_h, part_b, attack, spec)
        self._validate_service()
        self._validate_pop_shards()
        self._validate_dispatch()
        if attack is not None and attack.defense_aware and self.defense == "off":
            raise ValueError(
                f"attack {self.attack!r} is defense-aware (it reads the published "
                "detector EMA/CUSUM state inside the round) and requires --defense "
                "adaptive|monitor; with --defense off there is no detector state "
                "to observe"
            )
        if self.attack_param is not None and (attack is None or attack.param_name is None):
            raise ValueError(
                f"attack {self.attack!r} takes no scalar parameter "
                f"(attack_param={self.attack_param}); the knob exists for "
                "alie, ipm, gaussian, minmax and minsum"
            )
        DATASETS.get(self.dataset)
        MODELS.get(self.model)
        return self

    def _validate_impl(self):
        """The implementation knobs (JAX ``fed/config.py:522-527, :565-567,
        :657-660``); ``rbg`` and ``unsafe_rbg`` are JAX's own choices,
        refused here."""
        if self.agg_impl not in ("auto", "xla", "pallas"):
            raise ValueError(
                f"agg_impl must be 'auto', 'xla' or 'pallas', got {self.agg_impl!r}")
        if self.agg_impl == "pallas" and not self.use_gpu:
            raise ValueError(
                "agg_impl 'pallas' runs the hand-written CUDA kernels, and the CPU has "
                "none (JAX's interpret mode has no counterpart here): use --agg-impl xla "
                "or auto on the CPU")
        if self.fused_epilogue not in ("auto", "on", "off"):
            raise ValueError(
                f"fused_epilogue must be 'auto', 'on' or 'off', got {self.fused_epilogue!r}")
        if self.stack_dtype not in ("f32", "bf16"):
            raise ValueError(f"stack_dtype must be 'f32' or 'bf16', got {self.stack_dtype!r}")
        if self.prng_impl not in ("threefry", "rbg", "unsafe_rbg"):
            raise ValueError(
                f"prng_impl must be 'threefry', 'rbg' or 'unsafe_rbg', got {self.prng_impl!r}")
        if self.prng_impl != "threefry":
            raise ValueError(
                f"prng_impl {self.prng_impl!r} selects the TPU's hardware RNG path, which "
                "has no counterpart on this card: the port has one generator family "
                "(torch's Philox), named by 'threefry', the default")

    def _validate_training_options(self):
        """Participation, bucketing, local steps, FedProx, the server
        optimizer and client momentum (JAX ``fed/config.py:529-601, :647-663``)."""
        if not 0.0 < self.participation <= 1.0:
            raise ValueError(f"participation must be in (0, 1], got {self.participation}")
        part_h, part_b = self.participant_counts()
        if self.participation < 1.0:
            if part_h < 1:
                raise ValueError(
                    f"participation {self.participation} rounds to zero honest "
                    f"participants of {self.honest_size}"
                )
            if self.byz_size and part_b < 1:
                raise ValueError(
                    f"participation {self.participation} would silently drop all "
                    f"{self.byz_size} Byzantine clients (rounds to 0); raise the "
                    "fraction or set byz_size=0 explicitly"
                )
        if self.bucket_size < 1:
            raise ValueError(f"bucket_size must be >= 1, got {self.bucket_size}")
        if self.bucket_size > 1:
            m = part_h + part_b
            if m % self.bucket_size:
                raise ValueError(
                    f"bucket_size {self.bucket_size} must divide the {m} "
                    "participating clients"
                )
            n_buckets = m // self.bucket_size
            clean = n_buckets - part_b  # worst case: one Byzantine row per bucket
            if clean < 2:
                raise ValueError(
                    f"bucketing leaves {n_buckets} buckets of which {part_b} may be "
                    f"Byzantine-contaminated: {clean} worst-case clean buckets is "
                    "degenerate; use a smaller bucket_size or fewer Byzantine clients"
                )
            if self.agg in ("krum", "Krum", "multi_krum") and clean < 3:
                raise ValueError(
                    f"krum needs >= 3 worst-case clean buckets to score neighbors "
                    f"(got {clean}); smaller bucket_size required"
                )
            if self.agg in ("gm", "signmv"):
                raise ValueError(
                    f"bucketing is undefined for agg={self.agg!r}: its over-the-air "
                    "transmission happens inside aggregation; use gm2 (ideal) or a "
                    "prepass aggregator"
                )
            if self.sign_bits == 1:
                raise ValueError(
                    "sign_bits=1 packs each client's ballots into uint32 words; "
                    "bucket means over packed words are undefined (a mean of sign "
                    "words is not a sign word); use --bucket-size 1"
                )
        if self.fedprox_mu < 0:
            raise ValueError(f"fedprox_mu must be >= 0, got {self.fedprox_mu}")
        if not 0.0 <= self.client_momentum < 1.0:
            raise ValueError(
                f"client_momentum must be in [0, 1), got {self.client_momentum}"
            )
        if self.client_momentum and self.local_steps != 1:
            raise ValueError(
                "client_momentum requires local_steps == 1 (the FedSGD regime the "
                "momentum analysis covers); use server_opt for FedAvg"
            )
        if self.local_steps < 1:
            raise ValueError(f"local_steps must be >= 1, got {self.local_steps}")
        if self.server_opt not in ("none", "momentum", "adam"):
            raise ValueError(
                f"server_opt must be none|momentum|adam, got {self.server_opt!r}"
            )

    def _validate_defense(self):
        """The defense mode and knobs (JAX ``fed/config.py:723-795``)."""
        from ..defense.policy import validate_ladder

        if self.defense not in ("off", "monitor", "adaptive"):
            raise ValueError(
                f"defense must be off|monitor|adaptive, got {self.defense!r}"
            )
        if self.defense == "off":
            defaults = {f.name: f.default for f in fields(self)}
            touched = sorted(
                k for k in self._DEFENSE_KNOBS if getattr(self, k) != defaults[k]
            )
            if touched:
                raise ValueError(
                    f"defense knobs {touched} require --defense monitor|adaptive "
                    "(they configure the detector/ladder and would otherwise "
                    "silently do nothing)"
                )
            return
        if self.participation != 1.0:
            raise ValueError(
                "defense requires full participation: the detector EMA/CUSUM "
                "state is [K]-indexed by the full client stack"
            )
        if self.defense_warmup < 1:
            raise ValueError(f"defense_warmup must be >= 1, got {self.defense_warmup}")
        if not 0.0 < self.defense_alpha <= 1.0:
            raise ValueError(f"defense_alpha must be in (0, 1], got {self.defense_alpha}")
        if not (self.defense_drift > 0 and self.defense_z > 0 and self.defense_cusum > 0):
            raise ValueError(
                f"defense drift/z/cusum thresholds must be positive, got "
                f"{self.defense_drift}, {self.defense_z}, {self.defense_cusum}"
            )
        if not (self.defense_up >= 1 and self.defense_down >= 1
                and self.defense_min_flagged >= 1):
            raise ValueError(
                f"defense hysteresis knobs must be >= 1, got up={self.defense_up}, "
                f"down={self.defense_down}, min_flagged={self.defense_min_flagged}"
            )
        if self.defense_floor < 0.0:
            raise ValueError(
                "defense_floor must be >= 0 (0 disables the escalation-budget "
                f"rung floor), got {self.defense_floor}"
            )
        if not 0.0 <= self.defense_leak < 1.0:
            raise ValueError(
                "defense_leak must be in [0, 1) (per-iteration budget decay), "
                f"got {self.defense_leak}"
            )
        validate_ladder(
            self.defense_ladder_names(),
            self.agg if self.defense == "adaptive" else None,
        )

    def _validate_obs(self):
        """The observability knobs (JAX ``fed/config.py:688-724``, :787-815)."""
        from ..obs.profile import parse_rounds

        if self.profile_rounds:
            if not self.profile_dir:
                raise ValueError(
                    "profile_rounds requires profile_dir (a capture window without a "
                    "trace destination would silently do nothing)"
                )
            # a malformed window fails at startup, not at round A
            parse_rounds(self.profile_rounds)
        if not self.hbm_warn_factor > 0:
            raise ValueError(f"hbm_warn_factor must be positive, got {self.hbm_warn_factor}")
        if self.obs_rotate_mb < 0:
            raise ValueError(
                f"obs_rotate_mb must be >= 0 (0 disables rotation), got {self.obs_rotate_mb}"
            )
        if self.obs_rotate_mb > 0 and not self.obs_dir:
            raise ValueError("obs_rotate_mb requires --obs-dir")
        if self.trace not in ("off", "on"):
            raise ValueError(f"trace must be off|on, got {self.trace!r}")
        if self.metrics not in ("off", "on"):
            raise ValueError(f"metrics must be off|on, got {self.metrics!r}")
        if not 0 <= self.metrics_port <= 65535:
            raise ValueError(
                f"metrics_port must be a port number (0 disables), got {self.metrics_port}")
        if not self.alerts:
            raise ValueError("alerts must be 'off', 'default', or a JSON rules path — got "
                             "an empty string")
        if self.alerts not in ("off", "default"):
            # a malformed rules file fails at startup, not at round 0
            from ..obs.alerts import load_rules

            load_rules(self.alerts)
        if self.forensics not in ("off", "top", "full"):
            raise ValueError(f"forensics must be off|top|full, got {self.forensics!r}")
        if self.forensics == "off":
            self._untouched("forensics", self._FORENSICS_KNOBS, "--forensics top|full")
            return
        if self.defense == "off":
            raise ValueError(
                "--forensics attributes the defense detector's per-client scores — it "
                "requires --defense monitor|adaptive"
            )
        if not 1 <= self.forensics_top <= self.node_size:
            raise ValueError(
                f"forensics_top must be in [1, node_size={self.node_size}] (the top-k "
                f"runs over the K drawn rows), got {self.forensics_top}"
            )
        if self.flight_window < 1:
            raise ValueError(f"flight_window must be >= 1, got {self.flight_window}")

    def _untouched(self, kind: str, knobs, needs: str):
        """Raise when a knob of ``knobs`` is off its default (it would do
        nothing without ``needs``)."""
        defaults = {f.name: f.default for f in fields(self)}
        touched = sorted(k for k in knobs if getattr(self, k) != defaults[k])
        if touched:
            raise ValueError(
                f"{kind} knobs {touched} require {needs} (they would otherwise "
                "silently do nothing)"
            )

    def _validate_cohort(self, part_h: int, part_b: int, attack, fault):
        """Cohort streaming (JAX ``fed/config.py:839-940``)."""
        from ..ops import aggregators as agg_lib

        if self.cohort_size < 0:
            raise ValueError(f"cohort_size must be >= 0, got {self.cohort_size}")
        if self.cohort_size == 0:
            self._untouched("cohort", self._COHORT_KNOBS, "--cohort-size > 0")
            return
        if self.cohort_quantile not in ("exact", "sketch"):
            raise ValueError(
                f"cohort_quantile must be 'exact' or 'sketch', got {self.cohort_quantile!r}"
            )
        if self.cohort_sketch_bins < 2:
            raise ValueError(
                f"cohort_sketch_bins must be >= 2, got {self.cohort_sketch_bins}"
            )
        # under partial participation the chunks walk the drawn clients
        if part_h % self.cohort_size or part_b % self.cohort_size:
            raise ValueError(
                f"cohort_size {self.cohort_size} must divide both the {part_h} "
                f"participating honest and {part_b} participating Byzantine clients "
                "(each streamed chunk must be purely honest or purely Byzantine)"
            )
        if self.bucket_size != 1:
            raise ValueError(
                "bucketing shuffles rows across cohorts before aggregation, which "
                "needs the resident stack; use --cohort-size 0 with --bucket-size"
            )
        if self.client_momentum != 0.0:
            raise ValueError(
                "client_momentum carries a resident [K, d] state buffer, exactly "
                "the allocation the streamed path removes"
            )
        if self.stack_dtype != "f32":
            raise ValueError(
                "the streamed selection rung bisects f32 total-order keys; bf16 chunks "
                "are not supported (--cohort-size 0 for bf16)"
            )
        if self.fused_epilogue == "on":
            raise ValueError(
                "the fused sort-family epilogue reads the resident [K, d] stack in one "
                "pass; it cannot apply to a streamed round (the cohort scan is the "
                "single pass); leave it 'auto'"
            )
        rungs = {self.agg}
        if self.defense == "adaptive":
            rungs |= set(self.defense_ladder_names())
        for rung in sorted(rungs):
            if not agg_lib.streamable(rung):
                raise ValueError(
                    f"aggregator {rung!r} has no streaming/mergeable formulation "
                    "(needs the resident [K, d] stack); streamable: mean, median, "
                    "trimmed_mean, gm2"
                )
        if attack is not None and not attack.meta()["streamable"]:
            raise ValueError(
                f"attack {self.attack!r} is omniscient (reads the honest rows of the "
                "resident stack) and cannot run under cohort streaming; use "
                "--cohort-size 0 for it"
            )
        if fault is not None and fault.needs_stale:
            raise ValueError(
                f"fault {self.fault!r} keeps a resident [K, d] stale-replay buffer "
                "(dropout_prob > 0), exactly the allocation the streamed path "
                "removes; deep_fade/csi/corrupt stream fine"
            )

    def _validate_pop_shards(self):
        """Population shards (JAX ``fed/config.py:1040-1068``)."""
        if self.pop_shards < 1:
            raise ValueError(f"pop_shards must be >= 1, got {self.pop_shards}")
        if self.model_parallel is not None and self.model_parallel < 1:
            raise ValueError(f"model_parallel must be >= 1, got {self.model_parallel}")
        if self.pop_shards == 1:
            return
        if self.service != "on":
            raise ValueError(
                "--pop-shards > 1 shards the service population's cohort chunks over "
                "owners — it requires --service on")
        if self.cohort_size <= 0:
            raise ValueError(
                "--pop-shards > 1 shards the STREAMED chunk scan; set --cohort-size > 0 "
                "(the resident path has its own client-axis sharding via --sharded)")
        n_chunks = self.node_size // self.cohort_size
        if n_chunks % self.pop_shards:
            raise ValueError(
                f"pop_shards {self.pop_shards} must divide the per-round chunk count "
                f"{n_chunks} (node_size {self.node_size} / cohort_size "
                f"{self.cohort_size}) so every shard owns the same number of cohort "
                "chunks")
        if self.forensics != "off":
            raise ValueError(
                "--forensics needs the round's full top-M merge stream, which is not "
                "shard-mergeable; use --pop-shards 1 for forensic runs")

    def _validate_dispatch(self):
        """Multi-round dispatch (JAX ``fed/config.py:1070-1145``)."""
        if self.rounds_per_dispatch < 1:
            raise ValueError(
                f"rounds_per_dispatch must be >= 1, got {self.rounds_per_dispatch}"
            )
        if self.async_writer not in ("auto", "on", "off"):
            raise ValueError(
                f"async_writer must be auto, on, or off, got {self.async_writer!r}"
            )
        if self.dispatch_prefetch not in ("off", "on"):
            raise ValueError(
                f"dispatch_prefetch must be off or on, got {self.dispatch_prefetch!r}"
            )
        if self.dispatch_mode not in ("exact", "degraded"):
            raise ValueError(
                f"dispatch_mode must be exact or degraded, got {self.dispatch_mode!r}"
            )
        if self.rounds_per_dispatch == 1:
            # the R = 1 driver is the per-round loop: nothing to tune
            self._untouched("dispatch", self._DISPATCH_KNOBS + ("dispatch_prefetch",),
                            "--rounds-per-dispatch > 1")
            return
        if self.rounds % self.rounds_per_dispatch:
            raise ValueError(
                f"rounds_per_dispatch {self.rounds_per_dispatch} must divide the round "
                f"budget {self.rounds}: a fresh run schedules only full R-round "
                "dispatches (a resumed run may open with an alignment dispatch and "
                "close with a tail dispatch, but the budget itself must split cleanly)"
            )
        if self.eval_interval < 0:
            raise ValueError(f"eval_interval must be >= 0, got {self.eval_interval}")
        if self.eval_interval and self.eval_interval % self.rounds_per_dispatch:
            raise ValueError(
                f"eval_interval {self.eval_interval} must be 0 (every dispatch "
                f"boundary) or a multiple of rounds_per_dispatch "
                f"{self.rounds_per_dispatch}: evals only run between dispatches"
            )
        if self.service == "on" and self.rollback == "on" and self.dispatch_mode == "exact":
            raise ValueError(
                "--rounds-per-dispatch > 1 with --service on arms the warm-rollback "
                "divergence guard, which can only fire at dispatch boundaries; opt "
                "into that coarser granularity with --dispatch-mode degraded, or "
                "disable the guard with --rollback off, or keep "
                "--rounds-per-dispatch 1"
            )

    def _validate_service(self):
        """Service rounds (JAX ``fed/config.py:942-1040``)."""
        if self.service not in ("off", "on"):
            raise ValueError(f"service must be 'off' or 'on', got {self.service!r}")
        if self.service == "off":
            self._untouched("service", self._SERVICE_KNOBS, "--service on")
            return
        if self.population < self.node_size or self.population % self.node_size:
            raise ValueError(
                f"--service on needs --population set to a positive multiple of "
                f"node_size {self.node_size} (got {self.population}): the "
                "honest/Byzantine split over stable ids must stay proportional"
            )
        if self.participation != 1.0:
            raise ValueError(
                "--service on replaces the --participation draw (the per-iteration "
                "subsample is the participation model); leave participation at 1.0"
            )
        if self.fault is not None:
            raise ValueError(
                "--service on subsumes fault injection (stragglers and churn are "
                "its dropout model, and the fault state is [K]-row-indexed); use "
                "--straggler-prob instead"
            )
        if self.bucket_size != 1:
            raise ValueError(
                "--service on closes rounds with NaN rows for missed deadlines; a "
                "bucket mean would spread a NaN over its bucket; use --bucket-size 1"
            )
        if self.client_momentum != 0.0:
            raise ValueError(
                "client_momentum keeps a [K, d] per-row buffer; under per-iteration "
                "subsampling it would need one per population id; use server_opt "
                "momentum instead"
            )
        if not (0.0 <= self.churn_arrival <= 1.0 and 0.0 <= self.churn_departure <= 1.0):
            raise ValueError(
                f"churn rates are per-iteration probabilities in [0, 1], got "
                f"arrival={self.churn_arrival}, departure={self.churn_departure}"
            )
        if not 0.0 <= self.straggler_prob < 1.0:
            raise ValueError(
                f"straggler_prob must be in [0, 1) (at 1.0 every round closes "
                f"empty), got {self.straggler_prob}"
            )
        if self.rollback not in ("off", "on"):
            raise ValueError(f"rollback must be 'off' or 'on', got {self.rollback!r}")
        if self.rollback_loss_factor <= 1.0:
            raise ValueError(
                f"rollback_loss_factor must be > 1 (a spike factor over the recent "
                f"val-loss median), got {self.rollback_loss_factor}"
            )
        if self.rollback_cusum < 0.0:
            raise ValueError(
                f"rollback_cusum must be >= 0 (0 disables the CUSUM guard), got "
                f"{self.rollback_cusum}"
            )
        if self.rollback_cusum > 0.0 and self.defense == "off":
            raise ValueError(
                "rollback_cusum reads the defense CUSUM state; it requires "
                "--defense monitor|adaptive"
            )
        if self.rollback_widen < 1.0:
            raise ValueError(
                f"rollback_widen must be >= 1 (the trim fraction only widens), got "
                f"{self.rollback_widen}"
            )
        if self.rollback_max < 1:
            raise ValueError(f"rollback_max must be >= 1, got {self.rollback_max}")


#: fields a tenant's mapping may not set: the server's device decides them
SERVER_FIELDS = ("use_gpu",)


def coerce_field(name: str, raw: str):
    """Coerce a ``key=value`` string by the FedConfig field's annotation
    (JAX ``fed/config.py:1148-1166``): bools accept true/false/1/yes,
    Optional fields accept "none"/"null"."""
    hints = typing.get_type_hints(FedConfig)
    if name not in hints:
        raise ValueError(f"unknown FedConfig field {name!r}")
    tp = hints[name]
    if typing.get_origin(tp) is typing.Union:  # Optional[...]
        if raw.lower() in ("none", "null"):
            return None
        tp = [a for a in typing.get_args(tp) if a is not type(None)][0]
    if tp is bool:
        return raw.lower() in ("1", "true", "yes")
    return tp(raw)


def config_from_mapping(body: dict, use_gpu: bool = True) -> FedConfig:
    """A validated FedConfig from a JSON-ish mapping, the experiment
    server's ``POST /runs`` body (JAX ``fed/config.py:1169-1199``): strings
    go through :func:`coerce_field`, JSON numbers are cast by the field's
    annotation (``{"gamma": 1}`` stores a float), bools and None pass
    through.  An unknown field raises ``ValueError`` with JAX's message, so
    a misspelled knob is a 400, not a silent default.  ``use_gpu`` is the
    server's (its device), not a tenant's: the caller passes it, and a body
    that names it is refused."""
    hints = typing.get_type_hints(FedConfig)
    kwargs = {}
    for name, value in body.items():
        if name in SERVER_FIELDS:
            raise ValueError(
                f"FedConfig field {name!r} is the server's (its --device), not a tenant's")
        if name not in hints:
            raise ValueError(f"unknown FedConfig field {name!r}")
        if isinstance(value, str):
            kwargs[name] = coerce_field(name, value)
        elif isinstance(value, bool) or value is None:
            kwargs[name] = value
        elif isinstance(value, (int, float)):
            tp = hints[name]
            if typing.get_origin(tp) is typing.Union:  # Optional[...]
                tp = [a for a in typing.get_args(tp) if a is not type(None)][0]
            kwargs[name] = tp(value) if tp in (int, float) else value
        else:
            kwargs[name] = value
    cfg = FedConfig(use_gpu=use_gpu, **kwargs)
    cfg.validate()
    return cfg


def config_to_mapping(cfg: FedConfig) -> dict:
    """The JSON-safe inverse of :func:`config_from_mapping` (JAX
    ``fed/config.py:1202-1230``): every field whose value differs from the
    dataclass default, ``use_gpu`` left out (the server's).  The server's
    journal stores each submission so, and
    ``config_from_mapping(config_to_mapping(cfg), cfg.use_gpu) == cfg``
    holds for any valid config."""
    out = {}
    for f in dataclasses.fields(FedConfig):
        if f.name in SERVER_FIELDS:
            continue
        value = getattr(cfg, f.name)
        if value != f.default:
            out[f.name] = value
    return out
