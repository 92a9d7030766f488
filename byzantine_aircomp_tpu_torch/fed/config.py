"""Run configuration of the port.

A subset of ``byzantine_aircomp_tpu/fed/config.py`` (the main path, every
aggregation rule's knobs, the fault channel's, the models' widths and the
client partition): the same field names
and defaults, which mirror the reference's ``optConfig`` / CLI
surface (``MNIST_Air_weight.py:16-28, :516-544``): K=50 honest clients, 100
rounds x displayInterval 10, batch 50, gamma 1e-2, weight_decay 0, seed
2021, gm/gm2 maxiter 1000 tol 1e-5 (``:350``).  There is no ``agg_impl``:
on CUDA the hand-written kernels always run, on the CPU their plain
versions.
"""

from __future__ import annotations

from dataclasses import dataclass
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

    # determinism
    seed: int = 2021
    fix_seed: bool = True

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

    # eval
    eval_batch: int = 2000
    eval_train: bool = True

    # federated optimizer (reference --opt, only SGD exists)
    opt: str = "SGD"

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

    _FAULT_KNOBS = (
        "dropout_prob", "fade_floor", "csi_std", "corrupt_prob",
        "corrupt_mode", "corrupt_size", "ge_p_gb", "ge_p_bg", "ge_bad_mult",
    )

    @property
    def node_size(self) -> int:
        return self.honest_size + self.byz_size

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
        k = self.node_size
        if self.krum_m is not None and not 1 <= self.krum_m <= k:
            raise ValueError(f"krum_m must be in [1, {k}] (the clients), got {self.krum_m}")
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
            agg_lib.bulyan_sizes(k, self.byz_size)
        if self.agg == "dnc":
            agg_lib.dnc_removals(k, self.honest_size, self.dnc_iters, self.dnc_c)
        # a knob without a fault, an unknown fault or a knob out of range
        # raises here
        spec = fault_lib.resolve(self.fault, self.fault_overrides())
        if spec is not None and spec.corrupt_size > self.honest_size:
            raise ValueError(
                f"corrupt_size {spec.corrupt_size} exceeds the {self.honest_size} "
                "honest clients (corruption models crashed honest senders; "
                "Byzantine rows are the attack's)"
            )
        # unknown names fail here, not mid-run (KeyError lists known names)
        agg_lib.resolve(self.agg)
        # an unknown name, or a malformed "name@R", raises here
        attack = attack_lib.resolve(self.attack)
        if self.attack_param is not None and (attack is None or attack.param_name is None):
            raise ValueError(
                f"attack {self.attack!r} takes no scalar parameter "
                f"(attack_param={self.attack_param}); the knob exists for "
                "alie, ipm, gaussian, minmax and minsum"
            )
        DATASETS.get(self.dataset)
        MODELS.get(self.model)
        return self
